"""jamba's bf16 gradients, each package against its own f32 gradients
(``.reduced()``, the reference's weights, the bf16 test's batch): the
port's largest error on a mamba ``conv_b`` leaf is no larger than the
reference's own, so the looser tolerance that
``tests/test_torch_train_loss_bf16.py`` holds jamba to measures bf16
rounding that the reference shows too, not a fault of the port."""

import numpy as np

from repro_torch.models.convert import named_from_tree

from test_torch_models import one_torch_thread, ref_weights  # noqa: F401
from test_torch_train_loss import (
    _batch,
    _configs,
    port_loss_and_grads,
    reference_loss_and_grads,
)

ARCH = "jamba-v0.1-52b"


def _errors(f32, bf16, scale):
    """{leaf: max |bf16 − f32| / scale[leaf]}"""
    return {n: float(np.abs(bf16[n].astype(np.float32) - f32[n]).max())
            / scale[n] for n in f32}


def test_jamba_conv_b_bf16_error_is_the_references(ref_weights):
    tree = ref_weights(ARCH)
    grads = {}
    for dt in ("float32", "bfloat16"):
        rc, pc = _configs(ARCH, dt)
        batch = _batch(pc, seed=1)
        _, ref = reference_loss_and_grads(rc, tree, batch)
        _, port = port_loss_and_grads(pc, tree, batch)
        grads[dt] = (named_from_tree(pc, ref), port)
    (r32, p32), (r16, p16) = grads["float32"], grads["bfloat16"]
    # the bf16 test's scale: max(1, max |reference bf16 leaf|)
    scale = {n: max(1.0, float(np.abs(r16[n].astype(np.float32)).max()))
             for n in r16}
    ref_err = _errors(r32, r16, scale)
    port_err = _errors(p32, p16, scale)
    conv_b = [n for n in port_err if n.endswith("mamba.conv_b")]
    assert len(conv_b) == 14
    worst_port = max(port_err[n] for n in conv_b)
    worst_ref = max(ref_err[n] for n in conv_b)
    assert worst_port <= worst_ref, (worst_port, worst_ref)
    # and over every leaf: the port's bf16 is no further from its f32
    assert max(port_err.values()) <= max(ref_err.values())
