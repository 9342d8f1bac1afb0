"""The port's roofline (``repro_torch.roofline``) against the JAX
package's: the H100 constants, ``model_flops`` on every full config and
shape, the HLO model and the collective parser on the same HLO text (the
reference's own sample, copied, and the compiled HLO of two reduced train
steps that the reference builds on its 1 × 1 test mesh), all equal; and
``analyze_step``, the port's counterpart of ``analyze_compiled``, with the
reference's key set and its deliberate differences pinned: per-device
bytes as the exact sum of local shards plus the step's own peak, FLOPs
from ``FlopCounterMode``, ``*_raw`` equal to the counted numbers,
``unknown_trip_whiles`` always 0, ``fits_hbm`` against the H100's 80 GB.
CPU only; no process group and no mesh of more than one position."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import cells as ref_cells
from repro.configs import get_config as ref_config
from repro.configs import get_shape as ref_shape
from repro.configs.base import ShapeConfig as RefShape
from repro.launch.mesh import make_test_mesh as ref_test_mesh
from repro.launch.steps import make_train_step as ref_train_step
from repro.roofline import analyze as ref_analyze
from repro.roofline import hlo_model as ref_hlo

from repro_torch.configs import cells, get_config, get_shape
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.steps import (
    local_abstract_args, make_decode_step, make_train_step,
)
from repro_torch.roofline import analyze, hlo_model, hw

HLO_SAMPLE = """\
HloModule test

%body.1 (arg.1: (s32[], f32[8,16])) -> (s32[], f32[8,16]) {
  %arg.1 = (s32[], f32[8,16]{1,0}) parameter(0)
  %gte.0 = s32[] get-tuple-element(%arg.1), index=0
  %gte.1 = f32[8,16]{1,0} get-tuple-element(%arg.1), index=1
  %w = f32[16,16]{1,0} constant({...})
  %dot.1 = f32[8,16]{1,0} dot(%gte.1, %w), lhs_contracting_dims={1}, rhs_contracting_dims={0}
  %ar = f32[8,16]{1,0} all-reduce(%dot.1), channel_id=1, replica_groups=[2,8]<=[16], use_global_device_ids=true, to_apply=%add.1
  ROOT %tuple.1 = (s32[], f32[8,16]{1,0}) tuple(%gte.0, %ar)
}

%cond.1 (arg.2: (s32[], f32[8,16])) -> pred[] {
  %arg.2 = (s32[], f32[8,16]{1,0}) parameter(0)
  %gte.2 = s32[] get-tuple-element(%arg.2), index=0
  %c10 = s32[] constant(10)
  ROOT %cmp = pred[] compare(%gte.2, %c10), direction=LT
}

%add.1 (a: f32[], b: f32[]) -> f32[] {
  %a = f32[] parameter(0)
  %b = f32[] parameter(1)
  ROOT %add.2 = f32[] add(%a, %b)
}

ENTRY %main.1 (p0: f32[8,16]) -> (s32[], f32[8,16]) {
  %p0 = f32[8,16]{1,0} parameter(0)
  %zero = s32[] constant(0)
  %t = (s32[], f32[8,16]{1,0}) tuple(%zero, %p0)
  ROOT %loop = (s32[], f32[8,16]{1,0}) while(%t), condition=%cond.1, body=%body.1, backend_config={"known_trip_count":{"n":"10"}}
}
"""


TRAIN = ShapeConfig("t", seq_len=32, global_batch=4, kind="train")
DECODE = ShapeConfig("d", seq_len=32, global_batch=2, kind="decode")


def _small(cfg):
    """The reference's ``tests/test_launch_steps.py`` reduction."""
    cfg = cfg.reduced()
    return dataclasses.replace(
        cfg, vocab_size=128, loss_chunk=16, q_chunk=16,
        microbatches=2 if cfg.n_experts else 1, ssm_chunk=8,
    )


def test_h100_datasheet_constants():
    """NVIDIA's H100 SXM5 data sheet (dense, 700 W), not the reference's
    TPU figures."""
    assert hw.DEVICE_NAME == "NVIDIA H100 80GB HBM3"
    assert hw.PEAK_FLOPS_BF16 == 989e12
    assert hw.PEAK_FLOPS_FP32 == 67e12
    assert hw.HBM_BW == 3.35e12
    assert hw.HBM_BYTES == 80 * 10**9
    assert hw.NVLINK_BW == 450e9 and hw.ICI_BW == hw.NVLINK_BW
    from repro.roofline import hw as ref_hw

    assert hw.PEAK_FLOPS_BF16 != ref_hw.PEAK_FLOPS_BF16


def test_cells_are_the_references():
    assert cells(include_skips=True) == ref_cells(include_skips=True)
    assert cells() == ref_cells()


@pytest.mark.parametrize("arch, shape", cells(include_skips=True))
def test_model_flops_equals_reference(arch, shape):
    want = ref_analyze.model_flops(ref_config(arch), ref_shape(shape))
    got = analyze.model_flops(get_config(arch), get_shape(shape))
    assert got == want and got > 0


def _summaries_equal(text):
    assert hlo_model.HloModel(text).summary() == ref_hlo.HloModel(text).summary()
    got, want = hlo_model.parse_hlo(text), ref_hlo.parse_hlo(text)
    assert list(got) == list(want)
    for name in want:
        assert dataclasses.asdict(got[name]) == dataclasses.asdict(want[name])
    assert analyze.parse_collectives(text) == ref_analyze.parse_collectives(text)


def test_hlo_model_on_the_reference_sample():
    _summaries_equal(HLO_SAMPLE)
    s = hlo_model.HloModel(HLO_SAMPLE).summary()
    assert s["dot_flops"] == 4096 * 10 and s["unknown_trip_whiles"] == 0
    no_trip = HLO_SAMPLE.replace(
        ', backend_config={"known_trip_count":{"n":"10"}}', "")
    _summaries_equal(no_trip)
    assert hlo_model.HloModel(no_trip).summary()["unknown_trip_whiles"] == 1


@pytest.fixture(scope="module")
def compiled_steps():
    """The reference's train steps of two reduced archs, compiled on its
    1 × 1 test mesh: (arch, compiled) pairs."""
    mesh = ref_test_mesh((1, 1), ("data", "model"))
    shape = RefShape("t", seq_len=32, global_batch=4, kind="train")
    out = []
    for arch in ("starcoder2-3b", "mixtral-8x7b"):
        fn, in_sh, out_sh, args, donate = ref_train_step(
            _small(ref_config(arch)), shape, mesh)
        out.append((arch, jax.jit(fn, in_shardings=in_sh,
                                  out_shardings=out_sh,
                                  donate_argnums=donate).lower(*args).compile()))
    return out


def test_hlo_model_on_compiled_reference_steps(compiled_steps):
    for arch, compiled in compiled_steps:
        text = compiled.as_text()
        _summaries_equal(text)
        assert hlo_model.HloModel(text).summary()["dot_flops"] > 0, arch


def test_analyze_step_has_the_reference_keys(compiled_steps):
    """``analyze_step`` of the port's step returns every key of the
    reference's ``analyze_compiled`` for the same reduced cell."""
    arch, compiled = compiled_steps[0]
    ref_mesh = ref_test_mesh((1, 1), ("data", "model"))
    shape = RefShape("t", seq_len=32, global_batch=4, kind="train")
    want = ref_analyze.analyze_compiled(compiled, _small(ref_config(arch)),
                                        shape, ref_mesh)
    cfg = _small(get_config(arch))
    mesh = make_test_mesh((1, 1), device_type="cpu")
    fn, in_sh, _, args, donate = make_train_step(cfg, TRAIN, mesh)
    got = analyze.analyze_step(fn, local_abstract_args(args, in_sh), cfg,
                               TRAIN, mesh, donate=donate)
    assert set(got) == set(want)
    assert set(got["memory_analysis"]) == set(want["memory_analysis"])
    assert set(got["collectives"]) == set(want["collectives"])
    assert got["model_flops_global"] == want["model_flops_global"]
    assert got["chips"] == want["chips"] == 1


def test_analyze_step_counts_one_product():
    """FLOPs are 2·M·K·N, bytes accessed the inputs read once and the
    output written once, arguments their bytes, no collective."""
    m, k, n = 64, 96, 32
    a = torch.empty(m, k, device="meta")
    b = torch.empty(k, n, device="meta")
    mesh = make_test_mesh((1, 1), device_type="cpu")
    cfg = get_config("starcoder2-3b")
    res = analyze.analyze_step(lambda x, y: x @ y, (a, b), cfg, TRAIN, mesh)
    assert res["flops_per_device"] == 2 * m * k * n
    assert res["bytes_accessed_per_device"] == 4 * (m * k + k * n + m * n)
    assert res["memory_analysis"]["argument_bytes"] == 4 * (m * k + k * n)
    assert res["memory_analysis"]["output_bytes"] == 4 * m * n
    assert res["collectives"]["num_collectives"] == 0
    assert res["collective_s"] == 0 and res["dominant_term"] == "memory"


@pytest.mark.parametrize("batch", [None, 3])
def test_analyze_step_counts_bf16_products_as_the_card(batch):
    """On ``meta`` ``matmul_f32`` of bf16 operands is the card's bf16-in /
    f32-out GEMM: 2·M·K·N FLOPs (a 3-D product batched), the bf16 operands
    read once and the f32 result written once, and nothing held but the
    result: no f32 copy of an operand."""
    from repro_torch.models.common import matmul_f32

    m, k, n = 64, 96, 32
    lead = () if batch is None else (batch,)
    a = torch.empty(*lead, m, k, dtype=torch.bfloat16, device="meta")
    b = torch.empty(*lead, k, n, dtype=torch.bfloat16, device="meta")
    mesh = make_test_mesh((1, 1), device_type="cpu")
    cfg = get_config("starcoder2-3b")
    res = analyze.analyze_step(matmul_f32, (a, b), cfg, TRAIN, mesh)
    times = batch or 1
    assert res["flops_per_device"] == 2 * m * k * n * times
    assert res["bytes_accessed_per_device"] == times * (
        2 * (m * k + k * n) + 4 * m * n)
    mem = res["memory_analysis"]
    assert mem["output_bytes"] == 4 * m * n * times
    assert mem["temp_bytes"] == 0


def test_bf16_product_gradient_on_meta_makes_no_f32_operand():
    """The backward of ``matmul_f32`` on ``meta`` runs the card's
    products: every f32 tensor, forward or backward, is a bf16-in /
    f32-out product's result (the gradients then rounded to bf16); none
    is an f32 copy of a bf16 operand."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.models.common import matmul_f32

    made = []

    class Made(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            made.extend((str(func), tuple(t.shape), t.dtype)
                        for t in analyze._tensors(out))
            return out

    a = torch.empty(64, 96, dtype=torch.bfloat16, device="meta",
                    requires_grad=True)
    b = torch.empty(96, 32, dtype=torch.bfloat16, device="meta",
                    requires_grad=True)
    with Made():
        out = matmul_f32(a, b)
        da, db = torch.autograd.grad(out, (a, b), torch.empty_like(out))
    assert out.dtype == torch.float32
    assert (da.dtype, db.dtype) == (torch.bfloat16, torch.bfloat16)
    f32 = sorted({op for op, _, dt in made if dt == torch.float32})
    assert f32 == ["aten.empty_like.default", "aten.mm.dtype"], f32


def _softmax_step(x, g):
    x = x.detach().requires_grad_()
    (gx,) = torch.autograd.grad(torch.softmax(x, dim=-1), x, g)
    return gx


def test_analyze_step_holds_the_softmax_backward_buffer(monkeypatch):
    """CUDA's ``_softmax_backward_data`` holds one more buffer of its
    output's size while it runs: the peak is the probabilities, the
    gradient and that buffer, one more scores-sized buffer than the
    operators' outputs alone."""
    x = torch.empty(4, 8, 64, device="meta")
    g = torch.empty(4, 8, 64, device="meta")
    size = 4 * x.numel()
    mesh = make_test_mesh((1, 1), device_type="cpu")
    cfg = get_config("starcoder2-3b")

    def temp():
        res = analyze.analyze_step(_softmax_step, (x, g), cfg, TRAIN, mesh)
        return res["memory_analysis"]["temp_bytes"]

    held = temp()
    monkeypatch.setattr(analyze._Traffic, "_HELD", set())
    assert temp() == size  # the probabilities, beside the output
    assert held == 2 * size


@pytest.mark.parametrize("arch", ["gemma2-9b", "whisper-tiny"])
def test_held_buffers_only_raise_the_count(arch, monkeypatch):
    """Counting what the softmax backward holds never lowers a step's
    peak, and raises it by at most one scores-sized buffer."""
    cfg = dataclasses.replace(_small(get_config(arch)), dtype="bfloat16")
    mesh = make_test_mesh((1, 1), device_type="cpu")
    fn, in_sh, _, args, donate = make_train_step(cfg, TRAIN, mesh)

    def temp():
        res = analyze.analyze_step(fn, local_abstract_args(args, in_sh), cfg,
                                   TRAIN, mesh, donate=donate)
        return res["memory_analysis"]["temp_bytes"]

    held = temp()
    monkeypatch.setattr(analyze._Traffic, "_HELD", set())
    plain = temp()
    scores = 4 * TRAIN.global_batch * cfg.n_heads * cfg.q_chunk * TRAIN.seq_len
    assert plain <= held <= plain + scores


def test_analyze_step_deliberate_differences():
    """The port's method, pinned: eager counts leave ``*_raw`` equal and no
    while loop unknown; per-device bytes are the local shards (the whole
    state on one position) plus the step's own peak; ``fits_hbm`` is
    against 80 GB."""
    cfg = dataclasses.replace(_small(get_config("olmoe-1b-7b")),
                              dtype="float32")
    mesh = make_test_mesh((1, 1), device_type="cpu")
    fn, in_sh, _, args, donate = make_train_step(cfg, TRAIN, mesh)
    local = local_abstract_args(args, in_sh)
    res = analyze.analyze_step(fn, local, cfg, TRAIN, mesh, donate=donate)
    assert res["unknown_trip_whiles"] == 0
    assert res["flops_per_device_raw"] == res["flops_per_device"] > 0
    assert (res["bytes_accessed_per_device_raw"]
            == res["bytes_accessed_per_device"] > 0)
    p, o, b = args
    n_param = sum(x.numel() for x in p.parameters())
    state = 4 * n_param * 3 + 4  # f32 params, mu, nu; the int32 step
    batch = sum(v.numel() * v.element_size() for v in b.values())
    mem = res["memory_analysis"]
    assert mem["argument_bytes"] == state + batch
    assert mem["alias_bytes"] == 4 * n_param * 3  # updated in place
    assert mem["temp_bytes"] > 0
    assert res["per_device_bytes"] == (mem["argument_bytes"] + mem["temp_bytes"]
                                       + mem["output_bytes"]
                                       - mem["alias_bytes"])
    assert res["fits_hbm"] is (res["per_device_bytes"] <= 80 * 10**9)
    assert res["collectives"]["num_collectives"] == 0
    assert res["dominant_term"] in ("compute", "memory", "collective")


def test_analyze_step_of_a_decode_step():
    cfg = _small(get_config("gemma2-9b"))
    mesh = make_test_mesh((1, 1), device_type="cpu")
    fn, in_sh, _, args, donate = make_decode_step(cfg, DECODE, mesh)
    res = analyze.analyze_step(fn, local_abstract_args(args, in_sh), cfg,
                               DECODE, mesh, donate=donate)
    caches = sum(t.numel() * t.element_size()
                 for unit in args[2] for e in unit.values()
                 for t in e.values())
    assert res["memory_analysis"]["alias_bytes"] == caches
    assert res["flops_per_device"] > 0
