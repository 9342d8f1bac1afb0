"""The port's fault-tolerant trainer (``repro_torch.train.Trainer``) against
the JAX package's, on the CPU: ``tests/test_trainer_ft.py``'s tiny config
(starcoder2 ``.reduced()``, vocab 64, ``loss_chunk`` 8) from the
reference's initial weights, 10 steps whose losses agree within ``rtol =
1e-4`` in f32 (measured: ≤ 1e-7) and ``5e-2`` in bf16 (measured: ≤ 1e-3);
the reference's fault-tolerance properties on the port (golden restart,
resume from the checkpoint, giving up, the loss falling, the telemetry
mined); a port trainer resuming from the reference trainer's checkpoint;
and the training CLI.

The reference trainer runs here with synchronous checkpoint writes (its
async writer is a daemon thread with no exit; the files are the same).
An autouse fixture fails a test that leaves a thread behind.
"""

import dataclasses
import threading

import jax
import numpy as np
import pytest

import repro.train.trainer as ref_trainer_mod
from repro.checkpoint import CheckpointManager as RefManager
from repro.configs import get_config as ref_config
from repro.configs.base import TrainHParams as RefHParams
from repro.data.lm_data import TokenPipeline as RefPipeline

from repro_torch.configs import get_config
from repro_torch.configs.base import TrainHParams
from repro_torch.core import dfg_from_repository
from repro_torch.data.lm_data import TokenPipeline
from repro_torch.launch import train as train_cli
from repro_torch.models.convert import params_from_reference
from repro_torch.train import Trainer, TrainerError, init_opt_state

from test_torch_models import one_torch_thread  # noqa: F401

HP = dict(learning_rate=3e-3, warmup_steps=2, total_steps=200, grad_clip=1.0)
DATA = dict(batch=2, seq_len=16, seed=3, branching=4)


@pytest.fixture(autouse=True)
def _leaves_no_thread():
    before = set(threading.enumerate())
    yield
    left = [t.name for t in threading.enumerate()
            if t not in before and t.is_alive()]
    assert not left, f"threads left running: {left}"


def _tiny_cfg(dtype="float32"):
    cfg = get_config("starcoder2-3b").reduced()
    return dataclasses.replace(cfg, vocab_size=64, loss_chunk=8, dtype=dtype)


def _pipeline(cfg):
    return TokenPipeline(vocab_size=cfg.vocab_size, **DATA)


def _trainer(cfg, ckpt_dir, **kw):
    kw.setdefault("ckpt_every", 5)
    return Trainer(cfg, TrainHParams(**HP), _pipeline(cfg), str(ckpt_dir),
                   q_chunk=16, device="cpu", **kw)


@pytest.fixture
def sync_reference(monkeypatch):
    """The reference's trainer with synchronous checkpoint writes."""
    monkeypatch.setattr(
        ref_trainer_mod, "CheckpointManager",
        lambda d, keep=3, async_writes=True: RefManager(
            d, keep=keep, async_writes=False))


def _reference_trainer(dtype, ckpt_dir, **kw):
    rc = dataclasses.replace(ref_config("starcoder2-3b").reduced(),
                             vocab_size=64, loss_chunk=8, dtype=dtype)
    return ref_trainer_mod.Trainer(
        rc, RefHParams(**HP), RefPipeline(vocab_size=64, **DATA),
        str(ckpt_dir), q_chunk=16, **kw)


def _from_reference_init(trainer, ref):
    """The port trainer starts from the reference trainer's initial
    weights (``PRNGKey(seed)``)."""
    tree = jax.tree.map(np.asarray, ref.init_state()[0])

    def init_state():
        model = params_from_reference(trainer.cfg, tree)
        return model, init_opt_state(model)

    trainer.init_state = init_state


@pytest.mark.parametrize("dtype, rtol", [("float32", 1e-4),
                                         ("bfloat16", 5e-2)])
def test_history_matches_reference(dtype, rtol, tmp_path, sync_reference):
    ref = _reference_trainer(dtype, tmp_path / "ref", ckpt_every=5)
    want = ref.run(10)["history"]
    port = _trainer(_tiny_cfg(dtype), tmp_path / "port")
    _from_reference_init(port, ref)
    out = port.run(10)
    assert out["final_step"] == 10
    np.testing.assert_allclose(out["history"], want, rtol=rtol)
    assert port.ckpt.all_steps() == [5, 10]


def test_port_resumes_from_the_reference_checkpoint(tmp_path,
                                                    sync_reference):
    """The reference trainer writes steps 5 and 10; a port trainer in the
    same directory, told to run 13 steps, restores step 10 and continues
    where a reference run of 13 steps goes (f32, ``rtol = 1e-4``)."""
    ref = _reference_trainer("float32", tmp_path / "ck", ckpt_every=5)
    ref.run(10)
    longer = _reference_trainer("float32", tmp_path / "ref13", ckpt_every=50)
    want = longer.run(13)["history"]
    port = _trainer(_tiny_cfg(), tmp_path / "ck")
    port.init_state = None  # resuming must not initialize
    out = port.run(13)
    assert out["final_step"] == 13 and len(out["history"]) == 3
    np.testing.assert_allclose(out["history"], want[10:], rtol=1e-4)


def test_loss_decreases_on_markov_language(tmp_path):
    cfg = _tiny_cfg()
    out = _trainer(cfg, tmp_path / "ck", ckpt_every=50).run(30)
    first = np.mean(out["history"][:5])
    last = np.mean(out["history"][-5:])
    assert last < first - 0.1, (first, last)
    assert last < np.log(cfg.vocab_size)


def test_restart_golden_equivalence(tmp_path):
    """Crash at step 7, restart from the step-5 checkpoint → the last 3
    losses equal an uninterrupted run's, bit for bit."""
    cfg = _tiny_cfg()
    ref_out = _trainer(cfg, tmp_path / "ref").run(10)
    crashed = {"done": False}

    def injector(step):
        if step == 7 and not crashed["done"]:
            crashed["done"] = True
            raise RuntimeError("injected node failure")

    tr = _trainer(cfg, tmp_path / "ft", failure_injector=injector)
    out = tr.run(10)
    assert crashed["done"] and out["final_step"] == 10
    np.testing.assert_allclose(out["history"][-3:], ref_out["history"][-3:],
                               rtol=0, atol=0)
    acts = list(tr.collector._activities)
    assert acts.count("failure") == 1 and acts.count("restart") == 1


def test_restart_resumes_from_checkpoint_not_scratch(tmp_path):
    calls = []

    def injector(step):
        calls.append(step)
        if step == 6 and calls.count(6) == 1:
            raise RuntimeError("boom")

    out = _trainer(_tiny_cfg(), tmp_path / "ck",
                   failure_injector=injector).run(8)
    # restarted from 5 (checkpoint), not 0: step 6 ran twice, step 0 once
    assert calls.count(6) == 2
    assert calls.count(0) == 1
    assert out["final_step"] == 8


def test_gives_up_after_max_retries(tmp_path):
    def always_fail(step):
        raise RuntimeError("dead node")

    tr = _trainer(_tiny_cfg(), tmp_path / "ck", failure_injector=always_fail,
                  max_retries=2)
    with pytest.raises(TrainerError):
        tr.run(5)
    assert list(tr.collector._activities).count("failure") == 3


def test_telemetry_mined_as_process(tmp_path):
    """The trainer's event log is an event repository: its DFG is the
    step chain."""
    tr = _trainer(_tiny_cfg(), tmp_path / "ck", ckpt_every=100)
    tr.run(6)
    repo = tr.collector.to_repository()
    psi = dfg_from_repository(repo, device="cpu")
    names = repo.activity_names
    li, ti, gi = (names.index(x) for x in ("load_batch", "train_step", "log"))
    assert psi[li, ti] == 6  # load → train, every step
    assert psi[ti, gi] == 6  # train → log, every step
    assert int(psi.sum()) == 12 and repo.num_traces == 6


def test_train_cli_on_the_host(tmp_path, capsys):
    summary = train_cli.main([
        "--arch", "starcoder2-3b", "--preset", "tiny", "--device", "cpu",
        "--steps", "6", "--mine", "--ckpt-dir", str(tmp_path / "ck"),
        "--ckpt-every", "3"])
    assert summary["steps"] == 6 and len(summary["history"]) == 6
    assert all(np.isfinite(summary["history"]))
    assert summary["first_loss"] == pytest.approx(np.log(256), abs=0.1)
    mined = summary["mined"]
    names = mined["activities"]
    psi = np.asarray(mined["psi"])
    assert psi[names.index("load_batch"), names.index("train_step")] == 6
    assert psi[names.index("log"), names.index("checkpoint")] == 2
    out = capsys.readouterr().out
    assert "digraph" in out and '"steps": 6' in out
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "step-3", "step-6"]


def test_train_cli_default_checkpoint_dir_is_under_tmpdir(tmp_path,
                                                          monkeypatch):
    """The CLI's default ``--ckpt-dir`` is ``graphpm_torch_ckpt`` under the
    system's temporary directory (``tempfile.gettempdir()``, from
    ``$TMPDIR``), where the reference's is the fixed ``/tmp/graphpm_ckpt``:
    a deliberate difference."""
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    summary = train_cli.main([
        "--arch", "starcoder2-3b", "--preset", "tiny", "--device", "cpu",
        "--steps", "2", "--batch", "2", "--seq", "8", "--ckpt-every", "2"])
    assert summary["steps"] == 2
    assert (tmp_path / "graphpm_torch_ckpt" / "step-2" / "manifest.json") \
        .is_file()
