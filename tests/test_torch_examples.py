"""The port's examples (``examples/torch_*.py``) against the reference's
(``examples/*.py``): each pair runs in child processes under a time limit,
the port's with ``--device cpu`` and with the import of ``jax``,
``jaxlib`` and ``repro`` blocked, the reference's on the CPU with its
planner on its static constants (each ``$GRAPHPM_BENCH_*`` record named
as ``os.devnull``: the port commits no calibration record, so it plans on
the same constants).  Both with one thread and ``TMPDIR`` in the test's
own directory.

* ``torch_quickstart.py`` prints the reference's lines, counts, matrices,
  edges, plans and dices, with the timings, coverages, latencies, the
  count of exemplar lines (one per latency bucket hit) and the (random)
  trace ids masked and the reference's backend names mapped to
  the port's (``tests/torch_parity.py``).  Its alignments line is held in
  form only: the example's log holds a pair of traces that the
  reference's rolling hash merges into one variant and the port keeps
  apart, so their mean fitness and cost differ;
* ``torch_privacy_views.py`` prints exactly the reference's lines;
* ``torch_mine_training_run.py``: the crash at step 11 and the replay
  from checkpoint 10 (16 steps, 17 train steps), the activities (failure,
  restart and the straggler that the sleep at step 7 makes) and the DFG's
  edges but those of the straggler events, whose number is a matter of
  timing;
* ``torch_serve_lm.py``: the request and token counts, each shown
  prompt's length, ten sampled tokens in the vocabulary and its
  ``finished`` flag, and the telemetry's event count and activities (the
  tokens are the port's own: its weights and samples come from its own
  generators);
* ``torch_train_lm.py --preset tiny --steps 2``: the reference's summary
  keys (the port's CLI adds some), the same arch, steps and entropy floor,
  finite losses and the same mined DOT;
* every ``examples/torch_*.py`` imports only ``repro_torch``, ``torch``,
  ``numpy`` and the standard library."""

import ast
import json
import math
import os
import pathlib
import re
import subprocess
import sys

import pytest

from repro_torch.data import ProcessSpec, generate_repository

import torch_parity as T

ROOT = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"
TIMEOUT_S = 300
PORT_EXAMPLES = sorted(EXAMPLES.glob("torch_*.py"))
NAMES = ("quickstart", "privacy_views", "mine_training_run", "serve_lm",
         "train_lm")

#: runs an example as ``__main__`` with the reference blocked
BLOCKED = r"""
import importlib.abc, runpy, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name="__main__")
"""


def _env(tmp_path, **extra):
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
                TMPDIR=str(tmp_path), **extra)


def _run(cmd, env, tmp_path):
    out = subprocess.run(cmd, env=env, cwd=tmp_path, capture_output=True,
                         text=True, timeout=TIMEOUT_S)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    return out.stdout


def _port(tmp_path, name, *args):
    path = EXAMPLES / f"torch_{name}.py"
    return _run([sys.executable, "-c", BLOCKED, str(path), "--device", "cpu",
                 *args], _env(tmp_path), tmp_path)


def _reference(tmp_path, name, *args):
    static = {f"GRAPHPM_BENCH_{k}": os.devnull
              for k in ("QUERY", "GRAPH", "CONFORMANCE", "SHARD", "SERVE")}
    return _run([sys.executable, str(EXAMPLES / f"{name}.py"), *args],
                _env(tmp_path, JAX_PLATFORMS="cpu", **static), tmp_path)


def _both(tmp_path, name, *args):
    (tmp_path / "port").mkdir()
    (tmp_path / "ref").mkdir()
    return (_port(tmp_path / "port", name, *args),
            _reference(tmp_path / "ref", name, *args))


# ---------------------------------------------------------------------------
# The query-engine examples
# ---------------------------------------------------------------------------

#: (pattern, replacement) of what differs from run to run
_MASKS = (
    (re.compile(r"\b(total|parse|cache_probe)=[0-9.]+ms"), r"\1=<ms>"),
    (re.compile(r"coverage[ =][0-9.]+%"), "coverage <%>"),
    (re.compile(r"p50=\d+us p99=\d+us"), "p50=<us> p99=<us>"),
    (re.compile(r"\b[0-9a-f]{32}\b"), "<trace id>"),
    # one per latency bucket that a request fell in
    (re.compile(r"exemplar lines: \d+"), "exemplar lines: <buckets>"),
    (re.compile(r"(mean fitness|mean cost) [0-9.]+"), r"\1 <merged variants>"),
)


def _masked(text, port_names=False):
    out = []
    for line in text.splitlines():
        for pattern, repl in _MASKS:
            line = pattern.sub(repl, line)
        if port_names:
            line = re.sub(r"\b(backend|planned)=(\w+)",
                          lambda m: f"{m.group(1)}={T.port_backend(m.group(2))}",
                          line)
        out.append(line)
    return out


def test_quickstart_prints_the_references_lines(tmp_path):
    port, ref = _both(tmp_path, "quickstart")
    # why the alignments line is masked: the reference merges two of the
    # example's traces into one variant (the same log and seed as the
    # example's)
    assert T.collides(generate_repository(2_000, ProcessSpec(
        num_activities=12, seed=4)))
    assert "optimal alignments" in port and "Table 1" in port
    assert _masked(port) == _masked(ref, port_names=True)


def test_privacy_views_prints_the_references_lines(tmp_path):
    port, ref = _both(tmp_path, "privacy_views")
    assert "AccessDenied" in port
    assert port == ref


# ---------------------------------------------------------------------------
# The LM examples
# ---------------------------------------------------------------------------


def _dot_edges(text):
    return set(re.findall(r'^\s*"([^"]+)" -> "([^"]+)" \[label="([^"]+)"\];$',
                          text, re.M))


def test_mine_training_run_crashes_restores_and_straggles_as_the_reference(
        tmp_path):
    port, ref = _both(tmp_path, "mine_training_run")
    p, r = port.splitlines(), ref.splitlines()
    assert p[0] == r[0] == ("trained to step 16 (crash at 11 → restored from "
                            "checkpoint 10 and replayed)")
    reports = [ast.literal_eval(x[1].split(": ", 1)[1]) for x in (p, r)]
    assert reports[0]["train_step"]["count"] == reports[1]["train_step"]["count"] == 17
    logs = [next(l for l in x if l.startswith("event log:")) for x in (p, r)]
    steps = [re.search(r"over (\d+) steps; activities: (\[.*\])", l) for l in logs]
    assert steps[0].group(1) == steps[1].group(1) == "16"
    acts = [ast.literal_eval(m.group(2)) for m in steps]
    assert acts[0] == acts[1]
    assert {"failure", "restart", "straggler_detected"} <= set(acts[0])

    def steady(edges):  # the edges no straggler event moves
        return {e for e in edges if "straggler_detected" not in e[:2]
                and e[1] != "<end>"}

    pe, re_ = _dot_edges(port), _dot_edges(ref)
    assert steady(pe) == steady(re_)
    assert ("failure", "load_batch") in {e[:2] for e in pe}
    assert any(e[1] == "straggler_detected" for e in pe)


def test_serve_lm_serves_as_the_reference(tmp_path):
    port, ref = _both(tmp_path, "serve_lm")
    p, r = port.splitlines(), ref.splitlines()
    head = re.compile(r"^(\d+) requests, (\d+) tokens in [0-9.]+s \(")
    assert head.match(p[0]).groups() == head.match(r[0]).groups() == ("8", "192")
    shown = re.compile(r"^  prompt\[\s*(\d+) toks\] → \[([0-9, ]+)\]… \((\w+)\)$")
    for a, b in zip(p[1:4], r[1:4]):
        ma, mb = shown.match(a), shown.match(b)
        assert ma.group(1) == mb.group(1) and ma.group(3) == mb.group(3)
        toks = [int(t) for t in ma.group(2).split(",")]
        assert len(toks) == 10 and all(0 <= t < 512 for t in toks)
    assert p[4:] == r[4:]  # the telemetry's events and activities
    assert p[-1].startswith("server telemetry: ")


def test_train_lm_drives_the_cli_as_the_reference(tmp_path):
    args = ("--preset", "tiny", "--steps", "2", "--ckpt-dir", "ckpt")
    port, ref = _both(tmp_path, "train_lm", *args)
    ps, rs = (json.loads(x[:x.index("\n}\n") + 2]) for x in (port, ref))
    assert set(rs) <= set(ps)
    for key in ("arch", "steps", "bigram_entropy_floor", "stragglers"):
        assert ps[key] == rs[key], key
    assert math.isfinite(ps["first_loss"]) and math.isfinite(ps["last_loss"])
    mined = "== mined training process"
    assert port[port.index(mined):] == ref[ref.index(mined):]


# ---------------------------------------------------------------------------
# Imports
# ---------------------------------------------------------------------------


def test_every_reference_example_has_its_port():
    assert [p.name for p in PORT_EXAMPLES] == sorted(
        f"torch_{n}.py" for n in NAMES)


@pytest.mark.parametrize("path", PORT_EXAMPLES, ids=lambda p: p.name)
def test_port_example_imports_only_the_port_torch_numpy_and_stdlib(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    allowed = {"repro_torch", "torch", "numpy"} | set(sys.stdlib_module_names)
    assert roots <= allowed, sorted(roots - allowed)
