"""``repro_torch.analysis`` on the CPU: the lint rules on fixture trees, on
copies of the port's own tree with planted faults and on the real tree
against ``analysis_torch_baseline.json``; the CLI's exit codes and the
baseline round trip; parity with the reference's rules on the same planted
snippets; and the Hopper launch checker on fixed ``-Xptxas -v`` reports and
launch configurations, each limit on both sides of its boundary.

The rule tests re-target ``tests/test_analysis.py``'s at the port's tree
(``src/repro_torch``).  The reference's fixtures under
``tests/analysis_fixtures/`` are read, never written: a test that needs one
changed copies it into ``tmp_path`` first."""

import json
import shutil
from pathlib import Path

import pytest

import repro.analysis.framework as ref_framework
from repro_torch.analysis import __main__ as cli
from repro_torch.analysis import kernels_check as kc
from repro_torch.analysis.framework import (
    Finding,
    Project,
    load_baseline,
    registered_rules,
    run_rules,
    save_baseline,
    split_findings,
)
from repro_torch.kernels import build
from torch_ptxas import REPORTS

REPO_ROOT = Path(__file__).resolve().parent.parent
FIXTURES = Path(__file__).resolve().parent / "analysis_fixtures"
PORT_TREE = REPO_ROOT / "src" / "repro_torch"
BASELINE = REPO_ROOT / "analysis_torch_baseline.json"


def fixture_findings(tree, rules=None):
    return run_rules(Project(FIXTURES / tree), rules)


def _hygiene_tree(tmp_path):
    """The reference's hygiene fixture with its kernel module as a wrapper,
    ``kernels/fake/ops.py`` (the port's kernel bodies are CUDA sources, so
    the rule's scope is the wrappers)."""
    dst = tmp_path / "hygiene" / "kernels" / "fake"
    dst.mkdir(parents=True)
    shutil.copy(FIXTURES / "hygiene_bad" / "kernels" / "fake" / "kernel.py",
                dst / "ops.py")
    return tmp_path / "hygiene"


# ---------------------------------------------------------------------------
# Rule flag / pass cases on fixture trees
# ---------------------------------------------------------------------------


def test_unhandled_sink_is_flagged():
    found = fixture_findings("unhandled_sink", ["backend-coverage"])
    assert len(found) == 1
    f = found[0]
    assert "OrphanSink" in f.message
    assert f.path.endswith("query/planner.py")


def test_covered_sinks_pass_via_alias():
    # execute.py covers both sinks through the SINKS tuple alias
    found = fixture_findings("unhandled_sink", ["backend-coverage"])
    assert not any(f.path.endswith("execute.py") for f in found)


def test_unkeyed_plan_field_is_flagged():
    msgs = [f.message for f in fixture_findings(
        "unkeyed_field", ["cache-key-completeness"]
    )]
    assert any("unkeyed plan field: WindowSink.span" in m for m in msgs)
    assert any("MutableSink is not frozen=True" in m for m in msgs)
    assert any(
        "unkeyed plan field: ShardedDFGSink.num_shards" in m for m in msgs
    )
    assert any(
        "LogicalPlan.sink does not flow into the canonical payload" in m
        for m in msgs
    )


def test_unlocked_stats_mutation_is_flagged():
    msgs = [f.message for f in fixture_findings(
        "unlocked_stats", ["lock-discipline"]
    )]
    assert any(
        "StatsRegistry.reset: mutation of lock-protected attribute "
        "'counts'" in m
        for m in msgs
    )
    # annotated-only protection (no locked mutation site to infer from)
    assert any("AnnotatedRegistry.observe" in m and "'hists'" in m
               for m in msgs)
    # _locked-suffix helpers are exempt
    assert not any("_wipe_locked" in m for m in msgs)
    assert any("blocking call open()" in m for m in msgs)
    assert any("inconsistent lock order" in m for m in msgs)


def test_kernel_wrapper_hygiene_is_flagged(tmp_path):
    msgs = [f.message for f in run_rules(
        Project(_hygiene_tree(tmp_path)), ["rng-time-hygiene"]
    )]
    assert any("time.time()" in m for m in msgs)
    assert any("np.random.uniform()" in m for m in msgs)
    assert any("time.perf_counter_ns()" in m for m in msgs)


@pytest.mark.parametrize("call", [
    "torch.rand(3)", "torch.randint(0, 4, (3,))", "torch.randperm(5)",
    "torch.random.manual_seed(0)", "os.environ['CUDA_HOME']",
    "os.getenv('X')", "datetime.datetime.now()",
])
def test_ambient_state_in_a_wrapper_is_flagged(tmp_path, call):
    """torch's sampling takes ``jax.random``'s place among the banned
    calls; environment reads and clocks stay banned."""
    ops = tmp_path / "kernels" / "k"
    ops.mkdir(parents=True)
    (ops / "ops.py").write_text(
        "import datetime, os, torch\n\n\ndef launch(x):\n"
        f"    return x + {call}\n"
    )
    found = run_rules(Project(tmp_path), ["rng-time-hygiene"])
    assert len(found) == 1 and found[0].path == "kernels/k/ops.py"


def test_build_and_timing_stay_out_of_the_hygiene_scope():
    """``kernels/build.py`` reads ``$CUDA_HOME`` and times ``nvcc`` by
    design, as ``kernels/timing.py`` reads the clock: neither is in the
    rule's scope, and every kernel wrapper is."""
    from repro_torch.analysis.rules.hygiene import SCOPE_GLOBS

    project = Project(REPO_ROOT)
    scoped = {project.rel(p) for g in SCOPE_GLOBS for p in project.iter_pkg(g)}
    assert {f"src/repro_torch/kernels/{k}/ops.py" for k in
            ("dfg_count", "segment_count", "align_dp")} <= scoped
    assert "src/repro_torch/kernels/build.py" not in scoped
    assert "src/repro_torch/kernels/timing.py" not in scoped
    source = (PORT_TREE / "kernels" / "build.py").read_text()
    assert "os.environ" in source and "time.perf_counter" in source


def test_clean_tree_passes_every_rule():
    assert fixture_findings("clean_tree") == []


# ---------------------------------------------------------------------------
# Deliberate regressions against a copy of the port's real tree
# ---------------------------------------------------------------------------


@pytest.fixture()
def port_copy(tmp_path):
    """A copy of ``src/repro_torch`` laid out as a repository root."""
    dst = tmp_path / "src" / "repro_torch"
    shutil.copytree(PORT_TREE, dst,
                    ignore=shutil.ignore_patterns("__pycache__", "csrc"))
    return tmp_path


def _plant(root, rel, text):
    with open(root / "src" / "repro_torch" / rel, "a") as fh:
        fh.write(text)


PLANTS = {
    "new sink": ("query/ast.py", ["backend-coverage"], (
        "\n\n@dataclasses.dataclass(frozen=True)\n"
        "class ShinyNewSink:\n    backend: str = 'auto'\n"
    ), {("src/repro_torch/query/planner.py", "ShinyNewSink"),
        ("src/repro_torch/query/execute.py", "ShinyNewSink")}),
    "unkeyed field": ("query/ast.py", ["cache-key-completeness"], (
        "\n\n@dataclasses.dataclass(frozen=True)\n"
        "class SneakySink:\n"
        "    backend: str = 'auto'\n"
        "    def __post_init__(self):\n"
        "        object.__setattr__(self, 'mode', 'fast')\n"
    ), {("src/repro_torch/query/ast.py",
         "unkeyed plan field: SneakySink.mode")}),
    # the sharded-graph dispatch tables must not satisfy coverage for a
    # sink they never saw
    "new sharded sink": ("query/ast.py", ["backend-coverage"], (
        "\n\n@dataclasses.dataclass(frozen=True)\n"
        "class ShardMergeSink:\n    backend: str = 'sharded-graph'\n"
    ), {("src/repro_torch/query/planner.py", "ShardMergeSink"),
        ("src/repro_torch/query/execute.py", "ShardMergeSink")}),
    "clock in a kernel wrapper": ("kernels/segment_count/ops.py",
                                  ["rng-time-hygiene"], (
        "\n\ndef _jitter():\n    import time\n    return time.time()\n"
    ), {("src/repro_torch/kernels/segment_count/ops.py", "time.time()")}),
}


@pytest.mark.parametrize("plant", sorted(PLANTS))
def test_planted_fault_in_the_port_tree_is_caught(port_copy, plant):
    rel, rules, text, want = PLANTS[plant]
    _plant(port_copy, rel, text)
    found = run_rules(Project(port_copy), rules)
    got = {(f.path, s) for f in found for _, s in want if s in f.message}
    assert got == want
    assert len(found) == len(want)


def test_method_mutating_lane_depth_outside_the_lock_is_caught(port_copy):
    """A scheduler method that touches ``_depth`` without the scheduler's
    lock is a lock-discipline finding."""
    path = port_copy / "src" / "repro_torch" / "transport" / "scheduler.py"
    src = path.read_text()
    anchor = "    def _done(self, lane: str) -> None:\n"
    assert anchor in src
    path.write_text(src.replace(anchor, (
        "    def _bump(self, lane: str) -> None:\n"
        "        self._depth[lane] += 1\n\n" + anchor)))
    found = run_rules(Project(port_copy), ["lock-discipline"])
    assert [f.message for f in found] == [
        "TwoLaneScheduler._bump: mutation of lock-protected attribute "
        "'_depth' outside a 'with self.<lock>' scope"]


def test_unpatched_port_copy_is_clean(port_copy):
    assert run_rules(Project(port_copy)) == []


# ---------------------------------------------------------------------------
# The real tree + the port's baseline (the gate, in-process)
# ---------------------------------------------------------------------------


def test_real_tree_has_no_new_findings():
    findings = run_rules(Project(REPO_ROOT))
    baseline = load_baseline(BASELINE)
    new, _known, stale = split_findings(findings, baseline)
    assert new == [], [f.format() for f in new]
    assert stale == [], f"stale baseline entries: {stale}"


def test_project_roots_at_the_port_tree():
    project = Project(REPO_ROOT)
    assert project.pkg_root == PORT_TREE
    paths = {project.rel(p) for p in project.iter_pkg("**/*.py")}
    assert "src/repro_torch/transport/scheduler.py" in paths
    assert not any(p.startswith("src/repro/") for p in paths)


def test_cli_fail_on_new_is_clean_on_real_repo(capsys):
    rc = cli.main(["--root", str(REPO_ROOT), "--baseline", str(BASELINE),
                   "--fail-on-new"])
    assert rc == 0
    assert "analysis clean" in capsys.readouterr().out


def test_cli_finds_the_root_and_the_default_baseline(monkeypatch, capsys):
    assert cli.find_root(PORT_TREE / "transport") == REPO_ROOT
    assert cli.BASELINE_NAME == BASELINE.name
    monkeypatch.chdir(PORT_TREE / "query")
    assert cli.main([]) == 0
    capsys.readouterr()


# ---------------------------------------------------------------------------
# Baseline round-trip + CLI
# ---------------------------------------------------------------------------


def test_baseline_roundtrip(tmp_path):
    findings = fixture_findings("unlocked_stats")
    assert findings
    path = tmp_path / "baseline.json"
    save_baseline(path, findings, justification="fixture")
    baseline = load_baseline(path)
    new, known, stale = split_findings(findings, baseline)
    assert new == [] and stale == []
    assert len(known) == len(findings)
    # a fixed finding leaves a stale entry behind (baselines only shrink)
    new, _known, stale = split_findings(findings[1:], baseline)
    assert new == [] and stale == [findings[0].identity()]


def test_finding_identity_ignores_line_numbers():
    a = Finding("r", "p.py", 10, "msg")
    b = Finding("r", "p.py", 99, "msg")
    assert a.identity() == b.identity()
    assert a.identity() != Finding("r", "p.py", 10, "other").identity()
    ref = ref_framework.Finding("r", "p.py", 10, "msg")
    assert a.identity() == ref.identity() and a.to_dict() == ref.to_dict()


def test_cli_exits_nonzero_on_new_findings(tmp_path, capsys):
    rc = cli.main(["--root", str(FIXTURES / "unlocked_stats"),
                   "--baseline", str(tmp_path / "none.json"), "--fail-on-new"])
    assert rc == 1
    assert "lock-discipline" in capsys.readouterr().out


def test_cli_exits_one_on_a_planted_port_copy(port_copy, capsys):
    _plant(port_copy, *PLANTS["new sink"][::2])
    shutil.copy(BASELINE, port_copy / BASELINE.name)
    rc = cli.main(["--root", str(port_copy), "--fail-on-new"])
    out = capsys.readouterr().out
    assert rc == 1 and "ShinyNewSink" in out


def test_cli_usage_errors_exit_two(capsys):
    assert cli.main(["--root", str(REPO_ROOT), "--rules", "no-such-rule"]) \
        == 2
    assert "unknown rules" in capsys.readouterr().err
    with pytest.raises(SystemExit) as e:
        cli.main(["--no-such-flag"])
    assert e.value.code == 2
    capsys.readouterr()


def test_cli_list_rules(capsys):
    assert cli.main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    assert sorted(line.split(":")[0] for line in out.splitlines()) == \
        sorted(registered_rules())


def test_cli_baseline_gates_to_zero(tmp_path, capsys):
    baseline = tmp_path / "baseline.json"
    rc = cli.main(["--root", str(FIXTURES / "unlocked_stats"),
                   "--baseline", str(baseline), "--write-baseline"])
    assert rc == 0
    capsys.readouterr()  # drain the --write-baseline chatter
    rc = cli.main(["--root", str(FIXTURES / "unlocked_stats"),
                   "--baseline", str(baseline), "--fail-on-new", "--json"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out)
    assert out["new"] == []
    assert out["baselined"]


def test_the_package_keeps_the_lint_stack_lazy():
    import subprocess
    import sys

    code = ("import sys, repro_torch.analysis as a; "
            "import repro_torch.query, repro_torch.transport; "
            "lint = [m for m in sys.modules if m.startswith("
            "'repro_torch.analysis.') and m != 'repro_torch.analysis.lockdep']; "
            "print(lint, a.Project.__module__, a.KernelLaunchError.__module__)")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, env={"PYTHONPATH": str(REPO_ROOT / "src"),
                          "PATH": "/usr/bin:/bin"},
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [
        "[]", "repro_torch.analysis.framework",
        "repro_torch.analysis.kernels_check"]


# ---------------------------------------------------------------------------
# Parity with the reference's rules on the same planted snippets
# ---------------------------------------------------------------------------


def _identities(findings):
    return sorted((f.rule, f.path, f.message) for f in findings)


@pytest.mark.parametrize("tree", ["unhandled_sink", "unkeyed_field",
                                  "unlocked_stats", "clean_tree"])
def test_fixture_findings_match_the_reference(tree):
    port = run_rules(Project(FIXTURES / tree))
    ref = ref_framework.run_rules(ref_framework.Project(FIXTURES / tree))
    assert _identities(port) == _identities(ref)


SNIPPETS = {
    "query/ast.py": (
        "import dataclasses\nfrom typing import Union\n\n\n"
        "@dataclasses.dataclass(frozen=True)\nclass DFGSink:\n"
        "    backend: str = 'auto'\n\n\n"
        "@dataclasses.dataclass\nclass LooseSink:\n    top: float = 1.0\n"
        "    def grow(self):\n        self.extra = 1\n\n\n"
        "Sink = Union[DFGSink, LooseSink]\n\n\n"
        "@dataclasses.dataclass(frozen=True)\nclass LogicalPlan:\n"
        "    sink: object = None\n    ops: tuple = ()\n"
        "    def _payload(self):\n        return {'ops': self.ops}\n"
    ),
    "query/planner.py": "def plan(s):\n    return isinstance(s, DFGSink)\n",
    "query/execute.py": "def run(s):\n    return isinstance(s, Sink)\n",
    "kernels/k/ops.py": (
        "import os, random, time\n\n\ndef launch(x):\n"
        "    return x + time.monotonic() + random.random() + "
        "len(os.environ['HOME'])\n"
    ),
    "store.py": (
        "import threading\n\n\nclass Ring:\n"
        "    def __init__(self):\n        self._lock = threading.Lock()\n"
        "        self.rows = []\n\n"
        "    def add(self, r):\n        with self._lock:\n"
        "            self.rows.append(r)\n\n"
        "    def clear(self):\n        self.rows.clear()\n\n"
        "    def flush(self, path):\n        with self._lock:\n"
        "            with open(path, 'w') as fh:\n"
        "                fh.write(str(self.rows))\n"
    ),
}


def test_planted_snippets_match_the_reference(tmp_path):
    for rel, text in SNIPPETS.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(text)
    port = run_rules(Project(tmp_path))
    ref = ref_framework.run_rules(ref_framework.Project(tmp_path))
    assert _identities(port) == _identities(ref)
    assert {f.rule for f in port} == set(registered_rules())


def test_rule_catalog_matches_the_reference():
    ref = ref_framework.registered_rules()
    assert sorted(registered_rules()) == sorted(ref)
    assert {n: r.doc for n, r in registered_rules().items()} == {
        n: r.doc for n, r in ref.items()}


# ---------------------------------------------------------------------------
# ptxas resources (kernels/build.py)
# ---------------------------------------------------------------------------


def test_ptxas_resources_parse_static_shared_and_constant_memory():
    report = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z4scanPi' for 'sm_90a'
ptxas info    : Function properties for _Z4scanPi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 4096 bytes smem, 368 bytes cmem[0], 8 bytes cmem[2]
ptxas info    : Compiling entry function '_Z4tilev' for 'sm_90a'
ptxas info    : Function properties for _Z4tilev
    16 bytes stack frame, 16 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 255 registers, used 0 barriers
"""
    assert build.ptxas_resources(report) == {
        "_Z4scanPi": {"spill_stores": 0, "spill_loads": 0, "registers": 40,
                      "smem": 4096, "cmem": 376},
        "_Z4tilev": {"spill_stores": 16, "spill_loads": 16,
                     "registers": 255, "smem": 0, "cmem": 0},
    }


# ---------------------------------------------------------------------------
# The Hopper launch checker
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def records():
    return {k: build.ptxas_resources(v) for k, v in REPORTS.items()}


#: the main path's launches at PAPER_EVAL on an H100 (132 SMs), as the
#: launchers configure them (PERF.md §6; chip_smoke.py phases 2 and 5)
MAIN_PATH = [
    {"library": "dfg_count", "branch": "hash", "window": False,
     "columns": "shifted", "grid": 132, "threads": 1024,
     "smem_bytes": 16 + 2 * 16384 * 4},
    {"library": "dfg_count", "branch": "hash", "window": True,
     "columns": "shifted", "grid": 132, "threads": 1024,
     "smem_bytes": 16 + 2 * 16384 * 4},
    {"library": "dfg_count", "branch": "shared", "window": False,
     "columns": "separate", "grid": 1056, "threads": 256,
     "smem_bytes": 16 + 32 * 32 * 4},
    {"library": "segment_count", "branch": "shared", "valid": False,
     "grid": 132, "blocks_per_sm": 1, "threads": 1024, "smem_bytes": 2400},
    {"library": "segment_count", "branch": "global", "valid": True,
     "grid": 132, "blocks_per_sm": 1, "threads": 1024, "smem_bytes": 0},
    {"library": "align_dp", "branch": "registers", "k": 20, "grid": 924,
     "threads": 128, "smem_bytes": 0},
    {"library": "align_dp", "branch": "registers", "k": 32, "grid": 528,
     "threads": 128, "smem_bytes": 0},
    {"library": "align_dp", "branch": "shared", "k": 0, "grid": 264,
     "threads": 256, "smem_bytes": 8 * 300 * 4},
    {"library": "align_dp", "branch": "global", "k": 0, "grid": 264,
     "threads": 256, "smem_bytes": 0},
]


def test_every_table_row_has_one_ptxas_entry(records):
    assert {(c["library"], c["branch"]) for c in MAIN_PATH} == \
        set(kc.KERNEL_TABLE)
    seen = set()
    for c in MAIN_PATH:
        entry, res = kc.entry_resources(c, records[c["library"]])
        assert entry not in seen and res["registers"] > 0
        seen.add(entry)
    # the two dfg_count template arguments pick one of eight entries
    flipped = dict(MAIN_PATH[0], window=True, columns="separate")
    assert "ILb1ELb0ENS_9HashTable" in kc.entry_resources(
        flipped, records["dfg_count"])[0]


def test_table_names_the_pallas_kernels_it_ports():
    ported = {kc.ported_kernel(c).key for c in MAIN_PATH}
    assert ported == set(kc.PALLAS_KERNELS) == {"B1", "B2", "B3", "B4"}
    for pk in kc.PALLAS_KERNELS.values():
        path, line = pk.location.split(":")
        text = (REPO_ROOT / path).read_text().splitlines()[int(line) - 1]
        assert text.startswith(f"def {pk.name}("), pk


def test_main_path_launches_are_clean(records):
    report = kc.report_from(records, MAIN_PATH)
    assert report["configurations"] == len(MAIN_PATH)
    assert report["hard"] == report["warnings"] == 0
    occ = {(r["library"], r["tier"], r["grid"]): (r["blocks_per_sm"],
                                                  r["limit"])
           for r in report["launches"]}
    # the hash table (128 KB) and 44 registers x 1,024 threads: one block
    assert occ[("dfg_count", "hash", 132)] == (1, "registers")
    # align_dp's register tier: the launcher's persistent grid of 924 =
    # 132 x 7 is what 70 registers allow (2,304 per warp, 7 warps per
    # sub-partition, 7 blocks of 4 warps); K = 32's 124 registers allow 4
    assert occ[("align_dp", "registers", 924)] == (7, "registers")
    assert occ[("align_dp", "registers", 528)] == (4, "registers")
    assert occ[("segment_count", "shared", 132)] == (1, "registers")
    assert [line.split(":")[0] for line in kc.format_report(report)] == [
        c["library"] for c in MAIN_PATH]


def _cfg(**kw):
    base = {"library": "align_dp", "branch": "shared", "k": 0, "grid": 1,
            "threads": 256, "smem_bytes": 0}
    base.update(kw)
    return base


def _res(**kw):
    base = {"registers": 32, "spill_stores": 0, "spill_loads": 0, "smem": 0}
    base.update(kw)
    return base


def _checks(found, severity="hard"):
    return sorted(f.check for f in found if f.severity == severity)


@pytest.mark.parametrize("config,resources,inside", [
    (_cfg(threads=1024), _res(), True),
    (_cfg(threads=1025), _res(), False),
    (_cfg(threads=0), _res(), False),
    (_cfg(grid=2**31 - 1), _res(), True),
    (_cfg(grid=0), _res(), False),
    # static + dynamic shared memory per block, 227 KB
    (_cfg(smem_bytes=232_448), _res(), True),
    (_cfg(smem_bytes=232_449), _res(), False),
    (_cfg(smem_bytes=232_000), _res(smem=448), True),
    (_cfg(smem_bytes=232_000), _res(smem=449), False),
    # registers per thread
    (_cfg(threads=32), _res(registers=255), True),
    (_cfg(threads=32), _res(registers=256), False),
    # registers x threads within one SM: 64 x 1,024 fills the file
    (_cfg(threads=1024), _res(registers=64), True),
    (_cfg(threads=1024), _res(registers=65), False),
], ids=lambda v: None)
def test_each_limit_on_both_sides_of_its_boundary(config, resources, inside):
    found = kc.check_launch(config, resources)
    assert (_checks(found) == []) is inside, _checks(found)
    if inside:
        assert kc.occupancy(config, resources).blocks_per_sm >= 1
        kc.validate_launch(config, resources)
    else:
        with pytest.raises(kc.KernelLaunchError):
            kc.validate_launch(config, resources)


@pytest.mark.parametrize("threads,regs,smem,want", [
    (32, 16, 0, (32, "blocks")),          # 32 block slots
    (64, 16, 0, (32, "blocks")),          # warps allow 32 too: blocks first
    (128, 16, 0, (16, "warps")),          # 64 warps / 4
    (128, 70, 0, (7, "registers")),       # 2,304 per warp
    (256, 32, 0, (8, "warps")),
    (256, 32, 40_000, (5, "shared memory")),  # (40,000 + 1 KB) in 128s
    (256, 32, 232_448, (1, "shared memory")),
    (1024, 64, 0, (1, "registers")),      # 2,048 x 32 warps = 65,536
    (1024, 32, 0, (2, "warps")),
])
def test_occupancy_and_its_limit(threads, regs, smem, want):
    occ = kc.occupancy(_cfg(threads=threads, smem_bytes=smem),
                       _res(registers=regs))
    assert (occ.blocks_per_sm, occ.limit) == want


@pytest.mark.parametrize("library,branch,warns", [
    ("align_dp", "registers", True),
    ("align_dp", "shared", False),
    ("align_dp", "global", False),
    ("segment_count", "shared", True),
    ("segment_count", "global", True),
    ("dfg_count", "hash", False),
    ("dfg_count", "shared", False),
])
def test_spills_warn_only_where_the_tier_must_not_spill(library, branch,
                                                        warns):
    config = _cfg(library=library, branch=branch, k=20, threads=128)
    found = kc.check_launch(config, _res(spill_stores=8, spill_loads=8))
    assert _checks(found) == []
    assert _checks(found, "warning") == (["spills"] if warns else [])
    assert kc.check_launch(config, _res()) == []


@pytest.mark.parametrize("blocks_per_sm,warns", [(1, False), (2, True)])
def test_occupancy_below_the_launchers_blocks_per_sm_warns(records,
                                                            blocks_per_sm,
                                                            warns):
    """segment_count sizes its persistent grid by the occupancy it queried;
    with 39 registers x 1,024 threads an SM holds one block, so a launcher
    that asked for two would leave half its grid waiting."""
    config = dict(MAIN_PATH[3], blocks_per_sm=blocks_per_sm)
    _, res = kc.entry_resources(config, records["segment_count"])
    found = kc.check_launch(config, res)
    assert _checks(found, "warning") == (["occupancy"] if warns else [])
    assert _checks(found) == []


def test_unknown_tier_is_an_error(records):
    with pytest.raises(KeyError):
        kc.check_launch(_cfg(branch="tensor-cores"), _res())
    with pytest.raises(KeyError):
        kc.entry_resources(_cfg(branch="registers", k=24),
                           records["align_dp"])
