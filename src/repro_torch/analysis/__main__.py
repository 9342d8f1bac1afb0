"""``python -m repro_torch.analysis`` — the lint CLI of the port's tree.

Exit status: 0 when every finding is covered by the baseline, 1 when new
findings exist (the CI gate), 2 on usage errors.

Examples::

    python -m repro_torch.analysis                   # lint, gate on baseline
    python -m repro_torch.analysis --json            # machine-readable
    python -m repro_torch.analysis --write-baseline  # grandfather the
                                                     # current findings
                                                     # (justify them!)
    python -m repro_torch.analysis --kernel-report report.json  # on a card
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from .framework import (
    Project,
    load_baseline,
    registered_rules,
    run_rules,
    save_baseline,
    split_findings,
)

#: the port's own baseline at the repository root (the reference's
#: ``analysis_baseline.json`` belongs to the reference's tree)
BASELINE_NAME = "analysis_torch_baseline.json"


def find_root(start: Path) -> Path:
    """Walk up from ``start`` to the directory holding ``src/repro_torch``."""
    cur = start.resolve()
    for cand in (cur, *cur.parents):
        if (cand / "src" / "repro_torch").is_dir():
            return cand
    return cur


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="engine-invariant static analysis for the repro_torch "
        "tree",
    )
    parser.add_argument(
        "--root", type=Path, default=None,
        help="project root (default: nearest ancestor with src/repro_torch)",
    )
    parser.add_argument(
        "--baseline", type=Path, default=None,
        help=f"baseline file (default: <root>/{BASELINE_NAME})",
    )
    parser.add_argument(
        "--fail-on-new", action="store_true",
        help="exit 1 on findings not in the baseline (this is also the "
        "default behavior; the flag makes CI intent explicit)",
    )
    parser.add_argument(
        "--write-baseline", action="store_true",
        help="write the current findings to the baseline file and exit 0",
    )
    parser.add_argument(
        "--rules", default=None,
        help="comma-separated subset of rules to run",
    )
    parser.add_argument("--json", action="store_true", dest="as_json")
    parser.add_argument(
        "--list-rules", action="store_true", help="print the rule catalog"
    )
    parser.add_argument(
        "--kernel-report", type=Path, default=None, metavar="PATH",
        help="build and launch every kernel on the card, write the Hopper "
        "launch report to PATH and exit (1 on a hard finding)",
    )
    args = parser.parse_args(argv)

    if args.list_rules:
        for name, r in sorted(registered_rules().items()):
            print(f"{name}: {r.doc}")
        return 0

    if args.kernel_report is not None:
        from .kernels_check import build_report, format_report

        report = build_report()
        args.kernel_report.write_text(json.dumps(report, indent=2) + "\n")
        for line in format_report(report):
            print(line)
        print(
            f"wrote {args.kernel_report} — {report['configurations']} "
            f"launch(es), {report['hard']} hard finding(s), "
            f"{report['warnings']} warning(s)"
        )
        return 1 if report["hard"] else 0

    root = args.root or find_root(Path.cwd())
    project = Project(root)
    names = args.rules.split(",") if args.rules else None
    try:
        findings = run_rules(project, names)
    except KeyError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    baseline_path = args.baseline or (project.root / BASELINE_NAME)
    if args.write_baseline:
        save_baseline(baseline_path, findings, justification="grandfathered")
        print(f"wrote {len(findings)} finding(s) to {baseline_path}")
        return 0

    baseline = load_baseline(baseline_path)
    new, known, stale = split_findings(findings, baseline)

    if args.as_json:
        print(json.dumps({
            "new": [f.to_dict() for f in new],
            "baselined": [f.to_dict() for f in known],
            "stale_baseline_ids": stale,
        }, indent=2))
    else:
        for f in new:
            print(f.format())
        if known:
            print(f"({len(known)} baselined finding(s) suppressed)")
        for fid in stale:
            entry = baseline[fid]
            print(
                f"stale baseline entry {fid} "
                f"({entry.get('rule')}: {entry.get('message')}) — "
                "the finding no longer fires; delete it"
            )
        if not new:
            print(
                f"analysis clean: {len(findings)} finding(s), all baselined"
                if findings else "analysis clean: no findings"
            )
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
