"""CLI for the privacy-egress analyzer.

    python -m repro_torch.analysis [paths...] [--rules egress,asserts,...]
                             [--json] [--fail-on-findings]
                             [--baseline FILE | --no-baseline]
                             [--write-baseline FILE]

With no paths, analyzes the ``src/repro_torch`` tree this package lives in.
``--baseline`` defaults to the checked-in ``analysis/baseline.json``
(currently empty: the tree is finding-free) so a future rule addition can
land by baselining its pre-existing findings instead of blocking.
Exit status: 0 clean (or findings tolerated without --fail-on-findings),
1 findings with --fail-on-findings, 2 usage/parse errors.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from . import ALL_RULES, run_analysis
from .base import filter_baseline, load_baseline

_DEFAULT_BASELINE = Path(__file__).with_name("baseline.json")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Privacy-egress taint linter + rule passes for the "
                    "federated forest tree")
    parser.add_argument("paths", nargs="*",
                        help="files/dirs to analyze "
                             "(default: src/repro_torch)")
    parser.add_argument("--rules", default=",".join(ALL_RULES),
                        help=f"comma-separated subset of {ALL_RULES}")
    parser.add_argument("--json", action="store_true", dest="as_json",
                        help="emit a JSON report instead of text")
    parser.add_argument("--fail-on-findings", action="store_true",
                        help="exit 1 if any non-baselined finding remains")
    parser.add_argument("--baseline", default=None, metavar="FILE",
                        help="fingerprint baseline to tolerate "
                             f"(default: {_DEFAULT_BASELINE.name} if present)")
    parser.add_argument("--no-baseline", action="store_true",
                        help="ignore any baseline file")
    parser.add_argument("--write-baseline", default=None, metavar="FILE",
                        help="write current findings as the new baseline "
                             "and exit 0")
    args = parser.parse_args(argv)

    rules = tuple(r.strip() for r in args.rules.split(",") if r.strip())
    unknown = [r for r in rules if r not in ALL_RULES]
    if unknown:
        parser.error(f"unknown rules {unknown}; choose from {ALL_RULES}")

    paths = args.paths or [Path(__file__).resolve().parents[1]]
    findings = run_analysis(paths, rules=rules)

    if args.write_baseline:
        Path(args.write_baseline).write_text(json.dumps(
            [f.fingerprint() for f in findings], indent=2) + "\n")
        print(f"wrote {len(findings)} fingerprint(s) to "
              f"{args.write_baseline}")
        return 0

    baselined = []
    if not args.no_baseline:
        baseline_path = args.baseline or _DEFAULT_BASELINE
        baseline = load_baseline(baseline_path)
        findings, baselined = filter_baseline(findings, baseline)

    if args.as_json:
        print(json.dumps({
            "findings": [dict(f.fingerprint(), line=f.line)
                         for f in findings],
            "baselined": len(baselined),
            "rules": list(rules),
        }, indent=2))
    else:
        for f in findings:
            print(f.render())
        suffix = f" ({len(baselined)} baselined)" if baselined else ""
        print(f"repro_torch.analysis: {len(findings)} finding(s) across "
              f"rules {','.join(rules)}{suffix}")

    if findings and args.fail_on_findings:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
