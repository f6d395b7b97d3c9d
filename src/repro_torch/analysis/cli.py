"""mce_lint command-line driver, the port's (the reference's CLI, exit
codes and report, on `repro_torch`).

    python -m repro_torch.analysis src/repro_torch --strict
    python -m repro_torch.analysis src/repro_torch --rules R1,R4 \
        --format json --report lint_report.json

Exit status: 0 when no active (unsuppressed) finding remains, 1
otherwise. `--strict` additionally fails on suppressions that carry no
justification (S1) — the CI lint job runs in this mode so every silenced
rule documents *why* (DESIGN.md §7).

Stdlib-only end to end: neither torch nor jax is imported.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, List, Optional, Sequence

from repro_torch.analysis import (donation, kernel_rules, layering,
                                  tracer_rules)
from repro_torch.analysis.findings import (Finding, Suppressions, dedupe,
                                     render_json, render_text,
                                     split_suppressed,
                                     unjustified_suppressions)
from repro_torch.analysis.modindex import PackageIndex

RULE_FAMILIES = {
    "R1": ("layering", layering.check),
    "R2": ("accumulators left unset", kernel_rules.check),
    "R3": ("fails only on the hardware", None),    # runs with R2's walker
    "R4": ("host syncs in the step", tracer_rules.check),
    "R5": ("donation", donation.check),
}


def analyze(root: str, package: Optional[str] = None,
            rules: Optional[Sequence[str]] = None):
    """Run all (or the selected) rule families over one package tree.

    Returns (active, suppressed, s1, n_modules). R2/R3 share one kernel
    walker, so selecting either runs it and the other family's findings
    are filtered out afterwards.
    """
    index = PackageIndex.build(root, package=package)
    selected = set(rules) if rules else set(RULE_FAMILIES)
    findings: List[Finding] = []
    if "R1" in selected:
        findings.extend(layering.check(index))
    if selected & {"R2", "R3"}:
        findings.extend(f for f in kernel_rules.check(index)
                        if f.rule in selected)
    if "R4" in selected:
        findings.extend(tracer_rules.check(index))
    if "R5" in selected:
        findings.extend(donation.check(index))
    findings = dedupe(findings)
    tables: Dict[str, Suppressions] = {m.path: m.suppressions for m in index}
    active, suppressed = split_suppressed(findings, tables)
    s1 = unjustified_suppressions(tables)
    return active, suppressed, s1, len(index.modules)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="mce_lint",
        description="AST-based kernel-contract and host-sync analyzer "
                    "for the repro_torch package (rule families R1-R5; "
                    "see DESIGN.md §7).")
    ap.add_argument("paths", nargs="+",
                    help="package directories to analyze (e.g. "
                         "src/repro_torch)")
    ap.add_argument("--strict", action="store_true",
                    help="also fail on suppressions without a justification")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule subset (default: all)")
    ap.add_argument("--package", default=None,
                    help="override the dotted package name (default: "
                         "basename of each path)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--report", default=None, metavar="FILE",
                    help="also write a JSON findings report to FILE")
    args = ap.parse_args(argv)

    rules = [r.strip() for r in args.rules.split(",")] if args.rules else None
    active: List[Finding] = []
    suppressed: List[Finding] = []
    checked = 0
    for path in args.paths:
        if not os.path.isdir(path):
            print(f"mce_lint: {path} is not a directory", file=sys.stderr)
            return 2
        a, s, s1, n = analyze(path, package=args.package, rules=rules)
        active.extend(a)
        suppressed.extend(s)
        if args.strict:
            active.extend(s1)
        checked += n

    if args.report:
        with open(args.report, "w", encoding="utf-8") as f:
            f.write(render_json(active, suppressed, checked) + "\n")
    if args.format == "json":
        print(render_json(active, suppressed, checked))
    else:
        print(render_text(active, suppressed, checked))
    return 1 if active else 0


if __name__ == "__main__":
    sys.exit(main())
