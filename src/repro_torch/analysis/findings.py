"""Findings, suppressions, and report formatting for mce_lint (the
port's copy of the reference's `repro.analysis.findings`: the same
grammar, the same reports).

A `Finding` is one (rule, file, line) diagnostic. Suppressions are
in-source comments:

    x = something()            # mce-lint: disable=R4 -- host boundary: the live check
    # mce-lint: disable=R2 -- zeroed by the entry point itself
    acc = torch.empty(n, device=dev)

    # mce-lint: disable-file=R3 -- whole-module opt-out (use sparingly)

A suppression on line L covers findings on L; a suppression on a
standalone comment line covers the next line. `disable-file` covers the
whole module. The text after `--` (or an em dash) is the justification;
`--strict` turns every justification-less suppression into an `S1`
finding, so a silenced rule always says *why* (DESIGN.md §7).

This module is stdlib-only: the analyzer imports neither torch nor jax.
"""
from __future__ import annotations

import dataclasses
import json
import re
from typing import Dict, List, Optional, Sequence, Tuple

_SUPPRESS_RE = re.compile(
    r"#\s*mce-lint:\s*disable(?P<file>-file)?\s*=\s*"
    r"(?P<rules>[A-Za-z0-9_]+(?:\s*,\s*[A-Za-z0-9_]+)*)"
    r"(?:\s*(?:--|—)\s*(?P<why>\S.*?))?\s*$")

_COMMENT_ONLY_RE = re.compile(r"^\s*#")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    col: int
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class Suppression:
    rules: Tuple[str, ...]
    line: int               # line the comment sits on (1-based)
    covers: Tuple[int, ...]  # source lines this suppression applies to
    file_level: bool
    justification: Optional[str]


class Suppressions:
    """Per-module suppression table parsed from raw source lines."""

    def __init__(self, source: str):
        self.entries: List[Suppression] = []
        self._by_line: Dict[int, List[Suppression]] = {}
        self._file_level: List[Suppression] = []
        for i, raw in enumerate(source.splitlines(), start=1):
            m = _SUPPRESS_RE.search(raw)
            if not m:
                continue
            rules = tuple(r.strip() for r in m.group("rules").split(","))
            file_level = m.group("file") is not None
            # a comment-only line shields the NEXT line; an inline trailing
            # comment shields its own line
            covers = () if file_level else (
                (i + 1,) if _COMMENT_ONLY_RE.match(raw) else (i,))
            sup = Suppression(rules=rules, line=i, covers=covers,
                              file_level=file_level,
                              justification=m.group("why"))
            self.entries.append(sup)
            if file_level:
                self._file_level.append(sup)
            for ln in covers:
                self._by_line.setdefault(ln, []).append(sup)

    def match(self, rule: str, line: int) -> Optional[Suppression]:
        for sup in self._by_line.get(line, ()):
            if rule in sup.rules:
                return sup
        for sup in self._file_level:
            if rule in sup.rules:
                return sup
        return None


def split_suppressed(findings: Sequence[Finding],
                     tables: Dict[str, Suppressions]
                     ) -> Tuple[List[Finding], List[Finding]]:
    """Partition findings into (active, suppressed) using per-path tables."""
    active: List[Finding] = []
    suppressed: List[Finding] = []
    for f in findings:
        table = tables.get(f.path)
        if table is not None and table.match(f.rule, f.line):
            suppressed.append(f)
        else:
            active.append(f)
    return active, suppressed


def unjustified_suppressions(tables: Dict[str, Suppressions]) -> List[Finding]:
    """S1: every suppression must carry a one-line justification."""
    out = []
    for path, table in sorted(tables.items()):
        for sup in table.entries:
            if not sup.justification:
                out.append(Finding(
                    rule="S1", path=path, line=sup.line, col=0,
                    message=(f"suppression of {','.join(sup.rules)} has no "
                             f"justification — append `-- <why>` to the "
                             f"mce-lint comment")))
    return out


def dedupe(findings: Sequence[Finding]) -> List[Finding]:
    seen = set()
    out = []
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.col, f.rule)):
        key = (f.rule, f.path, f.line, f.message)
        if key not in seen:
            seen.add(key)
            out.append(f)
    return out


def render_text(active: Sequence[Finding], suppressed: Sequence[Finding],
                checked: int) -> str:
    lines = [f.format() for f in active]
    lines.append(f"mce_lint: {checked} modules checked, "
                 f"{len(active)} finding(s), {len(suppressed)} suppressed")
    return "\n".join(lines)


def render_json(active: Sequence[Finding], suppressed: Sequence[Finding],
                checked: int) -> str:
    return json.dumps({
        "modules_checked": checked,
        "findings": [f.as_dict() for f in active],
        "suppressed": [f.as_dict() for f in suppressed],
        "counts": {"active": len(active), "suppressed": len(suppressed)},
    }, indent=2)
