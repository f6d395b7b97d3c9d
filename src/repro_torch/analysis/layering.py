"""R1 — layering: declarative import-graph contracts of the port.

The reference's walker (`repro.analysis.layering`), on `repro_torch`:
imports are resolved (relative forms and aliasing included) before they
are matched, so a mention in a docstring does not count and an alias does
not hide an import. The contracts live once, here, as data (`LAYERS`);
the test suite and the CLI both read this table.

* `kernel-privates` — the dead-kernel bug of DESIGN.md §7: the engine
  imported the plain `ref` directly and the kernel was dead code on
  the hot path. A kernel package's `ref`, `build` and `words` are private
  to the kernel packages, and so is the build helper `kernels._build`:
  everything else reaches a kernel through `ops`.
* `graph-purity` — `graph/` is the bottom layer: numpy, torch and its
  siblings only (and the standard library).
* `engine-no-upward` — the driver consumes the engine, never the reverse.
* `driver-no-launch` — `core/driver.py` stays launchable headless.
* `no-jax-no-reference` — the port's own rule: it imports neither JAX nor
  the reference package `repro` (a module there loads jax through its
  package `__init__`).
"""
from __future__ import annotations

import dataclasses
import fnmatch
import sys
from typing import List, Sequence, Tuple

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.modindex import Module, PackageIndex

RULE = "R1"
CANONICAL = "repro_torch"


@dataclasses.dataclass(frozen=True)
class LayerRule:
    """One declarative layer contract.

    scope/exclude are fnmatch globs over the module path relative to the
    package root (posix, e.g. 'core/engine/loop.py'). `forbid` patterns
    match resolved dotted import names with prefix semantics ('a.b' also
    bans 'a.b.c'). `allow_only` restricts every same-package import to
    the listed prefixes; `external`, when given, restricts every import
    from outside the package and the standard library to those top-level
    names.
    """
    name: str
    description: str
    scope: Tuple[str, ...]
    exclude: Tuple[str, ...] = ()
    forbid: Tuple[str, ...] = ()
    allow_only: Tuple[str, ...] = ()
    external: Tuple[str, ...] = ()


# The single source of truth for the port's layer contracts
# (tests/test_torch_analysis.py asserts this table's coverage).
LAYERS: Tuple[LayerRule, ...] = (
    LayerRule(
        name="kernel-privates",
        description=("a kernel package's `ref`/`build`/`words` and the "
                     "build helper `kernels._build` are private to the "
                     "kernel packages — everything else goes through `ops` "
                     "(DESIGN.md §3; the dead-kernel bug of §7)"),
        scope=("**",),
        exclude=("kernels/*.py", "kernels/*/*.py"),
        forbid=("repro_torch.kernels.*.ref", "repro_torch.kernels.*.build",
                "repro_torch.kernels.*.words", "repro_torch.kernels._build"),
    ),
    LayerRule(
        name="graph-purity",
        description=("graph/ is the bottom layer: numpy, torch and graph "
                     "siblings only, never core/kernels/launch "
                     "(DESIGN.md §6)"),
        scope=("graph/*.py",),
        allow_only=("repro_torch.graph",),
        external=("numpy", "torch"),
    ),
    LayerRule(
        name="engine-no-upward",
        description=("core/engine/ never imports the driver or launch — "
                     "the driver consumes the stream, not the reverse "
                     "(DESIGN.md §6)"),
        scope=("core/engine/*.py",),
        forbid=("repro_torch.core.driver", "repro_torch.launch"),
    ),
    LayerRule(
        name="driver-no-launch",
        description="core/driver.py never imports launch/ (DESIGN.md §6)",
        scope=("core/driver.py",),
        forbid=("repro_torch.launch",),
    ),
    LayerRule(
        name="no-jax-no-reference",
        description=("the port imports neither JAX nor the reference "
                     "package `repro`: it keeps its own copy of what it "
                     "needs"),
        scope=("**",),
        forbid=("jax", "jaxlib", "repro"),
    ),
)


def _matches_any(path: str, globs: Sequence[str]) -> bool:
    return any(fnmatch.fnmatch(path, g) for g in globs)


def _dotted_match(imp: str, pattern: str) -> bool:
    """Prefix-aware dotted match: 'a.b' bans 'a.b' and 'a.b.c'."""
    return fnmatch.fnmatch(imp, pattern) or fnmatch.fnmatch(imp, pattern + ".*")


def _rewrite(pattern: str, package: str) -> str:
    """Layer patterns are written against the canonical package name
    'repro_torch'; retarget them when linting a differently-named tree
    (the fixture corpus uses throwaway package names)."""
    if package == CANONICAL or not (pattern == CANONICAL or
                                    pattern.startswith(CANONICAL + ".")):
        return pattern
    return package + pattern[len(CANONICAL):]


def _external_ok(top: str, allowed: Sequence[str]) -> bool:
    return (top in allowed or top in sys.stdlib_module_names
            or top == "__future__")


def check_module(mod: Module, package: str,
                 layers: Sequence[LayerRule] = LAYERS) -> List[Finding]:
    out: List[Finding] = []
    for rule in layers:
        if not _matches_any(mod.relpath, rule.scope):
            continue
        if _matches_any(mod.relpath, rule.exclude):
            continue
        forbid = [_rewrite(p, package) for p in rule.forbid]
        allow = [_rewrite(p, package) for p in rule.allow_only]
        for rec in mod.imports:
            for cand in rec.candidates:
                hit = None
                for pat in forbid:
                    if _dotted_match(cand, pat):
                        hit = (f"imports `{cand}` (forbidden by layer rule "
                               f"'{rule.name}': {rule.description})")
                        break
                if hit is None and allow and cand.startswith(package + "."):
                    if not any(_dotted_match(cand, pat) or
                               cand == pat for pat in allow):
                        hit = (f"imports `{cand}` outside its layer "
                               f"(rule '{rule.name}' allows only "
                               f"{list(rule.allow_only)}: {rule.description})")
                top = cand.partition(".")[0]
                if hit is None and rule.external and top and \
                        top != package and \
                        not _external_ok(top, rule.external):
                    hit = (f"imports `{cand}` from outside its layer (rule "
                           f"'{rule.name}' allows only "
                           f"{list(rule.external)} and the standard library: "
                           f"{rule.description})")
                if hit:
                    out.append(Finding(rule=RULE, path=mod.path,
                                       line=rec.lineno, col=rec.col,
                                       message=hit))
                    break                          # one finding per import
    return out


def check(index: PackageIndex,
          layers: Sequence[LayerRule] = LAYERS) -> List[Finding]:
    out: List[Finding] = []
    for mod in index:
        out.extend(check_module(mod, index.package, layers))
    return out
