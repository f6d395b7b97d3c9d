"""R5 — donation: no stale alias of an argument a step writes in place.

The reference donates buffers to `jax.jit` (`donate_argnums`), and a read
of a donated buffer after the call raises there. The port writes the same
arguments IN PLACE: the decode step writes its cache, a train step its
parameters and moments, the driver its chunk buffers. After such a call
an alias taken before it (`old = cache["k"]`, a slice, an attribute)
silently holds the NEW values — where JAX would have raised, torch reads
whatever the step wrote:

    old_k = cache["k"]
    logits, cache = decode_step(cfg, params, cache, tok)
    drift = (cache["k"] - old_k).abs()             # R5: old_k is the new k

Donors are declared (`DONORS`), at the reference's `donate_argnums`
sites: a function (matched by the module it is defined in and its name,
or by its name alone when the call cannot be resolved) and the argument
positions it writes; a factory's donors are the functions it returns,
bound to whatever name takes its result. A `CellProgram`'s `fn` (the
dry-run cells, `launch/cells.py`) donates the arguments its `donate`
names; without a visible literal, every argument. At each donor call the
donated arguments' expressions are followed back: an alias bound from
one of them (or from a part of one: a subscript, an attribute, a slice)
before the call and read after it, before it is bound again, is flagged
on the line that reads it.
"""
from __future__ import annotations

import ast
import dataclasses
import fnmatch
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.modindex import Module, PackageIndex, dotted_name

RULE = "R5"


@dataclasses.dataclass(frozen=True)
class Donor:
    """`func` (defined in a module matching `path`) writes the arguments at
    `argnums` in place; with `factory`, the functions `func` returns do."""
    path: str
    func: str
    argnums: Tuple[int, ...]
    factory: bool = False


# The reference's donation sites, as the port's in-place writers
# (tests/test_torch_analysis.py reads this table).
DONORS: Tuple[Donor, ...] = (
    # serving: the decode cache (src/repro/launch/serve.py:40)
    Donor("models/transformer.py", "decode_step", (2,)),
    Donor("models/lm_steps.py", "make_decode_step", (1,), factory=True),
    # training: parameters and moments (src/repro/launch/train.py:119)
    Donor("models/lm_steps.py", "make_train_step", (0, 1), factory=True),
    Donor("models/recsys.py", "make_train_step", (0, 1), factory=True),
    Donor("models/gnn_steps.py", "make_gnn_train_step", (0, 1),
          factory=True),
    Donor("optim/adamw.py", "apply_gradients", (0, 2)),
    Donor("optim/adamw.py", "adamw_update", (0, 2)),
    # the driver's chunk buffers (src/repro/core/driver.py:176)
    Donor("core/driver.py", "_shard_counts", (0, 1, 2, 3, 4)),
)
CELL_BUILDERS = {"build_cell", "CellProgram"}


def _chain(node: ast.AST) -> Optional[Tuple[str, ...]]:
    """`a["k"].b[1:]` -> ('a', "['k']", 'b', '[...]'); None if the
    expression is not rooted in a name through subscripts, attributes and
    slicing methods."""
    parts: List[str] = []
    while True:
        if isinstance(node, ast.Name):
            return (node.id,) + tuple(reversed(parts))
        if isinstance(node, ast.Attribute):
            parts.append("." + node.attr)
            node = node.value
        elif isinstance(node, ast.Subscript):
            parts.append("[" + ast.dump(node.slice) + "]")
            node = node.value
        elif isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in ("view", "narrow", "select", "unbind",
                                   "chunk", "split", "reshape", "t",
                                   "transpose", "permute", "expand",
                                   "as_strided", "detach", "view_as"):
            node = node.func.value
        else:
            return None


def _statements(body: Sequence[ast.stmt]) -> List[ast.stmt]:
    out: List[ast.stmt] = []
    for st in body:
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
            continue
        out.append(st)
        for field in ("body", "orelse", "finalbody"):
            out.extend(_statements(getattr(st, field, []) or []))
        for h in getattr(st, "handlers", []) or []:
            out.extend(_statements(h.body))
    return out


def _own_nodes(st: ast.stmt) -> List[ast.AST]:
    """The nodes of `st` itself, not of the blocks nested in it (which
    `_statements` lists on their own)."""
    if isinstance(st, (ast.If, ast.While)):
        roots = [st.test]
    elif isinstance(st, ast.For):
        roots = [st.target, st.iter]
    elif isinstance(st, ast.With):
        roots = [i for item in st.items for i in
                 (item.context_expr, item.optional_vars) if i is not None]
    elif isinstance(st, ast.Try):
        roots = []
    else:
        roots = [st]
    return [n for r in roots for n in ast.walk(r)]


class _Scope:
    def __init__(self, mod: Module, index: PackageIndex,
                 donors: Sequence[Donor]):
        self.mod = mod
        self.index = index
        self.donors = donors
        self.findings: List[Finding] = []

    def _donor_of(self, func: ast.AST) -> Optional[Donor]:
        name = dotted_name(func)
        if name is None:
            return None
        last = name.rpartition(".")[2]
        resolved = self.index.resolve_call_target(self.mod, func)
        for d in self.donors:
            if d.func != last:
                continue
            if resolved is None or fnmatch.fnmatch(resolved[0].relpath,
                                                   d.path):
                return d
        return None

    def scan(self, fn_body: Sequence[ast.stmt]) -> None:
        stmts = _statements(fn_body)
        # name -> donated positions (None: all), bound in this scope
        callers: Dict[str, Optional[Tuple[int, ...]]] = {}
        cells: Dict[str, Optional[Tuple[int, ...]]] = {}
        for k, st in enumerate(stmts):
            nodes = _own_nodes(st)
            for node in nodes:
                if isinstance(node, ast.Call):
                    self._check_call(node, stmts, k, callers, cells)
            if isinstance(st, ast.Assign) and isinstance(st.value, ast.Call):
                d = self._donor_of(st.value.func)
                last = (dotted_name(st.value.func) or "").rpartition(".")[2]
                for tgt in st.targets:
                    if not isinstance(tgt, ast.Name):
                        continue
                    if d is not None and d.factory:
                        callers[tgt.id] = d.argnums
                    elif last in CELL_BUILDERS:
                        cells[tgt.id] = _literal_donate(st.value)

    def _check_call(self, call: ast.Call, stmts, k, callers, cells) -> None:
        func = call.func
        argnums: Optional[Tuple[int, ...]] = None
        label = dotted_name(func) or "?"
        if isinstance(func, ast.Name) and func.id in callers:
            argnums = callers[func.id]
        elif isinstance(func, ast.Attribute) and func.attr == "fn" and \
                isinstance(func.value, ast.Name) and func.value.id in cells:
            argnums = cells[func.value.id]
            if argnums is None:
                argnums = tuple(range(len(call.args)))
        else:
            d = self._donor_of(func)
            if d is None or d.factory:
                return
            argnums = d.argnums
        donated = []
        for i, arg in enumerate(call.args):
            if isinstance(arg, ast.Starred):
                c = _chain(arg.value)
                if c and any(n >= i for n in argnums):
                    donated.append(c)
                break
            if i in argnums:
                c = _chain(arg)
                if c:
                    donated.append(c)
        if donated:
            self._stale_reads(call, label, donated, stmts, k)

    def _stale_reads(self, call, label, donated, stmts, k) -> None:
        line = call.lineno
        # aliases bound before the call from a donated expression
        aliases: Dict[str, Tuple[int, Tuple[str, ...]]] = {}
        for st in stmts[:k]:
            if isinstance(st, ast.Assign):
                c = _chain(st.value)
                for tgt in st.targets:
                    if not isinstance(tgt, ast.Name):
                        continue
                    if c and any(c[:len(d)] == d and c != d
                                 or (c == d and tgt.id != d[0])
                                 for d in donated):
                        aliases[tgt.id] = (st.lineno, c)
                    else:
                        aliases.pop(tgt.id, None)
        if not aliases:
            return
        rebound = {n.id for n in ast.walk(stmts[k])
                   if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store)}
        for name, (bound_at, _) in aliases.items():
            if name in rebound:
                continue
            for st in stmts[k + 1:]:
                loads = [n for n in _own_nodes(st)
                         if isinstance(n, ast.Name) and n.id == name]
                read = [n for n in loads if isinstance(n.ctx, ast.Load)]
                if read:
                    n = read[0]
                    self.findings.append(Finding(
                        rule=RULE, path=self.mod.path, line=n.lineno,
                        col=n.col_offset,
                        message=(f"`{name}` (bound at line {bound_at}) "
                                 f"aliases an argument that `{label}()` "
                                 f"writes in place at line {line}; read "
                                 f"after the call it holds the new values, "
                                 f"where the reference's donation would "
                                 f"raise — copy it first (`.clone()`) or "
                                 f"read it before the call")))
                    break
                if loads:
                    break                          # bound again: fresh


def _literal_donate(call: ast.Call) -> Optional[Tuple[int, ...]]:
    for kw in call.keywords:
        if kw.arg == "donate" and isinstance(kw.value, (ast.Tuple,
                                                        ast.List)):
            vals = [e.value for e in kw.value.elts
                    if isinstance(e, ast.Constant)]
            if len(vals) == len(kw.value.elts):
                return tuple(vals)
    return None


def check(index: PackageIndex, donors: Sequence[Donor] = DONORS
          ) -> List[Finding]:
    out: List[Finding] = []
    for mod in index:
        bodies = [mod.tree.body] + [
            n.body for n in ast.walk(mod.tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        for body in bodies:
            scope = _Scope(mod, index, donors)
            scope.scan(body)
            out.extend(scope.findings)
    return out
