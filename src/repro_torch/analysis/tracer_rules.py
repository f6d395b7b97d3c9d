"""R4 — host syncs in the step.

The reference's R4 finds tracer leaks in jitted code. The port runs eagerly,
so its bug class is a read of the device inside code that must not read it:
a step that `ROADMAP.md` Queue 2 item 1 wants to capture as a CUDA graph
(`core/engine/loop.py::dfs_step`, replayed 64 times between the live
checks), where any read of a tensor's value on the host is a device sync
and breaks the capture.

Roots are declared (`ROOTS`): functions whose parameters hold tensors,
except the ones named static. From each root a taint analysis (the
reference's: taint flows through assignments, calls into the package
followed with the callee's parameters tainted as the arguments are,
memoized and depth-capped) marks the names that hold device values, and
flags the sinks:

* `.item()`, `.tolist()`, `.cpu()`, `.numpy()` of a tensor;
* `int()`, `float()`, `bool()` of a tensor (`int(revised)` on a Python
  bool is clean: the taint follows values, not names);
* python `if`/`while` and conditional expressions on a tensor;
* `np.asarray`/`np.array` of a tensor;
* any `torch.cuda.synchronize()` reached from a root.

Not tainted: `.shape`/`.ndim`/`.dtype`/`.device` and the other metadata,
`.size()`/`.dim()`/`.numel()`/`.stride()`/`.data_ptr()`, `len()`,
`x is None` tests, and parameters a root declares static. Calls that
cannot be resolved propagate taint conservatively but flag nothing. The
live checks of `run_bucket` (`loop.py`) lie outside the roots by design:
they are the one read every `LIVE_CHECK_EVERY` steps.
"""
from __future__ import annotations

import ast
import dataclasses
import fnmatch
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.modindex import Module, PackageIndex, call_name

RULE = "R4"


@dataclasses.dataclass(frozen=True)
class Root:
    """A function that must not read the device: `path` a glob over the
    module path relative to the package root, `func` its name, `static`
    the parameters that hold no tensor."""
    path: str
    func: str
    static: Tuple[str, ...] = ()


# The functions that must not read the device (tests/test_torch_analysis.py
# reads this table). `dfs_step` reaches `enter_call`, `pivot.py`,
# `reductions.py`, `frames.py` and the bitset `ops` entry points.
ROOTS: Tuple[Root, ...] = (
    Root("core/engine/loop.py", "dfs_step", static=("cfg",)),
)

_STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "is_meta",
                 "layout", "requires_grad", "is_sparse"}
_STATIC_METHODS = {"size", "dim", "numel", "element_size", "stride",
                   "is_contiguous", "data_ptr", "get_device", "nelement"}
_HOST_METHODS = {"item", "tolist", "cpu", "numpy"}
_UNTAINTED_CALLS = {"len", "range", "zip", "enumerate", "isinstance",
                    "hasattr", "getattr", "type", "id", "repr", "str",
                    "tuple", "list", "dict", "set", "frozenset", "sorted",
                    "min", "max", "print"}
_COERCIONS = {"int", "float", "bool", "complex"}
_NUMPY_SINKS = {"np.asarray", "np.array", "numpy.asarray", "numpy.array"}
_SYNCS = {"torch.cuda.synchronize", "cuda.synchronize"}
# torch functions that return host values
_HOST_TORCH = {"torch.device", "torch.Size", "torch.is_tensor",
               "torch.is_grad_enabled", "torch.cuda.is_available",
               "torch.cuda.current_stream", "torch.cuda.device_count",
               "torch.get_default_dtype", "torch.finfo", "torch.iinfo",
               "torch.is_floating_point"}
_PRODUCER_PREFIXES = ("torch.", "F.")
_MAX_DEPTH = 12


def _local_defs(scope: ast.AST) -> Dict[str, ast.FunctionDef]:
    return {n.name: n for n in ast.walk(scope)
            if isinstance(n, ast.FunctionDef)}


class HostSyncTaint:
    """Taint analysis over one package: declared roots -> findings."""

    def __init__(self, index: PackageIndex, roots: Sequence[Root] = ROOTS):
        self.index = index
        self.roots = roots
        self.findings: List[Finding] = []
        self._memo: Dict[Tuple[int, frozenset], bool] = {}

    def run(self) -> List[Finding]:
        for mod in self.index:
            for root in self.roots:
                if not fnmatch.fnmatch(mod.relpath, root.path):
                    continue
                entry = mod.symbols.get(root.func)
                if entry and entry[0] == "func":
                    fn = entry[1]
                    self._analyze(mod, fn, self._param_taint(fn, root.static))
        return self.findings

    @staticmethod
    def _param_taint(fn: ast.FunctionDef, static: Sequence[str]
                     ) -> Dict[str, bool]:
        env = {}
        for a in (fn.args.posonlyargs + fn.args.args + fn.args.kwonlyargs):
            env[a.arg] = a.arg not in static
        if fn.args.vararg:
            env[fn.args.vararg.arg] = True
        if fn.args.kwarg:
            env[fn.args.kwarg.arg] = True
        return env

    def _flag(self, mod: Module, node: ast.AST, what: str) -> None:
        self.findings.append(Finding(
            rule=RULE, path=mod.path, line=node.lineno, col=node.col_offset,
            message=(f"{what} inside the step (reached from a declared "
                     f"root) — a device sync each call, which a CUDA graph "
                     f"of the step cannot hold (ROADMAP Queue 2 item 1)")))

    # ---- per-function analysis -------------------------------------------

    def _analyze(self, mod: Module, fn: ast.AST, env: Dict[str, bool],
                 depth: int = 0) -> bool:
        """Walk one function with `env` as the initial taint map; returns
        the taint of its return value (conservative)."""
        if depth > _MAX_DEPTH:
            return True
        key = (id(fn), frozenset(k for k, v in env.items() if v))
        if key in self._memo:
            return self._memo[key]
        self._memo[key] = True                      # conservative for cycles
        if not isinstance(fn, ast.FunctionDef):
            return True
        ret = [False]
        self._stmts(mod, fn.body, env, _local_defs(fn), depth, ret)
        self._memo[key] = ret[0]
        return ret[0]

    def _stmts(self, mod, stmts, env, local, depth, ret) -> None:
        for st in stmts:
            if isinstance(st, (ast.FunctionDef, ast.ClassDef)):
                continue                       # analyzed only when invoked
            if isinstance(st, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                value = getattr(st, "value", None)
                t = self._expr(mod, value, env, local, depth) \
                    if value is not None else False
                targets = st.targets if isinstance(st, ast.Assign) \
                    else [st.target]
                for tgt in targets:
                    if isinstance(tgt, (ast.Subscript, ast.Attribute)):
                        self._expr(mod, tgt, env, local, depth)
                    if isinstance(st, ast.Assign) and \
                            isinstance(tgt, ast.Tuple) and \
                            isinstance(value, ast.Tuple) and \
                            len(tgt.elts) == len(value.elts):
                        for el, v in zip(tgt.elts, value.elts):
                            self._bind(el, self._expr(mod, v, env, local,
                                                      depth), env)
                        continue
                    self._bind(tgt, t or (isinstance(st, ast.AugAssign) and
                                          self._expr(mod, st.target, env,
                                                     local, depth)), env)
                    if isinstance(tgt, ast.Name):
                        self._note_literal(tgt.id, value, env)
            elif isinstance(st, (ast.If, ast.While)):
                if self._branch_taint(mod, st.test, env, local, depth):
                    self._flag(mod, st.test, "python `if`/`while` on a "
                               "tensor's value")
                self._stmts(mod, st.body, env, local, depth, ret)
                self._stmts(mod, st.orelse, env, local, depth, ret)
            elif isinstance(st, ast.For):
                items = self._dict_items(mod, st.iter, env, local, depth)
                if items is not None and isinstance(st.target, ast.Tuple) \
                        and len(st.target.elts) == 2:
                    # `for k, (a, b) in table.items()` over a dict literal
                    # of tuples: each position as tainted as its entries
                    key, val = st.target.elts
                    self._bind(key, False, env)
                    if isinstance(val, ast.Tuple) and \
                            len(val.elts) == len(items):
                        for el, t in zip(val.elts, items):
                            self._bind(el, t, env)
                    else:
                        self._bind(val, any(items), env)
                else:
                    self._bind(st.target, self._expr(mod, st.iter, env,
                                                     local, depth), env)
                self._stmts(mod, st.body, env, local, depth, ret)
                self._stmts(mod, st.body, env, local, depth, ret)
                self._stmts(mod, st.orelse, env, local, depth, ret)
            elif isinstance(st, ast.Return):
                if st.value is not None:
                    ret[0] |= bool(self._expr(mod, st.value, env, local,
                                              depth))
            elif isinstance(st, ast.Expr):
                self._expr(mod, st.value, env, local, depth)
            elif isinstance(st, ast.With):
                for item in st.items:
                    self._expr(mod, item.context_expr, env, local, depth)
                self._stmts(mod, st.body, env, local, depth, ret)
            elif isinstance(st, ast.Try):
                self._stmts(mod, st.body, env, local, depth, ret)
                for h in st.handlers:
                    self._stmts(mod, h.body, env, local, depth, ret)
                self._stmts(mod, st.orelse, env, local, depth, ret)
                self._stmts(mod, st.finalbody, env, local, depth, ret)
            # Assert/Raise/Pass/Import/...: no taint flow worth tracking

    def _bind(self, tgt: ast.AST, taint: bool, env: Dict[str, bool]) -> None:
        if isinstance(tgt, ast.Name):
            env[tgt.id] = bool(taint)
        elif isinstance(tgt, (ast.Tuple, ast.List)):
            for el in tgt.elts:
                self._bind(el, taint, env)
        elif isinstance(tgt, ast.Starred):
            self._bind(tgt.value, taint, env)

    @staticmethod
    def _note_literal(name: str, value, env) -> None:
        """Remember that `name` holds a container literal (its truth is
        its length, no device read), and a dict literal's entries."""
        def literal(v):
            if isinstance(v, ast.IfExp):
                return literal(v.body) and literal(v.orelse)
            return isinstance(v, (ast.Tuple, ast.List, ast.Set, ast.Dict,
                                  ast.ListComp, ast.SetComp, ast.DictComp))
        env.pop("<seq>" + name, None)
        env.pop("<dict>" + name, None)
        if value is not None and literal(value):
            env["<seq>" + name] = True
            if isinstance(value, ast.Dict):
                env["<dict>" + name] = value

    def _dict_items(self, mod, it, env, local, depth):
        """Per-position taint of `d.items()`'s values when `d` holds a
        dict literal of equal-length tuples; else None."""
        if not (isinstance(it, ast.Call) and
                isinstance(it.func, ast.Attribute) and
                it.func.attr == "items" and
                isinstance(it.func.value, ast.Name)):
            return None
        node = env.get("<dict>" + it.func.value.id)
        if not isinstance(node, ast.Dict) or not node.values or not all(
                isinstance(v, ast.Tuple) for v in node.values):
            return None
        n = len(node.values[0].elts)
        if any(len(v.elts) != n for v in node.values):
            return None
        return [any([self._expr(mod, v.elts[i], env, local, depth)
                     for v in node.values]) for i in range(n)]

    def _branch_taint(self, mod, test, env, local, depth) -> bool:
        """Taint of an if/while test, with the static-test exemptions."""
        if isinstance(test, ast.Name) and env.get("<seq>" + test.id):
            return False                   # a container's length
        if isinstance(test, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in test.ops):
                return False
            if all(isinstance(op, (ast.In, ast.NotIn)) for op in test.ops) \
                    and isinstance(test.left, ast.Constant):
                return False
        if isinstance(test, ast.BoolOp):
            return any([self._branch_taint(mod, v, env, local, depth)
                        for v in test.values])
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            return self._branch_taint(mod, test.operand, env, local, depth)
        return bool(self._expr(mod, test, env, local, depth))

    # ---- expression taint (and sink detection) ---------------------------

    def _expr(self, mod, node, env, local, depth) -> bool:
        if node is None or isinstance(node, ast.Constant):
            return False
        if isinstance(node, ast.Name):
            return env.get(node.id, False)
        if isinstance(node, ast.Attribute):
            t = self._expr(mod, node.value, env, local, depth)
            return False if node.attr in _STATIC_ATTRS else t
        if isinstance(node, ast.Subscript):
            return (self._expr(mod, node.value, env, local, depth) |
                    self._expr(mod, node.slice, env, local, depth))
        # sub-expressions are evaluated eagerly: sinks are visited even
        # after the taint is known
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return any([self._expr(mod, el, env, local, depth)
                        for el in node.elts])
        if isinstance(node, ast.Dict):
            return any([self._expr(mod, v, env, local, depth)
                        for v in list(node.keys) + list(node.values)
                        if v is not None])
        if isinstance(node, ast.BinOp):
            return (self._expr(mod, node.left, env, local, depth) |
                    self._expr(mod, node.right, env, local, depth))
        if isinstance(node, ast.UnaryOp):
            return self._expr(mod, node.operand, env, local, depth)
        if isinstance(node, ast.BoolOp):
            return any([self._expr(mod, v, env, local, depth)
                        for v in node.values])
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                return False
            vals = [node.left] + list(node.comparators)
            return any([self._expr(mod, v, env, local, depth) for v in vals])
        if isinstance(node, ast.IfExp):
            if self._branch_taint(mod, node.test, env, local, depth):
                self._flag(mod, node.test, "conditional expression on a "
                           "tensor's value")
            return (self._expr(mod, node.body, env, local, depth) |
                    self._expr(mod, node.orelse, env, local, depth))
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                             ast.DictComp)):
            cenv = dict(env)
            for gen in node.generators:
                self._bind(gen.target,
                           self._expr(mod, gen.iter, cenv, local, depth), cenv)
                for cond in gen.ifs:
                    self._expr(mod, cond, cenv, local, depth)
            if isinstance(node, ast.DictComp):
                return (self._expr(mod, node.key, cenv, local, depth) |
                        self._expr(mod, node.value, cenv, local, depth))
            return self._expr(mod, node.elt, cenv, local, depth)
        if isinstance(node, ast.Starred):
            return self._expr(mod, node.value, env, local, depth)
        if isinstance(node, (ast.JoinedStr, ast.Lambda)):
            return False
        if isinstance(node, ast.Call):
            return self._call(mod, node, env, local, depth)
        return False

    def _call(self, mod, node: ast.Call, env, local, depth) -> bool:
        name = call_name(node) or ""
        arg_taints = [self._expr(mod, a, env, local, depth)
                      for a in node.args]
        kw_taints = {kw.arg: self._expr(mod, kw.value, env, local, depth)
                     for kw in node.keywords}
        any_taint = any(arg_taints) or any(kw_taints.values())

        # ---- sinks ----
        if name in _SYNCS or name.endswith(".cuda.synchronize"):
            self._flag(mod, node, "`torch.cuda.synchronize()`")
            return False
        if isinstance(node.func, ast.Name) and node.func.id in _COERCIONS \
                and any_taint:
            self._flag(mod, node, f"`{node.func.id}()` of a tensor")
            return False
        if isinstance(node.func, ast.Attribute):
            recv = self._expr(mod, node.func.value, env, local, depth)
            if node.func.attr in _HOST_METHODS and recv:
                self._flag(mod, node, f"`.{node.func.attr}()` of a tensor")
                return False
            if node.func.attr in _STATIC_METHODS:
                return False
        if name in _NUMPY_SINKS and any_taint:
            self._flag(mod, node, f"`{name}()` of a tensor")
            return False

        # ---- interprocedural propagation ----
        if isinstance(node.func, ast.Name) and \
                node.func.id in _UNTAINTED_CALLS:
            return node.func.id in ("tuple", "list", "dict", "sorted",
                                    "min", "max", "getattr") and any_taint
        resolved = self.index.resolve_call_target(mod, node.func, local)
        if resolved and isinstance(resolved[1], ast.FunctionDef):
            tmod, fn = resolved
            if any(isinstance(a, ast.Starred) for a in node.args):
                # positions unknown past a *args: every one as tainted as any
                arg_taints = [any(arg_taints)] * (len(fn.args.posonlyargs) +
                                                  len(fn.args.args))
            cenv = self._map_args(fn, arg_taints, kw_taints)
            return self._analyze(tmod, fn, cenv, depth + 1)
        if name in _HOST_TORCH:
            return False
        if name.startswith(_PRODUCER_PREFIXES):
            return True                            # a new tensor
        # unresolved: propagate conservatively, flag nothing
        base = self._expr(mod, node.func, env, local, depth) \
            if isinstance(node.func, ast.Attribute) else False
        return any_taint or base

    @staticmethod
    def _map_args(fn: ast.FunctionDef, arg_taints: List[bool],
                  kw_taints: Dict[Optional[str], bool]) -> Dict[str, bool]:
        params = [a.arg for a in fn.args.posonlyargs + fn.args.args]
        env: Dict[str, bool] = {p: False for p in params}
        env.update({a.arg: False for a in fn.args.kwonlyargs})
        for i, t in enumerate(arg_taints):
            if i < len(params):
                env[params[i]] = t
            elif fn.args.vararg:
                env[fn.args.vararg.arg] = env.get(fn.args.vararg.arg,
                                                  False) or t
        for k, t in kw_taints.items():
            if k in env:
                env[k] = t
        return env


def check(index: PackageIndex, roots: Sequence[Root] = ROOTS
          ) -> List[Finding]:
    return HostSyncTaint(index, roots).run()

