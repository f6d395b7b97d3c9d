"""R2/R3 — the contract between a kernel package's wrappers (`ops`) and its
CUDA source (`csrc/<name>.cu`), read from both sides.

The reference's R2/R3 read Pallas kernel bodies. The port's kernels are
CUDA C++ bound by ctypes (`kernels/_build.py::CudaLibrary`), so the same
bug classes sit at the boundary:

R2 (accumulators left unset — DESIGN.md §7's first bug class: an
output that a launch adds into). In the `.cu`, an argument that a kernel
updates with an atomic read-modify-write (`atomicAdd`, `atomicSub`,
`atomicOr`, `atomicAnd`, `atomicMax`, `atomicMin`, `atomicInc`,
`atomicDec`) is followed through local aliases, device calls and
launches up to the `extern "C"` entry point's argument. An entry point that zeroes it first
(`cudaMemset[Async]`, or a kernel it launches storing a literal into it)
needs nothing of its caller. Otherwise the tensor the wrapper passes in
that position (`t.data_ptr()`) must come from `torch.zeros*` /
`new_zeros`, or be `.zero_()`-ed or `.fill_()`-ed before the call, or
have been passed before, in the same function, to an entry point that
initialises that argument. A `torch.empty` there is flagged on the line
that allocates it.

R3 (fails only on the hardware). A ctypes declaration that disagrees with
its C prototype passes every CPU test and corrupts arguments on the card.
Every `CudaLibrary(SOURCE, {name: [ctypes...]})` is held to the
`extern "C"` functions of SOURCE: the name exists, the argument counts
agree, and each argument's kind agrees (pointer: `c_void_p` against a
`T*`; integer: `c_int`/`c_longlong`/... against an integer type; float:
`c_float`/`c_double` against `float`/`double`).

The C side is read by a small scanner (comments stripped, braces and
parentheses balanced), not a compiler: it follows what the port's
sources use, and finds nothing to flag in what it cannot read.
"""
from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.modindex import Module, PackageIndex, dotted_name

RULE_ACC = "R2"
RULE_SIG = "R3"

_ATOMIC_RE = re.compile(
    r"\batomic(?:Add|Sub|Or|And|Max|Min|Inc|Dec)(?:_block|_system)?\s*\(")
_MEMSET_RE = re.compile(r"\bcudaMemset(?:Async)?\s*\(")
_LITERAL = r"(?:-?\d+(?:\.\d*)?[fFuUlL]*|false|true|nullptr)"
_STORE_RE = re.compile(
    r"(?:\b(\w+)\s*\[[^\]]*\]|\*\s*(\w+))\s*=\s*" + _LITERAL + r"\s*;")
_HEADER_RE = re.compile(r"\b([A-Za-z_]\w*)\s*\(")
# a declaration with an initialiser: `T* p = ...;`, `auto* p = ...;`,
# `auto p = ...;` (group 1 the name, group 2 the right side)
_PTR_DECL_RE = re.compile(
    r"\b(?:const\s+)?(?:[A-Za-z_][\w:]*(?:<[^;<>]*>)?)\s*\**\s*"
    r"(?:const\s+)?(?:__restrict__\s+)?\**\s*([A-Za-z_]\w*)\s*=(?!=)"
    r"\s*([^;]+);")
_IDENT_RE = re.compile(r"[A-Za-z_]\w*")
_ADDR_RE = re.compile(r"&\s*([A-Za-z_]\w*)\s*\[[^\[\]]*\]")
_READ_RE = re.compile(r"[A-Za-z_]\w*\s*\[[^\[\]]*\]")
_CAST_RE = re.compile(r"\b(?:static|reinterpret|const)_cast\s*<([^;(){}]*?)>\s*\(")
_C_KEYWORDS = {"if", "for", "while", "switch", "return", "sizeof", "catch",
               "__launch_bounds__", "__attribute__", "alignas", "decltype",
               "static_assert", "defined", "operator"}
_FLOAT_WORDS = {"float", "double", "half", "__half", "__nv_bfloat16"}

_CTYPES_KIND = {
    "c_void_p": "pointer", "c_char_p": "pointer",
    "c_int": "integer", "c_uint": "integer", "c_long": "integer",
    "c_ulong": "integer", "c_longlong": "integer", "c_ulonglong": "integer",
    "c_int8": "integer", "c_int16": "integer", "c_int32": "integer",
    "c_int64": "integer", "c_uint8": "integer", "c_uint16": "integer",
    "c_uint32": "integer", "c_uint64": "integer", "c_size_t": "integer",
    "c_ssize_t": "integer", "c_bool": "integer", "c_short": "integer",
    "c_float": "float", "c_double": "float",
}
_ZEROING_CALLS = {"zeros", "zeros_like", "new_zeros"}
_ZEROING_METHODS = {"zero_", "fill_"}


# ---------------------------------------------------------------------------
# the C side
# ---------------------------------------------------------------------------

def strip_comments(src: str) -> str:
    """`src` with every comment blanked (newlines kept, so offsets and
    line numbers stay those of the file)."""
    def blank(m):
        return re.sub(r"[^\n]", " ", m.group(0))
    return re.sub(r"//[^\n]*|/\*.*?\*/", blank, src, flags=re.S)


def _match(src: str, i: int, open_: str, close: str) -> int:
    """Index of the bracket closing the one at `src[i]`, or -1."""
    depth = 0
    for j in range(i, len(src)):
        if src[j] == open_:
            depth += 1
        elif src[j] == close:
            depth -= 1
            if depth == 0:
                return j
    return -1


def base_idents(expr: str) -> List[str]:
    """The identifiers of an address expression that may be its base
    pointer: `&p[i]` counts as p, any other subscript `q[i]` as the value
    it reads (no pointer), and casts to a non-pointer type as values
    (`grad_table + static_cast<int64_t>(ids[b]) * D` -> grad_table, D)."""
    expr = _ADDR_RE.sub(r" \1 ", expr)
    prev = None
    while prev != expr:
        prev, expr = expr, _READ_RE.sub(" 0 ", expr)
    out, pos = [], 0
    while True:
        m = _CAST_RE.search(expr, pos)
        if m is None:
            break
        end = _match(expr, m.end() - 1, "(", ")")
        if end < 0:
            break
        if "*" not in m.group(1):
            expr = expr[:m.start()] + " 0 " + expr[end + 1:]
            pos = m.start()
        else:
            expr = expr[:m.start()] + " " + expr[m.end() - 1:]
            pos = m.start()
    for ident in _IDENT_RE.findall(expr):
        out.append(ident)
    return out


def split_top(s: str) -> List[str]:
    """`s` split at the commas outside any bracket."""
    out, depth, cur = [], 0, []
    for ch in s:
        if ch in "([{<":
            depth += 1
        elif ch in ")]}>":
            depth -= 1
        if ch == "," and depth == 0:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if "".join(cur).strip():
        out.append("".join(cur))
    return [p.strip() for p in out]


@dataclasses.dataclass
class CParam:
    name: str
    kind: str            # pointer | integer | float


def _param(decl: str) -> Optional[CParam]:
    decl = decl.split("=")[0].strip()
    if not decl or decl == "void":
        return None
    words = _IDENT_RE.findall(decl)
    if not words:
        return None
    if "*" in decl or "[" in decl:
        kind = "pointer"
    elif set(words[:-1]) & _FLOAT_WORDS:
        kind = "float"
    else:
        kind = "integer"
    return CParam(words[-1], kind)


@dataclasses.dataclass
class CFunction:
    name: str
    line: int
    params: List[CParam]
    body: str
    body_line: int
    extern_c: bool
    # filled by CSource.solve: param index -> line of the atomic it reaches
    acc: Dict[int, int] = dataclasses.field(default_factory=dict)
    init: Set[int] = dataclasses.field(default_factory=set)


class CSource:
    """The functions of one `.cu` file, with each function's accumulated
    and initialised arguments (through aliases, calls and launches)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, encoding="utf-8") as f:
            self.src = strip_comments(f.read())
        self.functions: Dict[str, List[CFunction]] = {}
        self._parse()
        self._solve()

    def line_of(self, offset: int) -> int:
        return self.src.count("\n", 0, offset) + 1

    def _extern_spans(self) -> List[Tuple[int, int]]:
        spans = []
        for m in re.finditer(r'extern\s+"C"\s*', self.src):
            j = m.end()
            if j < len(self.src) and self.src[j] == "{":
                spans.append((j, _match(self.src, j, "{", "}")))
            else:
                spans.append((m.start(), self.src.find("{", j)))
        return spans

    def _parse(self) -> None:
        src = self.src
        externs = self._extern_spans()
        pos = 0
        while True:
            m = _HEADER_RE.search(src, pos)
            if m is None:
                break
            name, lp = m.group(1), m.end() - 1
            rp = _match(src, lp, "(", ")")
            pos = m.end()
            if rp < 0 or name in _C_KEYWORDS:
                continue
            k = rp + 1
            while k < len(src) and (src[k].isspace() or
                                    src[k:k + 5] == "const"):
                k += 5 if src[k:k + 5] == "const" else 1
            before = src[:m.start()].rstrip()
            if k >= len(src) or src[k] != "{" or not before or \
                    before[-1] in "=,(:;!?+-/%|^~[{}.":
                continue
            end = _match(src, k, "{", "}")
            if end < 0:
                continue
            params = [p for p in (_param(d) for d in
                                  split_top(src[lp + 1:rp])) if p]
            fn = CFunction(name=name, line=self.line_of(m.start()),
                           params=params, body=src[k + 1:end],
                           body_line=self.line_of(k + 1),
                           extern_c=any(a <= m.start() <= b
                                        for a, b in externs))
            self.functions.setdefault(name, []).append(fn)
            pos = end + 1

    @staticmethod
    def _aliases(fn: CFunction) -> Dict[str, Set[int]]:
        """Local pointer name -> the pointer params it may point into
        (declarations `T* p = ...` and `auto p = <cast to T*>(...)` whose
        right side names a pointer param or an earlier such alias)."""
        alias = {p.name: {i} for i, p in enumerate(fn.params)
                 if p.kind == "pointer"}
        decls = [(m.group(1), m.group(2)) for m in _PTR_DECL_RE.finditer(
            fn.body) if "*" in m.group(0).split("=")[0]
            or "*>" in m.group(2)]
        for _ in range(3):
            for lhs, rhs in decls:
                hit = set()
                for ident in base_idents(rhs):
                    hit |= alias.get(ident, set())
                if hit and lhs not in {p.name for p in fn.params}:
                    alias.setdefault(lhs, set()).update(hit)
        return alias

    def _first_arg_params(self, fn, alias, start: int) -> Set[int]:
        lp = start - 1
        rp = _match(fn.body, lp, "(", ")")
        args = split_top(fn.body[lp + 1:rp]) if rp > 0 else []
        hit: Set[int] = set()
        for ident in base_idents(args[0] if args else ""):
            hit |= alias.get(ident, set())
        return hit

    def _calls(self, fn: CFunction):
        """(callee, [arg text], offset in body) of every call or launch of
        a function defined in this file."""
        out = []
        for name in self.functions:
            pat = re.compile(r"\b" + re.escape(name) +
                             r"\s*(?:<(?!<)[^;{}()<>]*>)?\s*(?:<<<.*?>>>)?"
                             r"\s*\(", re.S)
            for m in pat.finditer(fn.body):
                lp = m.end() - 1
                rp = _match(fn.body, lp, "(", ")")
                if rp > 0:
                    out.append((name, split_top(fn.body[lp + 1:rp]),
                                m.start()))
        return out

    def _solve(self) -> None:
        fns = [f for group in self.functions.values() for f in group]
        direct = {}
        for fn in fns:
            alias = self._aliases(fn)
            acc: Dict[int, int] = {}
            init: Set[int] = set()
            for m in _ATOMIC_RE.finditer(fn.body):
                line = fn.body_line + fn.body.count("\n", 0, m.start())
                for i in self._first_arg_params(fn, alias, m.end()):
                    acc.setdefault(i, line)
            for m in _MEMSET_RE.finditer(fn.body):
                init |= self._first_arg_params(fn, alias, m.end())
            for m in _STORE_RE.finditer(fn.body):
                init |= alias.get(m.group(1) or m.group(2), set())
            direct[id(fn)] = (alias, self._calls(fn))
            fn.acc, fn.init = acc, init
        for _ in range(len(fns) + 1):
            changed = False
            for fn in fns:
                alias, calls = direct[id(fn)]
                for callee, args, _ in calls:
                    for target in self.functions[callee]:
                        for j, arg in enumerate(args):
                            mine = set()
                            for ident in base_idents(arg):
                                mine |= alias.get(ident, set())
                            for i in mine:
                                if j in target.acc and i not in fn.acc:
                                    fn.acc[i] = target.acc[j]
                                    changed = True
                                if j in target.init and i not in fn.init:
                                    fn.init.add(i)
                                    changed = True
            if not changed:
                break

    def entries(self) -> Dict[str, CFunction]:
        return {name: group[0] for name, group in self.functions.items()
                if any(f.extern_c for f in group)}


_SOURCES: Dict[str, CSource] = {}


def c_source(path: str) -> CSource:
    path = os.path.normpath(path)
    if path not in _SOURCES:
        _SOURCES[path] = CSource(path)
    return _SOURCES[path]


# ---------------------------------------------------------------------------
# the Python side
# ---------------------------------------------------------------------------

def _module_assigns(mod: Module) -> Dict[str, ast.AST]:
    out: Dict[str, ast.AST] = {}
    for node in mod.tree.body:
        if not isinstance(node, ast.Assign):
            continue
        for tgt in node.targets:
            if isinstance(tgt, ast.Name):
                out[tgt.id] = node.value
            elif isinstance(tgt, ast.Tuple) and \
                    isinstance(node.value, ast.Tuple) and \
                    len(tgt.elts) == len(node.value.elts):
                for t, v in zip(tgt.elts, node.value.elts):
                    if isinstance(t, ast.Name):
                        out[t.id] = v
    return out


def _kinds(node: ast.AST, env: Dict[str, ast.AST], depth: int = 0
           ) -> Optional[List[str]]:
    """A ctypes argument list expression -> its kinds, or None."""
    if depth > 10:
        return None
    if isinstance(node, (ast.List, ast.Tuple)):
        out: List[str] = []
        for el in node.elts:
            k = _kinds(el, env, depth + 1)
            if k is None:
                return None
            out.extend(k)
        return out
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        a, b = _kinds(node.left, env, depth + 1), _kinds(node.right, env,
                                                         depth + 1)
        return None if a is None or b is None else a + b
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mult):
        for lst, n in ((node.left, node.right), (node.right, node.left)):
            if isinstance(n, ast.Constant) and isinstance(n.value, int):
                k = _kinds(lst, env, depth + 1)
                return None if k is None else k * n.value
        return None
    if isinstance(node, ast.Name):
        if node.id in env:
            return _kinds(env[node.id], env, depth + 1)
        kind = _CTYPES_KIND.get(node.id)
        return [kind] if kind else None
    if isinstance(node, ast.Attribute):
        kind = _CTYPES_KIND.get(node.attr)
        return [kind] if kind else None
    return None


def _source_path(mod: Module, node: ast.AST, env: Dict[str, ast.AST]
                 ) -> Optional[str]:
    """`Path(__file__).resolve().parent / "csrc" / "x.cu"` (or a name
    bound to it) -> the file it names."""
    if isinstance(node, ast.Name) and node.id in env:
        node = env[node.id]
    parts = []
    while isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
        if not (isinstance(node.right, ast.Constant) and
                isinstance(node.right.value, str)):
            return None
        parts.append(node.right.value)
        node = node.left
    if not parts:
        return None
    return os.path.join(os.path.dirname(mod.path), *reversed(parts))


@dataclasses.dataclass
class Library:
    module: Module
    source: CSource
    call: ast.Call
    signatures: Dict[str, Tuple[ast.AST, Optional[List[str]]]]


def find_libraries(index: PackageIndex) -> List[Library]:
    out = []
    for mod in index:
        env = _module_assigns(mod)
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call) and
                    (dotted_name(node.func) or "").rpartition(".")[2]
                    == "CudaLibrary" and len(node.args) >= 2):
                continue
            path = _source_path(mod, node.args[0], env)
            sigs = node.args[1]
            if path is None or not os.path.exists(path) or \
                    not isinstance(sigs, ast.Dict):
                continue
            table = {}
            for k, v in zip(sigs.keys, sigs.values):
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    table[k.value] = (k, _kinds(v, env))
            out.append(Library(mod, c_source(path), node, table))
    return out


def _check_signatures(lib: Library) -> List[Finding]:
    out = []
    entries = lib.source.entries()
    rel = os.path.basename(lib.source.path)
    for name, (key, kinds) in lib.signatures.items():
        def flag(msg, key=key):
            out.append(Finding(rule=RULE_SIG, path=lib.module.path,
                               line=key.lineno, col=key.col_offset,
                               message=msg))
        fn = entries.get(name)
        if fn is None:
            flag(f"`{name}` is declared for {rel} but no `extern \"C\"` "
                 f"function of that name is defined there — the load "
                 f"fails only on the card")
            continue
        if kinds is None:
            continue                               # not a literal list
        want = [p.kind for p in fn.params]
        if len(kinds) != len(want):
            flag(f"`{name}` declares {len(kinds)} arguments; "
                 f"{rel}:{fn.line} takes {len(want)} — ctypes passes "
                 f"them shifted, which only the card shows")
            continue
        bad = [f"#{i} {k} vs {w} `{p.name}`"
               for i, (k, w, p) in enumerate(zip(kinds, want, fn.params))
               if k != w]
        if bad:
            flag(f"`{name}`'s ctypes kinds disagree with {rel}:{fn.line} "
                 f"({'; '.join(bad)}) — a pointer cut to 32 bits or a "
                 f"float passed as an int fails only on the card")
    return out


def _ptr_name(arg: ast.AST) -> Optional[str]:
    """`t.data_ptr()` -> 't'."""
    if isinstance(arg, ast.Call) and isinstance(arg.func, ast.Attribute) \
            and arg.func.attr == "data_ptr" and \
            isinstance(arg.func.value, ast.Name):
        return arg.func.value.id
    return None


def _zeroed_by_value(value: ast.AST) -> bool:
    """An allocation whose values are set: torch.zeros*, new_zeros, or a
    chain ending in .zero_()/.fill_()."""
    if not isinstance(value, ast.Call):
        return False
    last = (dotted_name(value.func) or "").rpartition(".")[2]
    if isinstance(value.func, ast.Attribute):
        last = value.func.attr
    return last in _ZEROING_CALLS or last in _ZEROING_METHODS


def _statements(body: Sequence[ast.stmt]) -> List[ast.stmt]:
    """Every statement under `body`, in source order (nested blocks
    flattened; nested functions left out)."""
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


def _entry_calls(stmt: ast.stmt, entries: Dict[str, CFunction]):
    for node in ast.walk(stmt):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in entries:
            yield node


def _check_accumulators(mod: Module, entries: Dict[str, Tuple[CSource,
                                                              CFunction]]
                        ) -> List[Finding]:
    out: List[Finding] = []
    plain = {k: v[1] for k, v in entries.items()}
    funcs = [n for n in ast.walk(mod.tree)
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    for func in funcs:
        stmts = _statements(func.body)
        inited: Set[str] = set()         # names set by an earlier entry
        for k, st in enumerate(stmts):
            for call in _entry_calls(st, plain):
                src, cfn = entries[call.func.attr]
                needs = {i: ln for i, ln in cfn.acc.items()
                         if i not in cfn.init}
                for i, arg in enumerate(call.args):
                    name = _ptr_name(arg)
                    if name is None:
                        continue
                    if i in needs and name not in inited:
                        where = _unset_allocation(stmts[:k], name)
                        if where is not None:
                            out.append(Finding(
                                rule=RULE_ACC, path=mod.path,
                                line=where.lineno, col=where.col_offset,
                                message=(
                                    f"`{name}` is accumulated into by "
                                    f"`{call.func.attr}` (atomic at "
                                    f"{os.path.basename(src.path)}:"
                                    f"{needs[i]}) but is allocated without "
                                    f"values — use torch.zeros or .zero_() "
                                    f"(DESIGN.md §7)")))
                    if i in cfn.init:
                        inited.add(name)
    return out


def _unset_allocation(before: Sequence[ast.stmt], name: str
                      ) -> Optional[ast.AST]:
    """The statement that last bound `name` before the call, when it
    leaves the values unset (and nothing zeroes it after); else None."""
    bound, zeroed = None, False
    for st in before:
        if isinstance(st, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == name
                for t in st.targets):
            bound, zeroed = st, _zeroed_by_value(st.value)
        elif isinstance(st, ast.Expr) and isinstance(st.value, ast.Call) \
                and isinstance(st.value.func, ast.Attribute) \
                and st.value.func.attr in _ZEROING_METHODS \
                and isinstance(st.value.func.value, ast.Name) \
                and st.value.func.value.id == name:
            zeroed = True
    return None if bound is None or zeroed else bound


def check(index: PackageIndex) -> List[Finding]:
    libs = find_libraries(index)
    out: List[Finding] = []
    entries: Dict[str, Tuple[CSource, CFunction]] = {}
    for lib in libs:
        out.extend(_check_signatures(lib))
        for name, fn in lib.source.entries().items():
            if name in lib.signatures:
                entries[name] = (lib.source, fn)
    if entries:
        for mod in index:
            out.extend(_check_accumulators(mod, entries))
    return out
