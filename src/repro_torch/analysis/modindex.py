"""Package index: parsed modules, resolved imports, cross-module symbols.

Builds the shared substrate every rule walks:

* one `ast` tree + suppression table per module;
* every `import`/`from ... import` resolved to absolute dotted names
  (relative imports resolved against the module's package), with the
  source location — the R1 layer walker consumes these;
* a per-module symbol table (top-level functions, assignments, import
  bindings) plus transitive re-export following, so the R4 call-graph
  can resolve `from repro_torch.core.engine import run_root` through the
  package `__init__` down to the defining `FunctionDef`.

The port's copy of the reference's `repro.analysis.modindex`; stdlib-only
on purpose (see findings.py).
"""
from __future__ import annotations

import ast
import dataclasses
import os
from typing import Dict, Iterator, List, Optional, Tuple

from repro_torch.analysis.findings import Suppressions


@dataclasses.dataclass(frozen=True)
class ImportRecord:
    """One imported dotted target with its source location.

    `module` is the imported module path; `symbol` the name taken from it
    (None for plain `import x.y`). `candidates` lists the dotted names a
    layer rule should test: for `from a.b import c` both `a.b` and
    `a.b.c` — `c` may be a submodule (the dead-kernel bug's exact form)
    or a function, and the walker cannot always tell, so both are
    checked.
    """
    module: str
    symbol: Optional[str]
    lineno: int
    col: int

    @property
    def candidates(self) -> Tuple[str, ...]:
        if self.symbol is None:
            return (self.module,)
        return (self.module, f"{self.module}.{self.symbol}")


@dataclasses.dataclass
class Module:
    name: str                 # dotted: repro_torch.core.engine.loop
    path: str                 # filesystem path as given to the CLI
    relpath: str              # posix path relative to the package root
    tree: ast.Module
    source: str
    suppressions: Suppressions
    imports: List[ImportRecord] = dataclasses.field(default_factory=list)
    # top-level bindings: name -> ("func", FunctionDef) | ("assign", Assign)
    #                          | ("module", dotted) | ("ref", dotted)
    symbols: Dict[str, Tuple[str, object]] = dataclasses.field(
        default_factory=dict)

    @property
    def package(self) -> str:
        """Dotted package the module's relative imports resolve against."""
        if self.name.endswith("__init__") or self.is_package:
            return self.name
        return self.name.rpartition(".")[0]

    @property
    def is_package(self) -> bool:
        return os.path.basename(self.path) == "__init__.py"


def _module_name(relpath: str, package: str) -> str:
    parts = relpath.replace(os.sep, "/").split("/")
    parts[-1] = parts[-1][:-3]                      # strip .py
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join([package] + [p for p in parts if p])


def _collect_imports(mod: Module) -> None:
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                mod.imports.append(ImportRecord(
                    module=alias.name, symbol=None,
                    lineno=node.lineno, col=node.col_offset))
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:                          # relative import
                pkg_parts = mod.package.split(".")
                up = node.level - 1
                if up:
                    pkg_parts = pkg_parts[:-up] if up < len(pkg_parts) else []
                base = ".".join(pkg_parts + ([node.module]
                                             if node.module else []))
            for alias in node.names:
                if alias.name == "*":
                    mod.imports.append(ImportRecord(
                        module=base, symbol=None,
                        lineno=node.lineno, col=node.col_offset))
                else:
                    mod.imports.append(ImportRecord(
                        module=base, symbol=alias.name,
                        lineno=node.lineno, col=node.col_offset))


def _collect_symbols(mod: Module) -> None:
    for node in mod.tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            mod.symbols[node.name] = ("func", node)
        elif isinstance(node, ast.ClassDef):
            mod.symbols[node.name] = ("class", node)
        elif isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    mod.symbols[tgt.id] = ("assign", node)
        elif isinstance(node, ast.Import):
            for alias in node.names:
                bound = alias.asname or alias.name.partition(".")[0]
                target = alias.name if alias.asname else \
                    alias.name.partition(".")[0]
                mod.symbols[bound] = ("module", target)
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                pkg_parts = mod.package.split(".")
                up = node.level - 1
                if up:
                    pkg_parts = pkg_parts[:-up] if up < len(pkg_parts) else []
                base = ".".join(pkg_parts + ([node.module]
                                             if node.module else []))
            for alias in node.names:
                if alias.name == "*":
                    continue
                mod.symbols[alias.asname or alias.name] = (
                    "ref", f"{base}.{alias.name}")


class PackageIndex:
    """All modules of one package, with cross-module resolution."""

    def __init__(self, package: str):
        self.package = package
        self.modules: Dict[str, Module] = {}      # dotted name -> Module

    @staticmethod
    def build(root: str, package: Optional[str] = None) -> "PackageIndex":
        """Parse every .py under `root` (the package directory itself)."""
        root = os.path.normpath(root)
        if package is None:
            package = os.path.basename(root)
        index = PackageIndex(package)
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames.sort()
            for name in sorted(filenames):
                if not name.endswith(".py"):
                    continue
                path = os.path.join(dirpath, name)
                relpath = os.path.relpath(path, root).replace(os.sep, "/")
                with open(path, encoding="utf-8") as f:
                    source = f.read()
                try:
                    tree = ast.parse(source, filename=path)
                except SyntaxError:
                    continue                       # not this tool's job
                mod = Module(name=_module_name(relpath, package), path=path,
                             relpath=relpath, tree=tree, source=source,
                             suppressions=Suppressions(source))
                _collect_imports(mod)
                _collect_symbols(mod)
                index.modules[mod.name] = mod
        return index

    def __iter__(self) -> Iterator[Module]:
        return iter(self.modules.values())

    # ---- cross-module function resolution (R4 call graph) ----------------

    def resolve_symbol(self, dotted: str, _depth: int = 0
                       ) -> Optional[Tuple[Module, ast.AST]]:
        """Resolve `repro_torch.a.b.sym` to (defining module, FunctionDef).

        Follows `from x import y` re-export chains (package __init__
        indirection) up to a small depth; returns None for anything it
        cannot pin to a function/class definition.
        """
        if _depth > 8:
            return None
        if dotted in self.modules:
            return None                            # a module, not a symbol
        mod_name, _, sym = dotted.rpartition(".")
        mod = self.modules.get(mod_name)
        if mod is None:
            return None
        entry = mod.symbols.get(sym)
        if entry is None:
            return None
        kind, val = entry
        if kind in ("func", "class", "assign"):
            return mod, val                        # type: ignore[return-value]
        if kind == "ref":
            return self.resolve_symbol(val, _depth + 1)  # type: ignore[arg-type]
        if kind == "module":
            return None
        return None

    def resolve_call_target(self, mod: Module, func: ast.AST,
                            local: Optional[Dict[str, ast.AST]] = None
                            ) -> Optional[Tuple[Module, ast.AST]]:
        """Resolve a Call.func expression to a FunctionDef if possible.

        `local` maps names in the current scope to nested FunctionDefs
        (inner helpers passed to while_loop etc.).
        """
        if isinstance(func, ast.Name):
            if local and func.id in local:
                return mod, local[func.id]
            entry = mod.symbols.get(func.id)
            if entry is None:
                return None
            kind, val = entry
            if kind in ("func", "class", "assign"):
                return mod, val                    # type: ignore[return-value]
            if kind == "ref":
                return self.resolve_symbol(val)    # type: ignore[arg-type]
            return None
        if isinstance(func, ast.Attribute):
            base = dotted_name(func)
            if base is None:
                return None
            head, _, rest = base.partition(".")
            entry = mod.symbols.get(head)
            if entry and entry[0] == "module":
                return self.resolve_symbol(f"{entry[1]}.{rest}")
            if entry and entry[0] == "ref" and rest:
                return self.resolve_symbol(f"{entry[1]}.{rest}")
            return None
        return None


def dotted_name(node: ast.AST) -> Optional[str]:
    """`a.b.c` attribute chain -> 'a.b.c'; None if not a pure name chain."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(node: ast.Call) -> Optional[str]:
    """Dotted name of a call's callee ('torch.zeros', 'x.item', ...)."""
    return dotted_name(node.func)


def name_endswith(node: ast.Call, *suffixes: str) -> bool:
    """True if the callee's dotted name ends with any suffix (module-alias
    agnostic: matches `torch.zeros`, `th.zeros`, bare `zeros`)."""
    name = call_name(node)
    if name is None:
        return False
    last = name.rpartition(".")[2]
    return last in suffixes
