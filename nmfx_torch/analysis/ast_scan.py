"""The linter's project model: modules, their functions and imports
(counterpart of ``nmfx/analysis/ast_scan.py``).

The project loader parses every ``.py`` file of the analyzed paths once;
each module records its function definitions (nested ones too, under
dotted qualnames), its ``from X import name`` bindings and its module
aliases, and :class:`Project` resolves an absolute import to the
analyzed module it names (by dotted-path suffix, so
``nmfx_torch.serve`` finds ``/any/prefix/nmfx_torch/serve.py``; an
import from outside the analyzed set resolves to nothing). The
concurrency rules build their typed call graph on this resolution.

The reference's traced-code set (what ``jax.jit``, ``vmap`` and
``pallas_call`` reach) becomes the hot path: the port traces nothing,
and what runs once an iteration or a check is what the host loops reach.
Its roots are :data:`HOT_ROOTS` (the slot scheduler's trips, the batched
restart route's check blocks and the tiled pool's passes); each function
records the names it calls, and :class:`Project` resolves them through
the imports (the reference's ``_resolve``) and walks the call graph from
the roots (its ``_compute_traced``). NMFX004 and NMFX005 read it.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from collections import deque
from typing import Iterable


def _attr_tail(node: ast.AST) -> "str | None":
    """``a.b.c`` -> "c"; bare name -> itself; else None."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _dotted(node: ast.AST) -> "str | None":
    """``a.b.c`` -> "a.b.c" when every link is a Name/Attribute."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def own_nodes(stmt: ast.stmt) -> "list[ast.AST]":
    """The statement's own subtree — header expressions included, nested
    statement lists excluded. Statement-ordered rules (the NMFX012-015
    concurrency scans) flatten compound statements into source order;
    walking the full subtree at the compound's position would process
    nested events out of order.

    Memoized on the node (one project is one parse) and pruned at the
    excluded statement lists. Returns in ``ast.walk`` (breadth-first)
    order."""
    cached = getattr(stmt, "_nmfx_own_nodes", None)
    if cached is not None:
        return cached
    skip: "set[int]" = set()
    for field in ("body", "orelse", "finalbody"):
        children = getattr(stmt, field, None)
        if isinstance(children, list):
            skip.update(id(c) for c in children)
    skip.update(id(h) for h in getattr(stmt, "handlers", []) or [])
    out: "list[ast.AST]" = []
    queue: "deque[ast.AST]" = deque([stmt])
    while queue:
        node = queue.popleft()
        out.append(node)
        for child in ast.iter_child_nodes(node):
            if id(child) not in skip:
                queue.append(child)
    stmt._nmfx_own_nodes = out
    return out


def stores(stmt: ast.stmt) -> "set[str]":
    """Names (re)bound at the statement's own level."""
    return {node.id for node in own_nodes(stmt)
            if isinstance(node, ast.Name)
            and isinstance(node.ctx, (ast.Store, ast.Del))}


#: the hot path's roots, (module path suffix, function qualname): the
#: slot scheduler's trip loop (``mu_sched``, its trips and ragged stage
#: nested in it), the check blocks of the batched restart route and the
#: tiled pool's pass loop. What they reach runs once an iteration or a
#: check on every kernel and plain route of a sweep
HOT_ROOTS = (("nmfx_torch/ops/sched_mu.py", "mu_sched"),
             ("nmfx_torch/solvers/base.py", "run_loop_batched"),
             ("nmfx_torch/tiles.py", "run_tiled_pool"))


@dataclasses.dataclass
class FunctionInfo:
    """One (possibly nested) function definition."""

    module: "ModuleInfo"
    qualname: str  # "outer.inner" style, dots only
    node: ast.AST  # FunctionDef | AsyncFunctionDef | Lambda
    #: names of directly nested function defs
    nested: "set[str]" = dataclasses.field(default_factory=set)
    #: (base, tail) call/reference edges out of this function's body:
    #: base None = bare name, "" = attribute on a non-name expression,
    #: "<ref>" = a bare name passed as an argument (a function value in a
    #: callback position), else the leading name of a dotted call
    calls: "set[tuple]" = dataclasses.field(default_factory=set)

    @property
    def name(self) -> str:
        return self.qualname.rsplit(".", 1)[-1]

    @property
    def line(self) -> int:
        return getattr(self.node, "lineno", 1)


@dataclasses.dataclass
class ModuleInfo:
    path: str  # as given (project-relative when invoked that way)
    text: str
    tree: ast.Module
    functions: "dict[str, FunctionInfo]" = dataclasses.field(
        default_factory=dict)
    #: local name -> (source module dotted path, original name) for
    #: ``from X import name [as alias]``
    from_imports: "dict[str, tuple[str, str]]" = dataclasses.field(
        default_factory=dict)
    #: local alias -> dotted module for ``import X [as Y]`` and
    #: ``from pkg import submodule`` (resolved against the analyzed set)
    module_aliases: "dict[str, str]" = dataclasses.field(
        default_factory=dict)


def _collect_imports(mod: ModuleInfo) -> None:
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.asname:
                    mod.module_aliases[alias.asname] = alias.name
                else:
                    # `import a.b` binds the top-level name `a` (to
                    # module a, not a.b)
                    top = alias.name.split(".")[0]
                    mod.module_aliases[top] = top
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            src = node.module or ""
            for alias in node.names:
                local = alias.asname or alias.name
                mod.from_imports[local] = (src, alias.name)
                # `from pkg import submodule` doubles as a module alias
                mod.module_aliases.setdefault(local,
                                              f"{src}.{alias.name}")


class _FunctionCollector(ast.NodeVisitor):
    """Collect every function definition (lambdas included) with its
    qualname and its directly nested definitions."""

    def __init__(self, module: ModuleInfo):
        self.module = module
        self.stack: "list[FunctionInfo]" = []

    def _handle_def(self, node, name: str):
        qual = (self.stack[-1].qualname + "." + name if self.stack
                else name)
        info = FunctionInfo(module=self.module, qualname=qual, node=node)
        if self.stack:
            self.stack[-1].nested.add(name)
        self.module.functions[qual] = info
        self.stack.append(info)
        for child in ast.iter_child_nodes(node):
            self.visit(child)
        self.stack.pop()

    def visit_FunctionDef(self, node):
        self._handle_def(node, node.name)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        self._handle_def(node, f"<lambda@{node.lineno}>")

    def visit_Call(self, node):
        # a nested def's calls are credited to every enclosing function:
        # running the outer function runs the closures it builds
        callee = _attr_tail(node.func)
        if callee:
            base = None
            if isinstance(node.func, ast.Attribute):
                dotted = _dotted(node.func)
                base = dotted.split(".")[0] if dotted else ""
            for fn in self.stack:
                fn.calls.add((base, callee))
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            if isinstance(arg, ast.Name):
                for fn in self.stack:
                    fn.calls.add(("<ref>", arg.id))
        self.generic_visit(node)


def parse_module(path: str, text: "str | None" = None) -> ModuleInfo:
    if text is None:
        with open(path, encoding="utf-8") as f:
            text = f.read()
    tree = ast.parse(text, filename=path)
    mod = ModuleInfo(path=path, text=text, tree=tree)
    _collect_imports(mod)
    _FunctionCollector(mod).visit(tree)
    return mod


def _dotted_module(path: str) -> "tuple[str, ...]":
    """Path -> dotted-name segments for import matching:
    ``a/b/nmfx_torch/ops/sched_mu.py`` ->
    ("a", "b", "nmfx_torch", "ops", "sched_mu"); ``__init__.py``
    collapses onto its package."""
    norm = path.replace("\\", "/").rstrip("/")
    if norm.endswith(".py"):
        norm = norm[:-3]
    parts = tuple(p for p in norm.split("/") if p and p != ".")
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return parts


class Project:
    """The analyzed file set, its import resolution and the hot path."""

    def __init__(self, modules: "list[ModuleInfo]"):
        self.modules = modules
        #: simple name -> functions bearing it, across the project
        self.by_name: "dict[str, list[FunctionInfo]]" = {}
        for mod in modules:
            for fn in mod.functions.values():
                self.by_name.setdefault(fn.name, []).append(fn)
        #: dotted-segment tuple -> module, for import resolution
        self._by_dotted = {_dotted_module(m.path): m for m in modules}
        #: id()s of the hot path's functions
        self.hot_ids = self.reachable(self.roots(HOT_ROOTS))

    def _module_for(self, dotted: str) -> "ModuleInfo | None":
        """The analyzed module an absolute import refers to, matched by
        dotted-path suffix. None = external (torch, numpy, stdlib)."""
        want = tuple(dotted.split("."))
        for segs, mod in self._by_dotted.items():
            if segs[-len(want):] == want:
                return mod
        return None

    def roots(self, specs) -> "list[FunctionInfo]":
        """The functions ``(module path suffix, qualname)`` names in the
        analyzed set (a root outside it is skipped)."""
        out = []
        for suffix, qual in specs:
            want = _dotted_module(suffix)
            for mod in self.modules:
                segs = _dotted_module(mod.path)
                if segs[-len(want):] == want and qual in mod.functions:
                    out.append(mod.functions[qual])
        return out

    def _resolve(self, caller: FunctionInfo, base: "str | None",
                 tail: str) -> "list[FunctionInfo]":
        """The functions a call edge may reach (the reference's
        ``Project._resolve``): a bare name through the caller's module
        and its imports, a module alias's attribute through the module it
        names; a method of an ordinary variable falls back to every
        function of that name (over-approximate, reviewable)."""
        mod = caller.module
        if base is None or base == "<ref>":
            local = [f for f in mod.functions.values() if f.name == tail]
            if local:
                return local
            if tail in mod.from_imports:
                src, orig = mod.from_imports[tail]
                target = self._module_for(src)
                if target is None:
                    return []  # imported from outside the analyzed set
                return [f for f in target.functions.values()
                        if f.name == orig]
            # a direct call of an unresolved bare name falls back to
            # every bearer; a mere reference does not (data names collide
            # with function names too often)
            return [] if base == "<ref>" else self.by_name.get(tail, [])
        if base in mod.module_aliases:
            target = self._module_for(mod.module_aliases[base])
            if target is None:
                return []  # torch.where, np.sum, os.environ: not ours
            return [f for f in target.functions.values()
                    if f.name == tail]
        return self.by_name.get(tail, [])

    def reachable(self, roots) -> "set[int]":
        """id()s of the functions reachable from ``roots`` over nested
        defs and resolved call edges (the reference's
        ``_compute_traced``; identity, since qualnames collide across
        modules)."""
        work = list(roots)
        seen = {id(fn) for fn in work}
        while work:
            fn = work.pop()
            edges = [(None, n) for n in fn.nested] + sorted(
                fn.calls, key=lambda e: (str(e[0]), e[1]))
            for base, tail in edges:
                for cand in self._resolve(fn, base, tail):
                    if id(cand) not in seen:
                        seen.add(id(cand))
                        work.append(cand)
        return seen

    def functions_in(self, ids: "set[int]") -> "list[FunctionInfo]":
        """The analyzed functions whose id() is in ``ids``, in module
        and definition order."""
        return [fn for mod in self.modules for fn in mod.functions.values()
                if id(fn) in ids]

    def hot_functions(self) -> "list[FunctionInfo]":
        return self.functions_in(self.hot_ids)


def collect_paths(paths: "Iterable[str]") -> "list[str]":
    """Expand files/directories into a sorted .py file list (skips
    __pycache__ and hidden directories). A path that exists as neither
    raises: a mistyped lint target must fail, not lint nothing."""
    out = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d != "__pycache__"
                                 and not d.startswith("."))
                out.extend(os.path.join(root, f) for f in sorted(files)
                           if f.endswith(".py"))
        elif p.endswith(".py") and os.path.isfile(p):
            out.append(p)
        else:
            raise FileNotFoundError(
                f"lint target {p!r} is neither a directory nor an "
                "existing .py file")
    return out


def load_project(paths: "Iterable[str]") -> Project:
    return Project([parse_module(p) for p in collect_paths(paths)])
