"""Shared concurrency model for the NMFX012-015 rules.

One pass over the project builds everything the four concurrency rules
need — threaded classes with their lock inventory, ``@guarded_by``
declarations, per-method lock-scope events (statement-ordered, with
``Condition`` aliasing, local lock aliases, and ``acquire``/``release``
tracking), a typed cross-class call graph, the interprocedural
held-at-entry fixpoint for private helpers, and the static
lock-acquisition order graph. The model is memoized on the
:class:`~nmfx_torch.analysis.ast_scan.Project` so the rules share it
(the graph is built once a run, not once a rule).

Resolution policy: the lock graph uses TYPED call edges only —
``self.m()``, ``self.attr.m()``/``name.m()`` where the receiver's class
is known from a constructor assignment, an ``AnnAssign`` annotation, or
an annotated parameter, and bare/imported module-level functions. No
by-name fallback: a false lock edge would invent deadlock cycles the
code cannot execute, and the runtime witness
(``nmfx_torch/analysis/witness.py``) covers the under-approximation by
feeding observed acquisition orders back into a completeness test.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Iterable

from nmfx_torch.analysis.ast_scan import ModuleInfo, Project, _attr_tail

#: constructors that create a lock object
_LOCK_CTORS = {"Lock": False, "RLock": True, "Condition": True,
               "Semaphore": False, "BoundedSemaphore": False}


def _mod_stem(mod: ModuleInfo) -> str:
    base = os.path.basename(mod.path)
    return base[:-3] if base.endswith(".py") else base


def _const_str(node: ast.AST) -> "str | None":
    return node.value if (isinstance(node, ast.Constant)
                          and isinstance(node.value, str)) else None


def _self_attr(node: ast.AST) -> "str | None":
    """``self.x`` -> "x", else None."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


@dataclasses.dataclass
class LockInfo:
    """One lock object: an instance attribute of a class, or a
    module-level global."""

    key: str                 # graph node id, e.g. "serve.NMFXServer._lock"
    attr: str                # attribute / global name
    reentrant: bool
    site: "tuple[str, int]"  # (path, lineno) of the creation call
    #: a Condition built on another declared lock IS that lock — its
    #: key aliases the underlying one and this records the surface name
    alias_of: "str | None" = None


@dataclasses.dataclass
class FutureCreation:
    """One ``Future()`` (or Future-subclass) construction site."""

    line: int
    name: "str | None"       # local name it is bound to (None = unbound)
    published_line: "int | None" = None  # first store into attr/subscript
    disposed: bool = False   # returned / stored / passed / resolved
    gap_line: "int | None" = None  # risky stmt in a published-unresolved gap


@dataclasses.dataclass
class ThreadStart:
    """One ``threading.Thread(...)`` / ``Timer(...)`` construction."""

    line: int
    kind: str                # "Thread" | "Timer"
    daemon: bool
    name: "str | None"       # local binding, if any
    stored_attr: "str | None" = None   # self.<attr> = t / self.<attr>.append(t)
    container: bool = False  # stored via .append / subscript
    joined: bool = False


@dataclasses.dataclass
class MethodModel:
    """Per-function lock-scope analysis results."""

    qual: str                # "ClassName.meth" or "func"
    node: ast.AST
    #: guarded-attr accesses: (attr, line, frozenset(held keys), nested)
    accesses: "list[tuple]" = dataclasses.field(default_factory=list)
    #: module_guarded() global accesses: (name, line, held keys, nested)
    global_accesses: "list[tuple]" = dataclasses.field(
        default_factory=list)
    #: lock acquisitions: (frozenset(held keys), key, line)
    acquisitions: "list[tuple]" = dataclasses.field(default_factory=list)
    #: typed call events: (frozenset(held keys), callee function id, line)
    calls: "list[tuple]" = dataclasses.field(default_factory=list)
    #: class-internal self.m() sites: (callee name, frozenset(held ATTR
    #: names of this class's locks))
    self_calls: "list[tuple]" = dataclasses.field(default_factory=list)
    #: self.m references without a call (callback positions)
    self_refs: "set[str]" = dataclasses.field(default_factory=set)
    futures: "list[FutureCreation]" = dataclasses.field(
        default_factory=list)
    threads: "list[ThreadStart]" = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ClassModel:
    name: str
    module: ModuleInfo
    node: ast.ClassDef
    methods: "dict[str, ast.FunctionDef]" = dataclasses.field(
        default_factory=dict)
    locks: "dict[str, LockInfo]" = dataclasses.field(default_factory=dict)
    #: guarded attr -> owning lock attr (from @guarded_by decorators)
    guarded: "dict[str, str]" = dataclasses.field(default_factory=dict)
    #: self.<attr> -> ClassModel, inferred from constructor assignments
    #: and annotations
    attr_types: "dict[str, 'ClassModel']" = dataclasses.field(
        default_factory=dict)
    #: method -> lock ATTR names provably held at entry (private-helper
    #: fixpoint over in-class call sites)
    entry_held: "dict[str, frozenset]" = dataclasses.field(
        default_factory=dict)
    #: join()/cancel() receivers seen anywhere in the class:
    #: self.<attr> names whose threads are joined on some path
    joined_attrs: "set[str]" = dataclasses.field(default_factory=set)
    #: method names called from OUTSIDE the class through a typed
    #: receiver — their entry-held answer must stay empty
    external_calls: "set[str]" = dataclasses.field(default_factory=set)

    @property
    def key_prefix(self) -> str:
        return f"{_mod_stem(self.module)}.{self.name}"

    def lock_key(self, attr: str) -> "str | None":
        li = self.locks.get(attr)
        if li is None:
            return None
        return li.key


@dataclasses.dataclass
class ConcurrencyModel:
    project: Project
    classes: "dict[tuple, ClassModel]" = dataclasses.field(
        default_factory=dict)   # (module path, class name) -> model
    by_class_name: "dict[str, list]" = dataclasses.field(
        default_factory=dict)
    #: module path -> {global name -> LockInfo}
    module_locks: "dict[str, dict]" = dataclasses.field(
        default_factory=dict)
    #: module path -> {lock global -> guarded global names} from
    #: module_guarded(...) top-level calls
    module_guarded: "dict[str, dict]" = dataclasses.field(
        default_factory=dict)
    #: function id (module path, qual) -> MethodModel
    functions: "dict[tuple, MethodModel]" = dataclasses.field(
        default_factory=dict)
    #: function id -> transitively acquired lock keys
    acquires: "dict[tuple, frozenset]" = dataclasses.field(
        default_factory=dict)
    #: lock key -> LockInfo
    lock_index: "dict[str, LockInfo]" = dataclasses.field(
        default_factory=dict)
    #: directed order edges: (held key, acquired key) -> (path, line)
    #: of the first acquisition/call site that creates the edge
    order_edges: "dict[tuple, tuple]" = dataclasses.field(
        default_factory=dict)

    #: memoized module-level singleton types, keyed by module path
    inst_types: "dict[str, dict]" = dataclasses.field(
        default_factory=dict)

    def _instance_type(self, mod: ModuleInfo,
                       name: str) -> "ClassModel | None":
        """Type of a module-level singleton (``_flight =
        FlightRecorder(...)``), followed through ``from X import``."""
        types = self.inst_types.get(mod.path)
        if types is None:
            types = _module_instance_types(self, mod)
            self.inst_types[mod.path] = types
        if name in types:
            return types[name]
        if name in mod.from_imports:
            src, orig = mod.from_imports[name]
            target = self.project._module_for(src)
            if target is not None and target.path != mod.path:
                return self._instance_type(target, orig)
        return None

    def class_of(self, mod: ModuleInfo, name: str) -> "ClassModel | None":
        """Resolve a class name seen in ``mod`` — local definition
        first, then through ``from X import name``."""
        cm = self.classes.get((mod.path, name))
        if cm is not None:
            return cm
        if name in mod.from_imports:
            src, orig = mod.from_imports[name]
            target = self.project._module_for(src)
            if target is not None:
                return self.classes.get((target.path, orig))
        return None


# ---------------------------------------------------------------------------
# collection

def _guarded_from_decorators(cls: ast.ClassDef) -> "dict[str, str]":
    """Read stacked ``@guarded_by("_lock", "a", "b")`` decorators
    syntactically (no import needed in fixture files)."""
    guarded: "dict[str, str]" = {}
    for dec in cls.decorator_list:
        if not (isinstance(dec, ast.Call)
                and _attr_tail(dec.func) == "guarded_by"
                and dec.args):
            continue
        lock = _const_str(dec.args[0])
        if lock is None:
            continue
        for arg in dec.args[1:]:
            attr = _const_str(arg)
            if attr is not None:
                guarded[attr] = lock
    return guarded


def _lock_ctor(call: ast.AST) -> "tuple[str, bool] | None":
    """``threading.Lock()`` / ``Lock()`` etc -> (ctor name, reentrant)."""
    if not isinstance(call, ast.Call):
        return None
    tail = _attr_tail(call.func)
    if tail in _LOCK_CTORS:
        return tail, _LOCK_CTORS[tail]
    return None


def _collect_class(model: ConcurrencyModel, mod: ModuleInfo,
                   node: ast.ClassDef) -> ClassModel:
    cm = ClassModel(name=node.name, module=mod, node=node,
                    guarded=_guarded_from_decorators(node))
    for item in node.body:
        if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            cm.methods[item.name] = item
    # lock inventory + attr types, from every method (locks are almost
    # always created in __init__, but a lazy _ensure_started counts too)
    for meth in cm.methods.values():
        for stmt in ast.walk(meth):
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
                attr = _self_attr(stmt.targets[0])
                if attr is None:
                    continue
                ctor = _lock_ctor(stmt.value)
                if ctor is not None:
                    name, reentrant = ctor
                    alias = None
                    if name == "Condition" and stmt.value.args:
                        alias = _self_attr(stmt.value.args[0])
                    cm.locks[attr] = LockInfo(
                        key=f"{cm.key_prefix}.{attr}", attr=attr,
                        reentrant=reentrant,
                        site=(mod.path, stmt.lineno), alias_of=alias)
            elif isinstance(stmt, ast.AnnAssign):
                attr = _self_attr(stmt.target)
                if attr is not None:
                    ann = stmt.annotation
                    tname = (_const_str(ann)
                             if isinstance(ann, ast.Constant)
                             else (ann.id if isinstance(ann, ast.Name)
                                   else None))
                    if tname:
                        cm.attr_types.setdefault(attr, tname)  # raw name
    # Condition(self._lock) aliases: collapse onto the underlying lock's
    # key so "holding the condition" and "holding the lock" are one node
    for li in cm.locks.values():
        if li.alias_of and li.alias_of in cm.locks:
            base = cm.locks[li.alias_of]
            li.key = base.key
            li.reentrant = base.reentrant
    return cm


class _Ctx:
    """Resolution context for one function body scan."""

    def __init__(self, model: ConcurrencyModel, mod: ModuleInfo,
                 cls: "ClassModel | None"):
        self.model = model
        self.mod = mod
        self.cls = cls
        #: guarded global name -> owning module-level lock name
        self.mod_guarded: "dict[str, str]" = {
            name: lock
            for lock, names in model.module_guarded.get(mod.path,
                                                        {}).items()
            for name in names}
        #: local name -> lock key ("l = self._lock", "with X as l")
        self.lock_aliases: "dict[str, str]" = {}
        #: local name -> ClassModel ("obj = ClassName(...)", annotations)
        self.local_types: "dict[str, ClassModel]" = {}

    def lock_key_of(self, expr: ast.AST) -> "str | None":
        attr = _self_attr(expr)
        if attr is not None and self.cls is not None:
            return self.cls.lock_key(attr)
        if isinstance(expr, ast.Name):
            if expr.id in self.lock_aliases:
                return self.lock_aliases[expr.id]
            li = self.model.module_locks.get(self.mod.path, {}).get(
                expr.id)
            if li is not None:
                return li.key
        return None

    def class_lock_attr(self, expr: ast.AST) -> "str | None":
        """``self._cond`` -> "_lock" (alias-resolved attr name of THIS
        class's lock), for the entry-held fixpoint."""
        attr = _self_attr(expr)
        if attr is None or self.cls is None:
            return None
        li = self.cls.locks.get(attr)
        if li is None:
            return None
        return li.alias_of if li.alias_of in self.cls.locks else attr


def _future_names(mod: ModuleInfo) -> "set[str]":
    """Names that construct a Future in this module: ``Future`` itself
    plus in-module subclasses (transitively)."""
    names = {"Future"}
    changed = True
    while changed:
        changed = False
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ClassDef) and node.name not in names:
                if any(_attr_tail(b) in names for b in node.bases):
                    names.add(node.name)
                    changed = True
    return names


class _BodyScan:
    """Statement-ordered lock-scope walker over one function body."""

    def __init__(self, ctx: _Ctx, out: MethodModel,
                 entry_held_keys: "frozenset[str]",
                 entry_held_attrs: "frozenset[str]",
                 future_ctors: "set[str]"):
        self.ctx = ctx
        self.out = out
        self.future_ctors = future_ctors
        self.entry_keys = set(entry_held_keys)
        self.entry_attrs = set(entry_held_attrs)

    # -- expression-level event extraction ---------------------------------
    def _scan_expr_events(self, stmt: ast.stmt, held: "set[str]",
                          held_attrs: "set[str]", nested: bool) -> None:
        from nmfx_torch.analysis.ast_scan import own_nodes

        ctx, out = self.ctx, self.out
        hk = frozenset(held | self.entry_keys)
        ha = frozenset(held_attrs | self.entry_attrs)
        # a lambda body (done-callbacks, sort keys) runs LATER on an
        # unknown thread — locks held lexically here are not held then
        deferred: "set[int]" = set()
        for node in own_nodes(stmt):
            if isinstance(node, ast.Lambda):
                deferred.update(id(sub) for sub in ast.walk(node.body))
        empty = frozenset()
        for node in own_nodes(stmt):
            later = id(node) in deferred
            nhk = empty if later else hk
            nha = empty if later else ha
            nnested = nested or later
            if isinstance(node, ast.Attribute):
                attr = _self_attr(node)
                if (attr is not None and ctx.cls is not None
                        and attr in ctx.cls.guarded):
                    out.accesses.append(
                        (attr, node.lineno, nhk, nnested))
            if (isinstance(node, ast.Name)
                    and node.id in ctx.mod_guarded):
                out.global_accesses.append(
                    (node.id, node.lineno, nhk, nnested))
            if not isinstance(node, ast.Call):
                continue
            tail = _attr_tail(node.func)
            # explicit acquire()/release() on a recognized lock
            if (tail in ("acquire", "release")
                    and isinstance(node.func, ast.Attribute)):
                key = ctx.lock_key_of(node.func.value)
                if key is not None:
                    if tail == "acquire":
                        out.acquisitions.append((nhk, key, node.lineno))
                    continue
            # typed call edges (for the lock graph)
            callee = self._resolve_call(node)
            if callee is not None:
                out.calls.append((nhk, callee, node.lineno))
            # in-class call / reference bookkeeping (entry-held fixpoint)
            if ctx.cls is not None:
                sa = _self_attr(node.func)
                if sa is not None and sa in ctx.cls.methods:
                    out.self_calls.append((sa, nha))
        # self.m references outside call position -> callback escape
        if ctx.cls is not None:
            called = {id(n.func) for n in own_nodes(stmt)
                      if isinstance(n, ast.Call)}
            for node in own_nodes(stmt):
                if (isinstance(node, ast.Attribute)
                        and id(node) not in called):
                    sa = _self_attr(node)
                    if sa is not None and sa in ctx.cls.methods:
                        out.self_refs.add(sa)

    def _resolve_call(self, node: ast.Call) -> "tuple | None":
        """Typed resolution of a call to a project function id —
        (module path, "Class.meth") / (module path, "func"); None when
        the receiver's type is unknown (deliberate under-approximation,
        see module docstring)."""
        ctx = self.ctx
        func = node.func
        if isinstance(func, ast.Name):
            name = func.id
            # constructor of a known class -> its __init__
            cm = ctx.model.class_of(ctx.mod, name)
            if cm is not None:
                if "__init__" in cm.methods:
                    return (cm.module.path, f"{cm.name}.__init__")
                return None
            # module-level function (local or from-imported)
            if name in ctx.mod.functions:
                return (ctx.mod.path, name)
            if name in ctx.mod.from_imports:
                src, orig = ctx.mod.from_imports[name]
                target = ctx.model.project._module_for(src)
                if target is not None and orig in target.functions:
                    return (target.path, orig)
            return None
        if not isinstance(func, ast.Attribute):
            return None
        meth = func.attr
        recv = func.value
        sa = _self_attr(recv)
        if sa is not None and ctx.cls is not None:
            # self.m() handled by self_calls; here: self.attr.m()
            tcm = ctx.cls.attr_types.get(sa)
            if isinstance(tcm, ClassModel) and meth in tcm.methods:
                return (tcm.module.path, f"{tcm.name}.{meth}")
            return None
        if isinstance(recv, ast.Attribute):
            sa2 = _self_attr(recv.value)
            if sa2 is None:
                return None
        if isinstance(recv, ast.Name):
            base = recv.id
            if base == "self" and ctx.cls is not None:
                if meth in ctx.cls.methods:
                    return (ctx.mod.path, f"{ctx.cls.name}.{meth}")
                return None
            # typed local / module-level instance / module alias
            tcm = ctx.local_types.get(base)
            if tcm is not None and meth in tcm.methods:
                return (tcm.module.path, f"{tcm.name}.{meth}")
            inst = ctx.model._instance_type(ctx.mod, base)
            if inst is not None and meth in inst.methods:
                return (inst.module.path, f"{inst.name}.{meth}")
            if base in ctx.mod.module_aliases:
                target = ctx.model.project._module_for(
                    ctx.mod.module_aliases[base])
                if target is not None and meth in target.functions:
                    return (target.path, meth)
        return None

    # -- statement walk ----------------------------------------------------
    def scan(self, body: "list[ast.stmt]", held: "set[str]",
             held_attrs: "set[str]", nested: bool = False) -> None:
        from nmfx_torch.analysis.ast_scan import own_nodes

        ctx, out = self.ctx, self.out
        for stmt in body:
            # nested defs run LATER on an unknown thread: locks held
            # lexically here are NOT held when the body executes
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.scan(stmt.body, set(), set(), nested=True)
                continue
            # local aliases: l = self._lock / obj = ClassName(...)
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
                tgt = stmt.targets[0]
                if isinstance(tgt, ast.Name):
                    key = ctx.lock_key_of(stmt.value)
                    if key is not None:
                        ctx.lock_aliases[tgt.id] = key
                    if isinstance(stmt.value, ast.Call):
                        t2 = stmt.value.func
                        name = (t2.id if isinstance(t2, ast.Name)
                                else None)
                        cm = (ctx.model.class_of(ctx.mod, name)
                              if name else None)
                        if cm is not None:
                            ctx.local_types[tgt.id] = cm
            self._scan_expr_events(stmt, held, held_attrs, nested)
            self._scan_futures_threads(stmt, nested)
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                entered: "list[tuple[str, str | None]]" = []
                for item in stmt.items:
                    key = ctx.lock_key_of(item.context_expr)
                    if key is None:
                        continue
                    hk = frozenset(held | self.entry_keys)
                    out.acquisitions.append((hk, key, stmt.lineno))
                    attr = ctx.class_lock_attr(item.context_expr)
                    entered.append((key, attr))
                    if (item.optional_vars is not None
                            and isinstance(item.optional_vars, ast.Name)):
                        ctx.lock_aliases[item.optional_vars.id] = key
                inner = set(held) | {k for k, _ in entered}
                inner_attrs = set(held_attrs) | {
                    a for _, a in entered if a is not None}
                self.scan(stmt.body, inner, inner_attrs, nested)
                continue
            # explicit acquire()/release() adjust the LINEAR held set
            for node in own_nodes(stmt):
                if (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)):
                    key = ctx.lock_key_of(node.func.value)
                    if key is None:
                        continue
                    if node.func.attr == "acquire":
                        held.add(key)
                        attr = ctx.class_lock_attr(node.func.value)
                        if attr is not None:
                            held_attrs.add(attr)
                    elif node.func.attr == "release":
                        held.discard(key)
                        attr = ctx.class_lock_attr(node.func.value)
                        if attr is not None:
                            held_attrs.discard(attr)
            for block in self._sub_blocks(stmt):
                self.scan(block, set(held), set(held_attrs), nested)
            # a release buried in a finally ends the region for the
            # statements that FOLLOW the try
            for sub in getattr(stmt, "finalbody", []) or []:
                for node in ast.walk(sub):
                    if (isinstance(node, ast.Call)
                            and isinstance(node.func, ast.Attribute)
                            and node.func.attr == "release"):
                        key = ctx.lock_key_of(node.func.value)
                        if key is not None:
                            held.discard(key)
                            attr = ctx.class_lock_attr(node.func.value)
                            if attr is not None:
                                held_attrs.discard(attr)

    @staticmethod
    def _sub_blocks(stmt: ast.stmt) -> "Iterable[list[ast.stmt]]":
        for field in ("body", "orelse", "finalbody"):
            block = getattr(stmt, field, None)
            if block:
                yield block
        for handler in getattr(stmt, "handlers", []) or []:
            yield handler.body

    # -- NMFX014 / NMFX015 raw material ------------------------------------
    def _scan_futures_threads(self, stmt: ast.stmt, nested: bool) -> None:
        from nmfx_torch.analysis.ast_scan import own_nodes

        out = self.out
        for node in own_nodes(stmt):
            if not isinstance(node, ast.Call):
                continue
            tail = _attr_tail(node.func)
            if tail in self.future_ctors:
                # the binding owns the future(s) — a direct assign, an
                # annotated assign, or a container/wrapper built around
                # the construction (comprehensions, _Pending(future=..))
                name = None
                if (isinstance(stmt, ast.Assign)
                        and len(stmt.targets) == 1
                        and isinstance(stmt.targets[0], ast.Name)):
                    name = stmt.targets[0].id
                elif (isinstance(stmt, ast.AnnAssign)
                      and isinstance(stmt.target, ast.Name)):
                    name = stmt.target.id
                out.futures.append(
                    FutureCreation(line=node.lineno, name=name))
            elif tail in ("Thread", "Timer"):
                daemon = any(
                    kw.arg == "daemon"
                    and isinstance(kw.value, ast.Constant)
                    and kw.value.value is True
                    for kw in node.keywords)
                name = None
                if (isinstance(stmt, ast.Assign)
                        and len(stmt.targets) == 1):
                    tgt = stmt.targets[0]
                    if isinstance(tgt, ast.Name):
                        name = tgt.id
                out.threads.append(ThreadStart(
                    line=node.lineno, kind=tail, daemon=daemon,
                    name=name,
                    stored_attr=_self_attr(
                        stmt.targets[0]) if (
                            isinstance(stmt, ast.Assign)
                            and len(stmt.targets) == 1) else None))


# ---------------------------------------------------------------------------
# assembly

def _collect_module_locks(model: ConcurrencyModel,
                          mod: ModuleInfo) -> None:
    locks: "dict[str, LockInfo]" = {}
    guarded: "dict[str, tuple]" = {}
    for stmt in mod.tree.body:
        if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Name)):
            ctor = _lock_ctor(stmt.value)
            if ctor is not None:
                name = stmt.targets[0].id
                locks[name] = LockInfo(
                    key=f"{_mod_stem(mod)}.{name}", attr=name,
                    reentrant=ctor[1], site=(mod.path, stmt.lineno))
        elif (isinstance(stmt, ast.Expr)
              and isinstance(stmt.value, ast.Call)
              and _attr_tail(stmt.value.func) == "module_guarded"):
            args = [_const_str(a) for a in stmt.value.args]
            if args and args[0] and all(args):
                guarded[args[0]] = tuple(args[1:])
    if locks:
        model.module_locks[mod.path] = locks
    if guarded:
        model.module_guarded[mod.path] = guarded


def _module_instance_types(model: ConcurrencyModel,
                           mod: ModuleInfo) -> "dict[str, ClassModel]":
    """Module-level singletons: ``_flight = FlightRecorder(...)``."""
    out: "dict[str, ClassModel]" = {}
    for stmt in mod.tree.body:
        if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Name)
                and isinstance(stmt.value, ast.Call)
                and isinstance(stmt.value.func, ast.Name)):
            cm = model.class_of(mod, stmt.value.func.id)
            if cm is not None:
                out[stmt.targets[0].id] = cm
    return out


def _resolve_attr_types(model: ConcurrencyModel) -> None:
    """Second pass: raw annotation names and ``self.x = ClassName(...)``
    constructor assignments become ClassModel references."""
    for cm in model.classes.values():
        resolved: "dict[str, ClassModel]" = {}
        for attr, raw in list(cm.attr_types.items()):
            if isinstance(raw, str):
                target = model.class_of(cm.module, raw)
                if target is not None:
                    resolved[attr] = target
            else:
                resolved[attr] = raw
        for meth in cm.methods.values():
            # parameter annotations type the attrs they are stored into:
            #   def __init__(self, server: "NMFXServer"): self.server = server
            ann: "dict[str, ClassModel]" = {}
            for arg in meth.args.args + meth.args.kwonlyargs:
                if arg.annotation is None:
                    continue
                raw = (_const_str(arg.annotation)
                       if isinstance(arg.annotation, ast.Constant)
                       else (arg.annotation.id
                             if isinstance(arg.annotation, ast.Name)
                             else None))
                if raw:
                    target = model.class_of(cm.module, raw)
                    if target is not None:
                        ann[arg.arg] = target
            for stmt in ast.walk(meth):
                if not (isinstance(stmt, ast.Assign)
                        and len(stmt.targets) == 1):
                    continue
                attr = _self_attr(stmt.targets[0])
                if attr is None or attr in resolved:
                    continue
                val = stmt.value
                if (isinstance(val, ast.Call)
                        and isinstance(val.func, ast.Name)):
                    target = model.class_of(cm.module, val.func.id)
                    if target is not None:
                        resolved[attr] = target
                elif isinstance(val, ast.Name) and val.id in ann:
                    resolved[attr] = ann[val.id]
        cm.attr_types = resolved


def _entry_held_fixpoint(cm: ClassModel,
                         fns: "dict[str, MethodModel]") -> None:
    """Which of the class's locks is provably held at entry of each
    PRIVATE method: the intersection over every in-class call site's
    held set. A method referenced as a value (callback), called from
    outside the class, public, or never called resolves to the empty
    set — the conservative answer."""
    refs: "set[str]" = set()
    sites: "dict[str, list]" = {m: [] for m in cm.methods}
    for caller, mm in fns.items():
        refs.update(mm.self_refs)
        for callee, held in mm.self_calls:
            sites[callee].append((caller, held))
    entry = {m: frozenset() for m in cm.methods}
    eligible = {m for m in cm.methods
                if m.startswith("_") and not m.startswith("__")
                and m not in refs and m not in cm.external_calls
                and sites[m]}
    for _ in range(len(cm.methods) + 1):
        changed = False
        for m in eligible:
            new = None
            for caller, held in sites[m]:
                eff = frozenset(held) | entry.get(caller, frozenset())
                new = eff if new is None else (new & eff)
            new = new or frozenset()
            if new != entry[m]:
                entry[m] = new
                changed = True
        if not changed:
            break
    cm.entry_held = entry


def _collect_joins(cm: ClassModel) -> None:
    for meth in cm.methods.values():
        for node in ast.walk(meth):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("join", "cancel")):
                continue
            recv = node.func.value
            attr = _self_attr(recv)
            if attr is not None:
                cm.joined_attrs.add(attr)
            elif isinstance(recv, ast.Name):
                # "for t in self._threads: t.join()" — credit every
                # container attr the loop variable ranges over
                cm.joined_attrs.add(f"<var>{recv.id}")
        for node in ast.walk(meth):
            if isinstance(node, ast.For) and isinstance(node.target,
                                                        ast.Name):
                var = f"<var>{node.target.id}"
                if var in cm.joined_attrs:
                    for sub in ast.walk(node.iter):
                        attr = _self_attr(sub)
                        if attr is not None:
                            cm.joined_attrs.add(attr)


def build_model(project: Project) -> ConcurrencyModel:
    model = ConcurrencyModel(project=project)
    # pass 1: classes, locks, module locks
    for mod in project.modules:
        _collect_module_locks(model, mod)
        for node in mod.tree.body:
            if isinstance(node, ast.ClassDef):
                cm = _collect_class(model, mod, node)
                model.classes[(mod.path, node.name)] = cm
                model.by_class_name.setdefault(node.name, []).append(cm)
    _resolve_attr_types(model)
    for locks in model.module_locks.values():
        for li in locks.values():
            model.lock_index[li.key] = li
    for cm in model.classes.values():
        for li in cm.locks.values():
            model.lock_index.setdefault(li.key, li)
    # pass 2a: cross-class calls into private methods void entry-held
    for cm in model.classes.values():
        cm.external_calls = set()
    for mod in project.modules:
        inst_types = _module_instance_types(model, mod)
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)):
                continue
            recv = node.func.value
            if isinstance(recv, ast.Name) and recv.id in inst_types:
                inst_types[recv.id].external_calls.add(node.func.attr)
        for cm in (c for c in model.classes.values()
                   if c.module is mod):
            for attr, target in cm.attr_types.items():
                for meth in cm.methods.values():
                    for node in ast.walk(meth):
                        if (isinstance(node, ast.Call)
                                and isinstance(node.func, ast.Attribute)
                                and node.func.attr in target.methods):
                            sa = _self_attr(node.func.value)
                            if sa == attr:
                                target.external_calls.add(
                                    node.func.attr)
    # pass 2b: per-function scan (first with empty entry-held to feed
    # the fixpoint, then re-scanned with the fixpoint answer)
    def scan_all(use_entry: bool) -> None:
        model.functions.clear()
        for mod in project.modules:
            futures = _future_names(mod)
            for node in mod.tree.body:
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    ctx = _Ctx(model, mod, None)
                    mm = MethodModel(qual=node.name, node=node)
                    _BodyScan(ctx, mm, frozenset(), frozenset(),
                              futures).scan(node.body, set(), set())
                    model.functions[(mod.path, node.name)] = mm
                elif isinstance(node, ast.ClassDef):
                    cm = model.classes[(mod.path, node.name)]
                    for name, meth in cm.methods.items():
                        ctx = _Ctx(model, mod, cm)
                        mm = MethodModel(
                            qual=f"{cm.name}.{name}", node=meth)
                        attrs = (cm.entry_held.get(name, frozenset())
                                 if use_entry else frozenset())
                        keys = frozenset(
                            k for k in (cm.lock_key(a) for a in attrs)
                            if k is not None)
                        _BodyScan(ctx, mm, keys, attrs, futures).scan(
                            meth.body, set(), set())
                        model.functions[
                            (mod.path, f"{cm.name}.{name}")] = mm

    scan_all(use_entry=False)
    for mod in project.modules:
        for cm in (c for c in model.classes.values()
                   if c.module is mod):
            fns = {name: model.functions[(mod.path,
                                          f"{cm.name}.{name}")]
                   for name in cm.methods}
            _entry_held_fixpoint(cm, fns)
            _collect_joins(cm)
    scan_all(use_entry=True)
    _compute_acquires(model)
    _compute_order_edges(model)
    return model


def _compute_acquires(model: ConcurrencyModel) -> None:
    """Transitive lock-acquisition sets per function over the typed
    call graph (self-calls resolve within the class)."""
    direct: "dict[tuple, set]" = {}
    edges: "dict[tuple, set]" = {}
    for fid, mm in model.functions.items():
        direct[fid] = {key for _, key, _ in mm.acquisitions}
        out = set()
        for _, callee, _ in mm.calls:
            out.add(callee)
        mod_path, qual = fid
        if "." in qual:
            cls_name = qual.split(".", 1)[0]
            if (mod_path, cls_name) in model.classes:
                for callee, _ in mm.self_calls:
                    out.add((mod_path, f"{cls_name}.{callee}"))
        edges[fid] = out
    # fixpoint BFS
    acquires = {fid: set(d) for fid, d in direct.items()}
    changed = True
    while changed:
        changed = False
        for fid in acquires:
            for callee in edges.get(fid, ()):
                extra = acquires.get(callee)
                if extra and not extra <= acquires[fid]:
                    acquires[fid] |= extra
                    changed = True
    model.acquires = {fid: frozenset(s) for fid, s in acquires.items()}


def _compute_order_edges(model: ConcurrencyModel) -> None:
    """The static lock-order graph: held -> acquired, from direct
    acquisitions and from typed calls whose callees acquire."""
    for fid, mm in model.functions.items():
        mod_path, qual = fid
        for held, key, line in mm.acquisitions:
            for h in held:
                model.order_edges.setdefault(
                    (h, key), (mod_path, line))
        call_edges = list(mm.calls)
        if "." in qual:
            cls_name = qual.split(".", 1)[0]
            cm = model.classes.get((mod_path, cls_name))
            if cm is not None:
                for callee, held_attrs in mm.self_calls:
                    keys = frozenset(
                        k for k in (cm.lock_key(a) for a in held_attrs)
                        if k is not None)
                    call_edges.append(
                        (keys, (mod_path, f"{cls_name}.{callee}"),
                         mm.node.lineno))
        for held, callee, line in call_edges:
            if not held:
                continue
            for key in model.acquires.get(callee, ()):
                for h in held:
                    model.order_edges.setdefault(
                        (h, key), (mod_path, line))


def concurrency_model(project: Project) -> ConcurrencyModel:
    """The per-run shared model (built once, memoized on the project)."""
    cached = getattr(project, "_concurrency_model", None)
    if cached is None:
        cached = build_model(project)
        project._concurrency_model = cached
    return cached
