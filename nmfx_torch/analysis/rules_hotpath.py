"""NMFX004 / NMFX005 — the key chain's discipline and host syncs in the
hot path (counterpart of ``nmfx/analysis/rules_traced.py``'s two rules).

The reference's rules watch traced code; the port traces nothing, so
their scope becomes the hot path (``ast_scan.HOT_ROOTS``: what the slot
scheduler's trips, the batched restart route's check blocks and the
tiled pool's passes reach).

* **NMFX004 — PRNG discipline.** The port draws every initial factor and
  every sketch operator from the reference's threefry key chain
  (``nmfx_torch/random.py``). A key value that two sampling calls
  (``random_bits``, ``uniform``, ``normal`` and their ``*_device``
  forms) consume with no ``split`` or ``fold_in`` between them draws
  the same bits twice, and restarts the consensus math assumes
  independent collapse toward each other with no numerical signature.
  Every function is scanned for that (the reference's scope), a key
  consumed in a loop body that never rebinds it included. A host draw
  (``np.random``, the stdlib ``random``, or torch's global generator:
  ``torch.rand`` / ``randn`` / ``randint`` / ... or an in-place
  ``uniform_`` / ``normal_`` with no ``generator=``) leaves the key
  chain: the run depends on process state no seed records. It is
  flagged in the hot path and in the draws that feed the key chain
  (what ``init.restart_inits`` reaches).

* **NMFX005 — implicit host syncs.** In the hot path, ``.item()``,
  ``.tolist()``, ``float()`` / ``int()`` / ``bool()`` of a tensor,
  ``.cpu()``, ``.numpy()`` and ``torch.cuda.synchronize`` block the
  host on the card once a call. The design allows one counted read a
  trip or a check (``host_syncs``), which carries an inline suppression
  that gives its reason. Gated by dataflow as the reference's
  ``_array_tainted`` is: ``.item()`` / ``.tolist()`` / the conversions
  count only on names bound from ``torch.`` results (or from names so
  bound) and on parameters annotated as tensors, so host arithmetic on
  static config stays quiet; ``.cpu()`` and ``.numpy()`` exist only on
  tensors and count wherever they run.
"""

from __future__ import annotations

import ast
from typing import Iterable

from nmfx_torch.analysis.ast_scan import (FunctionInfo, _attr_tail,
                                          _dotted, own_nodes, stores)
from nmfx_torch.analysis.core import Finding, Rule, register

#: the key chain's module and its sampling calls (a key consumed for
#: bits); ``key`` takes a seed, ``split`` / ``fold_in`` derive new keys
_RANDOM_MODULE = "nmfx_torch.random"
_KEY_CONSUMERS = {"random_bits", "uniform", "normal", "random_bits_device",
                  "uniform_device", "normal_device"}
#: the draws that feed the key chain: host RNG is flagged in what these
#: reach, besides the hot path
_DRAW_ROOTS = (("nmfx_torch/init.py", "restart_inits"),)
#: torch calls that draw from the global generator unless given one
_TORCH_DRAWS = {"rand", "randn", "randint", "randperm", "rand_like",
                "randn_like", "randint_like", "normal", "bernoulli",
                "multinomial", "poisson"}
_TENSOR_DRAWS = {"uniform_", "normal_", "random_", "exponential_",
                 "bernoulli_", "geometric_", "cauchy_", "log_normal_"}


def _function_body_nodes(fn: FunctionInfo) -> "Iterable[ast.AST]":
    """Nodes lexically inside ``fn`` but not inside a nested def (a
    nested def is its own FunctionInfo and is visited there)."""
    skip: "set[int]" = set()
    for node in ast.walk(fn.node):
        if node is not fn.node and isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            skip.update(id(sub) for sub in ast.walk(node))
    for node in ast.walk(fn.node):
        if id(node) not in skip:
            yield node


def _resolves_to(fn: FunctionInfo, head: str, module: str) -> bool:
    """Whether the leading name ``head`` names ``module`` in ``fn``'s
    module (``import torch as t``, ``from nmfx_torch import random``)."""
    return fn.module.module_aliases.get(head) == module


@register
class PRNGDiscipline(Rule):
    """NMFX004: a threefry key consumed twice; host RNG in the hot path
    or the draws."""

    rule_id = "NMFX004"
    title = "PRNG discipline"

    def check(self, project) -> "Iterable[Finding]":
        scope = project.hot_ids | project.reachable(
            project.roots(_DRAW_ROOTS))
        for fn in project.functions_in(scope):
            yield from self._host_rng(fn)
        # key reuse is a property of any function (a host driver reusing
        # a key across two draws correlates them just the same)
        for mod in project.modules:
            for fn in mod.functions.values():
                yield from self._key_reuse(fn)

    # -- host RNG ----------------------------------------------------------
    def _host_rng(self, fn: FunctionInfo) -> "Iterable[Finding]":
        aliases = fn.module.module_aliases
        for node in _function_body_nodes(fn):
            if not isinstance(node, ast.Call):
                continue
            dotted = _dotted(node.func) or ""
            parts = dotted.split(".")
            head = aliases.get(parts[0], parts[0]) if parts[0] else ""
            seeded = any(kw.arg == "generator" for kw in node.keywords)
            what = None
            if ((len(parts) >= 3 and parts[1] == "random"
                 and head in ("numpy", "np"))
                    or (len(parts) >= 2 and head == "numpy.random")):
                what = "numpy's global generator"
            elif len(parts) >= 2 and head == "random":
                what = "the stdlib random module"
            elif (len(parts) == 2 and head == "torch"
                  and parts[1] in _TORCH_DRAWS and not seeded):
                what = "torch's global generator"
            elif (isinstance(node.func, ast.Attribute)
                  and node.func.attr in _TENSOR_DRAWS and not seeded
                  and head != "torch"):
                what = "torch's global generator"
            if what is None:
                continue
            yield self.finding(
                fn.module.path, node.lineno,
                f"host RNG call ({dotted or _attr_tail(node.func)}) in "
                f"'{fn.qualname}', which the hot path or the key chain's "
                f"draws reach: it draws from {what}, which no seed of "
                "the sweep records, so a rerun draws other numbers. "
                "Draw from the threefry key chain (nmfx_torch.random) or "
                "pass an explicit generator=")

    # -- key reuse ---------------------------------------------------------
    def _consumption(self, fn: FunctionInfo,
                     node: ast.Call) -> "str | None":
        """The key Name this call consumes for sampling, or None: a
        sampling call of ``nmfx_torch.random`` through an alias of the
        module, a name imported from it, or (inside the module itself) a
        bare call of its own function."""
        dotted = _dotted(node.func) or ""
        parts = dotted.split(".")
        mod = fn.module
        if len(parts) == 2:
            if not _resolves_to(fn, parts[0], _RANDOM_MODULE):
                return None
            leaf = parts[1]
        elif len(parts) == 1:
            origin = mod.from_imports.get(parts[0])
            if origin is not None and origin[0] == _RANDOM_MODULE:
                leaf = origin[1]  # from nmfx_torch.random import x as y
            elif parts[0] in mod.functions and mod.path.replace(
                    "\\", "/").endswith("nmfx_torch/random.py"):
                leaf = parts[0]
            else:
                return None
        else:
            return None
        if leaf not in _KEY_CONSUMERS:
            return None
        if not node.args or not isinstance(node.args[0], ast.Name):
            return None
        return node.args[0].id

    def _reuse_finding(self, fn: FunctionInfo, node: ast.Call,
                       key_name: str, first_line: int) -> Finding:
        leaf = (_dotted(node.func) or "?").split(".")[-1]
        return self.finding(
            fn.module.path, node.lineno,
            f"PRNG key '{key_name}' is consumed by {leaf} at line "
            f"{node.lineno} after already being consumed at line "
            f"{first_line} in '{fn.qualname}': both draws read the same "
            "bits, and restarts the consensus assumes independent "
            "correlate; split the key (random.split) so each draw owns "
            "a fresh one")

    def _key_reuse(self, fn: FunctionInfo) -> "Iterable[Finding]":
        """The same Name consumed by two sampling calls with no rebind
        between them: ``key = fold_in(key, i)`` rebinds the name (the
        statement-ordered scan clears it on store), and branch bodies
        scan with copies so sibling branches never see each other's
        draws."""
        if not isinstance(fn.node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            consumed: "dict[str, int]" = {}
            for node in _function_body_nodes(fn):
                if not isinstance(node, ast.Call):
                    continue
                key = self._consumption(fn, node)
                if key is None:
                    continue
                if key in consumed:
                    yield self._reuse_finding(fn, node, key, consumed[key])
                else:
                    consumed[key] = node.lineno
            return
        yield from self._scan_keys(fn, fn.node.body, {})

    def _scan_keys(self, fn: FunctionInfo, body,
                   consumed: "dict[str, int]") -> "Iterable[Finding]":
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue  # a nested def is scanned as its own function
            for node in own_nodes(stmt):
                if not isinstance(node, ast.Call):
                    continue
                key = self._consumption(fn, node)
                if key is None:
                    continue
                if key in consumed:
                    yield self._reuse_finding(fn, node, key, consumed[key])
                else:
                    consumed[key] = node.lineno
            for name in stores(stmt):
                consumed.pop(name, None)
            if isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
                yield from self._loop_carried(fn, stmt)
            for field in ("body", "orelse", "finalbody"):
                child = getattr(stmt, field, None)
                if child:
                    yield from self._scan_keys(fn, child, dict(consumed))
            for handler in getattr(stmt, "handlers", []) or []:
                yield from self._scan_keys(fn, handler.body,
                                           dict(consumed))

    def _loop_carried(self, fn: FunctionInfo, loop) -> "Iterable[Finding]":
        """One textual draw inside a loop body runs once an iteration:
        identical draws every trip unless the body rebinds the key (the
        loop target rebinds too: ``for kk in keys``). Inner loops run
        their own pass, so a defect is reported once."""
        inner: "set[int]" = set()
        for node in ast.walk(loop):
            if node is not loop and isinstance(
                    node, (ast.For, ast.AsyncFor, ast.While,
                           ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.Lambda)):
                inner.update(id(sub) for sub in ast.walk(node))
        body_stores: "set[str]" = set()
        for stmt in ast.walk(loop):
            if isinstance(stmt, ast.stmt) and id(stmt) not in inner:
                body_stores.update(stores(stmt))
        target = getattr(loop, "target", None)
        if target is not None:
            body_stores.update(n.id for n in ast.walk(target)
                               if isinstance(n, ast.Name))
        seen: "set[str]" = set()
        for node in ast.walk(loop):
            if not isinstance(node, ast.Call) or id(node) in inner:
                continue
            key = self._consumption(fn, node)
            if key is None or key in body_stores or key in seen:
                continue
            seen.add(key)
            yield self.finding(
                fn.module.path, node.lineno,
                f"PRNG key '{key}' is consumed inside a loop body in "
                f"'{fn.qualname}' without being rebound per iteration: "
                "every iteration replays the same draw (restarts "
                "collapse together); derive a fresh key per iteration "
                "(random.fold_in(key, i) or a pre-split key array)")


#: a tensor's host reads: the conversions gated by dataflow, the methods
#: of tensors alone flagged wherever they run
_SYNC_CALLS = {"float", "int", "bool"}
_SYNC_METHODS_GATED = {"item", "tolist"}
_SYNC_METHODS_TENSOR = {"cpu", "numpy"}
#: attributes and methods of a tensor that read no element (its shape,
#: dtype, device): a conversion of these is host arithmetic
_STATIC_ATTRS = {"shape", "dtype", "device", "ndim", "is_cuda", "size",
                 "dim", "numel", "stride", "element_size", "nelement",
                 "data_ptr", "is_contiguous", "names"}


def _annotated_tensor(arg: ast.arg) -> bool:
    ann = arg.annotation
    if ann is None:
        return False
    text = (ann.value if isinstance(ann, ast.Constant)
            and isinstance(ann.value, str) else ast.unparse(ann))
    return "Tensor" in text


def _torch_call(fn: FunctionInfo, node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    head = (_dotted(node.func) or "").split(".")[0]
    return bool(head) and _resolves_to(fn, head, "torch")


def _array_tainted(fn: FunctionInfo) -> "set[str]":
    """Names plausibly bound to tensors in ``fn``: its parameters
    annotated as tensors, names assigned from an expression with a
    ``torch.`` call, and (to a fixed point) names assigned from an
    expression that reads a tainted name's elements. Config objects and
    static shape math never enter the set: that keeps NMFX005 quiet on
    host arithmetic (the reference's ``_array_tainted``)."""
    tainted: "set[str]" = set()
    args = getattr(fn.node, "args", None)
    if args is not None:
        for a in (list(args.posonlyargs) + list(args.args)
                  + list(args.kwonlyargs)):
            if _annotated_tensor(a):
                tainted.add(a.arg)
    assigns = []
    for node in _function_body_nodes(fn):
        if isinstance(node, ast.Assign):
            assigns.append((node.targets, node.value))
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)) \
                and node.value is not None:
            assigns.append(([node.target], node.value))
    changed = True
    while changed:
        changed = False
        for targets, value in assigns:
            if not (any(_torch_call(fn, n) for n in ast.walk(value))
                    or _tensor_value(value, tainted)):
                continue
            for tgt in targets:
                for leaf in ast.walk(tgt):
                    if (isinstance(leaf, ast.Name)
                            and leaf.id not in tainted):
                        tainted.add(leaf.id)
                        changed = True
    return tainted


def _tensor_value(expr: ast.AST, tainted: "set[str]") -> bool:
    """Whether ``expr`` holds a tainted tensor's elements (not its shape,
    dtype or device)."""
    if isinstance(expr, ast.Name):
        return expr.id in tainted
    if isinstance(expr, ast.Attribute):
        return (expr.attr not in _STATIC_ATTRS
                and _tensor_value(expr.value, tainted))
    if isinstance(expr, ast.Subscript):
        return _tensor_value(expr.value, tainted)
    if isinstance(expr, ast.Call):
        func = expr.func
        return (isinstance(func, ast.Attribute)
                and func.attr not in _STATIC_ATTRS
                and _tensor_value(func.value, tainted))
    if isinstance(expr, ast.BinOp):
        return (_tensor_value(expr.left, tainted)
                or _tensor_value(expr.right, tainted))
    if isinstance(expr, ast.UnaryOp):
        return _tensor_value(expr.operand, tainted)
    if isinstance(expr, (ast.BoolOp, ast.Compare)):
        parts = (expr.values if isinstance(expr, ast.BoolOp)
                 else [expr.left, *expr.comparators])
        return any(_tensor_value(p, tainted) for p in parts)
    return False


@register
class ImplicitHostSync(Rule):
    """NMFX005: a tensor's host read in the hot path."""

    rule_id = "NMFX005"
    title = "implicit host sync"

    def check(self, project) -> "Iterable[Finding]":
        for fn in project.hot_functions():
            tainted = _array_tainted(fn)
            lines: "set[int]" = set()  # one finding a line: x.cpu().numpy()
            for node in _function_body_nodes(fn):
                if not isinstance(node, ast.Call) or node.lineno in lines:
                    continue
                hit = self._classify(fn, node, tainted)
                if hit:
                    lines.add(node.lineno)
                    yield self.finding(
                        fn.module.path, node.lineno,
                        f"{hit} in '{fn.qualname}', which the hot path "
                        "reaches (ast_scan.HOT_ROOTS): the host waits "
                        "for the card there once a call. Keep the value "
                        "on the card, or make it the trip's one counted "
                        "read and suppress it with the reason")

    @staticmethod
    def _classify(fn: FunctionInfo, node: ast.Call,
                  tainted: "set[str]") -> "str | None":
        func = node.func
        dotted = _dotted(func) or ""
        parts = dotted.split(".")
        if (len(parts) == 3 and parts[1:] == ["cuda", "synchronize"]
                and _resolves_to(fn, parts[0], "torch")):
            return "torch.cuda.synchronize()"
        if isinstance(func, ast.Attribute):
            if func.attr in _SYNC_METHODS_TENSOR:
                return f".{func.attr}() of a tensor"
            if (func.attr in _SYNC_METHODS_GATED
                    and (_tensor_value(func.value, tainted)
                         or _torch_call(fn, func.value))):
                return f".{func.attr}() of a tensor"
            return None
        if (isinstance(func, ast.Name) and func.id in _SYNC_CALLS
                and node.args):
            arg = node.args[0]
            if _tensor_value(arg, tainted) or _torch_call(fn, arg):
                return f"{func.id}() of a tensor"
        return None
