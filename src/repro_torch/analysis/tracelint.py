"""Host-sync lint (LANNS001-004, LANNS006).

The port of ``repro.analysis.tracelint``.  PyTorch runs eagerly, so there
is no trace to keep stable; what the rules guard in the port is the host
sync and the per-iteration launch.  On a CUDA device a ``.cpu()`` blocks
until the card has computed its operand, exactly as ``np.asarray`` of a
jax array does, so the host-sync rules carry over unchanged in meaning.

Scope: functions marked ``# lanns: hotpath`` plus everything reachable from
them through same-module calls (``foo(...)`` to a module-level def,
``self.meth(...)`` to a method of the enclosing class).  A function
compiled by ``torch.compile`` / ``torch.jit.script`` (decorator) runs its
loops at compile time: LANNS001-004 do not apply inside it and the closure
stops there; LANNS006 still does.

Device-value inference is a single forward pass per function: a name is
"device-valued" after being assigned from a ``torch.`` call, from a call
to one of the port's device-returning entry points (``KNOWN_DEVICE``:
K1/K2 and their launchers, the beam, the device merges, the exact re-rank),
from a tensor method of a device value (``x.index_select(...)``, ``x.to(
...)``), or from an expression over device values.  ``.cpu()``,
``.numpy()``, ``.tolist()``, ``.item()`` and ``np.asarray`` re-host it;
``.shape`` / ``.dtype`` / ``.device`` are host values.  A ``.cpu()`` is a
LANNS003 whatever its operand: only a tensor has it, and on the port's
device it is a copy to the host.  The tracking is
deliberately local and conservative: it exists to catch the syncs that
matter (hot loops, hot returns), not to be a type system.

The reference's LANNS005 (a jit parameter in a shape position) has no
eager-torch meaning and is never emitted.
"""

from __future__ import annotations

import ast

from repro_torch.analysis.rules import Finding, SourceFile, attr_chain

# callables living in other modules whose results are device tensors: a
# per-module pass cannot see that they return CUDA tensors.
KNOWN_DEVICE = {
    "beam_search", "beam_search_flat", "_beam_search_lanes",
    "distance_topk", "distance_topk_q8", "distance_topk_q8_codes",
    "distance_topk_cuda", "distance_topk_q8_cuda",
    "merge_topk", "merge_topk_vec", "merge_topk_disjoint",
    "exact_candidate_distances", "quantize_queries_q8_t",
}

_HOST_CAST = {"float", "int", "bool"}
_NP_SYNC = {"np.asarray", "np.array", "np.from_dlpack", "np.copy",
            "numpy.asarray", "numpy.array", "numpy.from_dlpack"}
#: tensor methods that copy to the host (LANNS003)
_SYNC_METHODS = {"cpu", "numpy", "tolist"}
#: tensor methods and attributes whose result is a host value
_HOST_METHODS = _SYNC_METHODS | {
    "item", "size", "dim", "numel", "nelement", "element_size", "data_ptr",
    "is_contiguous", "stride", "get_device", "storage_offset",
}
_HOST_ATTRS = {"shape", "dtype", "device", "ndim", "is_cuda", "layout",
               "requires_grad"}
_COMPILE_DECORATORS = {"torch.compile", "torch.jit.script"}


def _is_compiled(fn: ast.FunctionDef) -> bool:
    """Decorated with ``torch.compile`` / ``torch.jit.script`` (bare or
    called with options)."""
    for dec in fn.decorator_list:
        target = dec.func if isinstance(dec, ast.Call) else dec
        if attr_chain(target) in _COMPILE_DECORATORS:
            return True
    return False


class _FunctionIndex(ast.NodeVisitor):
    """qualname -> def node, plus per-function metadata."""

    def __init__(self) -> None:
        self.funcs: dict[str, ast.FunctionDef] = {}
        self._class: list[str] = []

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._class.append(node.name)
        self.generic_visit(node)
        self._class.pop()

    def _def(self, node: ast.FunctionDef) -> None:
        qual = f"{self._class[-1]}.{node.name}" if self._class else node.name
        self.funcs.setdefault(qual, node)
        # nested defs are not independently indexed on purpose: they run as
        # part of their parent and are walked with it.

    visit_FunctionDef = _def
    visit_AsyncFunctionDef = _def


def _callees(qual: str, fn: ast.FunctionDef,
             funcs: dict[str, ast.FunctionDef]) -> set[str]:
    cls = qual.split(".")[0] if "." in qual else None
    out: set[str] = set()
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        chain = attr_chain(node.func)
        if chain in funcs:
            out.add(chain)
        elif cls and chain.startswith("self."):
            meth = f"{cls}.{chain[5:]}"
            if meth in funcs:
                out.add(meth)
    return out


def hot_roster(src: SourceFile) -> dict[str, ast.FunctionDef]:
    """Marked functions plus their same-module call closure."""
    idx = _FunctionIndex()
    idx.visit(src.tree)
    seeds = [q for q, fn in idx.funcs.items() if src.func_is_hot(fn)]
    seen: dict[str, ast.FunctionDef] = {}
    work = list(seeds)
    while work:
        qual = work.pop()
        if qual in seen:
            continue
        fn = idx.funcs[qual]
        seen[qual] = fn
        # Closure stops at compiled defs: what THEY call runs at compile
        # time, not per query on the host.
        if _is_compiled(fn):
            continue
        work.extend(_callees(qual, fn, idx.funcs))
    return seen


class _DeviceTracker(ast.NodeVisitor):
    """Forward pass over one function; flags LANNS001-004 as it walks."""

    def __init__(self, src: SourceFile, qual: str, traced: bool) -> None:
        self.src = src
        self.qual = qual
        self.traced = traced  # torch.compile'd: loops run at compile time
        self.device: set[str] = set()
        self.loop_depth = 0
        self.findings: list[Finding] = []

    # -- device-value expression test -------------------------------------

    def _method_is_device(self, node: ast.Call) -> bool:
        meth = node.func.attr
        base = node.func.value
        if meth in _HOST_METHODS:
            return False
        if meth == "cuda":
            return True
        if self.is_device(base):
            return True
        if meth == "to":
            # an upload: a device argument, not a dtype or the string "cpu"
            if any(kw.arg == "device" for kw in node.keywords):
                return True
            if node.args:
                a = node.args[0]
                if isinstance(a, ast.Constant):
                    return isinstance(a.value, str) and a.value != "cpu"
                chain = attr_chain(a)
                return bool(chain) and not chain.startswith("torch.")
        return False

    def is_device(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.device
        if isinstance(node, ast.Call):
            chain = attr_chain(node.func)
            root = chain.split(".")[0] if chain else ""
            if isinstance(node.func, ast.Attribute) and root != "torch" and \
                    chain.split(".")[-1] not in KNOWN_DEVICE:
                return self._method_is_device(node)
            if root == "torch":
                return True
            if chain in KNOWN_DEVICE or chain.split(".")[-1] in KNOWN_DEVICE:
                return True
            return False
        if isinstance(node, ast.Attribute):
            if node.attr in _HOST_ATTRS:
                return False
            return self.is_device(node.value)
        if isinstance(node, (ast.Subscript, ast.Starred)):
            return self.is_device(node.value)
        if isinstance(node, ast.BinOp):
            return self.is_device(node.left) or self.is_device(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.is_device(node.operand)
        if isinstance(node, ast.Compare):
            return any(self.is_device(e) for e in [node.left, *node.comparators])
        if isinstance(node, ast.IfExp):
            return self.is_device(node.body) or self.is_device(node.orelse)
        if isinstance(node, (ast.Tuple, ast.List)):
            return any(self.is_device(e) for e in node.elts)
        return False

    def _bind(self, target: ast.AST, device: bool) -> None:
        if isinstance(target, ast.Name):
            (self.device.add if device else self.device.discard)(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                self._bind(el, device)

    # -- statements --------------------------------------------------------

    def visit_Assign(self, node: ast.Assign) -> None:
        self.visit(node.value)
        dev = self.is_device(node.value)
        for t in node.targets:
            self._bind(t, dev)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self.visit(node.value)
        if self.is_device(node.value):
            self._bind(node.target, True)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self.visit(node.value)
            self._bind(node.target, self.is_device(node.value))

    def _loop(self, node: ast.AST) -> None:
        self.loop_depth += 1
        self.generic_visit(node)
        self.loop_depth -= 1

    visit_For = _loop
    visit_While = _loop

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        # nested def: walk it with the same tracker (closures run inline on
        # the hot path often enough to deserve the same rules)
        self.generic_visit(node)

    # -- the rules ---------------------------------------------------------

    def visit_Call(self, node: ast.Call) -> None:
        self.generic_visit(node)
        if self.traced:
            return
        chain = attr_chain(node.func)
        where = "inside a host loop" if self.loop_depth else "in hot function"
        if isinstance(node.func, ast.Attribute) and node.func.attr == "item" \
                and not node.args:
            self.findings.append(Finding(
                "LANNS001", self.src.path, node.lineno,
                f"`.item()` in hot function `{self.qual}` forces a "
                "device->host sync",
            ))
        if isinstance(node.func, ast.Name) and node.func.id in _HOST_CAST \
                and len(node.args) == 1 and self.is_device(node.args[0]):
            self.findings.append(Finding(
                "LANNS002", self.src.path, node.lineno,
                f"`{node.func.id}()` of a device value in hot function "
                f"`{self.qual}` blocks on the device",
            ))
        if chain in _NP_SYNC and node.args and self.is_device(node.args[0]):
            self.findings.append(Finding(
                "LANNS003", self.src.path, node.lineno,
                f"`{chain}` of a device value {where} `{self.qual}` is a "
                "host sync",
            ))
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr in _SYNC_METHODS and not node.args and (
                    node.func.attr == "cpu" or self.is_device(node.func.value)):
            self.findings.append(Finding(
                "LANNS003", self.src.path, node.lineno,
                f"`.{node.func.attr}()` {where} `{self.qual}` copies a "
                "device tensor to the host (a sync)",
            ))
        root = chain.split(".")[0] if chain else ""
        if self.loop_depth and root == "torch":
            self.findings.append(Finding(
                "LANNS004", self.src.path, node.lineno,
                f"`{chain}` inside a host-side loop in `{self.qual}` "
                "launches per iteration",
            ))


def _iter_is_unordered(it: ast.AST) -> str | None:
    """Human tag if the iterable has nondeterministic / insertion order that
    a sorted() wrapper would fix; None if it is fine."""
    if isinstance(it, (ast.Set, ast.SetComp)):
        return "a set"
    if isinstance(it, ast.Call):
        chain = attr_chain(it.func)
        if chain == "set":
            return "a set"
        if isinstance(it.func, ast.Attribute) and \
                it.func.attr in ("items", "keys", "values"):
            return f"dict .{it.func.attr}()"
    return None


_ARRAY_FEED = {"asarray", "array", "stack", "concatenate", "vstack",
               "hstack", "column_stack", "append", "full", "zeros", "ones",
               "cat", "tensor", "as_tensor"}


def _feeds_arrays(body: list[ast.stmt]) -> bool:
    for stmt in body:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Call):
                chain = attr_chain(node.func)
                tail = chain.split(".")[-1] if chain else ""
                if tail in _ARRAY_FEED:
                    return True
    return False


def _check_unordered_iteration(src: SourceFile, qual: str,
                               fn: ast.FunctionDef,
                               findings: list[Finding]) -> None:
    for node in ast.walk(fn):
        if isinstance(node, ast.For):
            tag = _iter_is_unordered(node.iter)
            if tag and _feeds_arrays(node.body):
                findings.append(Finding(
                    "LANNS006", src.path, node.lineno,
                    f"iteration over {tag} feeds array construction in "
                    f"`{qual}` — wrap in sorted() for deterministic "
                    "layout order",
                ))
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                               ast.GeneratorExp)):
            for comp in node.generators:
                tag = _iter_is_unordered(comp.iter)
                if tag and isinstance(node, (ast.ListComp, ast.GeneratorExp)):
                    wrapped = ast.Expr(value=getattr(node, "elt", node))
                    if _feeds_arrays([wrapped]):
                        findings.append(Finding(
                            "LANNS006", src.path, node.lineno,
                            f"comprehension over {tag} feeds array "
                            f"construction in `{qual}`",
                        ))


def run(src: SourceFile) -> list[Finding]:
    findings: list[Finding] = []
    hot = hot_roster(src)
    for qual, fn in sorted(hot.items()):
        tracker = _DeviceTracker(src, qual, _is_compiled(fn))
        for stmt in fn.body:
            tracker.visit(stmt)
        findings.extend(tracker.findings)
        _check_unordered_iteration(src, qual, fn, findings)
    return findings
