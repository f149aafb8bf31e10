"""Scale-safety pass (LANNS030-032, LANNS034): symbolic shape/dtype
abstract interpretation at declared dimension bounds.

The port of ``repro.analysis.scalecheck``.  The port runs at <= 10M rows on
one card, but the paper serves 180M — and index arithmetic that is fine at
1M silently wraps int32 long before paper scale (K1's and K2's ids are
int32, ``kernels/distance_topk.py``'s ``_INT32_MAX``).  A module declares
bounds with ``# lanns: dims[n<=180_000_000, d<=2048]`` and the interpreter
threads those bounds through numpy and ``torch.`` shape-producing ops
(``arange``/``full``/``zeros``/``empty``/``broadcast_to``/``cumsum``/
``reshape``, ``.to(dtype)`` / ``.long()`` casts, ``.to(device)`` uploads
and index arithmetic) over the ``# lanns: hotpath`` roster plus any
function carrying its own ``dims``/``budget`` directive.

Conservatism contract: a rule fires only on a PROVABLE violation at the
declared bounds — unknown values never flag.  This keeps honestly-annotated
code clean while making every overflow the bounds imply undeniable.

Name binding: any name (assignment target, loop variable, parameter,
attribute tail like ``plan.pstk``, or string dict key like
``stack["n_pad"]``) matching a declared dim is tracked at that dim's bound.
Runtime guards refine bounds: ``assert x <= C`` (and the equivalent
``if x > C: raise``) clamps ``x`` — the *proven-bounded cast* idiom the
LANNS030 fixes use.

Rules:

* LANNS030 — int32/uint32 value-range overflow at the bounds (flattened-id
  products like ``pi * n_pad`` landing in int32 storage).
* LANNS031 — implicit dtype promotion on a hot path: fp64 leaking into
  fp32 math, int8 arithmetic outside an explicit ``astype``/``.to``
  rescale.  (The reference also flags ``jnp.asarray`` silently narrowing
  int64 with x64 disabled; ``torch.as_tensor`` keeps int64, so that case
  has no torch counterpart.)
* LANNS032 — int64 values stored into int32 array or tensor slots without
  an explicit cast (``out[...] = rows`` casts silently in both numpy and
  torch).
* LANNS034 — the static device-resident footprint of a
  ``# lanns: budget[device<=8GiB]`` function, summed in closed form at the
  bounds, exceeds its declaration.  ``torch.`` constructors (unless given
  ``device="cpu"``) and ``.to(device)`` / ``.cuda()`` uploads count as
  device allocations.

The reference's LANNS033 (a jit static argument ranging over a declared
dim without pow2 bucketing) has no eager-torch meaning and is never
emitted.

``footprint_report`` emits the closed-form resident-bytes model of the
port's own allocations per engine x quantization mode (the
``--footprint-report`` CLI artifact).
"""

from __future__ import annotations

import ast
import dataclasses
from dataclasses import dataclass

from repro_torch.analysis.rules import Finding, SourceFile, attr_chain
from repro_torch.analysis.symdims import (
    DTYPE_BYTES,
    INT_RANGES,
    Sym,
    canon_dtype,
    fmt_bytes,
    is_float_dtype,
    is_int_dtype,
    next_pow2_bound,
    quarter_pow2_bound,
    sym_max,
    sym_min,
)
from repro_torch.analysis.tracelint import _FunctionIndex, hot_roster

BUCKET_FUNCS = {"next_pow2", "next_pow2_quarter"}
_SHAPE_CTORS = {"zeros", "ones", "empty", "full"}
_ARRAY_MODS = {"np", "numpy", "torch"}
_DTYPE_MODS = {"np", "numpy", "torch"}
_ARITH_OPS = (ast.Add, ast.Sub, ast.Mult, ast.Div, ast.FloorDiv, ast.Mod,
              ast.Pow, ast.MatMult)
#: tensor cast methods and the dtype each gives
_CAST_METHODS = {
    "float": "float32", "double": "float64", "half": "float16",
    "bfloat16": "bfloat16", "long": "int64", "int": "int32", "short": "int16",
    "char": "int8", "byte": "uint8", "bool": "bool",
}


@dataclass
class AV:
    """Abstract value: dtype + value interval + (symbolic) shape.

    ``dtype`` is a canonical dtype name, or the pseudo-dtypes
    "pyint"/"pyfloat"/"pybool" for Python scalars; None when unknown.
    ``shape`` is a tuple of scalar AVs (one per dim; None elements for
    unknown dims).  ``elts`` carries Python tuple/list literals (shape
    arguments, ``x.shape`` results).
    """

    dtype: str | None = None
    rng: Sym | None = None
    shape: tuple | None = None
    elts: tuple | None = None
    dtype_ref: str | None = None  # this AV *names* a dtype (torch.int32 arg)

    @property
    def is_const(self) -> bool:
        return self.rng is not None and self.rng.is_const


UNKNOWN = AV()


def _promote(da: str | None, db: str | None) -> str | None:
    if da == db:
        return da
    if da is None or db is None:
        # a known array dtype absorbs a Python scalar; anything else: unknown
        known = da if da is not None else db
        return known if known not in ("pyint", "pyfloat", "pybool") else None
    for weak in ("pybool", "pyint"):
        if da == weak:
            return db
        if db == weak:
            return da
    if "pyfloat" in (da, db):
        other = db if da == "pyfloat" else da
        return other if is_float_dtype(other) else None
    if is_float_dtype(da) or is_float_dtype(db):
        fa = da if is_float_dtype(da) else "float32"
        fb = db if is_float_dtype(db) else "float32"
        return fa if DTYPE_BYTES.get(fa, 0) >= DTYPE_BYTES.get(fb, 0) else fb
    if da in INT_RANGES and db in INT_RANGES:
        return da if DTYPE_BYTES[da] >= DTYPE_BYTES[db] else db
    return None


def _clamp_to_dtype(rng: Sym | None, dtype: str | None) -> Sym | None:
    if rng is None or dtype not in INT_RANGES:
        return rng
    lo, hi = INT_RANGES[dtype]
    return Sym(rng.expr, min(rng.hi, hi), max(rng.lo, lo))


class _FnInterp:
    """One forward pass over a function body at the declared bounds."""

    def __init__(self, src: SourceFile, qual: str, fn: ast.FunctionDef, *,
                 dims: dict[str, int], budget: dict[str, int],
                 consts: dict[str, AV], findings: list[Finding]) -> None:
        self.src = src
        self.qual = qual
        self.fn = fn
        self.dims = dims
        self.budget = budget
        self.findings = findings
        self.env: dict[str, AV] = dict(consts)
        self.refined: dict[str, int] = {}  # proven `expr <= C` facts
        self.allocs: list[tuple[int, Sym]] = []  # (line, device bytes)

    # -- plumbing ----------------------------------------------------------

    def _dim_av(self, name: str, cap: int | None = None) -> AV:
        hi = self.dims[name]
        if cap is not None:
            hi = min(hi, cap)
        return AV(dtype="pyint", rng=Sym(name, hi, 0))

    def _flag(self, code: str, lineno: int, msg: str) -> None:
        self.findings.append(Finding(code, self.src.path, lineno, msg))

    # -- entry -------------------------------------------------------------

    def run(self) -> None:
        args = self.fn.args
        for a in args.args + args.kwonlyargs + args.posonlyargs:
            if a.arg in self.dims:
                self.env[a.arg] = self._dim_av(a.arg)
        for stmt in self.fn.body:
            self.stmt(stmt)
        self._check_budget()

    def _check_budget(self) -> None:
        limit = self.budget.get("device")
        if limit is None:
            return
        if not self.allocs:
            return
        total = sum(b.hi for _, b in self.allocs)
        if total <= limit:
            return
        formula = " + ".join(b.expr for _, b in self.allocs)
        self._flag(
            "LANNS034", self.fn.lineno,
            f"`{self.qual}` device-resident footprint at declared bounds is "
            f"{fmt_bytes(total)} ({formula}) > budget[device<="
            f"{fmt_bytes(limit)}]",
        )

    # -- statements --------------------------------------------------------

    def stmt(self, node: ast.stmt) -> None:
        if isinstance(node, ast.Assign):
            av = self.eval(node.value)
            for t in node.targets:
                self.assign(t, av)
        elif isinstance(node, ast.AnnAssign):
            if node.value is not None:
                self.assign(node.target, self.eval(node.value))
        elif isinstance(node, ast.AugAssign):
            self.eval(node.value)
            if isinstance(node.target, ast.Name):
                # value changes across iterations: drop to unknown unless
                # the name is a declared dim (then the bound still holds)
                name = node.target.id
                self.env[name] = (
                    self._dim_av(name) if name in self.dims else UNKNOWN
                )
        elif isinstance(node, ast.Assert):
            self._refine_from_test(node.test)
        elif isinstance(node, ast.If):
            self.eval(node.test)
            raises = node.body and all(
                isinstance(s, ast.Raise) for s in node.body
            )
            if raises:
                # `if X > C: raise` proves X <= C on the fall-through
                self._refine_from_guard(node.test)
            else:
                for s in node.body:
                    self.stmt(s)
            for s in node.orelse:
                self.stmt(s)
        elif isinstance(node, ast.For):
            self._bind_loop(node.target, node.iter)
            for s in node.body + node.orelse:
                self.stmt(s)
        elif isinstance(node, ast.While):
            self.eval(node.test)
            for s in node.body + node.orelse:
                self.stmt(s)
        elif isinstance(node, ast.With):
            for s in node.body:
                self.stmt(s)
        elif isinstance(node, ast.Try):
            for s in node.body + node.finalbody:
                self.stmt(s)
            for h in node.handlers:
                for s in h.body:
                    self.stmt(s)
        elif isinstance(node, (ast.Return, ast.Expr)):
            if node.value is not None:
                self.eval(node.value)
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    self.env.pop(t.id, None)
        # nested defs/classes: separate scopes, skipped on purpose

    def _bind_loop(self, target: ast.AST, it: ast.AST) -> None:
        if isinstance(it, ast.Call) and isinstance(target, ast.Name):
            chain = attr_chain(it.func)
            if chain == "range" and it.args:
                stop = self.eval(it.args[0 if len(it.args) == 1 else 1])
                if stop.rng is not None:
                    self.env[target.id] = AV(
                        dtype="pyint",
                        rng=Sym(target.id, max(stop.rng.hi - 1, 0), 0),
                    )
                    return
        self._bind_names(target)

    def _bind_names(self, target: ast.AST) -> None:
        """Fallback loop-target binding: declared dims keep their bound."""
        for n in ast.walk(target):
            if isinstance(n, ast.Name):
                self.env[n.id] = (
                    self._dim_av(n.id) if n.id in self.dims else UNKNOWN
                )

    def assign(self, target: ast.AST, av: AV) -> None:
        if isinstance(target, ast.Name):
            name = target.id
            if name in self.dims and av.shape is None and av.elts is None:
                cap = av.rng.hi if av.rng is not None else None
                self.env[name] = self._dim_av(name, cap)
            else:
                self.env[name] = av
        elif isinstance(target, (ast.Tuple, ast.List)):
            vals = av.elts
            if vals is not None and len(vals) == len(target.elts):
                for t, v in zip(target.elts, vals):
                    self.assign(t, v if v is not None else UNKNOWN)
            else:
                self._bind_names(target)
        elif isinstance(target, ast.Subscript):
            self._check_store(target, av)
        elif isinstance(target, ast.Starred):
            self.assign(target.value, UNKNOWN)
        # attribute targets (self.x = ...) are not tracked

    def _check_store(self, target: ast.Subscript, val: AV) -> None:
        base = self.eval(target.value)
        self.eval(target.slice)
        if base.dtype not in ("int32", "uint32"):
            return
        if val.dtype in ("int64", "uint64"):
            self._flag(
                "LANNS032", target.lineno,
                f"{val.dtype} value stored into {base.dtype} slots of "
                f"`{ast.unparse(target.value)}` in `{self.qual}` — cast "
                "explicitly after a bounds assert",
            )
            return
        lo, hi = INT_RANGES[base.dtype]
        if val.rng is not None and (val.rng.hi > hi or val.rng.lo < lo):
            self._flag(
                "LANNS030", target.lineno,
                f"store into {base.dtype} `{ast.unparse(target.value)}` in "
                f"`{self.qual}`: value {val.rng.expr} reaches "
                f"{val.rng.hi:_} at declared bounds (> {hi:_})",
            )

    # -- guard refinement --------------------------------------------------

    def _const_of(self, node: ast.AST) -> int | None:
        av = self.eval(node)
        if av.rng is not None and av.rng.is_const:
            return av.rng.hi
        return None

    def _refine_from_test(self, test: ast.AST) -> None:
        """assert X <= C / X < C: clamp X (Name or Name+Y) and memoize."""
        if not (isinstance(test, ast.Compare) and len(test.ops) == 1):
            return
        op = test.ops[0]
        if not isinstance(op, (ast.LtE, ast.Lt)):
            return
        bound = self._const_of(test.comparators[0])
        if bound is None:
            return
        if isinstance(op, ast.Lt):
            bound -= 1
        self._refine_le(test.left, bound)

    def _refine_from_guard(self, test: ast.AST) -> None:
        """`if X > C: raise` / `if X >= C: raise`: fall-through has X <= C."""
        if not (isinstance(test, ast.Compare) and len(test.ops) == 1):
            return
        op = test.ops[0]
        if not isinstance(op, (ast.Gt, ast.GtE)):
            return
        bound = self._const_of(test.comparators[0])
        if bound is None:
            return
        if isinstance(op, ast.GtE):
            bound -= 1
        self._refine_le(test.left, bound)

    def _refine_le(self, left: ast.AST, bound: int) -> None:
        av = self.eval(left)
        if av.rng is not None:
            self.refined[av.rng.expr] = min(
                self.refined.get(av.rng.expr, bound), bound
            )
        if isinstance(left, ast.Name) and left.id in self.env:
            cur = self.env[left.id]
            if cur.rng is not None:
                self.env[left.id] = dataclasses.replace(
                    cur, rng=cur.rng.clamp_hi(bound)
                )
        elif isinstance(left, ast.BinOp) and isinstance(left.op, ast.Add) \
                and isinstance(left.left, ast.Name):
            other = self.eval(left.right)
            slack = other.rng.lo if other.rng is not None else 0
            cur = self.env.get(left.left.id)
            if cur is not None and cur.rng is not None:
                self.env[left.left.id] = dataclasses.replace(
                    cur, rng=cur.rng.clamp_hi(bound - slack)
                )

    # -- expressions -------------------------------------------------------

    def eval(self, node: ast.AST) -> AV:
        if isinstance(node, ast.Constant):
            if isinstance(node.value, bool):
                return AV(dtype="pybool")
            if isinstance(node.value, int):
                return AV(dtype="pyint", rng=Sym.lit(node.value))
            if isinstance(node.value, float):
                return AV(dtype="pyfloat")
            if isinstance(node.value, str):
                dt = canon_dtype(node.value)
                return AV(dtype_ref=dt) if dt else UNKNOWN
            return UNKNOWN
        if isinstance(node, ast.Name):
            if node.id in self.env:
                return self.env[node.id]
            if node.id in self.dims:
                return self._dim_av(node.id)
            return UNKNOWN
        if isinstance(node, (ast.Tuple, ast.List)):
            return AV(elts=tuple(self.eval(e) for e in node.elts))
        if isinstance(node, ast.BinOp):
            return self._binop(node)
        if isinstance(node, ast.UnaryOp):
            inner = self.eval(node.operand)
            if isinstance(node.op, ast.USub) and inner.rng is not None:
                return dataclasses.replace(inner, rng=-inner.rng)
            if isinstance(node.op, ast.Not):
                return AV(dtype="pybool")
            return dataclasses.replace(inner, rng=None)
        if isinstance(node, ast.Compare):
            self.eval(node.left)
            for c in node.comparators:
                self.eval(c)
            return AV(dtype="pybool")
        if isinstance(node, ast.BoolOp):
            for v in node.values:
                self.eval(v)
            return UNKNOWN
        if isinstance(node, ast.IfExp):
            self.eval(node.test)
            a, b = self.eval(node.body), self.eval(node.orelse)
            if a.dtype == b.dtype and a.rng is not None and b.rng is not None:
                return AV(dtype=a.dtype, rng=a.rng.hull(b.rng))
            return UNKNOWN
        if isinstance(node, ast.Call):
            return self._call(node)
        if isinstance(node, ast.Attribute):
            return self._attr(node)
        if isinstance(node, ast.Subscript):
            return self._subscript(node)
        if isinstance(node, ast.Starred):
            return self.eval(node.value)
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                             ast.GeneratorExp)):
            for gen in node.generators:
                self.eval(gen.iter)
            return UNKNOWN
        if isinstance(node, ast.Slice):
            for part in (node.lower, node.upper, node.step):
                if part is not None:
                    self.eval(part)
            return UNKNOWN
        return UNKNOWN

    def _binop(self, node: ast.BinOp) -> AV:
        lt, rt = self.eval(node.left), self.eval(node.right)
        if isinstance(node.op, _ARITH_OPS):
            self._check_promotion(node, lt, rt)
        dtype = _promote(lt.dtype, rt.dtype)
        rng: Sym | None = None
        if lt.rng is not None and rt.rng is not None:
            if isinstance(node.op, ast.Add):
                rng = lt.rng + rt.rng
            elif isinstance(node.op, ast.Sub):
                rng = lt.rng - rt.rng
            elif isinstance(node.op, ast.Mult):
                rng = lt.rng * rt.rng
            elif isinstance(node.op, ast.FloorDiv):
                rng = lt.rng // rt.rng
            elif isinstance(node.op, ast.Mod):
                rng = lt.rng % rt.rng
            elif isinstance(node.op, ast.MatMult):
                rng = self._matmul_rng(lt, rt)
        if isinstance(node.op, ast.Div):
            dtype = dtype if is_float_dtype(dtype) else "pyfloat"
            rng = None
        if rng is not None and rng.expr in self.refined:
            rng = rng.clamp_hi(self.refined[rng.expr])
        shape = lt.shape if lt.shape is not None else rt.shape
        if isinstance(node.op, ast.MatMult):
            shape = None
        self._check_int_range(node.lineno, dtype, rng,
                              f"`{ast.unparse(node)}`")
        return AV(dtype=dtype, rng=rng, shape=shape)

    def _matmul_rng(self, lt: AV, rt: AV) -> Sym | None:
        """int matmul accumulator bound: contraction length x |a| x |b|."""
        if lt.shape is None or not lt.shape or lt.shape[-1] is None:
            return None
        contraction = lt.shape[-1]
        if contraction.rng is None or lt.rng is None or rt.rng is None:
            return None
        mags = (abs(lt.rng.hi), abs(lt.rng.lo), abs(rt.rng.hi),
                abs(rt.rng.lo))
        a = Sym(lt.rng.expr, max(mags[:2]), -max(mags[:2]))
        b = Sym(rt.rng.expr, max(mags[2:]), -max(mags[2:]))
        return contraction.rng * a * b

    def _check_promotion(self, node: ast.BinOp, lt: AV, rt: AV) -> None:
        dts = {lt.dtype, rt.dtype}
        if "float64" in dts and "float32" in dts:
            self._flag(
                "LANNS031", node.lineno,
                f"float64 x float32 arithmetic in `{self.qual}` "
                f"(`{ast.unparse(node)}`): fp64 leaks into a hot path's "
                "fp32 math — pin float32",
            )
        if "int8" in dts:
            self._flag(
                "LANNS031", node.lineno,
                f"int8 arithmetic without an explicit cast in "
                f"`{self.qual}` (`{ast.unparse(node)}`): the int8 "
                "accumulator wraps at +-127 products — rescale via "
                ".astype(...) / .to(...) first",
            )

    def _check_int_range(self, lineno: int, dtype: str | None,
                         rng: Sym | None, what: str) -> None:
        if dtype not in ("int32", "uint32") or rng is None:
            return
        lo, hi = INT_RANGES[dtype]
        if rng.hi > hi or rng.lo < lo:
            self._flag(
                "LANNS030", lineno,
                f"{what} is {dtype} but reaches {rng.hi:_} at declared "
                f"bounds ({rng.expr}) — exceeds {dtype} "
                f"[{lo:_}, {hi:_}] in `{self.qual}`",
            )

    # -- attribute / subscript --------------------------------------------

    def _attr(self, node: ast.Attribute) -> AV:
        chain = attr_chain(node)
        dt = canon_dtype(chain) if chain else None
        if dt and chain.split(".")[0] in _DTYPE_MODS:
            return AV(dtype_ref=dt)
        # np.iinfo(np.int32).max / torch.iinfo(torch.int32).min
        if node.attr in ("max", "min") and isinstance(node.value, ast.Call):
            ichain = attr_chain(node.value.func)
            if ichain and ichain.split(".")[-1] == "iinfo" \
                    and node.value.args:
                ref = self.eval(node.value.args[0]).dtype_ref
                if ref in INT_RANGES:
                    lo, hi = INT_RANGES[ref]
                    v = hi if node.attr == "max" else lo
                    return AV(dtype="pyint", rng=Sym.lit(v))
        base = self.eval(node.value)
        if node.attr == "shape":
            if base.shape is not None:
                return AV(elts=base.shape)
            return UNKNOWN
        if node.attr == "size" and base.shape is not None:
            rng = None
            if all(d is not None and d.rng is not None for d in base.shape):
                rng = Sym.lit(1)
                for d in base.shape:
                    rng = rng * d.rng
            return AV(dtype="pyint", rng=rng)
        if node.attr in ("T", "mT"):
            shape = None
            if base.shape is not None:
                shape = tuple(reversed(base.shape))
            return dataclasses.replace(base, shape=shape, elts=None)
        if node.attr in self.dims:
            return self._dim_av(node.attr)
        return UNKNOWN

    def _subscript(self, node: ast.Subscript) -> AV:
        base = self.eval(node.value)
        idx = node.slice
        if base.elts is not None and isinstance(idx, ast.Constant) \
                and isinstance(idx.value, int) \
                and -len(base.elts) <= idx.value < len(base.elts):
            got = base.elts[idx.value]
            return got if got is not None else UNKNOWN
        if isinstance(idx, ast.Constant) and isinstance(idx.value, str) \
                and idx.value in self.dims:
            self.eval(idx)
            return self._dim_av(idx.value)
        self.eval(idx)
        if base.dtype in (None, "pyint", "pyfloat", "pybool") \
                and base.elts is None and base.shape is None:
            return UNKNOWN
        return AV(dtype=base.dtype, rng=base.rng)

    # -- calls -------------------------------------------------------------

    def _kw(self, node: ast.Call, name: str) -> ast.AST | None:
        for kw in node.keywords:
            if kw.arg == name:
                return kw.value
        return None

    def _dtype_arg(self, node: ast.AST | None) -> str | None:
        if node is None:
            return None
        return self.eval(node).dtype_ref

    def _shape_of(self, av: AV) -> tuple | None:
        if av.elts is not None:
            return tuple(
                e if e is not None and e.rng is not None else None
                for e in av.elts
            )
        if av.rng is not None:
            return (av,)
        return None

    def _size_arg(self, node: ast.Call, arg_avs: list[AV],
                  n_size: int | None) -> AV:
        """torch takes a size as one tuple or as leading ints
        (``torch.zeros(B, k)``); ``n_size`` is how many leading positional
        arguments form the size (None: all of them)."""
        if arg_avs and arg_avs[0].elts is not None:
            return arg_avs[0]
        parts = arg_avs if n_size is None else arg_avs[:n_size]
        return AV(elts=tuple(parts)) if len(parts) > 1 else arg_avs[0]

    def _infer_reshape(self, shape: tuple | None,
                       base_shape: tuple | None) -> tuple | None:
        """Resolve a single -1 wildcard dim from the source total.

        ``x.reshape(-1, C)`` keeps x's element count: the wildcard is
        total // prod(other dims).  With an unknown source shape (or more
        than one wildcard) the -1 stays, which downstream checks treat as
        an unknown dim — conservative, never flagged.
        """
        if shape is None or base_shape is None:
            return shape
        wild = [j for j, s in enumerate(shape)
                if s is not None and s.rng is not None
                and s.rng.is_const and s.rng.hi == -1]
        if len(wild) != 1 or any(
            s is None or s.rng is None for s in base_shape
        ):
            return shape
        total = Sym.lit(1)
        for s in base_shape:
            total = total * s.rng
        inferred = total
        for j, s in enumerate(shape):
            if j != wild[0] and s is not None and s.rng is not None:
                inferred = inferred // s.rng
            elif j != wild[0]:
                return shape  # a sibling dim is unknown: keep the -1
        return tuple(
            AV(dtype="pyint", rng=inferred) if j == wild[0] else s
            for j, s in enumerate(shape)
        )

    def _device_alloc(self, lineno: int, shape: tuple | None,
                      dtype: str | None, label: str) -> None:
        if not self.budget or shape is None or dtype not in DTYPE_BYTES:
            return
        if any(d is None or d.rng is None for d in shape):
            return
        nbytes = Sym.lit(DTYPE_BYTES[dtype])
        for d in shape:
            nbytes = nbytes * d.rng
        self.allocs.append(
            (lineno, Sym(f"{label}:{nbytes.expr}", nbytes.hi, nbytes.lo))
        )

    def _cast(self, node: ast.Call, base: AV, dt: str | None) -> AV:
        self._check_int_range(
            node.lineno, dt, base.rng,
            f"cast of `{ast.unparse(node.func.value)}` to {dt}",
        )
        return AV(dtype=dt, rng=_clamp_to_dtype(base.rng, dt),
                  shape=base.shape)

    def _method(self, node: ast.Call, arg_avs: list[AV]) -> AV | None:
        """x.astype(dt) / x.to(dt | device) / x.long() / x.reshape(...) /
        x.cumsum(...) ...; None when the method is not modelled."""
        attr = node.func.attr
        base = self.eval(node.func.value)
        if attr == "astype" and node.args:
            return self._cast(node, base, self._dtype_arg(node.args[0]))
        if attr in ("to", "type"):
            dt = self._dtype_arg(self._kw(node, "dtype"))
            for a in node.args:
                dt = dt or self._dtype_arg(a)
            if dt is not None:
                return self._cast(node, base, dt)
            # an upload: .to(device)
            self._device_alloc(node.lineno, base.shape, base.dtype,
                               ".to(device)")
            return dataclasses.replace(base, elts=None)
        if attr == "cuda":
            self._device_alloc(node.lineno, base.shape, base.dtype, ".cuda()")
            return dataclasses.replace(base, elts=None)
        if attr in _CAST_METHODS and not node.args:
            return self._cast(node, base, _CAST_METHODS[attr])
        if attr in ("reshape", "view"):
            shape_av = (
                arg_avs[0] if len(arg_avs) == 1 and
                arg_avs[0].elts is not None else AV(elts=tuple(arg_avs))
            )
            shape = self._infer_reshape(
                self._shape_of(shape_av), base.shape
            )
            return dataclasses.replace(base, shape=shape, elts=None)
        if attr == "cumsum":
            return self._cumsum(node, base)
        if attr in ("copy", "ravel", "flatten", "squeeze", "clone",
                    "contiguous"):
            return dataclasses.replace(base, shape=None, elts=None)
        if attr in ("sum", "max", "min", "mean", "item"):
            return AV(dtype=base.dtype)
        return None

    def _cumsum(self, node: ast.Call, x: AV) -> AV:
        """Running sum.  torch (and numpy, on a 64-bit platform) promote an
        integer input to int64 unless ``dtype=`` names the accumulator,
        which then wraps past its range (the reference's jnp keeps int32)."""
        dt = self._dtype_arg(self._kw(node, "dtype"))
        if dt is None:
            dt = "int64" if is_int_dtype(x.dtype) else x.dtype
        rng = None
        if x.rng is not None and x.shape is not None and \
                all(d is not None and d.rng is not None for d in x.shape):
            total = Sym.lit(1)
            for d in x.shape:
                total = total * d.rng
            m = max(abs(x.rng.hi), abs(x.rng.lo))
            rng = total * Sym(f"|{x.rng.expr}|", m, -m)
        self._check_int_range(
            node.lineno, dt, rng,
            f"`{ast.unparse(node)}` (the running sum's accumulator)",
        )
        return AV(dtype=dt, rng=rng, shape=x.shape)

    def _call(self, node: ast.Call) -> AV:
        arg_avs = [self.eval(a) for a in node.args]
        for kw in node.keywords:
            if kw.arg is None:
                self.eval(kw.value)
        chain = attr_chain(node.func)
        tail = chain.split(".")[-1] if chain else ""
        root = chain.split(".")[0] if chain else ""

        if isinstance(node.func, ast.Attribute) and root not in _ARRAY_MODS:
            got = self._method(node, arg_avs)
            if got is not None:
                return got

        if root in _ARRAY_MODS:
            return self._array_call(node, root, tail, arg_avs)

        if tail in BUCKET_FUNCS and arg_avs:
            x = arg_avs[0]
            bound = next_pow2_bound if tail == "next_pow2" \
                else quarter_pow2_bound
            rng = bound(x.rng) if x.rng is not None else None
            return AV(dtype="pyint", rng=rng)
        if tail == "round_up" and arg_avs:
            x = arg_avs[0]
            if x.rng is None:
                return AV(dtype="pyint")
            m = arg_avs[1].rng if len(arg_avs) > 1 and \
                arg_avs[1].rng is not None else x.rng
            return AV(dtype="pyint",
                      rng=Sym(f"round_up({x.rng.expr})",
                              x.rng.hi + max(m.hi - 1, 0), x.rng.lo))
        if isinstance(node.func, ast.Name):
            builtin = self._builtin(node, arg_avs)
            if builtin is not None:
                return builtin
        return UNKNOWN

    def _builtin(self, node: ast.Call, arg_avs: list[AV]) -> AV | None:
        name = node.func.id
        if name == "len" and arg_avs:
            x = arg_avs[0]
            if x.shape is not None and x.shape[0] is not None:
                return x.shape[0]
            if x.elts is not None:
                return AV(dtype="pyint", rng=Sym.lit(len(x.elts)))
            return AV(dtype="pyint")
        if name in ("min", "max") and len(arg_avs) >= 2:
            known = [a.rng for a in arg_avs if a.rng is not None]
            fn = sym_min if name == "min" else sym_max
            rng = None
            if name == "min" and known:
                rng = fn(*known)  # any known arg upper-bounds a min
            elif name == "max" and len(known) == len(arg_avs):
                rng = fn(*known)
            return AV(dtype="pyint", rng=rng)
        if name == "int" and arg_avs:
            return AV(dtype="pyint", rng=arg_avs[0].rng)
        if name == "abs" and arg_avs:
            x = arg_avs[0]
            if x.rng is not None:
                m = max(abs(x.rng.hi), abs(x.rng.lo))
                return dataclasses.replace(
                    x, rng=Sym(f"abs({x.rng.expr})", m, 0)
                )
            return x
        return None

    def _on_device(self, node: ast.Call) -> bool:
        """A ``torch.`` constructor allocates on the device unless it is
        told ``device="cpu"``."""
        dev = self._kw(node, "device")
        return not (isinstance(dev, ast.Constant) and dev.value == "cpu")

    def _array_call(self, node: ast.Call, root: str, tail: str,
                    arg_avs: list[AV]) -> AV:
        is_torch = root == "torch"
        device = is_torch and self._on_device(node)
        if tail in _SHAPE_CTORS and arg_avs:
            if tail == "full":
                shape = self._shape_of(arg_avs[0])
                dt = self._dtype_arg(
                    self._kw(node, "dtype") if is_torch or len(node.args) < 3
                    else node.args[2]
                )
                fill = arg_avs[1] if len(arg_avs) > 1 else UNKNOWN
                if dt is None:
                    dt = {"pyint": "int64", "pybool": "bool",
                          "pyfloat": "float32" if is_torch else "float64"}.get(
                        fill.dtype
                    )
                self._check_int_range(
                    node.lineno, dt, fill.rng,
                    f"fill value of `{ast.unparse(node)}`",
                )
                rng = _clamp_to_dtype(fill.rng, dt)
            else:
                shape = self._shape_of(
                    self._size_arg(node, arg_avs, None) if is_torch
                    else arg_avs[0]
                )
                dt = self._dtype_arg(
                    self._kw(node, "dtype") if is_torch or len(node.args) < 2
                    else node.args[1]
                )
                if dt is None:
                    dt = "float32" if is_torch else "float64"
                rng = Sym.lit(0) if tail == "zeros" else (
                    Sym.lit(1) if tail == "ones" else None
                )
            if device:
                self._device_alloc(node.lineno, shape, dt, f"torch.{tail}")
            return AV(dtype=dt, rng=rng, shape=shape)
        if tail == "arange" and arg_avs:
            stop = arg_avs[-1] if len(node.args) >= 2 else arg_avs[0]
            dt = self._dtype_arg(self._kw(node, "dtype"))
            if dt is None:
                dt = "int64"  # numpy and torch alike, for integer bounds
            rng = None
            if stop.rng is not None:
                rng = Sym(f"{stop.rng.expr} - 1", max(stop.rng.hi - 1, 0), 0)
            self._check_int_range(
                node.lineno, dt, rng, f"`{ast.unparse(node)}`"
            )
            shape = (stop,) if stop.rng is not None else None
            if device:
                self._device_alloc(node.lineno, shape, dt, "torch.arange")
            return AV(dtype=dt, rng=_clamp_to_dtype(rng, dt), shape=shape)
        if tail in ("asarray", "array", "as_tensor", "tensor", "from_numpy") \
                and arg_avs:
            x = arg_avs[0]
            dt = self._dtype_arg(
                node.args[1] if len(node.args) > 1 and not is_torch
                else self._kw(node, "dtype")
            )
            out = dataclasses.replace(x, elts=None)
            if dt is not None:
                self._check_int_range(
                    node.lineno, dt, x.rng, f"`{ast.unparse(node)}`",
                )
                out = dataclasses.replace(
                    out, dtype=dt, rng=_clamp_to_dtype(x.rng, dt)
                )
            if is_torch and self._kw(node, "device") is not None and device:
                self._device_alloc(node.lineno, out.shape, out.dtype,
                                   f"torch.{tail}")
            return out
        if tail in ("broadcast_to", "expand") and len(arg_avs) >= 2:
            x = arg_avs[0]
            return AV(dtype=x.dtype, rng=x.rng,
                      shape=self._shape_of(arg_avs[1]))
        if tail == "reshape" and len(arg_avs) >= 2:
            x = arg_avs[0]
            return AV(dtype=x.dtype, rng=x.rng,
                      shape=self._shape_of(arg_avs[1]))
        if tail == "cumsum" and arg_avs:
            return self._cumsum(node, arg_avs[0])
        if tail in ("clip", "clamp") and len(arg_avs) >= 3:
            x, lo, hi = arg_avs[0], arg_avs[1], arg_avs[2]
            rng = None
            if lo.rng is not None and hi.rng is not None:
                rng = Sym(f"clip({x.rng.expr if x.rng else '?'})",
                          hi.rng.hi, lo.rng.lo)
            return AV(dtype=x.dtype, rng=rng, shape=x.shape)
        if tail in ("concatenate", "stack", "vstack", "hstack", "cat"):
            parts = arg_avs[0].elts if arg_avs and arg_avs[0].elts else ()
            dt = None
            rng = None
            for p in parts:
                if p is None:
                    return UNKNOWN
                dt = _promote(dt, p.dtype) if dt is not None else p.dtype
                if p.rng is not None:
                    rng = rng.hull(p.rng) if rng is not None else p.rng
                else:
                    rng = None
            return AV(dtype=dt, rng=rng)
        if tail == "where" and len(arg_avs) >= 3:
            a, b = arg_avs[1], arg_avs[2]
            dt = _promote(a.dtype, b.dtype)
            rng = a.rng.hull(b.rng) \
                if a.rng is not None and b.rng is not None else None
            return AV(dtype=dt, rng=rng)
        if tail in ("argpartition", "argsort", "argmax", "argmin"):
            return AV(dtype="int64")
        if tail in ("take_along_axis", "gather", "rint", "maximum",
                    "minimum", "abs"):
            x = arg_avs[0] if arg_avs else UNKNOWN
            return AV(dtype=x.dtype, rng=x.rng)
        if not is_torch and tail in ("int8", "int16", "int32", "int64",
                                     "uint32", "float32", "float64"):
            x = arg_avs[0] if arg_avs else UNKNOWN
            self._check_int_range(
                node.lineno, tail, x.rng, f"`{ast.unparse(node)}`"
            )
            return AV(dtype=tail, rng=_clamp_to_dtype(x.rng, tail))
        return UNKNOWN


# ---------------------------------------------------------------------------
# module pass
# ---------------------------------------------------------------------------


def _module_consts(src: SourceFile) -> dict[str, AV]:
    """Constant-fold simple module-level ``NAME = <int expr>`` bindings."""
    probe = _FnInterp(
        src, "<module>", ast.parse("def _probe(): pass").body[0],
        dims={}, budget={}, consts={}, findings=[],
    )
    consts: dict[str, AV] = {}
    for stmt in src.tree.body:
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name):
            probe.env = dict(consts)
            probe.findings = []
            av = probe.eval(stmt.value)
            if av.rng is not None and av.rng.is_const:
                consts[stmt.targets[0].id] = av
    return consts


def run(src: SourceFile) -> list[Finding]:
    if not src.dims and not src.budget:
        return []
    idx = _FunctionIndex()
    idx.visit(src.tree)
    claimed: set[int] = set()
    for fn in idx.funcs.values():
        claimed |= src._anchor_lines(fn) & (set(src.dims) | set(src.budget))
    mod_dims = src.module_dims(claimed)
    hot = hot_roster(src)
    consts = _module_consts(src)
    findings: list[Finding] = []
    for qual, fn in sorted(idx.funcs.items()):
        fdims = src.func_dims(fn)
        fbudget = src.func_budget(fn)
        dims = {**mod_dims, **fdims}
        if not dims and not fbudget:
            continue
        if not (qual in hot or fdims or fbudget):
            continue
        _FnInterp(src, qual, fn, dims=dims, budget=fbudget, consts=consts,
                  findings=findings).run()
    return findings


# ---------------------------------------------------------------------------
# footprint report (closed-form resident-bytes model)
# ---------------------------------------------------------------------------

#: the reference's default bounds (People-180M at 2048d); ``n_part`` (the
#: largest partition) defaults to ceil(n / P), balanced partitions
DEFAULT_FOOTPRINT_DIMS = {
    "n": 180_000_000, "d": 2048, "P": 4096, "M": 32, "L": 4,
}

#: where the port's layout differs from the reference's model, row by row
PAD_MODEL = {
    "scan_rows": "n: each scan partition holds exactly its rows "
                 "(`_Partition.vectors`, `_Q8Partition.codes`); the "
                 "reference pads scan corpora to 1.25*n (quarter-pow2)",
    "hnsw_rows": "P*n_pad, n_pad = next_pow2(n_part): the flat stack pads every partition "
                 "to the pow2 of the largest (`LannsIndex._hnsw_pads`); the "
                 "reference bounds it by 2*n",
    "q8_code_cols": "d4 = round_up(d, 4): scan codes are zero-padded along d to a "
                    "multiple of 4 for K2's int8 MMA (`_Q8Partition`)",
    "keys": "int64 keys live on the device next to the rows they name "
            "(scan and HNSW); the reference keeps them on the host",
    "q8_scales": "per-partition scales P*d on the device (scan and HNSW); "
                 "the reference models one d-vector for the scan and keeps "
                 "the HNSW scales on the host",
    "entry": "the HNSW entry points are int64 (P*8) on the host",
    "rerank_store": "the exact store (vectors, norms2, keys) is host memory; "
                    "in rerank_store='device' mode (the default on CUDA) its "
                    "vectors and norms2 are also copied to the device at "
                    "first use, which the resident counts leave out, as "
                    "`LannsIndex.hnsw_resident_bytes` does",
}


def _pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def footprint_report(dims: dict[str, int] | None = None) -> dict:
    """Closed-form device/host resident bytes per engine x quantized mode.

    Formulas mirror the port's allocations: ``_Partition`` (fp32 rows and
    int64 keys on the device), ``_Q8Partition`` (int8 codes padded along d
    to a multiple of 4, per-partition scales, a per-row bias, keys; the
    host ``ExactStore``), and ``LannsIndex._hnsw_stack`` (P*n_pad flat
    rows, n_pad = next_pow2 of the largest partition: vectors or codes +
    norms2, adj0 (2M wide), upper_adj (L levels), keys, q8 scales).  ``n``
    counts the rows the partitions hold, ``P`` the non-empty partitions,
    ``L`` the stack's upper levels and ``n_part`` the largest partition
    (default ceil(n / P)).  ``PAD_MODEL`` names every row whose layout
    differs from the reference's.
    """
    dd = {**DEFAULT_FOOTPRINT_DIMS, **(dims or {})}
    dd.setdefault("n_part", -(-dd["n"] // dd["P"]))
    n = Sym("n", dd["n"])
    d = Sym("d", dd["d"])
    P = Sym("P", dd["P"])
    M = Sym("M", dd["M"])
    L = Sym("L", dd["L"])
    d4 = Sym("d4", -(-dd["d"] // 4) * 4)  # round_up(d, 4)
    n_pad = _pow2(dd["n_part"])
    rows = P * Sym("n_pad", n_pad, n_pad)  # n_pad = next_pow2(n_part)

    modes = {
        "fp32_scan": {
            "device": [
                ("vectors", n * d * 4),
                ("keys", n * 8),
            ],
            "host": [],
        },
        "q8_scan": {
            "device": [
                ("codes", n * d4 * 1),
                ("scales", P * d * 4),
                ("bias", n * 4),
                ("keys", n * 8),
            ],
            "host": [
                ("rerank_store.vectors", n * d * 4),
                ("rerank_store.norms2", n * 4),
                ("rerank_store.keys", n * 8),
            ],
        },
        "fp32_hnsw": {
            "device": [
                ("vectors", rows * d * 4),
                ("adj0", rows * (2 * M) * 4),
                ("upper_adj", L * rows * M * 4),
                ("keys", rows * 8),
            ],
            "host": [("entry", P * 8)],
        },
        "q8_hnsw": {
            "device": [
                ("codes", rows * d * 1),
                ("norms2", rows * 4),
                ("adj0", rows * (2 * M) * 4),
                ("upper_adj", L * rows * M * 4),
                ("keys", rows * 8),
                ("scales", P * d * 4),
            ],
            "host": [
                ("rerank_store.vectors", n * d * 4),
                ("rerank_store.norms2", n * 4),
                ("rerank_store.keys", n * 8),
                ("entry", P * 8),
            ],
        },
    }

    metrics: dict[str, float] = {}
    rows_out: list[dict] = []
    for mode, placements in modes.items():
        for placement, comps in placements.items():
            total = 0
            for cname, sym in comps:
                total += sym.hi
                rows_out.append({
                    "mode": mode, "placement": placement,
                    "component": cname, "formula": f"{sym.expr} bytes",
                    "bytes": int(sym.hi),
                })
            metrics[f"footprint_{mode}_{placement}_bytes"] = float(total)
    return {
        "dims": {k: dd[k] for k in ("n", "d", "P", "M", "L", "n_part")},
        "pad_model": dict(PAD_MODEL),
        "metrics": metrics,
        "rows": rows_out,
    }


def index_footprint_dims(index) -> dict[str, int]:
    """A built ``LannsIndex``'s own footprint dims, for calibrating the
    model against the bytes it measures: ``n`` the rows its partitions
    hold, ``d`` their stored width, ``P`` the non-empty partitions,
    ``n_part`` the largest, ``M`` the HNSW degree and ``L`` the flat
    stack's upper levels (0 for a scan index)."""
    parts = [p for p in index.partitions.values() if p.size > 0]
    sizes = [p.size for p in parts]
    hnsw = [p for p in parts if p.kind == "hnsw"]
    if hnsw:
        d = hnsw[0].frozen.vectors.shape[1]
        levels = max(p.frozen.num_upper_levels for p in hnsw)
    else:
        p0 = parts[0]
        d = (p0.vectors if p0.vectors is not None else p0.host_vectors).shape[1]
        levels = 0
    return {"n": sum(sizes), "d": int(d), "P": len(parts), "M": index.config.hnsw_m,
            "L": int(levels), "n_part": max(sizes)}
