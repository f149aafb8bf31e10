"""Symbolic dimension algebra for the scale-safety pass (scalecheck).

The port of ``repro.analysis.symdims``, with torch's dtype names
(``torch.int32``, ``torch.long``, ``torch.float`` ...) in the dtype tables.

A ``Sym`` is a closed-form expression over declared dimension names plus a
conservative integer interval ``[lo, hi]`` — the value range the expression
can take when every declared dim sits at its bound.  The abstract
interpreter in ``scalecheck.py`` threads Syms through numpy/torch shape and
index arithmetic; the interval is what the LANNS03x rules test, the
expression string is what their messages (and the footprint report) print.

Also home to the ``dims[...]`` / ``budget[...]`` directive grammars and the
dtype width/range tables shared by the rules.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

_DIM_ITEM_RE = re.compile(r"^(?P<name>[A-Za-z_]\w*)\s*<=\s*(?P<val>[\d_]+)$")
_BUDGET_ITEM_RE = re.compile(
    r"^(?P<name>[A-Za-z_]\w*)\s*<=\s*(?P<val>[\d_]+(?:\.\d+)?)\s*"
    r"(?P<unit>[KMGT]i?B|B)?$"
)

_UNIT_BYTES = {
    None: 1, "B": 1,
    "KiB": 2 ** 10, "MiB": 2 ** 20, "GiB": 2 ** 30, "TiB": 2 ** 40,
    "KB": 10 ** 3, "MB": 10 ** 6, "GB": 10 ** 9, "TB": 10 ** 12,
}


def parse_dims(body: str, *, where: str = "?") -> dict[str, int]:
    """``"n<=180_000_000, d<=2048"`` -> ``{"n": 180000000, "d": 2048}``."""
    out: dict[str, int] = {}
    for item in body.split(","):
        item = item.strip()
        if not item:
            continue
        m = _DIM_ITEM_RE.match(item)
        if not m:
            raise ValueError(
                f"{where}: malformed dims[...] item {item!r} "
                "(expected name<=integer)"
            )
        out[m.group("name")] = int(m.group("val"))
    return out


def parse_budget(body: str, *, where: str = "?") -> dict[str, int]:
    """``"device<=8GiB"`` -> ``{"device": 8589934592}`` (bytes)."""
    out: dict[str, int] = {}
    for item in body.split(","):
        item = item.strip()
        if not item:
            continue
        m = _BUDGET_ITEM_RE.match(item)
        if not m:
            raise ValueError(
                f"{where}: malformed budget[...] item {item!r} "
                "(expected name<=<number><unit>, unit in B/KiB/MiB/GiB/TiB)"
            )
        out[m.group("name")] = int(
            float(m.group("val")) * _UNIT_BYTES[m.group("unit")]
        )
    return out


def fmt_bytes(n: int | float) -> str:
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return f"{n:.4g}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024
    return f"{n:.4g}TiB"


# ---------------------------------------------------------------------------
# dtype tables
# ---------------------------------------------------------------------------

DTYPE_BYTES = {
    "bool": 1, "int8": 1, "uint8": 1, "int16": 2, "uint16": 2,
    "int32": 4, "uint32": 4, "int64": 8, "uint64": 8,
    "float16": 2, "bfloat16": 2, "float32": 4, "float64": 8,
}

INT_RANGES = {
    "int8": (-(2 ** 7), 2 ** 7 - 1),
    "uint8": (0, 2 ** 8 - 1),
    "int16": (-(2 ** 15), 2 ** 15 - 1),
    "uint16": (0, 2 ** 16 - 1),
    "int32": (-(2 ** 31), 2 ** 31 - 1),
    "uint32": (0, 2 ** 32 - 1),
    "int64": (-(2 ** 63), 2 ** 63 - 1),
    "uint64": (0, 2 ** 64 - 1),
}

_DTYPE_NAMES = set(DTYPE_BYTES)


#: torch's dtype aliases (``torch.float`` is float32, where Python's and
#: numpy's ``float`` is float64)
_TORCH_ALIASES = {
    "float": "float32", "double": "float64", "half": "float16",
    "long": "int64", "int": "int32", "short": "int16",
}


def canon_dtype(name: str | None) -> str | None:
    """'np.int32' / 'torch.int32' / 'int32' / 'float' / 'torch.long' ->
    canonical name."""
    if not name:
        return None
    tail = name.split(".")[-1]
    if tail in _DTYPE_NAMES:
        return tail
    if name.split(".")[0] == "torch" and tail in _TORCH_ALIASES:
        return _TORCH_ALIASES[tail]
    if tail == "float":
        return "float64"
    if tail == "int":
        return "int64"
    return None


def is_int_dtype(dtype: str | None) -> bool:
    return dtype in INT_RANGES


def is_float_dtype(dtype: str | None) -> bool:
    return dtype in ("float16", "bfloat16", "float32", "float64")


# ---------------------------------------------------------------------------
# the symbolic interval
# ---------------------------------------------------------------------------


def _atom(expr: str) -> str:
    """True-ish when ``expr`` needs no parens as a product operand."""
    return expr if re.fullmatch(r"[\w.]+|\([^()]*\)", expr) \
        else f"({expr})"


@dataclass(frozen=True)
class Sym:
    """Closed-form expression + conservative value interval [lo, hi]."""

    expr: str
    hi: int
    lo: int = 0

    @staticmethod
    def lit(v: int) -> "Sym":
        return Sym(str(v), v, v)

    @property
    def is_const(self) -> bool:
        return self.lo == self.hi

    def _coerce(self, o) -> "Sym | None":
        if isinstance(o, Sym):
            return o
        if isinstance(o, int):
            return Sym.lit(o)
        return None

    def __add__(self, o) -> "Sym":
        o = self._coerce(o)
        return Sym(f"{self.expr} + {o.expr}", self.hi + o.hi,
                   self.lo + o.lo)

    __radd__ = __add__

    def __sub__(self, o) -> "Sym":
        o = self._coerce(o)
        return Sym(f"{self.expr} - {_atom(o.expr)}", self.hi - o.lo,
                   self.lo - o.hi)

    def __mul__(self, o) -> "Sym":
        o = self._coerce(o)
        ps = (self.hi * o.hi, self.hi * o.lo, self.lo * o.hi,
              self.lo * o.lo)
        return Sym(f"{_atom(self.expr)}*{_atom(o.expr)}", max(ps), min(ps))

    __rmul__ = __mul__

    def __floordiv__(self, o) -> "Sym":
        o = self._coerce(o)
        if o.lo <= 0:  # dividing by a possibly-nonpositive bound: give up
            return Sym(f"{_atom(self.expr)}//{_atom(o.expr)}",
                       abs(self.hi), -abs(self.hi))
        return Sym(f"{_atom(self.expr)}//{_atom(o.expr)}",
                   self.hi // o.lo, self.lo // o.hi)

    def __mod__(self, o) -> "Sym":
        o = self._coerce(o)
        return Sym(f"{_atom(self.expr)} % {_atom(o.expr)}",
                   max(o.hi - 1, 0), min(self.lo, 0))

    def __neg__(self) -> "Sym":
        return Sym(f"-{_atom(self.expr)}", -self.lo, -self.hi)

    def clamp_hi(self, hi: int) -> "Sym":
        return Sym(self.expr, min(self.hi, hi), min(self.lo, hi))

    def hull(self, o: "Sym") -> "Sym":
        """Interval union (for joins across branches / where)."""
        return Sym(f"{self.expr}|{o.expr}", max(self.hi, o.hi),
                   min(self.lo, o.lo))


def sym_min(*syms: Sym) -> Sym:
    """min() over intervals; any arg is a valid upper bound."""
    hi = min(s.hi for s in syms)
    lo = min(s.lo for s in syms)
    expr = f"min({', '.join(s.expr for s in syms)})"
    return Sym(expr, hi, lo)


def sym_max(*syms: Sym) -> Sym:
    hi = max(s.hi for s in syms)
    lo = max(s.lo for s in syms)
    expr = f"max({', '.join(s.expr for s in syms)})"
    return Sym(expr, hi, lo)


def next_pow2_bound(x: Sym) -> Sym:
    """Worst-case bound of next_pow2(x): <= 2*(x-1) for x >= 2; use 2x."""
    return Sym(f"next_pow2({x.expr})", max(2 * x.hi, 1), max(x.lo, 0))


def quarter_pow2_bound(x: Sym) -> Sym:
    """next_pow2_quarter pads on a {2^k, 1.25*2^k, 1.5*2^k, 1.75*2^k}
    grid: worst-case padded size < ceil(8/7 * x); 1.25x is a safe cover."""
    return Sym(f"next_pow2_quarter({x.expr})", (5 * x.hi + 3) // 4,
               max(x.lo, 0))
