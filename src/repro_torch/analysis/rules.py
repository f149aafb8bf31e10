"""Rule registry, findings, and inline directive parsing for
repro_torch.analysis.

The port of ``repro.analysis.rules``: the same rule codes, the same
``Finding`` and the same directive grammar.  Each rule's summary says what
it means in the port (eager PyTorch and hand-written CUDA).  LANNS005,
LANNS022, LANNS023 and LANNS033 stay registered, so that the catalogue and
every ``noqa[...]`` stay one-to-one with the reference, but no pass of the
port emits them: they are about jit static arguments, trace buckets and
Mosaic's lowering, which have no eager-torch or CUDA meaning.

Directives are comments of the form ``# lanns: <directive>`` (``//
lanns: <directive>`` in a CUDA source):

* ``# lanns: hotpath`` — marks the function defined on (or directly below)
  this line as a serving hot-path root.  The host-sync lint checks the
  marked function plus everything reachable from it inside the same module.
* ``# lanns: noqa[LANNS001] -- justification`` — suppress the named rule(s)
  on this line.  The justification after ``--`` is REQUIRED: a bare noqa is
  itself a finding (LANNS000) and cannot be suppressed.  Multiple codes:
  ``noqa[LANNS001,LANNS003]``.
* ``# lanns: holds[_cond]`` — declares that the function defined on this
  line must only be called with ``self._cond`` held; the lock checker then
  treats guarded-attribute accesses inside it as covered.
* ``# lanns: dims[n<=180_000_000, d<=2048]`` — declares symbolic dimension
  bounds for the scale-safety pass (scalecheck).  On/above a def it scopes
  to that function (merged over module-level declarations); anywhere else
  it scopes to the whole module.  Any name bound in an annotated function
  that MATCHES a declared dim is tracked at that bound.
* ``# lanns: budget[device<=8GiB]`` — declares a device-resident byte
  budget for the function defined on/below this line; scalecheck sums the
  static footprint of its device allocations at the declared dim bounds
  (LANNS034).
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field

from repro_torch.analysis.symdims import parse_budget, parse_dims

_DIRECTIVE_RE = re.compile(r"#\s*lanns:\s*(?P<body>.+?)\s*$")
_CUDA_DIRECTIVE_RE = re.compile(r"//\s*lanns:\s*(?P<body>.+?)\s*$")
_NOQA_RE = re.compile(
    r"noqa\[(?P<codes>[A-Z0-9,\s]+)\](?:\s*--\s*(?P<just>.+))?$"
)
_HOLDS_RE = re.compile(r"holds\[(?P<lock>\w+)\]$")
_DIMS_RE = re.compile(r"dims\[(?P<body>[^\]]*)\]$")
_BUDGET_RE = re.compile(r"budget\[(?P<body>[^\]]*)\]$")

#: CUDA sources the kernel check reads besides Python modules
CUDA_SUFFIXES = (".cu", ".cuh")


@dataclass(frozen=True)
class Rule:
    code: str
    name: str
    summary: str


RULES: dict[str, Rule] = {
    r.code: r
    for r in (
        # -- meta ----------------------------------------------------------
        Rule("LANNS000", "bare-noqa",
             "`# lanns: noqa[...]` without a `-- justification` tail"),
        # -- host syncs (hot-path functions) --------------------------------
        Rule("LANNS001", "item-sync",
             "`.item()` on a hot path: one device->host sync (a blocking "
             "copy from the card) per element"),
        Rule("LANNS002", "scalar-sync",
             "float()/int()/bool() of a CUDA tensor blocks until the card "
             "has computed it"),
        Rule("LANNS003", "asarray-sync",
             "`.cpu()` / `.numpy()` / `.tolist()` / `np.asarray` of a CUDA "
             "tensor is a host sync; hoist to one designed sync point per "
             "batch"),
        Rule("LANNS004", "jnp-in-host-loop",
             "`torch.` op inside a host-side Python loop launches per "
             "iteration instead of batching"),
        Rule("LANNS005", "dynamic-shape-arg",
             "jit parameter used in a shape/axis position without being "
             "declared static (no eager-torch meaning: never emitted by the "
             "port)"),
        Rule("LANNS006", "unordered-iteration",
             "set or unsorted-dict iteration feeding array/tensor "
             "construction makes layout order nondeterministic"),
        # -- lock discipline -----------------------------------------------
        Rule("LANNS010", "guarded-attr-unlocked",
             "attribute declared in _GUARDED_BY touched outside `with "
             "self.<lock>:`"),
        Rule("LANNS011", "blocking-under-lock",
             "blocking call (join/sleep/execute/query/CUDA synchronize) "
             "while holding a lock"),
        Rule("LANNS012", "lock-order-inversion",
             "nested lock acquisition contradicts the class _LOCK_ORDER"),
        Rule("LANNS013", "publish-after-set",
             "request result field assigned after event.set() — waiters "
             "can observe a half-published result"),
        # -- CUDA kernel constraints -----------------------------------------
        Rule("LANNS020", "kernel-f64",
             "float64 / `double` in a kernels/ module or CUDA source (the "
             "kernels compute in f32 or narrower; an H100 runs f64 at a "
             "fraction of the f32 rate)"),
        Rule("LANNS021", "dot-no-preferred-type",
             "`mma.sync` / `wgmma.mma_async` PTX whose accumulator type is "
             "not .f32 or .s32 (the f32-accumulation contract)"),
        Rule("LANNS022", "kernel-1d-iota",
             "1D iota/arange in a Pallas kernel body (Mosaic lowering; "
             "never emitted by the port)"),
        Rule("LANNS023", "kernel-sort",
             "sort/argsort/top_k in a Pallas kernel body (Mosaic lowering; "
             "never emitted by the port)"),
        Rule("LANNS024", "launcher-no-divisibility-guard",
             "ctypes launcher that passes `.data_ptr()` operands to a "
             "kernel without first checking their shapes (an `if ...: "
             "raise` or `assert` on .shape / .dim() / .is_contiguous())"),
        # -- scale safety (symbolic dims; scalecheck) ------------------------
        Rule("LANNS030", "int32-range-overflow",
             "index arithmetic provably exceeds the int32/uint32 value "
             "range at the declared `dims[...]` bounds (silent wraparound "
             "at scale; K1's and K2's ids are int32)"),
        Rule("LANNS031", "implicit-promotion",
             "implicit dtype promotion on a hot path: fp64 leaking into "
             "fp32 math, or int8 arithmetic outside an explicit "
             "astype/.to rescale"),
        Rule("LANNS032", "mixed-width-store",
             "int64 value stored into an int32-dtyped array or tensor slot "
             "without an explicit bounds-asserted cast"),
        Rule("LANNS033", "unbounded-trace-bucket",
             "jit static/shape argument ranging over a declared symbolic "
             "dim without pow2 bucketing (no eager-torch meaning: never "
             "emitted by the port)"),
        Rule("LANNS034", "device-budget-exceeded",
             "static device-resident footprint at the declared dim bounds "
             "exceeds the `# lanns: budget[device<=...]` declaration"),
    )
}

#: registered for one-to-one parity with the reference; no pass emits them
NOT_EMITTED = ("LANNS005", "LANNS022", "LANNS023", "LANNS033")


@dataclass
class Finding:
    code: str
    path: str
    line: int
    message: str
    suppressed: bool = False
    justification: str = ""

    def render(self) -> str:
        tag = " (suppressed: %s)" % self.justification if self.suppressed \
            else ""
        return f"{self.path}:{self.line}: {self.code} {self.message}{tag}"


@dataclass
class Noqa:
    codes: tuple[str, ...]
    justification: str
    used: bool = False


def is_cuda_source(path: str) -> bool:
    return path.endswith(CUDA_SUFFIXES)


@dataclass
class SourceFile:
    """A parsed module plus its ``# lanns:`` directive maps.

    A CUDA source (``.cu`` / ``.cuh``) parses to an empty Python tree: only
    the kernel check reads its text, and its directives are ``//``
    comments.
    """

    path: str
    text: str
    tree: ast.AST
    noqa: dict[int, Noqa] = field(default_factory=dict)
    hotpath_lines: set[int] = field(default_factory=set)
    holds: dict[int, str] = field(default_factory=dict)
    dims: dict[int, dict[str, int]] = field(default_factory=dict)
    budget: dict[int, dict[str, int]] = field(default_factory=dict)

    @classmethod
    def parse(cls, path: str, text: str | None = None) -> "SourceFile":
        if text is None:
            with open(path, encoding="utf-8") as f:
                text = f.read()
        cuda = is_cuda_source(path)
        tree = ast.Module(body=[], type_ignores=[]) if cuda \
            else ast.parse(text, filename=path)
        directive_re = _CUDA_DIRECTIVE_RE if cuda else _DIRECTIVE_RE
        src = cls(path=path, text=text, tree=tree)
        for lineno, line in enumerate(text.splitlines(), start=1):
            m = directive_re.search(line)
            if not m:
                continue
            body = m.group("body")
            nq = _NOQA_RE.match(body)
            if nq:
                codes = tuple(
                    c.strip() for c in nq.group("codes").split(",")
                    if c.strip()
                )
                src.noqa[lineno] = Noqa(codes, (nq.group("just") or "").strip())
                continue
            hl = _HOLDS_RE.match(body)
            if hl:
                src.holds[lineno] = hl.group("lock")
                continue
            dm = _DIMS_RE.match(body)
            if dm:
                src.dims[lineno] = parse_dims(
                    dm.group("body"), where=f"{path}:{lineno}"
                )
                continue
            bg = _BUDGET_RE.match(body)
            if bg:
                src.budget[lineno] = parse_budget(
                    bg.group("body"), where=f"{path}:{lineno}"
                )
                continue
            if body == "hotpath":
                src.hotpath_lines.add(lineno)
        return src

    # -- directive lookups -------------------------------------------------

    def _anchor_lines(self, node: ast.FunctionDef) -> set[int]:
        """Lines a function-scoped directive may sit on: the def line, the
        line directly above, any decorator line, or the line above the
        first decorator."""
        lines = {node.lineno, node.lineno - 1}
        lines.update(d.lineno for d in node.decorator_list)
        if node.decorator_list:
            lines.add(min(d.lineno for d in node.decorator_list) - 1)
        return lines

    def func_is_hot(self, node: ast.FunctionDef) -> bool:
        """A def is hot-marked if the directive sits on the def line, on a
        decorator line, or on the line directly above the def."""
        return bool(self._anchor_lines(node) & self.hotpath_lines)

    def func_dims(self, node: ast.FunctionDef) -> dict[str, int]:
        """Function-scoped ``dims[...]`` declarations (unmerged)."""
        out: dict[str, int] = {}
        for ln in sorted(self._anchor_lines(node) & set(self.dims)):
            out.update(self.dims[ln])
        return out

    def func_budget(self, node: ast.FunctionDef) -> dict[str, int]:
        out: dict[str, int] = {}
        for ln in sorted(self._anchor_lines(node) & set(self.budget)):
            out.update(self.budget[ln])
        return out

    def module_dims(self, claimed: set[int]) -> dict[str, int]:
        """Module-scoped dims: every dims line not anchored to a def."""
        out: dict[str, int] = {}
        for ln in sorted(set(self.dims) - claimed):
            out.update(self.dims[ln])
        return out

    def func_holds(self, node: ast.FunctionDef) -> str | None:
        lines = [node.lineno, node.lineno - 1]
        lines += [d.lineno for d in node.decorator_list]
        for ln in lines:
            if ln in self.holds:
                return self.holds[ln]
        return None

    # -- suppression -------------------------------------------------------

    def meta_findings(self) -> list[Finding]:
        """LANNS000 for every noqa directive missing a justification."""
        return [
            Finding("LANNS000", self.path, ln,
                    RULES["LANNS000"].summary)
            for ln, nq in sorted(self.noqa.items())
            if not nq.justification
        ]

    def apply_suppressions(self, findings: list[Finding]) -> list[Finding]:
        """Mark findings suppressed where a justified noqa names their code
        on the same line.  LANNS000 is never suppressible."""
        for f in findings:
            if f.code == "LANNS000":
                continue
            nq = self.noqa.get(f.line)
            if nq and f.code in nq.codes and nq.justification:
                f.suppressed = True
                f.justification = nq.justification
                nq.used = True
        return findings


def attr_chain(node: ast.AST) -> str:
    """Dotted name for Name/Attribute chains ('torch.zeros', 'self._cond');
    '' for anything unresolvable."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""
