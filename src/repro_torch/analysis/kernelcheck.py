"""Static CUDA-kernel constraint check (LANNS020, LANNS021, LANNS024).

The port of ``repro.analysis.kernelcheck``, in the CUDA form of its rules.
It applies to files under a ``kernels/`` directory: the Python modules
(launchers, plain versions) and the CUDA sources under ``kernels/csrc/``
(``.cu`` / ``.cuh``).

* LANNS020 — no float64 in a kernels module: ``torch.float64``,
  ``torch.double`` / ``.double()``, ``np.float64`` or ``'float64'`` in
  Python; the ``double`` type in a CUDA source (comments aside).  The
  kernels compute in f32 or narrower, and an H100 runs f64 at a fraction
  of its f32 rate.
* LANNS021 — the f32-accumulation contract: every ``mma.sync`` and
  ``wgmma.mma_async`` PTX string (inline asm) must accumulate in ``.f32``
  or ``.s32``.  For ``mma.sync`` both the D and the C types are read
  (``mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32``); for
  ``wgmma.mma_async`` the D type (``...m64n64k16.f32.bf16.bf16``).
* LANNS024 — every ctypes launcher checks its operands' shapes before the
  launch.  A launcher is a function that passes ``.data_ptr()`` arguments
  to a loaded library function; the check is an ``if ...: raise`` or an
  ``assert`` before the launch that reads ``.shape``, ``.dim()``,
  ``.ndim`` or ``.is_contiguous()`` (a kernel indexes raw pointers, so a
  wrong shape is an out-of-bounds read, not an error).

The reference's LANNS022 and LANNS023 (1-D iota and sorts in a Pallas
kernel body) are Mosaic lowering limits with no CUDA meaning; they stay
registered and are never emitted.
"""

from __future__ import annotations

import ast
import builtins
import os
import re

from repro_torch.analysis.rules import Finding, SourceFile, attr_chain, is_cuda_source

_F64_NAMES = {"float64", "f64", "double"}
_SHAPE_ATTRS = {"shape", "ndim"}
_SHAPE_CALLS = {"dim", "is_contiguous", "size"}
_ACC_TYPES = {"f32", "s32"}
_PTX_RE = re.compile(r"\b(?P<op>mma\.sync|wgmma\.mma_async)(?P<mods>(?:\.\w+)+)")
_SHAPE_RE = re.compile(r"^m\d+n\d+k\d+$")
_PTX_TYPES = {"f16", "bf16", "f32", "f64", "tf32", "s32", "s8", "u8", "s4", "u4",
              "b1", "e4m3", "e5m2"}
_CUDA_COMMENT_RE = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)
_DOUBLE_RE = re.compile(r"\bdouble\b")


def is_kernels_module(path: str) -> bool:
    parts = os.path.normpath(path).split(os.sep)
    return "kernels" in parts[:-1]


def _blank_comments(text: str) -> str:
    """``text`` with every C/C++ comment replaced by spaces (newlines kept,
    so line numbers stay)."""
    return _CUDA_COMMENT_RE.sub(
        lambda m: re.sub(r"[^\n]", " ", m.group(0)), text
    )


def _line_of(text: str, pos: int) -> int:
    return text.count("\n", 0, pos) + 1


def _ptx_accumulators(op: str, mods: str) -> list[str] | None:
    """The accumulator types of one PTX mma: [D, C] for ``mma.sync``, [D]
    for ``wgmma.mma_async``; None when the string carries no shape (prose,
    not an instruction)."""
    toks = mods.strip(".").split(".")
    shape_at = next((j for j, t in enumerate(toks) if _SHAPE_RE.match(t)), None)
    if shape_at is None:
        return None
    types = [t for t in toks[shape_at + 1:] if t in _PTX_TYPES]
    if not types:
        return None
    if op == "mma.sync":
        return [types[0], types[-1]]
    return [types[0]]


def _run_cuda(src: SourceFile) -> list[Finding]:
    findings: list[Finding] = []
    code = _blank_comments(src.text)
    for m in _DOUBLE_RE.finditer(code):
        findings.append(Finding(
            "LANNS020", src.path, _line_of(code, m.start()),
            "`double` in a CUDA kernel source — the kernels compute in f32 "
            "or narrower",
        ))
    for m in _PTX_RE.finditer(code):
        accs = _ptx_accumulators(m.group("op"), m.group("mods"))
        if accs is None:
            continue
        bad = [t for t in accs if t not in _ACC_TYPES]
        if bad:
            findings.append(Finding(
                "LANNS021", src.path, _line_of(code, m.start()),
                f"`{m.group('op')}{m.group('mods')}` accumulates in "
                f".{bad[0]} — the f32-accumulation contract wants .f32 "
                "(or .s32 for integer products)",
            ))
    return findings


def _launch_lines(fn: ast.FunctionDef) -> list[int]:
    """Lines where ``fn`` passes ``.data_ptr()`` operands to a callee that
    is not a Python builtin (the ctypes library function)."""
    out: list[int] = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        if isinstance(node.func, ast.Name) and hasattr(builtins, node.func.id):
            continue
        for arg in node.args:
            if any(isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute)
                   and sub.func.attr == "data_ptr" for sub in ast.walk(arg)):
                out.append(node.lineno)
                break
    return out


def _reads_shape(expr: ast.AST) -> bool:
    for sub in ast.walk(expr):
        if isinstance(sub, ast.Attribute) and sub.attr in _SHAPE_ATTRS:
            return True
        if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute) \
                and sub.func.attr in _SHAPE_CALLS:
            return True
    return False


def _shape_check_lines(fn: ast.FunctionDef) -> list[int]:
    """Lines of the shape checks in ``fn``: ``assert`` or ``if ...:
    raise`` whose test reads a shape."""
    out: list[int] = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Assert) and _reads_shape(node.test):
            out.append(node.lineno)
        elif isinstance(node, ast.If) and _reads_shape(node.test) and any(
                isinstance(s, ast.Raise) for s in node.body):
            out.append(node.lineno)
    return out


def run(src: SourceFile) -> list[Finding]:
    if not is_kernels_module(src.path):
        return []
    if is_cuda_source(src.path):
        return _run_cuda(src)
    findings: list[Finding] = []

    # LANNS020: module-wide f64 ban (dtype literals or attribute refs)
    for node in ast.walk(src.tree):
        name = None
        if isinstance(node, ast.Attribute) and node.attr in _F64_NAMES:
            name = attr_chain(node) or f".{node.attr}"
        elif isinstance(node, ast.Constant) and node.value == "float64":
            name = "'float64'"
        if name:
            findings.append(Finding(
                "LANNS020", src.path, node.lineno,
                f"float64 reference `{name}` in a kernels module — the "
                "kernels compute in f32 or narrower",
            ))

    # LANNS024: a ctypes launch with no shape check before it
    for fn in ast.walk(src.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        launches = _launch_lines(fn)
        if not launches:
            continue
        checks = _shape_check_lines(fn)
        if not any(c < min(launches) for c in checks):
            findings.append(Finding(
                "LANNS024", src.path, fn.lineno,
                f"launcher `{fn.name}` passes `.data_ptr()` operands to a "
                "kernel without a shape check (`if ...: raise` / `assert` "
                "on .shape / .dim() / .is_contiguous()) before the launch",
            ))
    return findings
