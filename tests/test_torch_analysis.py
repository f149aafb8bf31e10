"""The port's checkers (``repro_torch.analysis``) vs the JAX package's
(``repro.analysis``, ``tests/test_analysis.py``, ``tests/test_scalecheck.py``).

* directives: ``SourceFile.parse`` gives equal maps in both packages on every
  fixture under ``tests/fixtures/analysis/``; ``symdims`` parses and bounds
  alike on a seeded set of expressions;
* lock discipline: equal (code, line) findings on the lock fixtures;
* torch twins of the trace, scale and kernel fixtures (strings passed
  through ``analyze_file``): each bad twin trips the reference fixture's
  codes at the same lines, less LANNS005, 022, 023 and 033, which have no
  eager-torch or CUDA meaning; each clean twin is silent;
* suppressions and the CLI's exit codes;
* runtime: the lock-order and guarded-dict sequences replayed on both
  packages; a short race stress over a small port index on the CPU;
* the footprint model row for row against the reference's, and a small CPU
  index's resident bytes within it;
* isolation: the port's checkers import neither jax nor ``repro``, and the
  port passes its own ``--strict``.
"""

import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.analysis import analyze_file as j_analyze_file
from repro.analysis import rules as j_rules
from repro.analysis import runtime as j_runtime
from repro.analysis import symdims as j_symdims
from repro.analysis.scalecheck import footprint_report as j_footprint_report
from repro.data.synthetic import clustered_vectors as j_clustered_vectors
from repro_torch.analysis import RULES, analyze_file, analyze_paths
from repro_torch.analysis import rules as t_rules
from repro_torch.analysis import runtime as t_runtime
from repro_torch.analysis import symdims as t_symdims
from repro_torch.analysis.rules import NOT_EMITTED
from repro_torch.analysis.scalecheck import (
    DEFAULT_FOOTPRINT_DIMS,
    footprint_report,
    index_footprint_dims,
)
from repro_torch.core import LannsConfig, LannsIndex
from repro_torch.data.synthetic import clustered_vectors

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = Path(__file__).parent / "fixtures" / "analysis"
FIXTURE_FILES = sorted(str(p.relative_to(FIXTURES)) for p in FIXTURES.rglob("*.py"))
PORT = ROOT / "src" / "repro_torch"


def pairs(findings, *, include_suppressed=False):
    return sorted(
        (f.code, f.line) for f in findings if include_suppressed or not f.suppressed
    )


# ---------------------------------------------------------------------------
# directives and symdims: one grammar in both packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", FIXTURE_FILES)
def test_directive_maps_equal_reference(name):
    path = str(FIXTURES / name)
    j = j_rules.SourceFile.parse(path)
    t = t_rules.SourceFile.parse(path)
    as_tuples = lambda nq: {ln: (q.codes, q.justification) for ln, q in nq.items()}
    assert as_tuples(t.noqa) == as_tuples(j.noqa)
    assert t.hotpath_lines == j.hotpath_lines
    assert t.holds == j.holds
    assert t.dims == j.dims
    assert t.budget == j.budget


def _seeded_dims_bodies(seed: int, n: int = 40):
    rng = np.random.default_rng(seed)
    names = ["n", "d", "P", "M", "n_pad", "k", "B", "topk", "C", "pi"]
    out = []
    for _ in range(n):
        items = []
        for name in rng.choice(names, size=rng.integers(1, 5), replace=False):
            v = int(rng.integers(1, 10**9))
            items.append(f"{name}<={v:_}" if rng.random() < 0.5 else f"{name} <= {v}")
        out.append(", ".join(items))
    return out


def _seeded_budget_bodies(seed: int, n: int = 40):
    rng = np.random.default_rng(seed)
    units = ["", "B", "KiB", "MiB", "GiB", "TiB", "KB", "MB", "GB", "TB"]
    return [f"device<={int(rng.integers(1, 4096))}"
            f"{'.' + str(int(rng.integers(0, 100))) if rng.random() < 0.3 else ''}"
            f"{units[int(rng.integers(len(units)))]}" for _ in range(n)]


def test_parse_dims_and_budget_equal_reference_on_seeded_bodies():
    for body in _seeded_dims_bodies(0):
        assert t_symdims.parse_dims(body) == j_symdims.parse_dims(body), body
    for body in _seeded_budget_bodies(1):
        assert t_symdims.parse_budget(body) == j_symdims.parse_budget(body), body
    for bad in ("n<180", "n<=1e6", "<=5", "device<=8 XB"):
        for mod in (t_symdims, j_symdims):
            with pytest.raises(ValueError):
                (mod.parse_budget if "device" in bad else mod.parse_dims)(bad)


def _sym_program(mod, seed: int):
    """A seeded chain of Sym operations; returns every intermediate."""
    rng = np.random.default_rng(seed)
    pool = [mod.Sym("n", 180_000_000), mod.Sym("d", 2048), mod.Sym.lit(7),
            mod.Sym("k", 200, 1), mod.Sym.lit(-3)]
    out = []
    for _ in range(60):
        a, b = (pool[int(i)] for i in rng.integers(len(pool), size=2))
        op = int(rng.integers(12))
        if op == 0:
            r = a + b
        elif op == 1:
            r = a - b
        elif op == 2:
            r = a * b
        elif op == 3:
            r = a // b
        elif op == 4:
            r = a % b
        elif op == 5:
            r = -a
        elif op == 6:
            r = a.clamp_hi(int(rng.integers(0, 10**6)))
        elif op == 7:
            r = a.hull(b)
        elif op == 8:
            r = mod.sym_min(a, b)
        elif op == 9:
            r = mod.sym_max(a, b)
        elif op == 10:
            r = mod.next_pow2_bound(a)
        else:
            r = mod.quarter_pow2_bound(a)
        out.append((r.expr, r.hi, r.lo))
        if abs(r.hi) < 10**30 and abs(r.lo) < 10**30:
            pool.append(r)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sym_bounds_equal_reference(seed):
    assert _sym_program(t_symdims, seed) == _sym_program(j_symdims, seed)


def test_dtype_tables_equal_reference_plus_torch_aliases():
    assert t_symdims.DTYPE_BYTES == j_symdims.DTYPE_BYTES
    assert t_symdims.INT_RANGES == j_symdims.INT_RANGES
    for name in ("np.int32", "jnp.int32", "int32", "float", "int", "np.float64",
                 "uint8", "bfloat16", "bool", "x.y"):
        assert t_symdims.canon_dtype(name) == j_symdims.canon_dtype(name), name
    # torch's aliases: torch.float is float32 where Python's float is float64
    assert t_symdims.canon_dtype("torch.float") == "float32"
    assert t_symdims.canon_dtype("torch.long") == "int64"
    assert t_symdims.canon_dtype("torch.double") == "float64"
    assert t_symdims.canon_dtype("torch.int") == "int32"


def test_rule_catalogue_is_the_references():
    assert list(RULES) == list(j_rules.RULES)
    for code in RULES:
        assert RULES[code].name == j_rules.RULES[code].name
    assert set(NOT_EMITTED) == {"LANNS005", "LANNS022", "LANNS023", "LANNS033"}


# ---------------------------------------------------------------------------
# lock discipline: the rules run as they are
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["bad_locks.py", "clean_locks.py"])
def test_lock_findings_equal_reference(name):
    path = str(FIXTURES / name)
    assert pairs(analyze_file(path)) == pairs(j_analyze_file(path))


CUDA_SYNC_UNDER_LOCK = '''\
import threading
import torch


class Worker:
    _GUARDED_BY = {"queue": "_lock"}

    def __init__(self):
        self._lock = threading.Lock()
        self.queue = []

    def drain(self, ev):
        with self._lock:
            torch.cuda.synchronize()  # LANNS011: every waiter stalls on the card
            ev.synchronize()  # LANNS011: so does an event's sync
            return len(self.queue)
'''


def test_cuda_synchronize_under_lock_is_blocking():
    got = pairs(analyze_file("worker.py", CUDA_SYNC_UNDER_LOCK))
    assert got == [("LANNS011", 14), ("LANNS011", 15)]


# ---------------------------------------------------------------------------
# torch twins of the trace, scale and kernel fixtures
# ---------------------------------------------------------------------------

BAD_TRACELINT = '''\
"""Torch twin of bad_tracelint.py: trips LANNS001-004 and LANNS006."""
import numpy as np
import torch
# (line 4 of the reference imports jax.numpy)


# lanns: hotpath
def hot_item_sync(x):
    total = torch.sum(x)
    return total.item()  # LANNS001


# lanns: hotpath
def hot_float_cast(x):
    s = torch.sum(x)
    return float(s)  # LANNS002


# lanns: hotpath
def hot_asarray_sync(x):
    d = torch.sqrt(x)
    return d.cpu().numpy()  # LANNS003


# lanns: hotpath
def hot_loop_dispatch(parts):
    out = []
    for p in parts:
        out.append(torch.sum(p))  # LANNS004
    return out


@torch.compile
def jit_dynamic_shape(x, n):
    return torch.zeros((n, x.shape[1]))  # no LANNS005: eager torch has no static args


# lanns: hotpath
def hot_unordered_feed(parts):
    rows = []
    for key, val in parts.items():  # LANNS006: dict order feeds arrays
        rows.append(np.asarray(val))
    return np.stack(rows)
'''

CLEAN_TRACELINT = '''\
"""Torch twin of clean_tracelint.py: same shapes, no findings."""
from functools import partial

import numpy as np
import torch
# (line 6 of the reference imports jax.numpy)


# lanns: hotpath
def hot_no_sync(x):
    total = torch.sum(x)
    return total  # stays on device: caller decides when to sync


# lanns: hotpath
def hot_host_cast(x):
    s = np.sum(np.asarray(x, np.float32))  # host value in, host value out
    return float(s)


# lanns: hotpath
def hot_batched_dispatch(parts):
    stacked = torch.stack(parts)  # ONE launch outside any loop
    return torch.sum(stacked, dim=0)


@partial(torch.compile, dynamic=False)
def jit_static_shape(x, n):
    return torch.zeros((n, x.shape[1]))


# lanns: hotpath
def hot_sorted_feed(parts):
    rows = []
    for key, val in sorted(parts.items()):  # deterministic order
        rows.append(np.asarray(val))
    return np.stack(rows)
'''

BAD_SCALECHECK = '''\
"""Torch twin of bad_scalecheck.py: one LANNS03x rule per block.

LANNS033 (trace buckets) has no eager-torch meaning, so bad_buckets stays
silent here.
"""

import numpy as np
import torch

# lanns: dims[P<=4096, n_pad<=33_554_432, n<=200_000_000, d<=2048, k<=200]


# LANNS030: P * n_pad reaches 1.37e11 at the declared bounds — the int32
# fill value wraps (the K1 / K2 id width).
def bad_offsets(P, n_pad):  # lanns: hotpath
    return torch.full((P,), P * n_pad, dtype=torch.int32)


# LANNS031: a float64 scale multiplies the fp32 corpus: the whole hot-path
# product silently promotes to float64.
def bad_promotion(x, d):  # lanns: hotpath
    scale = torch.zeros((d,), dtype=torch.float64)
    return x.to(torch.float32) * scale


# LANNS032: torch.arange yields int64 rows; storing them into an int32 slot
# narrows values that reach n - 1 + n_pad > 2^31 at the declared bounds.
def bad_store(n, n_pad):  # lanns: hotpath
    out = torch.zeros((16,), dtype=torch.int32)
    rows = torch.arange(n) + n_pad
    out[:] = rows[:16]
    return out


# (LANNS033 in the reference: a device buffer shaped by a raw declared dim;
# eager torch compiles nothing per shape.)
def bad_buckets(q, n):  # lanns: hotpath
    pad = torch.zeros((n, 8), dtype=torch.float32)
    return pad


# LANNS034: 33.5M x 2048 fp32 rows are 256 GiB resident — two orders over
# the declared single-device budget.
def bad_budget(n_pad, d):  # lanns: budget[device<=8GiB]
    return torch.zeros((n_pad, d), dtype=torch.float32)
'''

CLEAN_SCALECHECK = '''\
"""Torch twin of clean_scalecheck.py — same code shapes, bounds respected."""

import numpy as np
import torch

from repro_torch.common.utils import next_pow2

# lanns: dims[P<=4096, n_pad<=33_554_432, n<=200_000_000, d<=2048, k<=200]

_INT32_MAX = torch.iinfo(torch.int32).max


# int64 offsets, plus the overflow guard that refines P * n_pad below the
# int32 line for the branch that narrows.
def clean_offsets(P, n_pad):  # lanns: hotpath
    off = P * n_pad
    if off > _INT32_MAX:
        raise OverflowError(off)
    return torch.full((P,), off, dtype=torch.int32)


# explicit fp32 scales: no promotion anywhere on the product.
def clean_promotion(x, d):  # lanns: hotpath
    scale = torch.zeros((d,), dtype=torch.float32)
    return x.to(torch.float32) * scale


# rows stay int64 end to end — the slot is sized for the values it holds.
def clean_store(n, n_pad):  # lanns: hotpath
    out = torch.zeros((16,), dtype=torch.int64)
    rows = torch.arange(n) + n_pad
    out[:] = rows[:16]
    return out


# the device buffer is shaped on the pow2 grid (the port's allocator
# buckets).
def clean_buckets(q, n):  # lanns: hotpath
    pad = torch.zeros((next_pow2(n), 8), dtype=torch.float32)
    return pad


# 12.5M x 512 int8 codes are ~6 GiB — inside the declared device budget.
def clean_budget(q8_rows):  # lanns: budget[device<=8GiB]
    m_pad = 12_500_000
    dim = 512
    return torch.zeros((m_pad, dim), dtype=torch.int8)
'''

BAD_KERNEL_PY = '''\
"""Torch twin of bad_kernel.py's Python side: trips LANNS020 and LANNS024."""
import ctypes

import torch


def bad_plain(x, o, *, block: int):
    x = x.to(torch.float64)  # LANNS020: f64 in a kernels module
    idx = torch.arange(block)  # (LANNS022: no CUDA meaning)
    order = torch.argsort(x[:, 0])  # (LANNS023: no CUDA meaning)
    w = x @ x.T  # (LANNS021 reads the PTX: bad_kernel.cu line 11)
    o[...] = (w + idx[None, :] + order[None, :]).to(torch.float32)


def bad_launcher(x, lib, block=128):
    # LANNS024: no shape check before the launch (a non-shape assert after)
    out = torch.empty_like(x)
    rc = lib.bad_kernel(
        x.data_ptr(), out.data_ptr(), ctypes.c_int(block),
    )
    assert rc == 0
    return out
'''

BAD_KERNEL_CU = '''\
// CUDA twin of bad_kernel.py's kernel body: trips LANNS020 and LANNS021.
// The word double in a comment is prose, not a type.
#include <cuda_runtime.h>



__global__ void bad_kernel(const float* x, float* o, int block) {
  double acc = 0.0;  // LANNS020: f64 in a kernel source
  int i = threadIdx.x;
  unsigned a0 = 0, a1 = 0, b0 = 0, c0 = 0, c1 = 0;
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f16.f16.f16.f16 {%0,%1}, {%2,%3,%4,%5}, {%6,%7}, {%8,%9};\\n" : "+r"(c0), "+r"(c1) : "r"(a0), "r"(a1), "r"(a0), "r"(a1), "r"(b0), "r"(b0), "r"(c0), "r"(c1));  // LANNS021
  o[i] = (float)acc + x[i] + (float)(c0 + block);
}
'''

CLEAN_KERNEL_PY = '''\
"""Torch twin of clean_kernel.py: same shapes, no findings."""
import ctypes

import torch


def clean_plain(x, o, *, block: int):
    x = x.to(torch.float32)
    idx = torch.arange(block, dtype=torch.int32)[None, :]
    w = torch.matmul(x, x.T)
    o[...] = w + idx.to(torch.float32)


def clean_launcher(x, lib, block=128):
    n = x.shape[0]
    if x.dim() != 2 or not x.is_contiguous() or n % block:
        raise ValueError("x must be a contiguous (n, d) tensor tiling the block")
    out = torch.empty_like(x)
    rc = lib.clean_kernel(x.data_ptr(), out.data_ptr(), ctypes.c_int(block))
    if rc != 0:
        raise RuntimeError(rc)
    return out
'''

CLEAN_KERNEL_CU = '''\
// CUDA twin of clean_kernel.py: f32 accumulation, no f64.
#include <cuda_runtime.h>

__global__ void clean_kernel(const float* x, float* o, int block) {
  float acc = 0.f;
  int i = threadIdx.x;
  unsigned a0 = 0, a1 = 0, b0 = 0;
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\\n" : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3]) : "r"(a0), "r"(a1), "r"(a0), "r"(a1), "r"(b0), "r"(b0));
  asm volatile("wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {%0}, %1, %2, 1;\\n" :: "r"(a0), "l"(0ull), "l"(0ull));
  o[i] = acc + c[0] + x[i] + block;
}
'''

#: (twin name, twin text, path it is analysed under, the reference fixture)
TWINS = {
    "bad_tracelint": (BAD_TRACELINT, "bad_tracelint.py", "bad_tracelint.py"),
    "clean_tracelint": (CLEAN_TRACELINT, "clean_tracelint.py", "clean_tracelint.py"),
    "bad_scalecheck": (BAD_SCALECHECK, "bad_scalecheck.py", "bad_scalecheck.py"),
    "clean_scalecheck": (CLEAN_SCALECHECK, "clean_scalecheck.py", "clean_scalecheck.py"),
    "bad_kernel": ((BAD_KERNEL_PY, BAD_KERNEL_CU), ("kernels/bad_kernel.py",
                                                    "kernels/csrc/bad_kernel.cu"),
                   "kernels/bad_kernel.py"),
    "clean_kernel": ((CLEAN_KERNEL_PY, CLEAN_KERNEL_CU), ("kernels/clean_kernel.py",
                                                          "kernels/csrc/clean_kernel.cu"),
                     "kernels/clean_kernel.py"),
}

#: every line of a twin whose findings differ from the reference fixture's,
#: besides the four codes no port pass emits: none.  The twins differ from
#: the fixtures only in lines that carry no finding — imports (jax -> torch),
#: the kernel body split into a Python plain version and a CUDA source (the
#: reference's line 11 `@` matmul is the CUDA twin's line 11 PTX string; its
#: line 8 f64 is on line 8 of both twin files).
LINE_DIFFERENCES: dict[str, list] = {name: [] for name in TWINS}


def _twin_findings(name):
    texts, paths, _ = TWINS[name]
    if isinstance(texts, str):
        texts, paths = (texts,), (paths,)
    out = []
    for text, path in zip(texts, paths):
        out += analyze_file(path, text)
    return out


@pytest.mark.parametrize("name", sorted(TWINS))
def test_torch_twin_trips_the_references_codes_at_its_lines(name):
    _, _, fixture = TWINS[name]
    want = sorted({(c, ln) for c, ln in pairs(j_analyze_file(str(FIXTURES / fixture)))
                   if c not in NOT_EMITTED} | set(LINE_DIFFERENCES[name]))
    got = sorted(set(pairs(_twin_findings(name))))
    assert got == want
    if name.startswith("clean"):
        assert got == []


def test_bad_twins_trip_every_emitted_rule():
    got = {c for name in TWINS if name.startswith("bad") for c, _ in
           pairs(_twin_findings(name))}
    emitted = {c for c in RULES if c not in NOT_EMITTED and c != "LANNS000"}
    locks = {c for c, _ in pairs(analyze_file(str(FIXTURES / "bad_locks.py")))}
    assert got | locks == emitted


def test_no_pass_emits_the_four_jit_and_mosaic_codes():
    """LANNS005/022/023/033 stay registered (the catalogue and every
    noqa[...] are one-to-one with the reference) but no pass emits them:
    not on the reference's own jnp fixtures, not on the twins, not on the
    port."""
    findings = analyze_paths([str(FIXTURES), str(PORT)])
    for name in TWINS:
        findings += _twin_findings(name)
    assert not {f.code for f in findings} & set(NOT_EMITTED)


def test_kernel_rules_only_apply_under_kernels_dir():
    got = pairs(analyze_file("bad_kernel.py", BAD_KERNEL_PY))
    assert not any(c.startswith("LANNS02") for c, _ in got)
    assert pairs(analyze_file("csrc/bad_kernel.cu", BAD_KERNEL_CU)) == []


def test_ptx_accumulators_of_the_ports_kernels():
    """Every mma.sync / wgmma.mma_async string in the port's csrc/
    accumulates in f32 or s32, and the scan reads them all."""
    from repro_torch.analysis.kernelcheck import _PTX_RE, _ptx_accumulators

    seen = 0
    for src in sorted((PORT / "kernels" / "csrc").glob("*.cu*")):
        for m in _PTX_RE.finditer(src.read_text()):
            accs = _ptx_accumulators(m.group("op"), m.group("mods"))
            if accs is not None:
                seen += 1
                assert set(accs) <= {"f32", "s32"}, (src.name, m.group(0))
    assert seen >= 15  # K2's s8 mma, K1/K3's tf32 and bf16 mma, K3-bwd's wgmma
    assert _ptx_accumulators("mma.sync", ".aligned.m16n8k32.row.col.s32.s8.s8.s32") == \
        ["s32", "s32"]
    assert _ptx_accumulators("wgmma.mma_async", ".sync.aligned.m64n64k16.f16.bf16.bf16") == \
        ["f16"]
    assert _ptx_accumulators("mma.sync", "") is None  # prose: "mma.sync m16n8k8 takes ..."


def test_the_scans_wgmma_strings_pass_the_accumulation_contract():
    """K2's s8 warpgroup MMA (``csrc/wgmma.cuh``) accumulates in .s32 and
    K1's tf32 ones in .f32; the scan's sources hold no mma.sync; an s8
    wgmma into .s16 trips LANNS021; the launchers of the scan (the batched
    and the small-batch K1, K2) check their shapes before they launch."""
    from repro_torch.analysis.kernelcheck import _PTX_RE, _ptx_accumulators

    csrc = PORT / "kernels" / "csrc"
    wg = [m for m in _PTX_RE.finditer((csrc / "wgmma.cuh").read_text())
          if _ptx_accumulators(m.group("op"), m.group("mods")) is not None]
    s8 = [m.group(0) for m in wg if ".s8." in m.group(0)]
    assert s8 == ["wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8"]
    assert _ptx_accumulators("wgmma.mma_async", s8[0][len("wgmma.mma_async"):]) == ["s32"]
    for name in ("scan.cuh", "topk.cuh", "distance_topk.cu", "distance_topk_q8.cu"):
        text = (csrc / name).read_text()
        assert not any(m.group("op") == "mma.sync" for m in _PTX_RE.finditer(text)), name
        assert pairs(analyze_file(str(csrc / name), text)) == []
    bad = 'asm("wgmma.mma_async.sync.aligned.m64n64k32.s16.s8.s8 {%0}, %1, %2, p;");\n'
    assert [c for c, _ in pairs(analyze_file("kernels/csrc/bad_scan.cu", bad))] == ["LANNS021"]
    for name in ("distance_topk.py", "distance_topk_q8.py"):
        path = PORT / "kernels" / name
        assert pairs(analyze_file(str(path), path.read_text())) == []


def test_launcher_shape_checks_of_the_ports_launchers():
    """The four ctypes launchers check shapes before they launch; taking
    the check out of one trips LANNS024."""
    src_path = PORT / "kernels" / "distance_topk.py"
    text = src_path.read_text()
    assert pairs(analyze_file(str(src_path), text)) == []
    cut = text.replace("    if q.dim() != 2 or x.dim() != 2 or q.shape[1] != x.shape[1]:\n"
                       "        raise ValueError(f\"distance_topk_cuda: shapes "
                       "{tuple(q.shape)} x {tuple(x.shape)}\")\n", "")
    cut = cut.replace("    if not (q.is_contiguous() and x.is_contiguous()):\n"
                      "        raise ValueError(\"distance_topk_cuda: q and x must be "
                      "contiguous\")\n", "")
    assert cut != text
    got = [c for c, _ in pairs(analyze_file(str(src_path), cut))]
    assert got == ["LANNS024"]


# ---------------------------------------------------------------------------
# suppressions and the CLI
# ---------------------------------------------------------------------------

SUPPRESSED = '''\
"""Torch twin of suppressed.py: justified noqa suppresses, bare noqa is LANNS000."""
import numpy as np
import torch


# lanns: hotpath
def justified(x):
    d = torch.sqrt(x)
    return np.asarray(d)  # lanns: noqa[LANNS003] -- test fixture: the designed sync


# lanns: hotpath
def unjustified(x):
    d = torch.sqrt(x)
    return np.asarray(d)  # lanns: noqa[LANNS003]


# lanns: hotpath
def wrong_code(x):
    d = torch.sqrt(x)
    return d.cpu()  # lanns: noqa[LANNS001] -- wrong code: does not match
'''


def test_suppression_semantics_equal_reference():
    got = analyze_file("suppressed.py", SUPPRESSED)
    want = j_analyze_file(str(FIXTURES / "suppressed.py"))
    assert pairs(got, include_suppressed=True) == pairs(want, include_suppressed=True)
    assert pairs(got) == pairs(want)
    sup = [f for f in got if f.suppressed]
    assert len(sup) == 1 and sup[0].code == "LANNS003"
    assert "designed sync" in sup[0].justification
    assert [c for c, _ in pairs(got)].count("LANNS003") == 2
    assert "LANNS000" in [c for c, _ in pairs(got)]


def test_cuda_source_noqa_uses_slash_comments():
    text = BAD_KERNEL_CU.replace(
        "double acc = 0.0;  // LANNS020: f64 in a kernel source",
        "double acc = 0.0;  // lanns: noqa[LANNS020] -- test: an f64 accumulator on purpose")
    got = analyze_file("kernels/csrc/bad_kernel.cu", text)
    assert pairs(got) == [("LANNS021", 11)]
    assert pairs(got, include_suppressed=True) == [("LANNS020", 8), ("LANNS021", 11)]


def _cli(*args, cwd=None):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis", *args],
                          capture_output=True, text=True, env=env, cwd=cwd, timeout=300)


@pytest.fixture(scope="module")
def twin_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("twins")
    for name, (texts, paths, _) in TWINS.items():
        if isinstance(texts, str):
            texts, paths = (texts,), (paths,)
        for text, path in zip(texts, paths):
            (root / path).parent.mkdir(parents=True, exist_ok=True)
            (root / path).write_text(text)
    return root


def test_cli_exit_codes(twin_dir):
    r = _cli("--strict", str(twin_dir / "bad_tracelint.py"))
    assert r.returncode == 1, r.stdout + r.stderr
    assert "LANNS001" in r.stdout
    r = _cli("--strict", str(twin_dir / "clean_tracelint.py"), str(FIXTURES / "clean_locks.py"))
    assert r.returncode == 0, r.stdout + r.stderr
    r = _cli(str(twin_dir / "bad_tracelint.py"))  # survey mode: always 0
    assert r.returncode == 0 and "LANNS001" in r.stdout
    r = _cli("--strict", str(twin_dir / "bad_scalecheck.py"))
    assert r.returncode == 1 and "LANNS034" in r.stdout


def test_cli_walks_directories_and_cuda_sources(twin_dir):
    findings = analyze_paths([str(twin_dir), str(FIXTURES / "bad_locks.py")])
    got = {(Path(f.path).name, f.code) for f in findings}
    assert ("bad_tracelint.py", "LANNS001") in got and ("bad_locks.py", "LANNS010") in got
    assert ("bad_kernel.cu", "LANNS021") in got and ("bad_kernel.py", "LANNS024") in got


def test_cli_footprint_report_round_trips(tmp_path):
    out = tmp_path / "fp.json"
    r = _cli("--footprint-report", str(out), "--footprint-dims", "n<=10_000_000, d<=512, P<=64")
    assert r.returncode == 0, r.stdout + r.stderr
    payload = json.loads(out.read_text())
    assert payload["config"]["dims"]["n"] == 10_000_000
    assert payload["metrics"] == footprint_report(
        {"n": 10_000_000, "d": 512, "P": 64})["metrics"]
    r = _cli("--footprint-report", str(out), "--footprint-dims", "n<1e6")
    assert r.returncode != 0


# ---------------------------------------------------------------------------
# the port itself: strict-clean, roots marked, and isolated
# ---------------------------------------------------------------------------

#: the reference's 10 hot-path roots and the port's counterparts
HOT_ROOTS = {
    "core/hnsw.py": ["HNSWIndex.add_batch", "FrozenHNSW.search"],
    "core/lanns.py": ["_Partition.search", "LannsIndex.query"],
    "core/plan.py": ["QueryPlanExecutor.execute"],
    "kernels/ops.py": ["distance_topk", "distance_topk_q8"],
    "quant/rerank.py": ["exact_candidate_distances"],
    "quant/twostage.py": ["QuantizedScanExecutor.run"],
    "serve/engine.py": ["AnnFrontend._execute"],
}


def test_the_references_hot_roots_are_marked_in_the_port():
    from repro_torch.analysis.tracelint import _FunctionIndex

    n = 0
    for rel, roots in HOT_ROOTS.items():
        src = t_rules.SourceFile.parse(str(PORT / rel))
        idx = _FunctionIndex()
        idx.visit(src.tree)
        for qual in roots:
            assert src.func_is_hot(idx.funcs[qual]), (rel, qual)
            n += 1
    assert n == 10


def test_every_suppression_in_the_port_is_justified():
    findings = analyze_paths([str(PORT)])
    assert [f for f in findings if not f.suppressed] == []
    sup = [f for f in findings if f.suppressed]
    assert sup and all(len(f.justification) > 20 for f in sup)
    # the beam's launches cite the roadmap item that removes them
    beam = [f for f in sup if f.path.endswith("core/hnsw.py") and f.code == "LANNS004"]
    assert beam and all("item 11" in f.justification for f in beam)


def test_take_declares_the_lock_its_callers_hold():
    """AsyncAnnFrontend._take runs only under _cond (every caller is in
    _loop's `with self._cond:`), as the reference's directive says; the
    reference's own checker agrees on the port's engine."""
    path = str(PORT / "serve" / "engine.py")
    assert pairs(analyze_file(path)) == []
    assert [p for p in pairs(j_analyze_file(path)) if p[0] == "LANNS010"] == []


ISOLATION = """
import sys
from repro_torch.analysis.__main__ import main
rc = main(["--strict"])
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("RC", rc, "LEAKED", bad)
sys.exit(rc or (1 if bad else 0))
"""


def test_strict_over_the_port_imports_neither_jax_nor_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", ISOLATION], capture_output=True, text=True,
                       env=env, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "RC 0 LEAKED []" in r.stdout


# ---------------------------------------------------------------------------
# runtime: lock-order registry, guarded dict, race stress
# ---------------------------------------------------------------------------


def _seq_ab_ba(rt):
    reg = rt.LockOrderRegistry()
    a, b = rt.InstrumentedLock("a", reg), rt.InstrumentedLock("b", reg)

    def ab():
        with a, b:
            pass

    def ba():
        with b, a:
            pass

    for fn in (ab, ba):
        t = threading.Thread(target=fn)
        t.start()
        t.join()
    with pytest.raises(AssertionError, match="cycle"):
        reg.assert_acyclic()
    return reg.edges, reg.cycles(), []


def _seq_consistent(rt):
    reg = rt.LockOrderRegistry()
    a, b, c = (rt.InstrumentedLock(x, reg) for x in "abc")
    for _ in range(3):
        with a, b:
            with c:
                pass
    reg.assert_acyclic()
    return reg.edges, reg.cycles(), []


def _seq_reentrant(rt):
    reg = rt.LockOrderRegistry()
    a = rt.InstrumentedLock("a", reg)
    with a, a:
        pass
    return reg.edges, reg.cycles(), []


def _seq_guarded_dict(rt):
    reg = rt.LockOrderRegistry()
    lock = rt.InstrumentedLock("m", reg)
    d = rt.GuardedDict({"n": 0}, lock, "stats")
    d["n"] = 1  # unlocked: recorded, not raised (the stress keeps running)
    d["k"] = 3
    with lock:
        d["n"] = 2
    t = threading.Thread(target=lambda: d.__delitem__("k"), name="other")
    t.start()
    t.join()
    return reg.edges, reg.cycles(), d.violations


def _seq_condition(rt):
    reg = rt.LockOrderRegistry()
    cond = threading.Condition(rt.InstrumentedLock("c", reg))
    other = rt.InstrumentedLock("o", reg)
    hit = []

    def waiter():
        with cond:
            hit.append(cond.wait(timeout=5.0))
            with other:
                pass

    t = threading.Thread(target=waiter)
    t.start()
    deadline = time.monotonic() + 10
    while not cond._waiters and time.monotonic() < deadline:
        time.sleep(0.005)
    with cond:
        cond.notify()
    t.join(timeout=5.0)
    return reg.edges, reg.cycles(), hit


SEQUENCES = {f.__name__[5:]: f for f in (_seq_ab_ba, _seq_consistent, _seq_reentrant,
                                         _seq_guarded_dict, _seq_condition)}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_runtime_sequences_equal_reference(name):
    got = SEQUENCES[name](t_runtime)
    want = SEQUENCES[name](j_runtime)
    assert got == want


@pytest.fixture(scope="module")
def stress_index():
    data = clustered_vectors(400, 8, n_clusters=8, seed=11)
    cfg = LannsConfig(num_shards=1, num_segments=2, segmenter="apd", engine="scan")
    return LannsIndex(cfg, device="cpu").build(data)


def _respects_lock_orders(edges):
    from repro_torch.serve.controller import SLOController
    from repro_torch.serve.engine import AsyncAnnFrontend

    order = AsyncAnnFrontend._LOCK_ORDER
    assert SLOController._LOCK_ORDER == ("_lock",)  # the controller's lock is a leaf
    for a, b in edges:
        assert a != "ctrl_lock", (a, b)
        if a in order and b in order:
            assert order.index(a) < order.index(b), (a, b)


def test_race_stress_short_burst_clean(stress_index):
    report = t_runtime.race_stress(threads=4, duration_s=2.0, seed=0, index=stress_index)
    assert report.ok, report.render()
    assert report.cycles_run >= 1
    assert report.submitted > 0 and report.completed > 0
    assert report.completed + report.cancelled == report.submitted
    _respects_lock_orders(report.lock_edges)


def _submitted_rows(monkeypatch, **kw):
    from repro_torch.serve.engine import AsyncAnnFrontend

    rows, real = [], AsyncAnnFrontend.submit

    def spy(self, query, **k):
        rows.append(np.asarray(query, np.float32))
        return real(self, query, **k)

    monkeypatch.setattr(AsyncAnnFrontend, "submit", spy)
    report = t_runtime.race_stress(threads=2, duration_s=0.5, **kw)
    monkeypatch.undo()
    assert report.ok, report.render()
    return np.stack(rows)


def test_race_stress_default_queries_are_the_references(stress_index, monkeypatch):
    """queries=None draws the reference's 256 queries (its own
    clustered_vectors call); queries=Q submits rows of Q."""
    want = j_clustered_vectors(256, 8, n_clusters=8, seed=7 + 1)
    rows = _submitted_rows(monkeypatch, seed=7, index=stress_index)
    assert len(rows) > 0
    assert all((want == r).all(1).any() for r in rows)
    mine = np.random.default_rng(3).standard_normal((5, 8)).astype(np.float32)
    rows = _submitted_rows(monkeypatch, seed=7, index=stress_index, queries=mine)
    assert all((mine == r).all(1).any() for r in rows)


def test_race_stress_builds_the_references_index_on_the_given_device(monkeypatch):
    built = []
    real = LannsIndex.build

    def spy(self, data, *a, **k):
        built.append((self.device, np.asarray(data).shape))
        return real(self, data, *a, **k)

    monkeypatch.setattr(LannsIndex, "build", spy)
    report = t_runtime.race_stress(threads=2, duration_s=0.3, seed=0, device="cpu")
    assert report.ok, report.render()
    assert built == [(torch.device("cpu"), (600, 8))]


# ---------------------------------------------------------------------------
# the footprint model
# ---------------------------------------------------------------------------

#: every row where the port's model differs from the reference's, keyed by
#: (mode, placement, component), with the PAD_MODEL entry that says why
DIFFERENCES = {
    ("fp32_scan", "device", "vectors"): "scan_rows",
    ("fp32_scan", "device", "keys"): "keys",
    ("fp32_scan", "host", "keys"): "keys",
    ("q8_scan", "device", "codes"): "scan_rows",
    ("q8_scan", "device", "scale_bias"): "q8_scales",
    ("q8_scan", "device", "scales"): "q8_scales",
    ("q8_scan", "device", "bias"): "scan_rows",
    ("q8_scan", "device", "keys"): "keys",
    ("q8_scan", "host", "keys"): "rerank_store",
    ("q8_scan", "host", "rerank_store.keys"): "rerank_store",
    ("fp32_hnsw", "device", "vectors"): "hnsw_rows",
    ("fp32_hnsw", "device", "adj0"): "hnsw_rows",
    ("fp32_hnsw", "device", "upper_adj"): "hnsw_rows",
    ("fp32_hnsw", "device", "keys"): "keys",
    ("fp32_hnsw", "host", "keys"): "keys",
    ("fp32_hnsw", "host", "entry"): "entry",
    ("q8_hnsw", "device", "codes"): "hnsw_rows",
    ("q8_hnsw", "device", "norms2"): "hnsw_rows",
    ("q8_hnsw", "device", "adj0"): "hnsw_rows",
    ("q8_hnsw", "device", "upper_adj"): "hnsw_rows",
    ("q8_hnsw", "device", "keys"): "keys",
    ("q8_hnsw", "device", "scales"): "q8_scales",
    ("q8_hnsw", "host", "scales"): "q8_scales",
    ("q8_hnsw", "host", "keys"): "keys",
    ("q8_hnsw", "host", "rerank_store.keys"): "rerank_store",
    ("q8_hnsw", "host", "entry"): "entry",
}


@pytest.mark.parametrize("dims", [None, {"n": 10_000_000, "d": 512, "P": 64, "M": 16}],
                         ids=["defaults", "deployment"])
def test_footprint_rows_against_the_references(dims):
    mine, ref = footprint_report(dims), j_footprint_report(dims)
    assert {k: v for k, v in mine["dims"].items() if k != "n_part"} == ref["dims"]
    key = lambda r: (r["mode"], r["placement"], r["component"])
    m = {key(r): r["bytes"] for r in mine["rows"]}
    j = {key(r): r["bytes"] for r in ref["rows"]}
    for k in sorted(set(m) | set(j)):
        if k in m and k in j and m[k] == j[k]:
            assert k not in DIFFERENCES, k
        else:
            assert k in DIFFERENCES, (k, m.get(k), j.get(k))
            assert DIFFERENCES[k] in mine["pad_model"]
    assert set(mine["metrics"]) == set(ref["metrics"])
    # the port's HNSW rows are a tighter pow2 pad than the reference's 2n
    assert m[("fp32_hnsw", "device", "vectors")] <= j[("fp32_hnsw", "device", "vectors")]


def test_footprint_at_the_defaults():
    rep = footprint_report()
    assert {k: rep["dims"][k] for k in DEFAULT_FOOTPRINT_DIMS} == DEFAULT_FOOTPRINT_DIMS
    assert rep["dims"]["n_part"] == -(-180_000_000 // 4096)
    met = rep["metrics"]
    assert met["footprint_q8_scan_device_bytes"] < met["footprint_fp32_scan_device_bytes"]
    assert met["footprint_q8_hnsw_device_bytes"] < met["footprint_fp32_hnsw_device_bytes"]


def _resident(idx, mode):
    if mode == "fp32_scan":
        return sum(p.vectors.numel() * 4 + p.keys.numel() * 8
                   for p in idx.partitions.values() if p.size)
    if mode == "q8_scan":
        return idx._q8_executor().resident_bytes()
    idx._hnsw_stack(quantized=mode == "q8_hnsw")
    return idx.hnsw_resident_bytes()


@pytest.mark.parametrize("mode", ["fp32_scan", "q8_scan", "fp32_hnsw", "q8_hnsw"])
def test_small_cpu_index_resident_bytes_within_the_model(mode):
    data = clustered_vectors(3000, 30, n_clusters=16, seed=5)
    cfg = LannsConfig(num_shards=2, num_segments=4, segmenter="rh",
                      engine="scan" if mode.endswith("scan") else "hnsw",
                      quantized="q8" if mode.startswith("q8") else "none", hnsw_m=8,
                      ef_construction=40)
    idx = LannsIndex(cfg, device="cpu").build(data)
    dims = index_footprint_dims(idx)
    assert dims["n"] == 3000 and dims["d"] == 30 and dims["P"] == 8
    measured = _resident(idx, mode)
    predicted = footprint_report(dims)["metrics"][f"footprint_{mode}_device_bytes"]
    assert 0 < measured <= predicted
    assert measured == predicted  # the model mirrors the allocations exactly
