#!/usr/bin/env python3
"""Time versions of the scan behind K1 and K2 against each other on one
CUDA card, split their time into parts, and sweep K1 over small batches.

    python3 tools/scan_time.py [--out PATH] [--split] [--sweep] [--k3] [--quick] CSRC ...

Each CSRC is a ``csrc/`` directory of the port's kernels: the working
tree's (``src/repro_torch/kernels/csrc``) or a parent commit's unpacked by
``git archive`` under ``build/``.  The first is the version under test.  A
directory whose ``distance_topk.cu`` has no small-batch path (its C entry
takes no ``path`` argument) is the earlier ``mma.sync`` design of the scan,
and is launched with that design's plan (64-query tiles, two blocks a SM).

Each version's ``distance_topk.cu`` and ``distance_topk_q8.cu`` are built
as the package builds them (``_build.UNITS``, one nvcc per unit, all
started together) into ``build/scan_time/``; the build's seconds, its
``-Xptxas -v`` lines (registers, spills) and the counts of ``HGMMA``
(wgmma), ``IGMMA`` (integer wgmma), ``HMMA`` (mma.sync f16 / tf32) and
``IMMA`` (mma.sync int8) in its SASS (``cuobjdump``) are printed.
``--k3`` also builds K3's and K3-bwd's sources of each version and prints
their SASS counts (an edit of ``wgmma.cuh`` rebuilds them; their code must
not change).

Each version is checked at every timed shape before it is timed: K1
within rtol = atol = 3e-4 of ``ref.distance_topk_blocked`` with ids equal
up to a k-th place swap, K2 bit-equal to ``ref.distance_topk_q8_blocked``,
and two launches bit-equal.  Then every shape of PERF.md's K1 / K2 rows is
timed with CUDA events in turns (first version to last, then last to
first) beside the library call (K1 ``torch.topk`` of ``addmm`` / ``q @
x.T``, K2 ``torch._int_mm`` + ``torch.topk``) and the bound (operations
at 165 TFLOP/s float32-grade or 1,979 TOP/s int8, or bytes at 3.35 TB/s,
the larger).  ``--sweep`` adds K1 at B in {1, 2, 4, 8, 16, 32, 64} against
the paper partition and the retrieval_cand corpus, the first version also
on its batched scan at B <= B_SMALL (the crossover of its two scans).

``--split`` builds four more versions of the first CSRC's sources, each
compiling one more part out (``-DREPRO_SCAN_OFF``, a bit mask; a parent's
sources are patched to read the same bits): the chunk merge (1), the
chunk end (2), the filter with the bounds and the flushes (4), the
products (8).  The parts are the differences of neighbouring versions;
what is left is the ring's data movement.  A fifth build (``-DREPRO_SCAN_CLOCKS``) sums
``clock64`` over the consumer warps: the share of their time inside
flushes splits the filter's part into filter and bounds, and flushes.
``--quick`` only builds and checks, at small shapes and the paths' edges
(a first run of a new version).  A library newer than its version's
sources (an earlier run's in the same call) is reused.  Prints one JSON
line per record and writes them all to PATH (default
``build/scan_time/scan_time.json``); exits 1 if a version failed to build
or a check failed.
"""

import ctypes
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
from chip_smoke import (PEAK_F32_FLOPS, PEAK_HBM_BYTES, PEAK_INT8_OPS,  # noqa: E402
                        compare_q8_topk, compare_topk, cuda_ms)
from repro_torch.kernels import _build, distance_topk as k1_mod, ref  # noqa: E402

OUT = ROOT / "build" / "scan_time"
SOURCES = ("distance_topk.cu", "distance_topk_q8.cu")
# cumulative: each compiles one more part out
VARIANTS = {"full": 0, "no_merge": 1, "no_end": 3, "no_filter": 7, "no_products": 15}
PARTS = (("merge", "full", "no_merge"), ("chunk_end", "no_merge", "no_end"),
         ("filter_bounds_flushes", "no_end", "no_filter"),
         ("products", "no_filter", "no_products"), ("data_movement", "no_products", None))
RECORDS = []

# (kernel, label, B, N, D, k, metric, n_valid): PERF.md's K1 / K2 rows
SHAPES = [
    ("K1", "paper partition", 440, 124_606, 128, 60, "l2", None),
    ("K1", "deployment partition", 345, 156_773, 512, 19, "l2", None),
    ("K1", "paper partition k_pad 512", 440, 124_606, 128, 400, "l2", None),
    ("K1", "ground truth", 4096, 1_000_000, 128, 100, "l2", None),
    ("K1", "retrieval_cand", 1, 1_000_448, 50, 100, "ip", 1_000_000),
    ("K2", "paper q8 partition", 440, 124_606, 128, 120, "l2", None),
    ("K2", "deployment q8 partition", 345, 156_773, 512, 38, "l2", None),
    ("K2", "paper q8 partition k_pad 512", 440, 124_606, 128, 400, "l2", None),
]
SWEEP_B = (1, 2, 4, 8, 16, 32, 64)
# --quick: a first run of a new version, checks only, small shapes and the
# paths' edges
QUICK = [
    ("K1", "quick l2 batched", 37, 5003, 128, 100, "l2", None),
    ("K1", "quick ip batched ragged D", 200, 20_000, 50, 60, "ip", 19_000),
    ("K1", "quick l2 batched D 512 k_pad 512", 130, 9_000, 512, 400, "l2", None),
    ("K1", "quick small B 1", 1, 100_000, 50, 100, "ip", 99_999),
    ("K1", "quick small B 5 D 7", 5, 20_000, 7, 60, "l2", None),
    ("K1", "quick small B 16 D 128 k_pad 256", 16, 50_000, 128, 200, "l2", None),
    ("K1", "quick small B 3 D 2048 k_pad 512", 3, 5_000, 2048, 400, "ip", 4_999),
    ("K1", "quick small B 9 D 1000", 9, 20_000, 1000, 100, "l2", None),
    ("K2", "quick q8", 37, 5003, 128, 38, "l2", None),
    ("K2", "quick q8 D 512", 200, 20_000, 512, 38, "l2", None),
    ("K2", "quick q8 D 36 k_pad 512", 70, 9_000, 36, 400, "ip", 8_000),
    ("K2", "quick q8 D 960", 37, 5003, 960, 100, "l2", None),
]
SPLIT_SHAPES = ("paper partition", "deployment partition", "paper partition k_pad 512",
                "retrieval_cand", "paper q8 partition", "deployment q8 partition",
                "paper q8 partition k_pad 512")

# the patches that make the mma.sync design's sources read the working
# tree's diagnostic macros, each (file, text, replacement)
PARENT_PATCHES = [
    ("scan.cuh", "        Op::kstep(acc, ol, a, bf);\n",
     "#if !(REPRO_SCAN_OFF & 8)\n        Op::kstep(acc, ol, a, bf);\n#endif\n"),
    ("scan.cuh", "    Op::scores(s, acc, ol, args, lane);\n",
     "    Op::scores(s, acc, ol, args, lane);\n#if REPRO_SCAN_OFF & 4\n"
     "    for (int j = 0; j < NJ; ++j) for (int e = 0; e < 4; ++e) sink = fminf(sink, s[j][e]);\n"
     "    continue;\n#endif\n"),
    ("scan.cuh", "  auto list_of = [&](int u, float*& ld, int*& li) {\n",
     "  float sink = topk::inf_f();\n  SCAN_CLOCK_START();\n"
     "  auto list_of = [&](int u, float*& ld, int*& li) {\n"),
    ("scan.cuh", "  // the rest of each buffer, then lists that never filled: pad and sort\n",
     "  if (sink == -1.2345f) list_d[0] = sink;\n  SCAN_CLOCK_END_TILES();\n"
     "#if !(REPRO_SCAN_OFF & 2)\n"),
    ("scan.cuh", "      topk::finish_list<K>(ld, li, n0, lane);\n    }\n  }\n}\n",
     "      topk::finish_list<K>(ld, li, n0, lane);\n    }\n  }\n#endif\n  SCAN_CLOCK_END();\n}\n"),
    ("scan.cuh", "  return topk::launch_merge<K>(part_d, part_i, out_d, out_i, B, nsplit, stream);\n",
     "#if REPRO_SCAN_OFF & 1\n  return cudaSuccess;\n#else\n"
     "  return topk::launch_merge<K>(part_d, part_i, out_d, out_i, B, nsplit, stream);\n#endif\n"),
    ("scan.cuh", "  auto flush_u = [&](int u, int h) {\n",
     "  auto flush_u = [&](int u, int h) {\n    SCAN_CLOCK_FLUSH_BEGIN();\n"),
    ("scan.cuh", "    if (bound != nullptr && lane == 0 && f.jb < jb0)\n"
                 "      bound[(size_t)(q0 + qw + u) * K + split] = f.jb;\n  };\n",
     "    if (bound != nullptr && lane == 0 && f.jb < jb0)\n"
     "      bound[(size_t)(q0 + qw + u) * K + split] = f.jb;\n    SCAN_CLOCK_FLUSH_END();\n  };\n"),
    ("scan.cuh", "#pragma unroll 1  // one k-step of fragments live at a time (fewer spills)\n",
     "      SCAN_CLOCK_PRODUCTS_BEGIN();\n"
     "#pragma unroll 1  // one k-step of fragments live at a time (fewer spills)\n"),
    ("scan.cuh", "      __syncwarp();\n      if (lane == 0) mbar_arrive(&sm.empty[st]);\n    }\n",
     "      SCAN_CLOCK_PRODUCTS_END();\n      __syncwarp();\n      if (lane == 0) mbar_arrive(&sm.empty[st]);\n    }\n"),
    ("scan.cuh", "namespace scan {\n", '#include "scan_clocks.cuh"\n\nnamespace scan {\n'),
]

# the clock counters of a diagnostic build: per consumer warp, sums of
# clock64 over its whole scan, its products (the fragment loads and the
# MMAs, after the wait for a stage), its flushes and its chunk end, summed over
# every warp of a launch (lane 0 adds)
CLOCKS_HEADER = r"""#pragma once
#include <cuda_runtime.h>
#ifndef REPRO_SCAN_OFF
#define REPRO_SCAN_OFF 0
#endif
#if defined(REPRO_SCAN_CLOCKS) && defined(REPRO_K)
static __device__ unsigned long long scan_clock_sums[4];  // total, products, flushes, chunk end
#define SCAN_CLOCK_CAT(a, b) a##b##_0
#define SCAN_CLOCK_FN(k) SCAN_CLOCK_CAT(repro_scan_clocks_, k)
extern "C" int SCAN_CLOCK_FN(REPRO_K)(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, scan_clock_sums, sizeof(scan_clock_sums));
  unsigned long long zero[4] = {0, 0, 0, 0};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(scan_clock_sums, zero, sizeof(zero));
  return (int)e;
}
#define SCAN_CLOCK_START() long long ck_t0 = clock64(), ck_p = 0, ck_f = 0, ck_e = 0, ck_a = 0, ck_b = 0, ck_e0 = 0
#define SCAN_CLOCK_PRODUCTS_BEGIN() ck_a = clock64()
#define SCAN_CLOCK_PRODUCTS_END() ck_p += clock64() - ck_a
#define SCAN_CLOCK_FLUSH_BEGIN() ck_b = clock64()
#define SCAN_CLOCK_FLUSH_END() ck_f += clock64() - ck_b
#define SCAN_CLOCK_END_TILES() ck_e0 = clock64()
#define SCAN_CLOCK_END() do { ck_e = clock64() - ck_e0; if ((threadIdx.x & 31) == 0) { \
    atomicAdd(&scan_clock_sums[0], (unsigned long long)(clock64() - ck_t0)); \
    atomicAdd(&scan_clock_sums[1], (unsigned long long)ck_p); \
    atomicAdd(&scan_clock_sums[2], (unsigned long long)ck_f); \
    atomicAdd(&scan_clock_sums[3], (unsigned long long)ck_e); } } while (0)
#else
#define SCAN_CLOCK_START()
#define SCAN_CLOCK_PRODUCTS_BEGIN()
#define SCAN_CLOCK_PRODUCTS_END()
#define SCAN_CLOCK_FLUSH_BEGIN()
#define SCAN_CLOCK_FLUSH_END()
#define SCAN_CLOCK_END_TILES()
#define SCAN_CLOCK_END()
#endif
"""


def emit(rec: dict, show: bool = True) -> None:
    RECORDS.append(rec)
    if show:
        print(json.dumps(rec), flush=True)


def is_parent(csrc: Path) -> bool:
    return not re.search(r"int path", (csrc / "distance_topk.cu").read_text())


def prepare(i: int, csrc: Path) -> Path:
    """A copy of the version's csrc under build/scan_time/v{i}, patched to
    read the split's macros when it is the mma.sync design."""
    dst = OUT / f"v{i}"
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(csrc, dst)
    if is_parent(csrc):
        (dst / "scan_clocks.cuh").write_text(CLOCKS_HEADER)
        for name, old, new in PARENT_PATCHES:
            text = (dst / name).read_text()
            if text.count(old) != 1:
                raise SystemExit(f"{csrc}/{name}: patch target found {text.count(old)} times:\n{old}")
            (dst / name).write_text(text.replace(old, new))
    return dst


def sass_counts(lib: Path) -> dict:
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(cuobjdump).exists():
        return {}
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True).stdout.splitlines()
    return {"HGMMA": sum("HGMMA" in ln for ln in sass), "IGMMA": sum("IGMMA" in ln for ln in sass),
            "HMMA": sum("HMMA" in ln for ln in sass), "IMMA": sum("IMMA" in ln for ln in sass)}


def build_job(csrc: Path, source: str, tag: str, defines=()) -> dict:
    """The nvcc commands of each unit of ``source`` (the package's flags,
    ``-I csrc``) and the library they link into."""
    flags = [f for f in _build.NVCC_FLAGS if f != "-shared"]
    units = _build.UNITS.get(source, ((),))
    if "REPRO_PATH" not in (csrc / source).read_text():  # a parent's: one unit a k_pad
        units = tuple(dict.fromkeys(tuple(d for d in u if "REPRO_PATH" not in d) for u in units))
    objs = [OUT / f"{tag}_{u}.o" for u in range(len(units))]
    cmds = [[_build._nvcc(), *flags, "-I", str(csrc), *unit_defs, *defines, "-c", "-o",
             str(obj), str(csrc / source)]
            for unit_defs, obj in zip(units, objs)]
    return {"cmds": cmds, "objs": objs, "lib": OUT / f"{tag}.so"}


def run_builds(jobs: dict, workers: int = 12) -> dict:
    """Every unit of every job, ``workers`` at a time, then each link;
    returns ``{key: CDLL}`` and prints each build's record."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    # a library newer than its version's sources (an earlier run's) is kept
    src_mtime = {}
    for job in jobs.values():
        d = Path(job["cmds"][0][job["cmds"][0].index("-I") + 1])
        src_mtime[job["lib"]] = max(f.stat().st_mtime for f in d.iterdir())
    jobs_run = {key: job for key, job in jobs.items()
                if not (job["lib"].exists() and job["lib"].stat().st_mtime > src_mtime[job["lib"]])}
    units = [(key, cmd) for key, job in jobs_run.items() for cmd in job["cmds"]]
    with ThreadPoolExecutor(workers) as pool:
        logs = list(pool.map(lambda u: subprocess.run(u[1], capture_output=True, text=True),
                             units))
    out = {}
    for key, job in jobs.items():
        if key not in jobs_run:
            emit({"build": " ".join(map(str, key)), "kept": str(job["lib"]),
                  "sass": sass_counts(job["lib"])})
            out[key] = ctypes.CDLL(str(job["lib"]))
            continue
        mine = [r for (k, _), r in zip(units, logs) if k == key]
        log = "".join(r.stdout + r.stderr for r in mine)
        label = " ".join(map(str, key))
        if any(r.returncode for r in mine):
            errors = [ln for ln in log.splitlines() if "error" in ln.lower()]
            emit({"build": label, "failed": "nvcc", "errors": errors[:40]})
            continue
        link = subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, "-shared", "-o",
                               str(job["lib"]), *map(str, job["objs"])], capture_output=True,
                              text=True)
        if link.returncode:
            emit({"build": label, "failed": "link", "errors": (link.stdout + link.stderr)[-3000:]})
            continue
        ptxas = [ln.strip()[:200] for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln or "Compiling entry" in ln or "C75" in ln]
        emit({"build": label, "sass": sass_counts(job["lib"]),
              "spills": sorted({ln for ln in ptxas
                                if "spill" in ln and not ln.startswith("0 bytes")}),
              "serialized_wgmma_warnings": sum("C7515" in ln for ln in ptxas)})
        emit({"build": label, "ptxas": ptxas}, show=False)
        out[key] = ctypes.CDLL(str(job["lib"]))
    emit({"builds": len(jobs), "units": len(units), "seconds": time.perf_counter() - t0})
    return out


class Version:
    """One version's K1 and K2 libraries and how to launch them."""

    def __init__(self, name: str, csrc: Path, libs: dict, force_path: int | None = None):
        self.name, self.parent = name, is_parent(csrc)
        self.force_path = force_path  # the sweep's "batched at every B" twin
        self.k1 = libs["distance_topk.cu"].repro_distance_topk
        self.k2 = libs["distance_topk_q8.cu"].repro_distance_topk_q8
        self.k1.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * (7 if self.parent else 8)
                            + [ctypes.c_void_p])
        self.k2.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        self.k1.restype = self.k2.restype = ctypes.c_int
        self.lib1 = libs["distance_topk.cu"]
        self.lib2 = libs["distance_topk_q8.cu"]

    def plan(self, B: int, n_valid: int, k_pad: int, q8: bool) -> tuple[int, int, int]:
        """(nsplit, chunk, path) of this version for one launch."""
        sm = torch.cuda.get_device_properties(0).multi_processor_count
        if self.parent:  # the mma.sync design: 64-query tiles, two blocks a SM
            n_tiles, q_tiles = -(-n_valid // 64), -(-B // 64)
            nsplit = max(1, min(sm * 2 // q_tiles, n_tiles // 4, k_pad))
            chunk = -(-n_tiles // nsplit) * 64
            return -(-n_valid // chunk), chunk, 0
        small = k1_mod.small_batch(B) if self.force_path is None else self.force_path == 1
        if not q8 and small:
            return (*k1_mod.small_plan(B, n_valid, sm, k_pad), 1)
        return (*k1_mod.split_plan(B, n_valid, sm, k_pad), 0)

    def run(self, kernel: str, ins: dict, k_pad: int, n_valid: int, metric: int):
        q8 = kernel == "K2"
        B = ins["q"].shape[0]
        ns, ch, path = self.plan(B, n_valid, k_pad, q8)
        dev = ins["q"].device
        out_d = torch.empty(B, k_pad, device=dev)
        out_i = torch.empty(B, k_pad, dtype=torch.int32, device=dev)
        part_d = torch.empty(B, max(ns, 1), k_pad, device=dev)
        part_i = torch.empty(B, max(ns, 1), k_pad, dtype=torch.int32, device=dev)
        st = torch.cuda.current_stream().cuda_stream
        tail = [part_d.data_ptr(), part_i.data_ptr(), out_d.data_ptr(), out_i.data_ptr()]
        if q8:
            rc = self.k2(ins["q"].data_ptr(), ins["x"].data_ptr(), ins["q_scale"].data_ptr(),
                         ins["norms2"].data_ptr(), *tail, B, ins["q"].shape[1] // 4, n_valid,
                         k_pad, metric, ns, ch, st)
        else:
            ints = [B, ins["q"].shape[1], n_valid, k_pad, metric, ns, ch]
            if not self.parent:
                ints.append(path)
            rc = self.k1(ins["q"].data_ptr(), ins["x"].data_ptr(), *tail, *ints, st)
        if rc != 0:
            raise RuntimeError(f"{self.name} {kernel}: cudaError {rc}")
        return out_d, out_i

    def clocks(self, kernel: str, k_pad: int, path: int):
        lib = self.lib2 if kernel == "K2" else self.lib1
        out = (ctypes.c_ulonglong * 4)()
        if getattr(lib, f"repro_scan_clocks_{k_pad}_{path}")(out) != 0:
            raise RuntimeError("clock read failed")
        return list(out)


def make_inputs(kernel: str, B: int, N: int, D: int, metric: str, gen) -> dict:
    if kernel == "K1":
        if metric == "l2" and N < 2_000_000 and B < 1000:  # clustered, as the partitions are
            from repro_torch.data.synthetic import sift_like

            x, q = sift_like(N, D, B, seed=N + D)
            return {"q": torch.from_numpy(q).cuda(), "x": torch.from_numpy(x).cuda()}
        return {"q": torch.randn(B, D, generator=gen, device="cuda"),
                "x": torch.randn(N, D, generator=gen, device="cuda")}
    from repro_torch.quant.codec import quantize_q8, quantize_queries_q8_t
    from repro_torch.data.synthetic import sift_like

    x, q = sift_like(N, D, B, seed=N + D)
    qc = quantize_q8(x, metric)
    scales = torch.from_numpy(qc.scales).cuda()
    q_codes, q_scale = quantize_queries_q8_t(torch.from_numpy(q).cuda(), scales)
    return {"q": q_codes.contiguous(), "x": torch.from_numpy(qc.codes).cuda(),
            "q_scale": q_scale.contiguous(), "norms2": torch.from_numpy(qc.norms2).cuda()}


def k_pad_of(k: int) -> int:
    return max(128, 1 << (k - 1).bit_length())


def bound(kernel: str, B: int, N: int, D: int, k_pad: int, metric: str) -> tuple[float, str]:
    if kernel == "K1":
        ops = 2.0 * B * N * D + (2.0 * N * D if metric == "l2" else 0.0)
        t_ops = ops / PEAK_F32_FLOPS
        t_bytes = (4.0 * (B * D + N * D) + 8.0 * B * k_pad) / PEAK_HBM_BYTES
    else:
        t_ops = 2.0 * B * N * D / PEAK_INT8_OPS
        t_bytes = (N * D + 4.0 * N + B * D + 4.0 * B + 8.0 * B * k_pad) / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def library_fn(kernel: str, ins: dict, k: int, metric: str, n_valid: int):
    q, x = ins["q"], ins["x"][:n_valid]
    if kernel == "K1":
        if metric == "ip":
            return lambda: torch.topk(q @ x.T, k, dim=1)
        xn = (x * x).sum(-1)
        return lambda: torch.topk(torch.addmm(xn, q, x.T, alpha=-2.0), k, dim=1, largest=False)
    n8 = -(-n_valid // 8) * 8
    x_t = torch.nn.functional.pad(x, (0, 0, 0, n8 - n_valid)).T
    bias8 = torch.nn.functional.pad(ins["norms2"][:n_valid], (0, n8 - n_valid),
                                    value=float("inf"))

    def lib():
        qx = torch._int_mm(q, x_t).to(torch.float32) * ins["q_scale"][:, None]
        return torch.topk(bias8[None, :] - 2.0 * qx if metric == "l2" else -qx, k, dim=1,
                          largest=False)

    return lib


def check(v: Version, kernel: str, label: str, ins: dict, k: int, metric: str, n_valid: int,
          strict: bool) -> dict:
    """One version at one shape against the plain version, and two launches
    against each other; a failure is printed (and raised when strict)."""
    k_pad = k_pad_of(k)
    mcode = 0 if metric == "l2" else 1
    rec = {"version": v.name, "check": label}
    try:
        d_k, i_k = v.run(kernel, ins, k_pad, n_valid, mcode)
        d_2, i_2 = v.run(kernel, ins, k_pad, n_valid, mcode)
        torch.cuda.synchronize()
        rec["repeat_bit_equal"] = bool(torch.equal(d_k, d_2) and torch.equal(i_k, i_2))
        if kernel == "K1":
            d = d_k[:, :k]
            if metric == "l2":
                d = d + (ins["q"] * ins["q"]).sum(-1, keepdim=True)
            d_p, i_p = ref.distance_topk_blocked(ins["q"], ins["x"], k, metric, n_valid=n_valid)
            rec["max_abs_err"], rec["tie_swaps"] = compare_topk(d, i_k[:, :k], d_p, i_p, label)
        else:
            d_p, i_p = ref.distance_topk_q8_blocked(ins["q"], ins["x"], ins["q_scale"],
                                                    ins["norms2"], k, metric, n_valid=n_valid)

            def scores_of(r, ids):
                idx = torch.from_numpy(ids.astype(np.int64)).cuda()
                return ref.q8_score_matrix(ins["q"][r: r + 1], ins["x"][idx],
                                           ins["q_scale"][r: r + 1], ins["norms2"][idx],
                                           metric)[0].cpu().numpy()

            rec["max_abs_err"], rec["tie_swaps"] = compare_q8_topk(
                d_k[:, :k], i_k[:, :k], d_p, i_p, scores_of, label)
        rec["ok"] = rec["repeat_bit_equal"]
    except (AssertionError, RuntimeError) as exc:
        rec["ok"], rec["error"] = False, str(exc)[:2000]
    emit(rec, show=not rec["ok"])
    if strict and not rec["ok"]:
        raise AssertionError(rec)
    return rec


def time_shape(versions, kernel, label, ins, k, metric, n_valid, extra=None) -> None:
    B, D = ins["q"].shape
    k_pad = k_pad_of(k)
    mcode = 0 if metric == "l2" else 1
    b_ms, b_by = bound(kernel, B, n_valid, D, k_pad, metric)
    lib = library_fn(kernel, ins, k, metric, n_valid)
    order = list(range(len(versions)))
    for turn, idx in enumerate(order + order[::-1]):
        v = versions[idx]
        ms = cuda_ms(lambda: v.run(kernel, ins, k_pad, n_valid, mcode))
        emit({"version": v.name, "kernel": kernel, "shape": label, "B": B, "N": n_valid, "D": D,
              "k": k, "k_pad": k_pad, "metric": metric, "turn": turn, "ms": ms,
              "library_ms": cuda_ms(lib), "bound_ms": b_ms, "bound_by": b_by,
              "share_of_bound": b_ms / ms, **(extra or {})})


def split_shape(splits, kernel, label, ins, k, metric, n_valid) -> None:
    """One version's variants at one shape: ms of each (two turns), the
    parts, and the clock shares."""
    k_pad = k_pad_of(k)
    mcode = 0 if metric == "l2" else 1
    ms = {}
    names = list(splits["variants"])
    for name in names + names[::-1]:
        v = splits["variants"][name]
        t = cuda_ms(lambda: v.run(kernel, ins, k_pad, n_valid, mcode))
        ms[name] = min(ms.get(name, t), t)
    parts = {p: ms[a] - (ms[b] if b else 0.0) for p, a, b in PARTS}
    ck = splits["clocks"]
    path = ck.plan(ins["q"].shape[0], n_valid, k_pad, kernel == "K2")[2]
    ck.clocks(kernel, k_pad, path)  # reset
    ck.run(kernel, ins, k_pad, n_valid, mcode)
    torch.cuda.synchronize()
    total, prod, flush, end = ck.clocks(kernel, k_pad, path)
    shares = {"products": prod / max(total, 1), "flushes": flush / max(total, 1),
              "chunk_end": end / max(total, 1)}
    emit({"version": splits["name"], "kernel": kernel, "split": label, "variant_ms": ms,
          "parts_ms": parts, "consumer_clock_shares": shares,
          "flushes_ms_est": parts["filter_bounds_flushes"] * (
              flush / max(total - prod - end, 1))})


def main() -> int:
    if not torch.cuda.is_available():
        print("scan_time: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    args = sys.argv[1:]
    out_path = OUT / "scan_time.json"
    if args[:1] == ["--out"]:
        out_path, args = Path(args[1]), args[2:]
    split, sweep, k3 = "--split" in args, "--sweep" in args, "--k3" in args
    quick = "--quick" in args
    dirs = [Path(a).resolve() for a in args if not a.startswith("--")] or [_build.CSRC]
    OUT.mkdir(parents=True, exist_ok=True)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    emit({"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda})
    names = ["new" if d == _build.CSRC.resolve() else "parent" if is_parent(d) else f"v{i}"
             for i, d in enumerate(dirs)]
    if len(set(names)) < len(names):
        names = [f"v{i}" for i in range(len(dirs))]
    # every build at once: each version's sources, its split variants, K3's
    jobs = {}
    preps = [prepare(i, d) for i, d in enumerate(dirs)]
    for i, csrc in enumerate(preps):
        for s in SOURCES:
            jobs[(names[i], s, "full")] = build_job(csrc, s, f"v{i}_{Path(s).stem}_full")
            if split and i == 0:
                for var, mask in VARIANTS.items():
                    if var != "full":
                        jobs[(names[i], s, var)] = build_job(
                            csrc, s, f"v{i}_{Path(s).stem}_{var}", (f"-DREPRO_SCAN_OFF={mask}",))
                jobs[(names[i], s, "clocks")] = build_job(
                    csrc, s, f"v{i}_{Path(s).stem}_clocks", ("-DREPRO_SCAN_CLOCKS",))
        if k3:
            for s in ("flash_attention.cu", "flash_attention_bwd.cu"):
                jobs[(names[i], s, "k3")] = build_job(csrc, s, f"v{i}_{Path(s).stem}")
    built = run_builds(jobs)
    libs = {(names.index(n), s, var): lib for (n, s, var), lib in built.items()}
    ok = [i for i in range(len(dirs)) if all((i, s, "full") in libs for s in SOURCES)]
    versions = [Version(names[i], dirs[i], {s: libs[(i, s, "full")] for s in SOURCES})
                for i in ok]
    gen = torch.Generator(device="cuda").manual_seed(0)
    failed = len(versions) < len(dirs)
    for kernel, label, B, N, D, k, metric, nv in (QUICK if quick else SHAPES):
        ins = make_inputs(kernel, B, N, D, metric, gen)
        nv = nv or N
        good = [v for v in versions
                if check(v, kernel, label, ins, k, metric, nv, strict=False)["ok"]]
        failed |= len(good) < len(versions)
        if quick:
            continue
        time_shape(good, kernel, label, ins, k, metric, nv)
        if split and label in SPLIT_SHAPES:
            for i, d in enumerate(dirs[:1]):
                if not all((i, s, var) in libs for s in SOURCES for var in [*VARIANTS, "clocks"]):
                    continue
                var = {name: Version(f"{names[i]} {name}", d,
                                     {s: libs[(i, s, name)] for s in SOURCES})
                       for name in VARIANTS}
                ck = Version(f"{names[i]} clocks", d, {s: libs[(i, s, "clocks")] for s in SOURCES})
                split_shape({"name": names[i], "variants": var, "clocks": ck}, kernel, label,
                            ins, k, metric, nv)
        del ins
        torch.cuda.empty_cache()
    if sweep and not quick:
        for label, N, D, k, metric, nv in (("paper partition", 124_606, 128, 60, "l2", None),
                                           ("retrieval corpus", 1_000_448, 50, 100, "ip",
                                            1_000_000)):
            full = (make_inputs("K1", max(SWEEP_B), N, D, metric, gen) if metric == "l2" else
                    {"q": torch.randn(max(SWEEP_B), D, generator=gen, device="cuda"),
                     "x": torch.randn(N, D, generator=gen, device="cuda")})
            x = full["x"]
            # the version under test also on its batched scan at every B, for
            # the crossover with its small-batch scan
            twin = [Version(f"{versions[0].name} batched", dirs[ok[0]],
                            {s: libs[(ok[0], s, "full")] for s in SOURCES}, force_path=0)
                    ] if versions and not versions[0].parent else []
            for B in SWEEP_B:
                ins = {"q": full["q"][:B].contiguous(), "x": x}
                swept = versions + (twin if B <= k1_mod.B_SMALL else [])
                good = [v for v in swept if check(v, "K1", f"sweep {label} B={B}", ins, k,
                                                  metric, nv or N, strict=False)["ok"]]
                time_shape(good, "K1", f"sweep {label}", ins, k, metric, nv or N,
                           {"sweep_B": B, "path": {v.name: v.plan(B, nv or N, k_pad_of(k), False)[2]
                                                   for v in good}})
            del x, full
            torch.cuda.empty_cache()
    out_path.write_text("\n".join(json.dumps(r) for r in RECORDS) + "\n")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
