#!/usr/bin/env python3
"""Time versions of K3's source against each other on one CUDA card, at the
bfloat16 shapes of the port's main paths and the float32 shapes of the LM
serving cell.

    python3 tools/k3_time.py [--out PATH] [SOURCE.cu ...]

Each SOURCE is a version of ``src/repro_torch/kernels/csrc/flash_attention.cu``
(default: that file alone), compiled with the package's nvcc flags and its
local headers taken from its own directory first (a parent commit's
``csrc/`` unpacked beside it), into ``build/k3_time/``.  A source that
splits into the package's translation units (``_build.UNITS``, the
``REPRO_K3_*`` defines) is built as those units in parallel and linked, as
the package builds it; one that does not is one unit.  The build's seconds,
``-Xptxas -v`` report (registers, spills, and the warnings that wgmmas were
serialized) and the counts of ``HGMMA`` (wgmma) and ``HMMA`` (mma.sync)
instructions in its SASS (``cuobjdump``) are printed.

Each is then checked against the plain version (``ref.flash_attention_ref``):
float32 at a few shapes within 3e-5; bfloat16 at every instance (D = Dv in
16-128 and (192, 128)), causal and not, at the tile edges, within 3e-2 and
``ref.bf16_agreement`` <= 1 against the plain version in float32, with
the lse output bit-equal to the output without.  The first SOURCE must
hold these; the others are reported with their error (a diagnostic build
may drop part of the work).

Each is timed with CUDA events at every shape of ``SHAPES`` (causal), in
turns (first to last, then last to first), beside PyTorch's
``scaled_dot_product_attention`` on the same inputs (a yardstick, never
called by the port), with the shape's bound: operations (BH S^2 (D + Dv)
causal flops over 989 TFLOP/s bf16 or 165 TFLOP/s float32-grade) or bytes
over 3.35 TB/s, the larger.  Prints one JSON line per record (a check
only when it fails, and each source's worst) and writes every record to
PATH (default ``build/k3_time/k3_time.json``).
"""

import ctypes
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
from chip_smoke import PEAK_BF16_FLOPS, PEAK_F32_FLOPS, PEAK_HBM_BYTES, cuda_ms  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels.flash_attention import INSTANCES  # noqa: E402

OUT = ROOT / "build" / "k3_time"
BF16, F32 = torch.bfloat16, torch.float32
# (BH, S, D, Dv, dtype, what runs it): K3's shapes on the main paths
SHAPES = [
    (60, 4096, 64, 64, BF16, "6b / 6f training layer"),
    (15, 32768, 64, 64, BF16, "phase 5 prefill_32k"),
    (16, 32768, 128, 128, BF16, "6c GQA prefill_32k"),
    (16, 32768, 192, 128, BF16, "6c MLA prefill_32k"),
    (64, 4096, 128, 128, BF16, "6d GQA step"),
    (64, 4096, 192, 128, BF16, "6d MLA step"),
    (16, 4096, 128, 128, BF16, "6c engine bucket"),
    (16, 2048, 128, 128, BF16, "6c engine bucket"),
    (16, 4096, 192, 128, BF16, "6c MLA engine bucket"),
    (16, 2048, 192, 128, BF16, "6c MLA engine bucket"),
    (15, 4096, 64, 64, F32, "serving's 4096 bucket"),
    (15, 2048, 64, 64, F32, "serving's 2048 bucket"),
]
# float32 (BH, S, D, causal, q scale): tile edges, the serving shape, and q
# scaled by 4 (a peaky softmax, where the scores' rounding shows most)
CHECKS = [(1, 1, 16, True, 1.0), (7, 65, 32, False, 1.0), (7, 1000, 64, True, 1.0),
          (3, 1025, 128, False, 1.0), (15, 4096, 64, True, 1.0)] + [
    (7, 4097, D, causal, 4.0) for D in (16, 32, 64, 128) for causal in (True, False)]
# bfloat16 (BH, S, D, Dv, causal): every instance at the edges of the
# 64-row tiles and past 4096
BF16_CHECKS = [(3, S, D, Dv, causal) for D, Dv in INSTANCES
               for S in (1, 63, 64, 65, 127, 129, 1000, 4097) for causal in (True, False)]
F32_TOL, BF16_TOL = 3e-5, 3e-2
K3_UNITS = _build.UNITS["flash_attention.cu"]
RECORDS = []


def emit(rec: dict, show: bool = True) -> None:
    RECORDS.append(rec)
    if show:
        print(json.dumps(rec), flush=True)


def build(i: int, source: Path):
    out = OUT / f"k3_{i}.so"
    text = source.read_text()
    units = K3_UNITS if all(d[2:] in text for u in K3_UNITS for d in u) else ((),)
    flags = [f for f in _build.NVCC_FLAGS if f != "-shared"]
    t0 = time.perf_counter()
    procs = [(subprocess.Popen(
        [_build._nvcc(), *flags, "-I", str(source.parent), "-I", str(_build.CSRC), *defines,
         "-c", "-o", str(OUT / f"k3_{i}_{u}.o"), str(source)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), OUT / f"k3_{i}_{u}.o")
        for u, defines in enumerate(units)]
    log = "".join(p.communicate()[0] for p, _ in procs)
    if any(p.returncode for p, _ in procs):
        raise RuntimeError(f"nvcc failed for {source}:\n{log}")
    link = subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, "-shared", "-o", str(out),
                           *(str(o) for _, o in procs)], capture_output=True, text=True)
    if link.returncode:
        raise RuntimeError(f"link failed for {source}:\n{link.stdout}{link.stderr}")
    seconds = time.perf_counter() - t0
    ptxas = [ln.strip()[:240] for ln in log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln
             or "C7515" in ln or "C7517" in ln or "C7508" in ln]
    counts = {}
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if Path(cuobjdump).exists():
        sass = subprocess.run([cuobjdump, "-sass", str(out)], capture_output=True,
                              text=True).stdout.splitlines()
        counts = {"sass_hgmma": sum("HGMMA" in ln for ln in sass),
                  "sass_hmma": sum("HMMA" in ln for ln in sass),
                  "sass_tf32_hmma": sum("HMMA" in ln and "TF32" in ln for ln in sass)}
    emit({"source": str(source), "units": len(units), "build_s": seconds,
          "serialized_wgmma_warnings": sum("C7515" in ln for ln in ptxas),
          "spills": sorted({ln for ln in ptxas if "spill" in ln and not ln.startswith("0 bytes")}),
          **counts})
    emit({"source": str(source), "ptxas": ptxas}, show=False)
    fn = ctypes.CDLL(str(out)).repro_flash_attention
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(q, k, v, causal=True, with_lse=False):
        BH, S, D = q.shape
        o = q.new_empty((BH, S, v.shape[-1]))
        lse = torch.empty((BH, S), device=q.device) if with_lse else None
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                None if lse is None else lse.data_ptr(), BH, S, D, v.shape[-1],
                int(q.dtype == BF16), int(causal), 1.0 / D ** 0.5,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{source}: cudaError {rc}")
        return (o, lse) if with_lse else o

    return run


def check(i: int, source: Path, run, gen) -> None:
    worst = {"max_abs_err_f32": 0.0, "max_abs_err_bf16": 0.0, "max_bf16_agreement": 0.0,
             "failed": 0}
    for BH, S, D, causal, q_scale in CHECKS:
        q, k, v = (torch.randn(BH, S, D, generator=gen, device="cuda") for _ in range(3))
        q = q * q_scale
        err = float((run(q, k, v, causal) - ref.flash_attention_ref(q, k, v, causal=causal))
                    .abs().max())
        ok = err <= F32_TOL
        worst["max_abs_err_f32"] = max(worst["max_abs_err_f32"], err)
        worst["failed"] += not ok
        emit({"source": str(source), "check": [BH, S, D, causal, q_scale], "dtype": "float32",
              "max_abs_err": err, "within_limit": ok}, show=not ok)
        if i == 0 and not ok:
            raise AssertionError(f"{source} at {(BH, S, D, causal, q_scale)}: max abs err {err}")
    for BH, S, D, Dv, causal in BF16_CHECKS:
        q, k = (torch.randn(BH, S, D, generator=gen, device="cuda").to(BF16) for _ in range(2))
        v = torch.randn(BH, S, Dv, generator=gen, device="cuda").to(BF16)
        out, _ = run(q, k, v, causal, with_lse=True)
        bare = run(q, k, v, causal)
        want = ref.flash_attention_ref(q.float(), k.float(), v.float(), causal=causal)
        err = float((out.float() - want).abs().max())
        agree = ref.bf16_agreement(out, want)
        same = bool(torch.equal(out, bare))
        ok = err <= BF16_TOL and agree <= 1.0 and same
        worst["max_abs_err_bf16"] = max(worst["max_abs_err_bf16"], err)
        worst["max_bf16_agreement"] = max(worst["max_bf16_agreement"], agree)
        worst["failed"] += not ok
        emit({"source": str(source), "check": [BH, S, D, Dv, causal], "dtype": "bfloat16",
              "max_abs_err": err, "bf16_agreement": agree, "lse_output_bit_equal": same,
              "within_limit": ok}, show=not ok)
        if i == 0 and not ok:
            raise AssertionError(f"{source} at {(BH, S, D, Dv, causal)}: max abs err {err}, "
                                 f"agreement {agree}, bit-equal with lse {same}")
    emit({"source": str(source), "checks": len(CHECKS) + len(BF16_CHECKS), **worst})


def main() -> int:
    if not torch.cuda.is_available():
        print("k3_time: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    args = sys.argv[1:]
    out_path = OUT / "k3_time.json"
    if args[:1] == ["--out"]:
        out_path, args = Path(args[1]), args[2:]
    sources = [Path(s).resolve() for s in args] or [_build.CSRC / "flash_attention.cu"]
    OUT.mkdir(parents=True, exist_ok=True)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    emit({"card": smi})
    kernels = [build(i, s) for i, s in enumerate(sources)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    for i, (source, run) in enumerate(zip(sources, kernels)):
        gen.manual_seed(0)  # every source sees the same inputs
        check(i, source, run, gen)
    order = list(range(len(sources)))
    for BH, S, D, Dv, dtype, what in SHAPES:
        q, k = (torch.randn(BH, S, D, generator=gen, device="cuda").to(dtype) for _ in range(2))
        v = torch.randn(BH, S, Dv, generator=gen, device="cuda").to(dtype)
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
            q[None], k[None], v[None], is_causal=True, scale=D ** -0.5)
        flops = 1.0 * BH * S * S * (D + Dv)  # q k^T and p v over the causal half
        t_ops = flops / (PEAK_BF16_FLOPS if dtype == BF16 else PEAK_F32_FLOPS)
        t_bytes = 2.0 * BH * S * (D + Dv) * q.element_size() / PEAK_HBM_BYTES
        iters = 5 if S > 8192 else 20
        for turn, idx in enumerate(order + order[::-1]):
            ms = cuda_ms(lambda: kernels[idx](q, k, v), iters=iters)
            emit({"source": str(sources[idx]), "shape": [BH, S, D, Dv], "dtype": str(dtype),
                  "what": what, "turn": turn, "ms": ms,
                  "sdpa_ms": cuda_ms(sdpa, iters=iters), "bound_ms": 1e3 * max(t_ops, t_bytes),
                  "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                  "share_of_bound": 1e3 * max(t_ops, t_bytes) / ms})
    out_path.write_text("\n".join(json.dumps(r) for r in RECORDS) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
