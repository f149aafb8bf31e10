#!/usr/bin/env python3
"""Time versions of K3-bwd's source against each other on one CUDA card.

    python3 tools/k3_bwd_time.py [--f32] [--profile] [SOURCE.cu ...]

Each SOURCE is a version of ``src/repro_torch/kernels/csrc/flash_attention_bwd.cu``
(default: that file alone), compiled with the package's nvcc flags, its
local headers taken from its own directory first and then from the
package's ``csrc/``, into ``build/k3_bwd_time/``; the compile's seconds and
its ``-Xptxas -v`` report (registers, spills, and ptxas's notes on
serialised wgmma) are printed.  Each is then checked against the plain
backward (``ref.flash_attention_bwd_ref`` in float32 on the same inputs)
at a few bf16 shapes, tile edges included: ``ref.bf16_agreement`` <= 1 on
dq, dk and dv, and two launches bit-equal (a SOURCE whose file name has
``diag`` in it is a diagnostic build that may drop part of the work: its
checks are reported, not enforced).  Each is timed with CUDA events
in turns (first to last, then last to first) at the training step's layer
(60, 4096, 64) and at one codeqwen1.5-7b sequence's (32, 4096, 128), both
causal bf16, beside PyTorch's SDPA backward on the same inputs
((forward + backward) - forward, a yardstick only) and the plain version.
``--f32`` does the same for the float32 path: each source's float32 output
is first checked at a few shapes (tile edges, q x 4 and v x 8 inputs
included) against the plain backward, max |kernel - plain| / max |plain|
<= 1e-4 on dq, dk and dv, and two launches bit-equal; then every source
is timed in turns at both shapes in float32 beside SDPA's float32
backward.  ``--profile`` splits one launch's device time by kernel under
``torch.profiler``.  Every source gets a (BH, S rounded up to 128, 2)
float32 scratch, the largest any version has taken.  Prints one JSON
line per record and writes them to ``build/k3_bwd_time/k3_bwd_time.json``.
"""

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
from chip_smoke import PEAK_BF16_FLOPS, PEAK_F32_FLOPS, PEAK_HBM_BYTES, cuda_ms  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels.flash_attention import _DTYPE, flash_attention_cuda  # noqa: E402

OUT = ROOT / "build" / "k3_bwd_time"
SHAPES = [(60, 4096, 64), (32, 4096, 128)]
CHECKS = [(1, 1, 64, True), (2, 127, 64, True), (2, 129, 64, False), (3, 1000, 16, True),
          (3, 1000, 32, False), (2, 33, 128, True), (3, 1025, 128, False), (4, 4096, 64, True)]
# float32: (BH, S, D, causal, q scale, v scale); a peaky softmax (q x 4) and
# large values (v x 8), as phase 2c gives K3's float32 forward
CHECKS_F32 = [(1, 1, 64, True, 1, 1), (2, 127, 64, True, 1, 1), (2, 129, 64, False, 4, 1),
              (3, 1000, 16, True, 1, 8), (3, 1000, 32, False, 4, 1), (2, 33, 128, True, 1, 8),
              (3, 1025, 128, False, 4, 1), (4, 4096, 64, True, 4, 1)]
F32_TOL = 1e-4
RECORDS = []


def emit(rec: dict) -> None:
    RECORDS.append(rec)
    print(json.dumps(rec), flush=True)


def build(i: int, source: Path):
    out = OUT / f"k3_bwd_{i}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(source.parent), "-I", str(_build.CSRC),
           "-o", str(out), str(source)]
    t0 = time.perf_counter()
    log = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if log.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n{log.stdout}{log.stderr}")
    lines = (log.stdout + log.stderr).splitlines()
    ptxas = [ln.strip() for ln in lines if any(
        w in ln for w in ("Compiling entry", "registers", "spill", "Performance", "arning"))]
    emit({"source": str(source), "build_s": seconds, "ptxas": ptxas})
    fn = ctypes.CDLL(str(out)).repro_flash_attention_bwd
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(q, k, v, o, do, lse, causal=True):
        BH, S, D = q.shape
        scale = 1.0 / D ** 0.5
        grads = [torch.empty_like(q) for _ in range(3)]
        scratch = torch.empty(BH * (-(-S // 128) * 128) * 2, device=q.device)
        rc = fn(*(t.data_ptr() for t in (q, k, v, o, do, lse, scratch, *grads)), BH, S, D,
                _DTYPE[q.dtype], int(causal), scale, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{source}: cudaError {rc}")
        return grads

    return run


def inputs(gen, BH, S, D, dtype, causal=True, q_scale=1, v_scale=1):
    q, k, v, do = (torch.randn(BH, S, D, generator=gen, device="cuda").to(dtype)
                   for _ in range(4))
    q, v = q * q_scale, v * v_scale
    out, lse = flash_attention_cuda(q, k, v, causal=causal, scale=D ** -0.5, with_lse=True)
    return q, k, v, out, do, lse


def sdpa_bwd_ms(q, k, v, do) -> float:
    qs, ks, vs = (t[None].detach().clone().requires_grad_() for t in (q, k, v))
    f = lambda: torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    fwd = cuda_ms(lambda: f().detach(), iters=10, warmup=2)
    both = cuda_ms(lambda: torch.autograd.grad(f(), (qs, ks, vs), do[None]), iters=10, warmup=2)
    return both - fwd


def bound(BH, S, D, dtype) -> dict:
    flops = 2.5 * 4.0 * BH * S * S * D / 2  # the gradient: 2.5x the forward, causal half
    nbytes = 8.0 * BH * S * D * (2 if dtype == torch.bfloat16 else 4) + 4.0 * BH * S
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / PEAK_HBM_BYTES
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes", "flops": flops}


def profile(run, args) -> dict:
    """Device ms by kernel name of one launch (after a warm one)."""
    run(*args)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        run(*args)
        torch.cuda.synchronize()
    return {e.key[:60]: e.device_time_total / 1e3 for e in prof.key_averages()
            if e.device_time_total > 0}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("sources", nargs="*")
    p.add_argument("--f32", action="store_true")
    p.add_argument("--profile", action="store_true")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("k3_bwd_time: no CUDA device", file=sys.stderr)
        return 1
    sources = ([Path(s).resolve() for s in args.sources]
               or [_build.CSRC / "flash_attention_bwd.cu"])
    OUT.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    emit({"card": smi})
    _build.build_all(("flash_attention.cu",))  # K3's forward gives lse
    kernels = [build(i, s) for i, s in enumerate(sources)]
    gen = torch.Generator(device="cuda")
    f = lambda t: t.float()
    for source, run in zip(sources, kernels):
        gen.manual_seed(0)  # every source sees the same inputs
        for BH, S, D, causal in CHECKS:
            q, k, v, o, do, lse = inputs(gen, BH, S, D, torch.bfloat16, causal)
            got = run(q, k, v, o, do, lse, causal)
            want = ref.flash_attention_bwd_ref(f(q), f(k), f(v), f(o), f(do), lse, causal=causal,
                                               scale=D ** -0.5)
            agree = max(ref.bf16_agreement(a, w) for a, w in zip(got, want))
            same = all(torch.equal(a, b) for a, b in zip(got, run(q, k, v, o, do, lse, causal)))
            emit({"source": str(source), "check": [BH, S, D, causal], "bf16_agreement": agree,
                  "deterministic": same})
            if not (agree <= 1.0 and same) and "diag" not in source.name:
                raise AssertionError(f"{source} at {(BH, S, D, causal)}: agreement {agree}, "
                                     f"deterministic {same}")
        for BH, S, D, causal, qs, vs in CHECKS_F32 if args.f32 else ():
            q, k, v, o, do, lse = inputs(gen, BH, S, D, torch.float32, causal, qs, vs)
            got = run(q, k, v, o, do, lse, causal)
            want = ref.flash_attention_bwd_ref(q, k, v, o, do, lse, causal=causal,
                                               scale=D ** -0.5)
            # with one key dq and dk are zero: both sides hold rounding
            # noise, held at the limit against dv's scale instead
            scales = [float(w.abs().max()) for w in want]
            if S == 1:
                scales[:2] = scales[2:] * 2
            rel = max(float((a - w).abs().max()) / max(sc, 1e-30)
                      for a, w, sc in zip(got, want, scales))
            same = all(torch.equal(a, b) for a, b in zip(got, run(q, k, v, o, do, lse, causal)))
            emit({"source": str(source), "check_f32": [BH, S, D, causal, qs, vs],
                  "rel_err": rel, "deterministic": same})
            if not (rel <= F32_TOL and same) and "diag" not in source.name:
                raise AssertionError(f"{source} at {(BH, S, D, causal, qs, vs)} float32: "
                                     f"rel. err {rel}, deterministic {same}")
    order = list(range(len(sources)))
    shapes = [(s, torch.bfloat16) for s in SHAPES] + ([(s, torch.float32) for s in SHAPES]
                                                      if args.f32 else [])
    for (BH, S, D), dtype in shapes:
        gen.manual_seed(1)
        q, k, v, o, do, lse = inputs(gen, BH, S, D, dtype)
        rec = {"shape": [BH, S, D], "dtype": str(dtype), "causal": True, **bound(BH, S, D, dtype),
               "library_ms": sdpa_bwd_ms(q, k, v, do)}
        for turn, idx in enumerate(order + order[::-1]):
            rec.setdefault("ms", []).append(
                [str(sources[idx]), cuda_ms(lambda: kernels[idx](q, k, v, o, do, lse),
                                            iters=10, warmup=2)])
        rec["library_ms_after"] = sdpa_bwd_ms(q, k, v, do)
        plain = lambda: ref.flash_attention_bwd_ref(q, k, v, o, do, lse, causal=True,
                                                    scale=D ** -0.5)
        rec["plain_ms"] = cuda_ms(plain, iters=2, warmup=1)
        if args.profile:
            rec["by_kernel"] = {str(s): profile(kern, (q, k, v, o, do, lse))
                                for s, kern in zip(sources, kernels)}
        emit(rec)
    (OUT / "k3_bwd_time.json").write_text("\n".join(json.dumps(r) for r in RECORDS) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
