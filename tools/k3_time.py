#!/usr/bin/env python3
"""Time versions of K3's source against each other at the float32 shapes of
the LM serving cell, on one CUDA card.

    python3 tools/k3_time.py [SOURCE.cu ...]

Each SOURCE is a version of ``src/repro_torch/kernels/csrc/flash_attention.cu``
(default: that file alone).  Each is compiled with the package's nvcc flags,
its local headers taken from that ``csrc/``, into ``build/k3_time/``; the
compile's seconds, ``-Xptxas -v`` report and the count of TF32 ``HMMA``
instructions in its SASS (``cuobjdump``) are printed.  Each is then checked
against the plain version (``ref.flash_attention_ref``) at a few float32
shapes: the first SOURCE must hold 3e-5 there, the others are reported with
their error (a diagnostic build may drop part of the work).  Each is timed
with CUDA events at (15, 4096, 64) and (15, 2048, 64) causal float32, the
shapes of the serving cell's prefills, in turns (first to last, then last
to first) beside PyTorch's ``scaled_dot_product_attention`` on the same
inputs.  Prints one JSON line per record and writes them to
``build/k3_time/k3_time.json``.
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
from chip_smoke import cuda_ms  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402

OUT = ROOT / "build" / "k3_time"
SHAPES = [(15, 4096, 64), (15, 2048, 64)]
# (BH, S, D, causal, q scale): tile edges, the serving shape, and q scaled by
# 4 (a peaky softmax, where the scores' rounding shows most)
CHECKS = [(1, 1, 16, True, 1.0), (7, 65, 32, False, 1.0), (7, 1000, 64, True, 1.0),
          (3, 1025, 128, False, 1.0), (15, 4096, 64, True, 1.0)] + [
    (7, 4097, D, causal, 4.0) for D in (16, 32, 64, 128) for causal in (True, False)]
F32_TOL = 3e-5
RECORDS = []


def emit(rec: dict) -> None:
    RECORDS.append(rec)
    print(json.dumps(rec), flush=True)


def build(i: int, source: Path):
    out = OUT / f"k3_{i}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(out),
           str(source)]
    t0 = time.perf_counter()
    log = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if log.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n{log.stdout}{log.stderr}")
    ptxas = [ln.strip() for ln in (log.stdout + log.stderr).splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    hmma = None
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if Path(cuobjdump).exists():
        sass = subprocess.run([cuobjdump, "-sass", str(out)], capture_output=True, text=True)
        hmma = sum("HMMA" in ln and "TF32" in ln for ln in sass.stdout.splitlines())
    emit({"source": str(source), "build_s": seconds, "ptxas": ptxas, "sass_tf32_hmma": hmma})
    fn = ctypes.CDLL(str(out)).repro_flash_attention
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(q, k, v, causal=True):
        BH, S, D = q.shape
        o = torch.empty_like(q)
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), BH, S, D, 0,
                int(causal), 1.0 / D ** 0.5, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{source}: cudaError {rc}")
        return o

    return run


def main() -> int:
    if not torch.cuda.is_available():
        print("k3_time: no CUDA device", file=sys.stderr)
        return 1
    sources = [Path(s).resolve() for s in sys.argv[1:]] or [_build.CSRC / "flash_attention.cu"]
    OUT.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    emit({"card": smi})
    kernels = [build(i, s) for i, s in enumerate(sources)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    for i, (source, run) in enumerate(zip(sources, kernels)):
        gen.manual_seed(0)  # every source sees the same inputs
        for BH, S, D, causal, q_scale in CHECKS:
            q, k, v = (torch.randn(BH, S, D, generator=gen, device="cuda") for _ in range(3))
            q = q * q_scale
            err = float((run(q, k, v, causal) - ref.flash_attention_ref(q, k, v, causal=causal))
                        .abs().max())
            emit({"source": str(source), "check": [BH, S, D, causal, q_scale],
                  "max_abs_err": err, "within_limit": err <= F32_TOL})
            if i == 0 and not err <= F32_TOL:
                raise AssertionError(f"{source} at {(BH, S, D, causal, q_scale)}: max abs err "
                                     f"{err}")
    order = list(range(len(sources)))
    for BH, S, D in SHAPES:
        q, k, v = (torch.randn(BH, S, D, generator=gen, device="cuda") for _ in range(3))
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
            q[None], k[None], v[None], is_causal=True)
        for turn, idx in enumerate(order + order[::-1]):
            ms = cuda_ms(lambda: kernels[idx](q, k, v))
            emit({"source": str(sources[idx]), "shape": [BH, S, D], "turn": turn, "ms": ms,
                  "sdpa_ms": cuda_ms(sdpa)})
    (OUT / "k3_time.json").write_text("\n".join(json.dumps(r) for r in RECORDS) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
