#!/usr/bin/env python3
"""Where the MoE / MLA LMs' serving time goes on one CUDA card: ``chip_smoke.py``
phase 6c's models (deepseek-moe-16b, deepseek-v2-lite-16b at full width and
depth under ``serving_config(..., "prefill")``: bf16, q_chunk 1024) under
``torch.profiler``.

    python3 tools/moe_prefill_profile.py [--arch deepseek-moe-16b] [--S 32768]
                                         [--decode-steps 5] [--top 15]

For each model, after a warm-up, it profiles one prefill of S seeded tokens
into a bf16 cache (B = 1), then ``--decode-steps`` decode steps of 4 slots
against a 4,096-position cache at per-row offsets (dropless MoE; MLA's
absorbed form), and prints, as JSON: the wall time (host clock after a
synchronize), the device time summed over kernels by group (K3, cuBLAS
GEMMs — attention projections, the expert and shared-expert products and
the LM head —, gathers and scatters, sorts, copies, reductions and
elementwise kernels), the kernel launches, the device busy share (kernel
time over wall time, an upper bound since kernels may overlap), the top
kernels by device time, and the card's name and power limit.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config, serving_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

GROUPS = (  # (group, substrings of the kernel name), first match wins
    ("K3", ("flash_fwd",)),
    ("gemm", ("gemm", "Gemm", "cutlass", "xmma", "nvjet")),
    ("sort", ("sort", "Sort", "radix", "Radix")),
    ("gather / scatter", ("index", "Index", "gather", "scatter", "Scatter")),
    ("copy", ("copy", "Memcpy", "Memset", "cat")),
    ("reduce", ("reduce", "Reduce", "softmax", "topk", "scan", "Scan")),
)


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "elementwise and other"


def profiled(fn, reps: int, top: int) -> dict:
    """``fn`` run ``reps`` times under the profiler: per-run wall ms,
    device ms by group, launches, busy share, top kernels."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / reps
    kernels = {}  # name -> (device us over the window, calls)
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        kernels[e.key] = (e.self_cuda_time_total if us is None else us, e.count)
    by_group = {}
    for name, (us, _) in kernels.items():
        g = group_of(name)
        by_group[g] = by_group.get(g, 0.0) + us / 1e3 / reps
    busy_ms = sum(by_group.values())
    top_k = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:top]
    return {"wall_ms": wall_ms, "device_ms": busy_ms, "busy_share": busy_ms / wall_ms,
            "launches": sum(c for _, c in kernels.values()) / reps,
            "device_ms_by_group": dict(sorted(by_group.items(), key=lambda kv: -kv[1])),
            "top_kernels": [{"name": n[:100], "ms": us / 1e3 / reps, "calls": c / reps}
                            for n, (us, c) in top_k]}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", action="append",
                   help="deepseek-moe-16b and/or deepseek-v2-lite-16b (default both)")
    p.add_argument("--S", type=int, default=32_768)
    p.add_argument("--decode-steps", type=int, default=5)
    p.add_argument("--top", type=int, default=15)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("moe_prefill_profile: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    _build.build_all(("flash_attention.cu",))
    for arch in args.arch or ("deepseek-moe-16b", "deepseek-v2-lite-16b"):
        torch.cuda.empty_cache()
        cfg = serving_config(get_config(arch), "prefill")
        params = tf.init(cfg, seed=0)
        gen = torch.Generator(device="cuda").manual_seed(1)
        tokens = torch.randint(0, cfg.vocab, (1, args.S), generator=gen, device="cuda")
        cache = tf.make_cache(cfg, 1, args.S, dtype=torch.bfloat16)
        prefill = lambda: tf.apply(params, cfg, tokens, cache=cache, cache_offset=0)[0][:, -1]
        tf.apply(params, cfg, tokens[:, :2048], cache=cache, cache_offset=0)  # warm-up
        pre = profiled(prefill, 1, args.top)
        del cache
        torch.cuda.empty_cache()
        dcache = tf.make_cache(cfg, 4, 4096, dtype=torch.bfloat16)
        off = torch.tensor([2000, 1500, 3000, 1200], device="cuda")
        tok = torch.randint(0, cfg.vocab, (4, 1), generator=gen, device="cuda")
        decode = lambda: tf.apply(params, cfg, tok, cache=dcache, cache_offset=off)[0][:, -1]
        decode()  # warm-up
        dec = profiled(decode, args.decode_steps, args.top)
        print(json.dumps({"card": smi, "arch": arch, "S": args.S, "prefill": pre,
                          "decode_slots": 4, "decode_steps": args.decode_steps,
                          "decode_step": dec}, indent=1), flush=True)
        del params, dcache
    return 0


if __name__ == "__main__":
    sys.exit(main())
