#!/usr/bin/env python3
"""Where a training step's time goes on one CUDA card: ``chip_smoke.py``
phase 6b's step (smollm-360m at full width and depth under
``training_config``: bf16, remat, q_chunk 1024; S 4096, 16 sequences in 4
microbatches) under ``torch.profiler``; with ``--arch deepseek-moe-16b
--layers 4`` (or deepseek-v2-lite-16b), phase 6d's step.

    python3 tools/train_profile.py [--arch smollm-360m] [--layers 0] [--steps 2] [--top 25]

After two warm-up steps it profiles ``--steps`` steps and prints, as JSON:
the step's wall time (CUDA events), the device time summed over kernels
by group (K3 forward, K3-bwd, cuBLAS GEMMs, gathers, scatters and sorts,
reductions and elementwise kernels, copies), the device busy share of the profiled window (kernel
time over wall time, an upper bound since kernels may overlap), the top
kernels by device time, and the card's name and power limit.
"""

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config, training_config  # noqa: E402
from repro_torch.data.synthetic import token_batch  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.train.optimizer import AdamWConfig, init_state  # noqa: E402
from repro_torch.train.train_step import lm_loss_fn, make_train_step  # noqa: E402

GROUPS = (  # (group, substrings of the kernel name), first match wins
    ("K3-bwd", ("bwd_dkdv", "bwd_dq", "delta_kernel", "rows_kernel")),
    ("K3", ("flash_fwd",)),
    ("gemm", ("gemm", "Gemm", "cutlass", "sm90_xmma", "nvjet")),
    ("copy", ("copy", "Memcpy", "Memset")),
    ("gather / scatter / sort", ("index", "gather", "scatter", "Sort", "sort", "radix")),
    ("reduce", ("reduce", "Reduce", "softmax", "logsumexp")),
)


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "elementwise and other"


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="smollm-360m")
    p.add_argument("--layers", type=int, default=0, help="cut the depth to this (0: the arch's)")
    p.add_argument("--steps", type=int, default=2)
    p.add_argument("--top", type=int, default=25)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("train_profile: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    _build.build_all(("flash_attention.cu", "flash_attention_bwd.cu"))
    cfg = training_config(get_config(args.arch))
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    params = tf.init(cfg, seed=0)
    state = init_state(params)
    step = make_train_step(lm_loss_fn(cfg), AdamWConfig(lr=1e-3, warmup_steps=2,
                                                        total_steps=10), num_micro=4)
    toks, labels = token_batch(16, 4096, cfg.vocab, seed=0)
    batch = {"tokens": torch.from_numpy(toks).cuda(), "labels": torch.from_numpy(labels).cuda()}
    for _ in range(2):
        params, state, m = step(params, state, batch)
        float(m["loss"])
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            params, state, m = step(params, state, batch)
            float(m["loss"])
        wall_s = time.perf_counter() - t0
    kernels = {}  # name -> (device us over the window, calls)
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        kernels[e.key] = (e.self_cuda_time_total if us is None else us, e.count)
    by_group = {}
    for name, (us, _) in kernels.items():
        g = group_of(name)
        by_group[g] = by_group.get(g, 0.0) + us / 1e3 / args.steps
    busy_ms = sum(by_group.values())
    step_ms = 1e3 * wall_s / args.steps
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:args.top]
    print(json.dumps({
        "card": smi, "arch": args.arch, "n_layers": cfg.n_layers, "steps": args.steps,
        "step_ms_profiled": step_ms,
        "device_ms_per_step": busy_ms, "busy_share": busy_ms / step_ms,
        "device_ms_per_step_by_group": dict(sorted(by_group.items(), key=lambda kv: -kv[1])),
        "top_kernels": [{"name": n[:120], "ms_per_step": us / 1e3 / args.steps,
                         "calls_per_step": c / args.steps} for n, (us, c) in top],
    }, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
