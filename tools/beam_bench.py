#!/usr/bin/env python3
"""Time the HNSW beam and its pieces on one CUDA card at the paper cell's
shapes, on a random graph (no build needed).

    python3 tools/beam_bench.py

The flat stack holds 8 partitions of 131,072 padded rows (d 128, M 16, 2M
32 neighbours, 4 padding upper levels), as ``chip_smoke.py`` phase 3c's
does; 3,368 lanes walk it with ef 100 and max_iters 132, topk 60.  Prints
milliseconds (CUDA events, or a synchronized host clock for whole beams)
of: one batched distance block for fp32 l2 and q8 l2 rows, the row gathers
alone, the q8 dot as an elementwise product + sum and as a batched matmul,
the beam's stable merge sort of (lanes, ef + 2M) and two composite-key
alternatives, the dedup compare, and one whole ``beam_search_flat`` call in
fp32 and in q8, with the card's name.
"""

import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import hnsw  # noqa: E402


def cuda_ms(fn, iters: int = 50) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("beam_bench: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    P, n_pad, d, m0, M, T, ef = 8, 131072, 128, 32, 16, 3368, 100
    N = P * n_pad
    vec = torch.randn(N, d, generator=g, device=dev)
    codes = torch.randint(-127, 128, (N, d), generator=g, device=dev, dtype=torch.int8)
    norms2 = torch.rand(N, generator=g, device=dev)
    adj0 = torch.randint(0, n_pad - 1, (N, m0), generator=g, device=dev, dtype=torch.int32)
    upper = torch.full((4, N, M), -1, dtype=torch.int32, device=dev)
    q = torch.randn(T, d, generator=g, device=dev)
    off = torch.randint(0, P, (T,), generator=g, device=dev) * n_pad
    rows = torch.randint(0, N, (T, m0), generator=g, device=dev)
    res = {}
    f32 = hnsw._make_row_dist({"vectors": vec}, "l2")
    q8 = hnsw._make_row_dist({"vectors": codes, "norms2": norms2}, "l2")
    res["dist_fp32_l2"] = cuda_ms(lambda: f32(q, rows))
    res["dist_q8_l2"] = cuda_ms(lambda: q8(q, rows))
    res["gather_fp32_rows"] = cuda_ms(lambda: vec[rows])
    res["gather_int8_rows"] = cuda_ms(lambda: codes[rows])
    res["q8_dot_mul_sum"] = cuda_ms(
        lambda: codes[rows].to(torch.float32).mul_(q[:, None, :]).sum(-1))
    res["q8_dot_bmm"] = cuda_ms(lambda: torch.bmm(codes[rows].to(torch.float32), q[:, :, None]))
    all_d = torch.rand(T, ef + m0, generator=g, device=dev)
    all_d[:, ef - 10:] = float("inf")
    pos = torch.arange(ef + m0, device=dev)
    # non-negative floats order as their bit patterns: (bits, position) is
    # a unique key with the stable sort's order
    key = lambda: (all_d.view(torch.int32).to(torch.int64) << 16) | pos
    res["merge_sort_stable"] = cuda_ms(lambda: torch.sort(all_d, dim=1, stable=True))
    res["merge_sort_composite_key"] = cuda_ms(lambda: torch.sort(key(), dim=1))
    res["merge_topk_composite_key"] = cuda_ms(lambda: torch.topk(key(), ef, dim=1, largest=False))
    ids = torch.randint(0, N, (T, ef), generator=g, device=dev)
    nb = torch.randint(0, N, (T, m0), generator=g, device=dev)
    res["dedup_compare"] = cuda_ms(lambda: (nb[:, :, None] == ids[:, None, :]).any(2))
    ep = off + torch.randint(0, n_pad, (T,), generator=g, device=dev)
    valid = torch.ones(T, dtype=torch.bool, device=dev)
    for name, arrs in (("fp32", {"vectors": vec, "adj0": adj0, "upper_adj": upper}),
                       ("q8", {"vectors": codes, "norms2": norms2, "adj0": adj0,
                               "upper_adj": upper})):
        run = lambda arrs=arrs: hnsw.beam_search_flat(arrs, q, ep, off, valid, k=60, ef=ef,
                                                      max_iters=132, metric="l2")
        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        res[f"beam_{name}"] = 1e3 * (time.perf_counter() - t0) / 3
    for k, v in res.items():
        print(f"{k:26s} {v:.4f} ms")
    print(torch.cuda.get_device_name(0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
