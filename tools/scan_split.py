#!/usr/bin/env python3
"""Split the time of the SIMT scan kernels K1 and K2 into scoring, in-kernel
top-k and chunk merge, on one CUDA card.

    python3 tools/scan_split.py PATH_TO_CHECKOUT

PATH_TO_CHECKOUT is a checkout whose ``src/repro_torch/kernels/csrc`` holds
the SIMT design (the one whose blocks stage a score tile and call
``topk::admit_tile`` per tile).  Its K1 and K2 sources are built three ways
into ``build/scan_split/``: as they are, with the chunk-merge launch
compiled out, and with both the merge and ``admit_tile`` compiled out.  Each
build is timed (CUDA events) at the shapes PERF.md times the kernels at, on
seeded random data; full - no_merge is the merge, no_merge - score_only the
in-kernel top-k.  Prints one JSON line per shape and writes them to
``build/scan_split/scan_split.json``.
"""

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

TREE = Path(sys.argv[1]).resolve()
sys.path.insert(0, str(TREE / "src"))
from repro_torch.kernels import _build  # noqa: E402  (the checkout's own flags)
from repro_torch.kernels.distance_topk import split_plan  # noqa: E402

CSRC = TREE / "src" / "repro_torch" / "kernels" / "csrc"
OUT = Path("build/scan_split")
ADMIT = "topk::admit_tile<Smem, K, TQ>(sm, tile_start, w, lane, thresh, cnt);"
MERGE = "return topk::launch_merge<K>(part_d, part_i, out_d, out_i, B, nsplit, stream);"
VARIANTS = {"full": [], "no_merge": ["-DSKIP_MERGE"], "score_only": ["-DSKIP_MERGE", "-DSKIP_ADMIT"]}
SOURCES = {"distance_topk.cu": "repro_distance_topk", "distance_topk_q8.cu": "repro_distance_topk_q8"}


def build() -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    for h in CSRC.glob("*.cuh"):
        shutil.copy(h, OUT / h.name)
    for s in SOURCES:
        t = (CSRC / s).read_text()
        if ADMIT not in t or MERGE not in t:
            raise SystemExit(f"{s}: not the SIMT design (no admit_tile / launch_merge call)")
        t = t.replace(ADMIT, f"\n#ifndef SKIP_ADMIT\n{ADMIT}\n#endif\n")
        t = t.replace(MERGE, f"\n#ifdef SKIP_MERGE\nreturn cudaSuccess;\n#else\n{MERGE}\n#endif\n")
        (OUT / s).write_text(t)
    procs = {}
    for s in SOURCES:
        for v, flags in VARIANTS.items():
            so = OUT / f"{Path(s).stem}_{v}.so"
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(so), str(OUT / s)]
            procs[s, v] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for key, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(log)
        fn = getattr(ctypes.CDLL(str(so)), SOURCES[key[0]])
        n_ptr = 6 if key[0] == "distance_topk.cu" else 8
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        libs[key] = fn
    return libs


def cuda_ms(fn, iters=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def main() -> None:
    libs = build()
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.Generator(device="cuda").manual_seed(0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    shapes = [("K1", "paper partition", 440, 124_606, 128, 128),
              ("K1", "deployment partition", 345, 156_773, 512, 128),
              ("K1", "paper k_pad 512", 440, 124_606, 128, 512),
              ("K1", "ground truth", 4096, 1_000_000, 128, 128),
              ("K2", "paper q8 partition", 440, 124_606, 128, 128),
              ("K2", "deployment q8 partition", 345, 156_773, 512, 128),
              ("K2", "paper q8 k_pad 512", 440, 124_606, 128, 512)]
    rows = []
    for kernel, label, B, N, D, kp in shapes:
        if kernel == "K1":
            src = "distance_topk.cu"
            ins = [torch.randn(B, D, generator=g, device="cuda"),
                   torch.randn(N, D, generator=g, device="cuda")]
            dw = D
        else:
            src = "distance_topk_q8.cu"
            ins = [torch.randint(-127, 128, (B, D), generator=g, device="cuda", dtype=torch.int8),
                   torch.randint(-127, 128, (N, D), generator=g, device="cuda", dtype=torch.int8),
                   torch.rand(B, generator=g, device="cuda") * 0.01,
                   torch.rand(N, generator=g, device="cuda") * 100]
            dw = D // 4
        ns, ch = split_plan(B, N, sm, kp)
        out_d = torch.empty(B, kp, device="cuda")
        out_i = torch.empty(B, kp, dtype=torch.int32, device="cuda")
        part_d = torch.empty(B, ns, kp, device="cuda")
        part_i = torch.empty(B, ns, kp, dtype=torch.int32, device="cuda")
        st = torch.cuda.current_stream().cuda_stream
        rec = {"kernel": kernel, "shape": label, "B": B, "N": N, "D": D, "k_pad": kp,
               "nsplit": ns, "chunk": ch}
        for v in VARIANTS:
            fn = libs[src, v]
            args = [t.data_ptr() for t in ins] + [part_d.data_ptr(), part_i.data_ptr(),
                                                  out_d.data_ptr(), out_i.data_ptr(),
                                                  B, dw, N, kp, 0, ns, ch, st]
            if fn(*args) != 0:
                raise SystemExit(f"{src} {v}: launch failed")
            rec[v] = cuda_ms(lambda: fn(*args))
        rows.append(rec)
        print(json.dumps(rec), flush=True)
    with open(OUT / "scan_split.json", "w") as f:
        json.dump({"card": card, "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
