#!/usr/bin/env python3
"""Do two recsys train steps from one state give the same bits on one CUDA
card?  ``chip_smoke.py`` phase 3g's training cell for each arch (AutoInt,
DIN, SASRec, xDeepFM at full published width, bf16 params, float32
moments, one seeded batch of 8,192): a warm-up step, then two steps run
three times from one saved state.  Prints, as JSON, each arch's tensors
whose bits differ from the first run's, the largest param gap and the
losses, beside the card's name and power limit.

    python3 tools/recsys_repeat_bits.py

Runs on any checkout of the repo (the parent of a change too).
"""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as c  # noqa: E402
from repro_torch.common.tree import flatten, leaves, unflatten  # noqa: E402
from repro_torch.configs import RECSYS_ARCH_IDS, get_config  # noqa: E402
from repro_torch.models import recsys as rs  # noqa: E402
from repro_torch.train.optimizer import AdamWConfig, init_state  # noqa: E402
from repro_torch.train.train_step import make_train_step, recsys_loss_fn  # noqa: E402


def clone(tree):
    return unflatten(tree, [t.detach().clone() for t in leaves(tree)])


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    for a_i, arch in enumerate(RECSYS_ARCH_IDS):
        cfg = get_config(arch)
        cfg16 = dataclasses.replace(cfg, param_dtype="bfloat16", compute_dtype="bfloat16")
        params = rs.init(cfg, seed=a_i, device="cuda")
        p16 = unflatten(params, [t.to(torch.bfloat16) for t in leaves(params)])
        del params
        batch = c.to_card(c.recsys_batch(arch, cfg, 8192, seed=3, for_loss=True))
        step = make_train_step(recsys_loss_fn(arch, cfg16),
                               AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=30))
        p16, state, _ = step(p16, init_state(p16), batch)
        runs = []
        for _ in range(3):
            p, s = clone(p16), clone(state)
            for _ in range(2):
                p, s, m = step(p, s, batch)
            runs.append((leaves(p), leaves(s["m"]), float(m["loss"])))
        names = [n for n, _ in flatten(p16)]
        rec = {"arch": arch, "losses": [r[2] for r in runs]}
        for r in (1, 2):
            rec[f"run{r}_params_differ"] = [n for n, a, b in zip(names, runs[0][0], runs[r][0])
                                            if not torch.equal(a, b)]
            rec[f"run{r}_m_differ"] = [n for n, a, b in zip(names, runs[0][1], runs[r][1])
                                       if not torch.equal(a, b)]
            rec[f"run{r}_max_param_gap"] = max(float((a.float() - b.float()).abs().max())
                                               for a, b in zip(runs[0][0], runs[r][0]))
        print(json.dumps(rec), flush=True)
        del p16, state, runs, p, s, batch
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
