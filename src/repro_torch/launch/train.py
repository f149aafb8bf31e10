"""Training driver: ``python -m repro_torch.launch.train --arch smollm-360m ...``.

The port of ``repro.launch.train``, with its flags and ``--device``: data
pipeline -> train step (K3 and K3-bwd in every layer's attention on the
card) -> checkpoint manager (+ resume), with step-time stats.  The arch's
reduced config is the default so the driver runs anywhere in seconds;
``--full`` uses the published config.  ``--device`` defaults to ``cuda``;
``--device cpu`` runs the plain PyTorch path.

``--resume`` restores the latest checkpoint under ``--ckpt-dir`` and
continues with the step after the saved one, so an interrupted run ends
with the uninterrupted run's numbers.  (The reference resumes at the saved
step itself and so repeats that step's batch once.)
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="smollm-360m")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--num-micro", type=int, default=1)
    p.add_argument("--full", action="store_true", help="published config")
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def train(args) -> dict:
    """Run the loop of ``args``; returns {"losses": {step: loss}, "loss",
    "start_step", "step_ms"}."""
    from repro_torch.common.tree import leaves
    from repro_torch.common.utils import resolve_device
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.data.pipeline import ShardedBatchIterator
    from repro_torch.data.synthetic import token_batch
    from repro_torch.models import transformer as tf
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.optimizer import AdamWConfig, init_state
    from repro_torch.train.train_step import lm_loss_fn, make_train_step

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full:
        cfg = reduced_config(cfg)
    print(f"arch={args.arch} params={cfg.num_params():,} device={dev}")

    params = tf.init(cfg, seed=args.seed, device=dev)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                          total_steps=args.steps)
    opt_state = init_state(params)
    step_fn = make_train_step(lm_loss_fn(cfg), opt_cfg, num_micro=args.num_micro)

    start_step = 0
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, keep_last_n=2, async_write=True)
        if args.resume:
            restored = mgr.restore_latest({"p": tf.param_tree(params), "o": opt_state})
            if restored:
                saved, tree, extra = restored
                with torch.no_grad():
                    for p, a in zip(leaves(tf.param_tree(params)), leaves(tree["p"])):
                        p.copy_(a)
                opt_state = tree["o"]
                start_step = saved + 1
                print(f"resumed from step {saved} (loss {extra.get('loss')})")

    def batch_fn(seed, step):
        toks, labels = token_batch(args.batch, args.seq, cfg.vocab,
                                   seed=seed * 1_000_003 + step)
        return {"tokens": toks, "labels": labels}

    it = ShardedBatchIterator(batch_fn, seed=args.seed, start_step=start_step, device=dev)
    times, losses = [], {}
    loss = float("nan")
    try:
        for _ in range(start_step, args.steps):
            step, batch = next(it)
            t0 = time.perf_counter()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])  # waits for the step
            times.append(time.perf_counter() - t0)
            losses[step] = loss
            if step % args.log_every == 0:
                print(
                    f"step {step:5d} loss {loss:.4f} "
                    f"lr {float(metrics['lr']):.2e} "
                    f"gnorm {float(metrics['grad_norm']):.2f} "
                    f"{np.mean(times[-args.log_every:]) * 1e3:.0f} ms/step",
                    flush=True,
                )
            if mgr and step and step % args.ckpt_every == 0:
                mgr.save(step, {"p": tf.param_tree(params), "o": opt_state},
                         extra={"loss": loss})
    finally:
        it.close()
        if mgr:
            mgr.wait()
    print(f"done: final loss {loss:.4f}")
    return {"losses": losses, "loss": loss, "start_step": start_step,
            "step_ms": [1e3 * t for t in times]}


def main(argv=None):
    train(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
