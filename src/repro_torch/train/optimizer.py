"""AdamW and its schedule: the port of ``repro.train.optimizer``.

The reference's arithmetic with torch ops on the tensors of a param tree
(``models.transformer.param_tree``; ``torch.optim.AdamW`` orders its
decay differently): float32 moments, bias correction at ``step + 1``,
clipping by the global norm, the update computed in float32 and cast back
to each param's dtype.  The update runs in place under ``torch.no_grad``:
params and moments are overwritten, and only ``step`` is a new tensor.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from repro_torch.common.tree import flatten, leaves, unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    schedule: str = "cosine"  # 'cosine' | 'constant'


def tree_of(params):
    """The param tree of a ``Transformer`` (``param_tree``); a tree as is."""
    if isinstance(params, torch.nn.Module):
        from repro_torch.models.transformer import param_tree

        return param_tree(params)
    return params


def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warm-up, then cosine decay to ``min_lr_ratio`` (or constant),
    in float32 as the reference computes it."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        return cfg.lr * warm
    t = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                    0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def init_state(params) -> dict:
    """{"step": int32 0, "m": zeros, "v": zeros}, the moments float32 and
    shaped like the param tree, on the params' devices."""
    tree = tree_of(params)
    zeros = lambda: unflatten(tree, [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                                     for p in leaves(tree)])
    dev = leaves(tree)[0].device
    return {"step": torch.zeros((), dtype=torch.int32, device=dev), "m": zeros(), "v": zeros()}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32))) for x in leaves(tree)))


def reference_ndim(name: str, leaf) -> int:
    """A leaf's rank in the reference's pytree, where every block leaf is
    stacked over the layers: one more than here for ``blocks/...``."""
    return leaf.ndim + 1 if name.startswith("blocks/") else leaf.ndim


def default_decay_mask(name: str, leaf) -> bool:
    """The reference's default, ``leaf.ndim >= 2`` on its own shapes: every
    block leaf decays (norm scales and biases included, being (L, d) there),
    ``embed`` and ``lm_head`` decay, ``final_norm`` does not."""
    return reference_ndim(name, leaf) >= 2


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state: dict,
                 decay_mask: Optional[Callable] = None):
    """One AdamW step, in place.  Returns (params, new_state, metrics).

    params: a ``Transformer`` or a param tree; grads: a tree of the same
    structure (any float dtype).  decay_mask(name, leaf) -> bool, name the
    leaf's path (``blocks/3/attn/wq``); default :func:`default_decay_mask`.
    metrics: ``grad_norm`` and ``lr``, 0-d float32 tensors.
    """
    tree = tree_of(params)
    step = state["step"] + 1
    lr = lr_schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
             if cfg.grad_clip > 0 else 1.0)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1.0 - b1 ** stepf
    bc2 = 1.0 - b2 ** stepf
    decay_mask = decay_mask or default_decay_mask
    named = flatten(tree)
    g_l, m_l, v_l = leaves(grads), leaves(state["m"]), leaves(state["v"])
    if not len(named) == len(g_l) == len(m_l) == len(v_l):
        raise ValueError(f"adamw_update: {len(named)} params, {len(g_l)} grads, "
                         f"{len(m_l)} / {len(v_l)} moments")
    for (name, p), g, m, v in zip(named, g_l, m_l, v_l):
        g = g.to(torch.float32) * scale
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * g * g)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if decay_mask(name, p):
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - lr * delta).to(p.dtype))
    new_state = {"step": step, "m": state["m"], "v": state["v"]}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
