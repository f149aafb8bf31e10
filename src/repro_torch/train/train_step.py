"""The LM train step: loss, grads, microbatch accumulation, AdamW update.

The port of ``repro.train.train_step``.  ``make_train_step`` returns
    (params, opt_state, batch) -> (params, opt_state, metrics)
with the reference's arithmetic: the loss's grads by autograd (K3 and
K3-bwd in every layer's attention on the card, under ``torch.utils.
checkpoint`` where the config asks for remat), float32 accumulation over
microbatches, and the AdamW update in place (``train.optimizer``).
Only the LM family is ported: the DimeNet and recsys losses raise.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.common.tree import leaves, unflatten
from repro_torch.train.optimizer import AdamWConfig, adamw_update, tree_of

_ROADMAP_MODELS = ("the {} model is not ported (ROADMAP §1 item 10: the port runs the dense "
                   "GQA LMs only)")


def cross_entropy_loss(logits, labels, *, z_loss: float = 0.0, mask=None):
    """Token CE with optional z-loss; logits (..., V) upcast to float32,
    labels integer (..., ); mask (...) weights the tokens.  A label
    outside [0, V) has gold logit 0, as the reference's iota select gives:
    its row's CE is the log-sum-exp, and its gold logit gets no gradient."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    labels = labels.to(torch.long)
    V = logits.shape[-1]
    gold = torch.gather(logits, -1, labels.clamp(0, V - 1)[..., None])[..., 0]
    gold = torch.where((labels >= 0) & (labels < V), gold, 0.0)
    ce = lse - gold
    if z_loss:
        ce = ce + z_loss * lse**2
    if mask is not None:
        mask = mask.to(torch.float32)
        return (ce * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return ce.mean()


def bce_with_logits(logits, labels):
    logits = logits.to(torch.float32)
    return torch.mean(torch.clamp(logits, min=0) - logits * labels
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def _grads(loss_fn, params, batch, leaf_list):
    loss, aux = loss_fn(params, batch)
    return loss, torch.autograd.grad(loss, leaf_list), aux


def _accumulate_grads(loss_fn, params, batch: dict, num_micro: int):
    """Returns (mean loss, mean grads in the params' leaf order, mean aux).

    ``num_micro <= 1``: one backward, grads in the params' dtype.  Else
    the batch's leading dim splits into ``num_micro`` microbatches, each
    microbatch's grads are taken with ``torch.autograd.grad`` and added
    into float32 buffers (``.grad`` would accumulate in the param dtype),
    and the sums are scaled by 1 / num_micro, as the reference's scan does.
    The params are made to require grad.
    """
    leaf_list = leaves(tree_of(params))
    for p in leaf_list:
        p.requires_grad_(True)
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    if num_micro <= 1:
        loss, grads, aux = _grads(loss_fn, params, batch, leaf_list)
        return loss.detach(), list(grads), aux.detach()
    n = next(iter(batch.values())).shape[0]
    if n % num_micro:
        raise ValueError(f"batch of {n} does not split into {num_micro} microbatches")
    per = n // num_micro
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaf_list]
    loss_acc = aux_acc = 0.0
    for i in range(num_micro):
        mb = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
        loss, grads, aux = _grads(loss_fn, params, mb, leaf_list)
        for a, g in zip(acc, grads):
            a.add_(g.to(torch.float32))
        del grads
        loss_acc = loss_acc + loss.detach().to(torch.float32)
        aux_acc = aux_acc + aux.detach()
    inv = 1.0 / num_micro
    return loss_acc * inv, [a.mul_(inv) for a in acc], aux_acc * inv


def make_train_step(loss_fn: Callable, opt_cfg: AdamWConfig, *, num_micro: int = 1,
                    decay_mask: Optional[Callable] = None):
    """Generic: loss_fn(params, batch) -> (loss, aux scalar tensor).

    The step updates params and the moments in place and returns
    (params, opt_state, metrics) with metrics ``loss``, ``aux_loss``,
    ``grad_norm`` and ``lr`` as 0-d tensors (read them when needed: each
    read waits for the step)."""

    def train_step(params, opt_state, batch):
        loss, grads, aux = _accumulate_grads(loss_fn, params, batch, num_micro)
        grads = unflatten(tree_of(params), grads)
        params, opt_state, metrics = adamw_update(opt_cfg, params, grads, opt_state, decay_mask)
        return params, opt_state, dict(metrics, loss=loss, aux_loss=aux)

    return train_step


# ---------------------------------------------------------------------------
# family-specific losses
# ---------------------------------------------------------------------------


def lm_loss_fn(cfg, z_loss: float = 1e-4):
    """loss_fn(params, batch) for a ``Transformer``: batch ``tokens`` (B, S)
    and ``labels`` (B, S), optional ``mask`` (B, S)."""
    from repro_torch.models import transformer as tf

    def loss_fn(params, batch):
        logits, _, aux = tf.forward(params, cfg, batch["tokens"])
        dev = logits.device
        mask = batch.get("mask")
        ce = cross_entropy_loss(logits, torch.as_tensor(batch["labels"]).to(dev), z_loss=z_loss,
                                mask=None if mask is None else torch.as_tensor(mask).to(dev))
        return ce + aux, torch.as_tensor(aux, dtype=torch.float32, device=dev)

    return loss_fn


def dimenet_loss_fn(cfg):
    raise NotImplementedError(_ROADMAP_MODELS.format("DimeNet"))


def recsys_loss_fn(arch: str, cfg):
    raise NotImplementedError(_ROADMAP_MODELS.format(f"recsys ({arch})"))
