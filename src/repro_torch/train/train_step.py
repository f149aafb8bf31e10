"""The train step: loss, grads, microbatch accumulation, AdamW update.

The port of ``repro.train.train_step``.  ``make_train_step`` returns
    (params, opt_state, batch) -> (params, opt_state, metrics)
with the reference's arithmetic: the loss's grads by autograd (for the LMs
K3 and K3-bwd in every layer's attention on the card, under ``torch.utils.
checkpoint`` where the config asks for remat), float32 accumulation over
microbatches, and the AdamW update in place (``train.optimizer``).  The LM
losses (dense GQA, and the MoE / MLA LMs with their load-balance loss), the
recsys losses and the DimeNet loss (one graph, or batched lanes with graph
or node targets) are ported.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.common.tree import leaves, unflatten
from repro_torch.train.optimizer import AdamWConfig, adamw_update, tree_of


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


def _softplus(x):
    """log(1 + e^x) = max(x, 0) + log1p(e^-|x|), as ``jax.nn.softplus``."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


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
    and ``labels`` (B, S), optional ``mask`` (B, S).  The loss is the
    token CE (with z-loss) plus ``aux``, the float32 sum of the MoE layers'
    Switch load-balance losses (0 for a dense model), as the reference's:
    grads reach the router through its softmax, the kept top-k gates and
    aux's mean router probabilities; aux is returned beside the loss."""
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
    """loss_fn(params, batch) for DimeNet (``models.dimenet``), with the
    reference's three batch layouts:

    * one graph, positions (n, 3): full-batch training on node targets y
      (n,), masked by ``node_mask`` where given;
    * batched lanes, positions (B, n, 3) (molecules, sampled subgraphs, halo
      partitions): ``apply_batched`` (the reference's ``vmap``), with graph
      targets y (B,) (mean squared error of each lane's sum) or node targets
      y (B, n) (masked by ``node_mask`` where given).

    Optional keys ``z``, ``features`` and ``node_mask``.  The batch moves to
    the params' device; aux is 0."""
    from repro_torch.models import dimenet as dn

    def loss_fn(params, batch):
        dev = leaves(params)[0].device
        b = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        kw = dict(positions=b["positions"], edge_index=b["edge_index"], t_in=b["t_in"],
                  t_out=b["t_out"], z=b.get("z"), node_feat=b.get("features"),
                  node_mask=b.get("node_mask"))
        y, mask = b["y"], b.get("node_mask")
        batched = b["positions"].ndim == 3
        if batched and y.ndim == 1:  # graph targets, one a lane
            _, graph_pred = dn.apply_batched(params, cfg, **kw)
            loss = torch.mean((graph_pred[:, 0] - y) ** 2)
        else:  # node targets, of one graph or of every lane
            node_pred, _ = (dn.apply_batched if batched else dn.apply)(params, cfg, **kw)
            se = (node_pred[..., 0] - y) ** 2
            if mask is None:
                loss = torch.mean(se)
            else:
                mask = mask.to(torch.float32)
                loss = torch.sum(se * mask) / torch.clamp(mask.sum(), min=1.0)
        return loss, torch.zeros((), dtype=torch.float32, device=dev)

    return loss_fn


def recsys_loss_fn(arch: str, cfg):
    """loss_fn(params, batch) for a recsys arch (``models.recsys``): BCE on
    ``label`` for AutoInt, DIN and xDeepFM; for SASRec, with ``neg_items``
    the paper's BCE on the positive next item and one sampled negative per
    position, else (small vocab) cross-entropy over every item.  SASRec's
    ``next_items`` are -1 where padded: masked out, and clipped to 0 before
    the lookup as the reference clips them.  The batch moves to the params'
    device."""
    from repro_torch.models import recsys as rs

    def loss_fn(params, batch):
        dev = leaves(params)[0].device
        b = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        if arch == "autoint":
            loss = bce_with_logits(rs.autoint_apply(params, cfg, b["sparse_ids"]), b["label"])
        elif arch == "xdeepfm":
            loss = bce_with_logits(rs.xdeepfm_apply(params, cfg, b["sparse_ids"]), b["label"])
        elif arch == "din":
            logits = rs.din_apply(params, cfg, history=b["history"], hist_len=b["hist_len"],
                                  target_item=b["target_item"], context_ids=b["context_ids"])
            loss = bce_with_logits(logits, b["label"])
        elif arch == "sasrec":
            labels = b["next_items"]
            mask = (labels >= 0).to(torch.float32)
            if "neg_items" in b:
                pos, neg = rs.sasrec_sampled_logits(params, cfg, b["item_seq"],
                                                    labels.clamp(min=0), b["neg_items"])
                ls = _softplus(-pos.to(torch.float32)) + _softplus(neg.to(torch.float32))
                loss = (ls * mask).sum() / torch.clamp(mask.sum(), min=1.0)
            else:  # small-vocab evaluation path
                logits = rs.sasrec_apply(params, cfg, b["item_seq"])
                loss = cross_entropy_loss(logits, labels.clamp(min=0), mask=mask)
        else:
            raise ValueError(f"recsys_loss_fn: unknown arch {arch!r}")
        return loss, torch.zeros((), dtype=torch.float32, device=dev)

    return loss_fn
