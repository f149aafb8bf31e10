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

import contextlib
from typing import Callable, Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.common.tree import leaves, unflatten
from repro_torch.distributed.sharding_rules import NULL_CTX
from repro_torch.train.optimizer import AdamWConfig, adamw_update, tree_of


def cross_entropy_loss(logits, labels, *, z_loss: float = 0.0, mask=None):
    """Token CE with optional z-loss; logits (..., V) upcast to float32,
    labels integer (..., ); mask (...) weights the tokens.  A label
    outside [0, V) has gold logit 0, as the reference's iota select gives:
    its row's CE is the log-sum-exp, and its gold logit gets no gradient."""
    return _mean_ce(_token_ce(logits, labels, z_loss), mask)


def _mean_ce(ce, mask=None):
    """The tokens' mean CE, weighted by ``mask`` where given."""
    if mask is not None:
        mask = mask.to(torch.float32)
        return (ce * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return ce.mean()


def _token_ce(logits, labels, z_loss: float):
    """Each token's CE (+ z-loss), float32."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    labels = labels.to(torch.long)
    V = logits.shape[-1]
    gold = torch.gather(logits, -1, labels.clamp(0, V - 1)[..., None])[..., 0]
    gold = torch.where((labels >= 0) & (labels < V), gold, 0.0)
    ce = lse - gold
    if z_loss:
        ce = ce + z_loss * lse**2
    return ce


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


def _placed_as(g, p):
    """A DTensor grad redistributed to its param's placements: the grad
    sync of a sharded step (a partial sum all-reduced, or reduce-scattered
    onto the param's shards); a plain grad as is."""
    if isinstance(g, DTensor) and list(g.placements) != list(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _microbatch(v, i: int, num_micro: int):
    """Microbatch ``i`` of ``num_micro`` along dim 0: rows ``[i per, (i + 1)
    per)`` of a tensor; of a DTensor sharded over dim 0, those rows of each
    rank's own shard (no gather)."""
    if isinstance(v, DTensor):
        loc = v.to_local()
        if loc.shape[0] % num_micro:
            raise ValueError(f"a rank's {loc.shape[0]} rows do not split into {num_micro} "
                             "microbatches (each takes whole rows of every rank's shard)")
        per = loc.shape[0] // num_micro
        shape = (v.shape[0] // num_micro, *v.shape[1:])
        stride = [1] * len(shape)
        for d in range(len(shape) - 2, -1, -1):
            stride[d] = stride[d + 1] * shape[d + 1]
        return DTensor.from_local(loc[i * per:(i + 1) * per], v.device_mesh, v.placements,
                                  shape=shape, stride=tuple(stride))
    per = v.shape[0] // num_micro
    return v[i * per:(i + 1) * per]


def _accumulate_grads(loss_fn, params, batch: dict, num_micro: int,
                      micro_limit: Optional[int] = None):
    """Returns (mean loss, mean grads in the params' leaf order, mean aux).

    ``num_micro <= 1``: one backward, grads in the params' dtype.  Else
    the batch's leading dim splits into ``num_micro`` microbatches, each
    microbatch's grads are taken with ``torch.autograd.grad`` and added
    into float32 buffers (``.grad`` would accumulate in the param dtype),
    and the sums are scaled by 1 / num_micro, as the reference's scan does.
    The params are made to require grad.  ``micro_limit`` runs only the
    first microbatches (the dry run traces one and scales its count).
    """
    with _replicating(params):
        return _accumulate(loss_fn, params, batch, num_micro, micro_limit)


def _replicating(params):
    """A sharded step's context: DTensor ops take the plain tensors they
    meet (positions, masks, the lr) as replicated."""
    if isinstance(leaves(tree_of(params))[0], DTensor):
        from repro_torch.distributed.sharding_rules import implicit_replication

        return implicit_replication()
    return contextlib.nullcontext()


def _accumulate(loss_fn, params, batch, num_micro, micro_limit):
    leaf_list = leaves(tree_of(params))
    for p in leaf_list:
        p.requires_grad_(True)
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    if num_micro <= 1:
        loss, grads, aux = _grads(loss_fn, params, batch, leaf_list)
        return loss.detach(), [_placed_as(g, p) for g, p in zip(grads, leaf_list)], aux.detach()
    n = next(iter(batch.values())).shape[0]
    if n % num_micro:
        raise ValueError(f"batch of {n} does not split into {num_micro} microbatches")
    per = n // num_micro
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           if not isinstance(p, DTensor) else torch.zeros_like(p, dtype=torch.float32)
           for p in leaf_list]
    loss_acc = aux_acc = 0.0
    for i in range(num_micro if micro_limit is None else min(micro_limit, num_micro)):
        mb = {k: _microbatch(v, i, num_micro) for k, v in batch.items()}
        loss, grads, aux = _grads(loss_fn, params, mb, leaf_list)
        for a, g, p in zip(acc, grads, leaf_list):
            a.add_(_placed_as(g, p).to(torch.float32))
        del grads
        loss_acc = loss_acc + loss.detach().to(torch.float32)
        aux_acc = aux_acc + aux.detach()
    inv = 1.0 / num_micro
    return loss_acc * inv, [a.mul_(inv) for a in acc], aux_acc * inv


def make_train_step(loss_fn: Callable, opt_cfg: AdamWConfig, *, num_micro: int = 1,
                    decay_mask: Optional[Callable] = None, micro_limit: Optional[int] = None):
    """Generic: loss_fn(params, batch) -> (loss, aux scalar tensor).

    The step updates params and the moments in place and returns
    (params, opt_state, metrics) with metrics ``loss``, ``aux_loss``,
    ``grad_norm`` and ``lr`` as 0-d tensors (read them when needed: each
    read waits for the step).

    Params that are DTensors (a cell of ``configs.families``) make a sharded
    step: the batch is a DTensor too, each microbatch takes its rows from
    every rank's own shard, each grad is redistributed to its param's
    placements (the grad sync), and AdamW runs on the shards."""

    def train_step(params, opt_state, batch):
        with _replicating(params):
            loss, grads, aux = _accumulate_grads(loss_fn, params, batch, num_micro,
                                                 micro_limit)
            grads = unflatten(tree_of(params), grads)
            params, opt_state, metrics = adamw_update(opt_cfg, params, grads, opt_state,
                                                      decay_mask)
        return params, opt_state, dict(metrics, loss=loss, aux_loss=aux)

    return train_step


# ---------------------------------------------------------------------------
# family-specific losses
# ---------------------------------------------------------------------------


def lm_loss_fn(cfg, ctx=NULL_CTX, z_loss: float = 1e-4):
    """loss_fn(params, batch) for a ``Transformer``: batch ``tokens`` (B, S)
    and ``labels`` (B, S), optional ``mask`` (B, S).  The loss is the
    token CE (with z-loss) plus ``aux``, the float32 sum of the MoE layers'
    Switch load-balance losses (0 for a dense model), as the reference's:
    grads reach the router through its softmax, the kept top-k gates and
    aux's mean router probabilities; aux is returned beside the loss.  On
    a mesh (``ctx``) the params and batch are DTensors
    (``families.LMArch.build_cell``), and so are the loss and aux."""
    from repro_torch.models import transformer as tf

    def loss_fn(params, batch):
        if ctx.mesh is not None:
            return _lm_loss_sharded(tf, params, cfg, batch, ctx, z_loss)
        logits, _, aux = tf.forward(params, cfg, batch["tokens"])
        dev = logits.device
        mask = batch.get("mask")
        ce = cross_entropy_loss(logits, torch.as_tensor(batch["labels"]).to(dev), z_loss=z_loss,
                                mask=None if mask is None else torch.as_tensor(mask).to(dev))
        return ce + aux, torch.as_tensor(aux, dtype=torch.float32, device=dev)

    return loss_fn


def _lm_loss_sharded(tf, params, cfg, batch, ctx, z_loss):
    from repro_torch.distributed.sharding_rules import implicit_replication

    logits, _, aux = tf.forward(params, cfg, batch["tokens"], ctx=ctx)
    ce = _token_ce_sharded(logits, batch["labels"], z_loss)
    with implicit_replication():
        return _mean_ce(ce, batch.get("mask")) + aux, aux


def _token_ce_sharded(logits, labels, z_loss: float):
    """:func:`cross_entropy_loss`'s per-token CE (with z-loss) of DTensor
    logits (B, S, V) whose vocab dim may be sharded, without gathering it:
    under ``local_map`` each rank takes its vocab shard's max (all-reduced,
    no gradient), its sum of exponentials and its share of the gold logits
    (labels outside its rows read 0), summed over the vocab axes with
    ``sharding_rules.psum``.  Returns (B, S) float32, sharded as the
    logits' batch."""
    import torch.distributed as dist
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.distributed.sharding_rules import psum, shard_start

    mesh = logits.device_mesh
    names = tuple(mesh.mesh_dim_names)
    V = logits.shape[-1]
    v_axes = [a for a, p in zip(names, logits.placements)
              if p == Shard(2) and mesh.size(names.index(a)) > 1]
    l_pl = [Shard(2) if a in v_axes else p if p == Shard(0) else Replicate()
            for a, p in zip(names, logits.placements)]
    b_pl = [Shard(0) if p == Shard(0) else Replicate() for p in l_pl]

    def local(lg, lab):
        if not v_axes:  # the vocab whole on this rank: one device's arithmetic
            return _token_ce(lg, lab, z_loss)
        lg = lg.to(torch.float32)
        v0 = shard_start(mesh, v_axes, V)
        with torch.no_grad():
            m = lg.max(dim=-1).values
            for a in v_axes:
                dist.all_reduce(m, op=dist.ReduceOp.MAX, group=mesh.get_group(a))
        lse = m + torch.log(psum(torch.exp(lg - m[..., None]).sum(-1), mesh, v_axes))
        rel = lab.long() - v0
        mine = (rel >= 0) & (rel < lg.shape[-1]) & (lab >= 0) & (lab < V)
        gold = torch.gather(lg, -1, rel.clamp(0, lg.shape[-1] - 1)[..., None])[..., 0]
        gold = psum(torch.where(mine, gold, 0.0), mesh, v_axes)
        ce = lse - gold
        return ce + z_loss * lse**2 if z_loss else ce

    grad_pl = [Shard(2) if a in v_axes else Shard(0) if p == Shard(0) else Partial()
               for a, p in zip(names, l_pl)]
    fn = local_map(local, out_placements=b_pl, in_placements=(l_pl, b_pl),
                   in_grad_placements=(grad_pl, b_pl), device_mesh=mesh,
                   redistribute_inputs=True)
    return fn(logits, labels)


def dimenet_loss_fn(cfg, ctx=NULL_CTX):
    """loss_fn(params, batch) for DimeNet (``models.dimenet``), with the
    reference's three batch layouts:

    * one graph, positions (n, 3): full-batch training on node targets y
      (n,), masked by ``node_mask`` where given;
    * batched lanes, positions (B, n, 3) (molecules, sampled subgraphs, halo
      partitions): ``apply_batched`` (the reference's ``vmap``), with graph
      targets y (B,) (mean squared error of each lane's sum) or node targets
      y (B, n) (masked by ``node_mask`` where given).

    Optional keys ``z``, ``features`` and ``node_mask``.  The batch moves to
    the params' device; aux is 0.  On a mesh (``ctx``; DTensor params,
    replicated, and batch) each rank runs its own lanes
    (:func:`_dimenet_loss_lanes`)."""
    from repro_torch.models import dimenet as dn

    def loss_fn(params, batch):
        if ctx.mesh is not None:
            return _dimenet_loss_lanes(dn, params, cfg, batch, ctx)
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


def _dimenet_terms(dn, params, cfg, b):
    """(sum of squared errors, their count) of one rank's lanes (or of one
    graph), float32: the loss is their quotient."""
    kw = dict(positions=b["positions"], edge_index=b["edge_index"], t_in=b["t_in"],
              t_out=b["t_out"], z=b.get("z"), node_feat=b.get("features"),
              node_mask=b.get("node_mask"))
    y, mask = b["y"], b.get("node_mask")
    batched = b["positions"].ndim == 3
    if batched and y.ndim == 1:  # graph targets, one a lane
        _, graph_pred = dn.apply_batched(params, cfg, **kw)
        se = ((graph_pred[:, 0] - y) ** 2).to(torch.float32)
        return se.sum(), torch.tensor(float(se.numel()), device=se.device)
    node_pred, _ = (dn.apply_batched if batched else dn.apply)(params, cfg, **kw)
    se = ((node_pred[..., 0] - y) ** 2).to(torch.float32)
    if mask is None:
        return se.sum(), torch.tensor(float(se.numel()), device=se.device)
    mask = mask.to(torch.float32)
    return torch.sum(se * mask), mask.sum()


def _dimenet_loss_lanes(dn, params, cfg, batch, ctx):
    """DimeNet's loss on a mesh: the reference's partition-parallel
    ``lane_loss`` under ``local_map``.  The batch's lanes are sharded over
    some mesh axes (its dim 0; none for one replicated graph), the params
    replicated; each rank runs DimeNet on its own lanes and the squared
    errors' sum and count are all-reduced over the lane axes
    (``sharding_rules.psum``), so only the scalar loss crosses ranks.  Each
    rank's param grads are its lanes' share (partial sums over the lane
    axes, which the step's grad sync all-reduces)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.distributed.sharding_rules import psum

    mesh = ctx.mesh
    names = tuple(mesh.mesh_dim_names)
    keys = sorted(batch)
    lane_axes = [a for a, p in zip(names, batch["positions"].placements) if p == Shard(0)]
    b_pl = [Shard(0) if a in lane_axes else Replicate() for a in names]
    p_leaves = leaves(params)
    rep = [Replicate()] * len(names)
    p_grad = [Partial() if a in lane_axes else Replicate() for a in names]

    def local(*flat):
        p = unflatten(params, flat[:len(p_leaves)])
        s, c = _dimenet_terms(dn, p, cfg, dict(zip(keys, flat[len(p_leaves):])))
        s, c = psum(s, mesh, lane_axes), psum(c.detach(), mesh, lane_axes)
        return s / torch.clamp(c, min=1.0)

    n_p, n_b = len(p_leaves), len(keys)
    fn = local_map(local, out_placements=rep, in_placements=(rep,) * n_p + (b_pl,) * n_b,
                   in_grad_placements=(p_grad,) * n_p + (b_pl,) * n_b, device_mesh=mesh,
                   redistribute_inputs=True)
    loss = fn(*p_leaves, *(batch[k] for k in keys))
    return loss, torch.zeros_like(loss)


def recsys_loss_fn(arch: str, cfg, ctx=NULL_CTX):
    """loss_fn(params, batch) for a recsys arch (``models.recsys``): BCE on
    ``label`` for AutoInt, DIN and xDeepFM; for SASRec, with ``neg_items``
    the paper's BCE on the positive next item and one sampled negative per
    position, else (small vocab) cross-entropy over every item.  SASRec's
    ``next_items`` are -1 where padded: masked out, and clipped to 0 before
    the lookup as the reference clips them.  The batch moves to the params'
    device.  On a mesh (``ctx``) the params are DTensors with the large
    tables sharded by row (``families.RecsysArch``) and the batch a DTensor
    sharded over the batch axes: :func:`_recsys_loss_sharded`."""
    from repro_torch.models import recsys as rs

    def loss_fn(params, batch):
        if ctx.mesh is not None:
            return _recsys_loss_sharded(rs, arch, cfg, params, batch, ctx)
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


def _recsys_terms(rs, arch, cfg, params, b, ctx):
    """(loss sum, count) of one rank's rows: the loss is their quotient."""
    if arch in ("autoint", "xdeepfm", "din"):
        if arch == "autoint":
            logits = rs.autoint_apply(params, cfg, b["sparse_ids"], ctx)
        elif arch == "xdeepfm":
            logits = rs.xdeepfm_apply(params, cfg, b["sparse_ids"], ctx)
        else:
            logits = rs.din_apply(params, cfg, history=b["history"], hist_len=b["hist_len"],
                                  target_item=b["target_item"], context_ids=b["context_ids"],
                                  ctx=ctx)
        n = logits.shape[0]
        return bce_with_logits(logits, b["label"]) * n, torch.tensor(float(n),
                                                                     device=logits.device)
    labels = b["next_items"]
    mask = (labels >= 0).to(torch.float32)
    pos, neg = rs.sasrec_sampled_logits(params, cfg, b["item_seq"], labels.clamp(min=0),
                                        b["neg_items"], ctx)
    ls = _softplus(-pos.to(torch.float32)) + _softplus(neg.to(torch.float32))
    return (ls * mask).sum(), mask.sum()


def _recsys_loss_sharded(rs, arch, cfg, params, batch, ctx):
    """A recsys loss on a mesh, under ``local_map``: each rank runs the model
    on its batch shard with its row shard of each sharded table (the
    lookups mask the ids outside its rows, gather the rest and sum over the
    table axes, ``models.recsys._lookup_rows``) and the dense layers whole;
    the loss's sum and count are all-reduced over the batch axes.  A
    rank's grads are its rows' share: partial sums over the batch axes,
    and the tables' over their row shards."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.distributed.sharding_rules import psum

    if arch == "sasrec" and "neg_items" not in batch:
        raise ValueError("the sharded SASRec loss takes the sampled (neg_items) objective")
    mesh = ctx.mesh
    names = tuple(mesh.mesh_dim_names)
    keys = sorted(batch)
    batch_axes = [a for a, p in zip(names, batch[keys[0]].placements) if p == Shard(0)]
    b_pl = [Shard(0) if a in batch_axes else Replicate() for a in names]
    p_leaves = leaves(params)
    p_pl = [list(p.placements) for p in p_leaves]
    p_grad = [[pl if pl == Shard(0) else Partial() if a in batch_axes else Replicate()
               for a, pl in zip(names, pls)] for pls in p_pl]
    n_rows = [p.shape[0] for p in p_leaves]

    def local(*flat):
        p_loc = flat[:len(p_leaves)]
        lctx = rs.row_shard_ctx(p_loc, p_pl, n_rows, mesh)
        b = dict(zip(keys, flat[len(p_leaves):]))
        s, c = _recsys_terms(rs, arch, cfg, unflatten(params, p_loc), b, lctx)
        s, c = psum(s, mesh, batch_axes), psum(c.detach(), mesh, batch_axes)
        return s / torch.clamp(c, min=1.0)

    rep = [Replicate()] * len(names)
    fn = local_map(local, out_placements=rep,
                   in_placements=tuple(p_pl) + (b_pl,) * len(keys),
                   in_grad_placements=tuple(p_grad) + (b_pl,) * len(keys),
                   device_mesh=mesh, redistribute_inputs=True)
    loss = fn(*p_leaves, *(batch[k] for k in keys))
    return loss, torch.zeros_like(loss)
