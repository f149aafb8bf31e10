"""DeepSeek-style Mixture-of-Experts FFN: the port of ``repro.models.moe``.

DeepSeekMoE (arXiv:2401.06066): many small routed experts (top-6 of 64 at
expert d_ff 1408) plus always-on shared experts; the first
``first_k_dense`` layers stay dense.  Routing runs in float32 whatever the
params' dtype (the router itself is float32): softmax -> top-k (optionally
renormalised), with the Switch load-balance auxiliary loss.

Dispatch is the reference's sort-based capacity scheme: a token's rank
within its expert comes from a stable argsort of the flattened (token, k)
assignments and a run-start max-scan, so the same copies drop as there.
Kept assignments go to slot ``e * C + rank`` of an (E, C, d) buffer, dropped
ones to a dump slot ``E * C`` that is sliced away, and empty slots gather a
zero row.  The expert FFNs are three batched products (``torch.bmm``: the
reference leaves them to XLA, outside any Pallas kernel).  The combine is
a gather of each (token, k)'s slot row summed over k, in ``ye``'s dtype:
the reference scatter-adds, and ``index_add_`` on the card is atomic, in an
order that changes from run to run; the gather sums in a fixed order.
Dispatch and combine are each other's gradient (``_Dispatch``,
``_Combine``): the dispatch's backward is the combine's gather and sum,
where autograd would scatter-add each token's k slot grads (atomically on
the card), and the combine's backward is the dispatch's gather, where
autograd's index backward would sort the slots and add every dropped
assignment's grad into the dump slot one after another.  So a step's grads
are the same bits every run.  Grads reach the router through its softmax,
the kept gates (``prob_buf``) and the load-balance loss's mean
probabilities; the top-1 fractions carry none, as in the reference.

On one device (``NULL_CTX``) ``moe_apply`` is the reference's local path
(``_moe_apply_local``).  On a mesh it is the reference's expert-parallel
schedule (``_moe_routed_shard_map``) under ``local_map``: each rank routes
its batch shard's tokens (routing is replicated over the expert axes),
runs :func:`_routed_core` for its own experts ``[e0, e0 + E_loc)`` only,
sums the expert partials over the expert axes (``sharding_rules.psum``, an
all-reduce that carries the gradient), averages over the remaining axes,
and averages aux over the batch axes; the shared experts run outside, on
DTensors.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.distributed.sharding_rules import NULL_CTX, mesh_shape, pmean, psum, scale_grad
from repro_torch.models.layers import _init_dense, mlp_apply


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 64
    top_k: int = 6
    d_ff_expert: int = 1408
    n_shared: int = 2
    first_k_dense: int = 1
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.001
    normalize_topk: bool = False
    routed_scaling: float = 1.0


def moe_init(gen: torch.Generator, d_model: int, cfg: MoEConfig, dtype) -> dict:
    """The reference's leaves and scales, drawn from ``gen`` on its device:
    ``router`` (d, E) float32 at 0.02 whatever ``dtype`` is, the experts'
    ``w_gate`` / ``w_up`` (E, d, f) and ``w_down`` (E, f, d), and ``shared``,
    one SwiGLU MLP of width ``n_shared * f``."""
    E, f = cfg.num_experts, cfg.d_ff_expert
    p = {
        "router": _init_dense(gen, (d_model, E), torch.float32, scale=0.02),
        "w_gate": _init_dense(gen, (E, d_model, f), dtype),
        "w_up": _init_dense(gen, (E, d_model, f), dtype),
        "w_down": _init_dense(gen, (E, f, d_model), dtype),
    }
    if cfg.n_shared:
        fs = cfg.n_shared * f
        p["shared"] = {"w_gate": _init_dense(gen, (d_model, fs), dtype),
                       "w_up": _init_dense(gen, (d_model, fs), dtype),
                       "w_down": _init_dense(gen, (fs, d_model), dtype)}
    return p


def capacity(cfg: MoEConfig, T: int, capacity_factor: float = 0.0) -> int:
    """Slots per expert for T tokens: ``ceil(T * K / E * cf)`` capped at T;
    ``cf < 0`` is dropless (C = T); 0 takes the config's factor."""
    cf = capacity_factor or cfg.capacity_factor
    C = T if cf < 0 else int(math.ceil(T * cfg.top_k / cfg.num_experts * cf))
    return min(C, T)


def _ranks_within_expert(flat_e: torch.Tensor, num_experts: int) -> torch.Tensor:
    """rank[i] = the number of earlier assignments with the same expert id,
    from a stable argsort and the start of each run of equal ids (a
    running max), as the reference computes it: no (T*k, E) one-hot."""
    tk = flat_e.shape[0]
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    idx = torch.arange(tk, device=flat_e.device)
    change = torch.ones(tk, dtype=torch.bool, device=flat_e.device)
    change[1:] = sorted_e[1:] != sorted_e[:-1]
    run_start = torch.cummax(torch.where(change, idx, 0), dim=0).values
    rank = torch.empty_like(idx)
    rank[order] = idx - run_start
    return rank


def route(params, cfg: MoEConfig, xf: torch.Tensor):
    """Float32 routing of the tokens ``xf`` (T, d): (probs (T, E), top_p
    (T, K) scaled, top_e (T, K) long) — softmax over ``xf @ router``, top-k
    in order of probability."""
    logits = xf.to(torch.float32) @ params["router"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, cfg.top_k, dim=-1)
    if cfg.normalize_topk:
        top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, top_p * cfg.routed_scaling, top_e


def _gather_slots(x, tok_buf):
    """Each slot's token row, ``x[tok_buf[s]]`` for x (T, d) and tok_buf
    (E * C,), zeros where a slot is empty (``tok_buf`` holds T there)."""
    return torch.cat([x, x.new_zeros(1, x.shape[1])])[tok_buf]


def _sum_assignments(ye, slot, top_k: int):
    """Each token's K assignments' slot rows, ``ye[slot]`` for ye (E * C,
    d) and slot (T * K,), summed over k in ``ye``'s dtype; the dump slot
    E * C reads zeros."""
    rows = torch.cat([ye, ye.new_zeros(1, ye.shape[1])])[slot]
    return rows.reshape(slot.shape[0] // top_k, top_k, ye.shape[1]).sum(dim=1)


class _Dispatch(torch.autograd.Function):
    """xe = ``_gather_slots(xf, tok_buf)``; its gradient is
    ``_sum_assignments`` of the slot grads (a gather and a sum over k,
    where autograd would scatter-add them)."""

    @staticmethod
    def forward(ctx, xf, tok_buf, slot, top_k: int):
        ctx.save_for_backward(slot)
        ctx.top_k = top_k
        return _gather_slots(xf, tok_buf)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        (slot,) = ctx.saved_tensors
        return _sum_assignments(g, slot, ctx.top_k), None, None, None


class _Combine(torch.autograd.Function):
    """y = ``_sum_assignments(ye, slot, K)``; its gradient is
    ``_gather_slots`` of the token grads (a kept slot has one assignment;
    dropped ones, all in the dump slot, get none), where autograd's index
    backward would sort the slots and accumulate the dump slot's many
    sources in series."""

    @staticmethod
    def forward(ctx, ye, tok_buf, slot, top_k: int):
        ctx.save_for_backward(tok_buf)
        return _sum_assignments(ye, slot, top_k)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        (tok_buf,) = ctx.saved_tensors
        return _gather_slots(g, tok_buf), None, None, None


def _routed_core(params, cfg: MoEConfig, x: torch.Tensor, capacity_factor: float, *,
                 e0: int = 0, E_loc: int | None = None):
    """Routing, dispatch and the expert FFNs of the experts ``[e0, e0 +
    E_loc)`` (all of them by default) for x (B, S, d), whose ``w_gate`` /
    ``w_up`` / ``w_down`` hold those experts only.  Returns (the routed
    output (T, d) — those experts' contributions alone —, aux): the
    reference's ``_routed_core``, and with every expert its local path
    without the shared experts."""
    B, S, d = x.shape
    E, K = cfg.num_experts, cfg.top_k
    E_loc = E if E_loc is None else E_loc
    T = B * S
    C = capacity(cfg, T, capacity_factor)
    xf = x.reshape(T, d)
    dev = x.device

    probs, top_p, top_e = route(params, cfg, xf)
    # the Switch load-balance loss: mean router prob x top-1 fraction per expert
    # (the top-1 counts by an integer index_add: bincount's counts, of a
    # size known before the data, as a traced step needs)
    top1 = torch.zeros(E, dtype=torch.long, device=dev).index_add_(
        0, top_e[:, 0], torch.ones_like(top_e[:, 0]))
    ce = top1.to(torch.float32) / T
    aux = cfg.aux_loss_weight * E * torch.sum(probs.mean(dim=0) * ce)

    # dispatch: slot (e - e0) * C + rank, or the dump slot E_loc * C past
    # capacity or outside this rank's experts
    flat_e = top_e.reshape(T * K)
    flat_tok = torch.arange(T, device=dev).repeat_interleave(K)
    rank = _ranks_within_expert(flat_e, E)
    local_e = flat_e - e0
    keep = (rank < C) & (local_e >= 0) & (local_e < E_loc)
    slot = torch.where(keep, local_e * C + rank, E_loc * C)
    tok_buf = torch.full((E_loc * C + 1,), T, dtype=torch.long, device=dev)
    tok_buf[slot] = flat_tok
    prob_buf = torch.zeros(E_loc * C + 1, dtype=torch.float32, device=dev)
    prob_buf[slot] = top_p.reshape(T * K)
    xe = _Dispatch.apply(xf, tok_buf[:E_loc * C], slot, K).reshape(E_loc, C, d)

    g = torch.bmm(xe, params["w_gate"])
    u = torch.bmm(xe, params["w_up"])
    ye = torch.bmm(torch.nn.functional.silu(g) * u, params["w_down"])
    ye = ye * prob_buf[:E_loc * C].reshape(E_loc, C, 1).to(ye.dtype)

    # combine: each assignment's slot row (the dump slot reads zeros), summed over k
    return _Combine.apply(ye.reshape(E_loc * C, d), tok_buf[:E_loc * C], slot, K), aux


def moe_apply(params, cfg: MoEConfig, x: torch.Tensor, *, ctx=NULL_CTX,
              capacity_factor: float = 0.0):
    """x (B, S, d) -> (out (B, S, d), aux_loss float32 scalar).

    ``capacity_factor`` overrides the config's (0 = the config's; < 0 =
    dropless, as decode runs).  An assignment past its expert's capacity
    is dropped: its token keeps its other top-k routes and the shared
    experts.  On a mesh (``ctx.mesh``, DTensor params and x) the routed
    experts take the expert-parallel path (:func:`_moe_routed_sharded`)."""
    if ctx.mesh is not None:
        routed, aux = _moe_routed_sharded(params, cfg, x, ctx, capacity_factor)
        if "shared" in params:
            routed = routed + mlp_apply(params["shared"], x)
        return routed, aux
    B, S, d = x.shape
    y, aux = _routed_core(params, cfg, x, capacity_factor)
    if "shared" in params:
        y = y + mlp_apply(params["shared"], x.reshape(B * S, d))
    return y.reshape(B, S, d), aux


def _moe_routed_sharded(params, cfg: MoEConfig, x, ctx, capacity_factor: float):
    """The expert-parallel routed experts (the reference's
    ``_moe_routed_shard_map``) on DTensors: ``local_map`` hands each rank
    its batch shard of x (replicated over the other axes), the router whole
    and its experts' weights (sharded by expert over the 'expert' axes).
    Each rank's grads are its share of the total over the axes it does not
    shard, so they come back as partial sums there (``in_grad_placements``);
    aux, which the ranks of one batch shard compute alike, has its gradient
    divided among them."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = ctx.mesh
    shape = mesh_shape(mesh)
    names = tuple(mesh.mesh_dim_names)
    expert_axes = tuple(a for a in ctx.rules.get("expert", ()) if a in shape)
    batch_axes = tuple(a for a in ctx.rules.get("batch", ()) if a in shape)
    if x.shape[0] % ctx.axis_size(*batch_axes):
        batch_axes = ()  # tiny batch (long-decode B=1): replicate tokens
    other_axes = tuple(a for a in names if a not in expert_axes + batch_axes)
    ep = ctx.axis_size(*expert_axes)
    n_other = ctx.axis_size(*other_axes)
    if cfg.num_experts % ep:
        raise ValueError(f"{cfg.num_experts} experts do not split over {ep} expert ranks")
    E_loc = cfg.num_experts // ep

    def on(axes, inside, outside):
        return [inside if a in axes else outside for a in names]

    x_pl = on(batch_axes, Shard(0), Replicate())
    w_pl = on(expert_axes, Shard(0), Replicate())
    rep = [Replicate()] * len(names)

    def local(router, w_gate, w_up, w_down, x_loc):
        e0, stride = 0, E_loc
        for a in reversed(expert_axes):
            e0 += mesh.get_local_rank(a) * stride
            stride *= shape[a]
        p = {"router": router, "w_gate": w_gate, "w_up": w_up, "w_down": w_down}
        out, aux = _routed_core(p, cfg, x_loc, capacity_factor, e0=e0, E_loc=E_loc)
        out = psum(out, mesh, expert_axes)  # combine expert partials
        out = pmean(out, mesh, other_axes)
        aux = pmean(scale_grad(aux, 1.0 / (ep * n_other)), mesh, batch_axes)
        return out.reshape(x_loc.shape), aux

    fn = local_map(
        local, out_placements=(x_pl, rep),
        in_placements=(rep, w_pl, w_pl, w_pl, x_pl),
        in_grad_placements=([Partial()] * len(names), on(expert_axes, Shard(0), Partial()),
                            on(expert_axes, Shard(0), Partial()),
                            on(expert_axes, Shard(0), Partial()),
                            on(batch_axes, Shard(0), Partial())),
        device_mesh=mesh, redistribute_inputs=True,
    )
    return fn(params["router"], params["w_gate"], params["w_up"], params["w_down"], x)
