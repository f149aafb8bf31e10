"""DimeNet (arXiv:2003.03123), the port of ``repro.models.dimenet``.

Messages live on directed edges m_ji; each of the ``n_blocks`` interaction
blocks updates m_ji from the incoming messages m_kj (k != i), weighted by a
2D spherical-radial basis of (d_kj, angle(k -> j -> i)) through a bilinear
layer.  The triplet list (t_in = edge k -> j, t_out = edge j -> i) is built
on the host (``build_triplets``, numpy, with an optional cap); the model
gathers, runs dense products and sums back to edges, then to nodes.  Every
ragged structure is padded with -1 and masked with ``where``, as in the
reference, so a padded entry gets a zero gradient.

Every index that reaches a parameter's gradient (the species ``z``, the
edges' source and destination nodes, the triplets' two edges) goes through
the fixed-order ``models.segment.gather`` / ``segment_sum``, where the
reference's gathers and ``segment_sum`` scatter-add: the sums keep the
reference's order inside each destination, and a step's grads are the same
bits every run on the card.

Dtypes follow the reference's promotion: the cells' params are bf16, but
``rbf``, ``sbf`` and the node features are float32, so every product
after the embedding computes in float32 (:func:`_mm`).  The blocks run
under ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` with
``nothing_saveable`` inside its ``lax.scan``); ``blocks`` keeps the
reference's layout, each leaf stacked over the blocks.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.common.utils import resolve_device
from repro_torch.distributed.sharding_rules import NULL_CTX
from repro_torch.models.layers import _init_dense
from repro_torch.models.segment import FixedIndex, gather, segment_sum


@dataclasses.dataclass(frozen=True)
class DimeNetConfig:
    name: str = "dimenet"
    n_blocks: int = 6
    d_hidden: int = 128
    n_bilinear: int = 8
    n_spherical: int = 7
    n_radial: int = 6
    cutoff: float = 5.0
    envelope_p: int = 6
    n_species: int = 95
    d_node_feat: int = 0  # >0: continuous node features instead of species
    out_dim: int = 1
    param_dtype: str = "float32"
    compute_dtype: str = "float32"

    def dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def num_params(self) -> int:
        h, nb = self.d_hidden, self.n_bilinear
        emb = (self.n_species if not self.d_node_feat else self.d_node_feat) * h
        emb += self.n_radial * h + 3 * h * h
        per_block = (
            self.n_radial * h  # rbf -> edge gate
            + self.n_spherical * self.n_radial * nb  # sbf proj
            + h * nb * h  # bilinear
            + 4 * h * h  # msg MLPs
            + h * self.out_dim
        )
        return emb + self.n_blocks * per_block + 2 * h * self.out_dim


# ---------------------------------------------------------------------------
# host-side graph preprocessing
# ---------------------------------------------------------------------------


def build_triplets(
    edge_index: np.ndarray,
    n_nodes: int,
    max_in_per_edge: Optional[int] = None,
    max_triplets: Optional[int] = None,
    seed: int = 0,
):
    """Triplets of directed edges: pairs (e_kj, e_ji) sharing node j, with
    k != i.  Returns (t_in, t_out) int32 arrays, grouped by t_out in edge
    order: t_in indexes the incoming edge (k -> j), t_out the updated edge
    (j -> i).  ``max_in_per_edge`` keeps the first in-edges of j (in edge
    order) for each outgoing edge; ``max_triplets`` subsamples the rest
    uniformly (seeded), which breaks the grouping."""
    src = np.asarray(edge_index[0], dtype=np.int64)
    dst = np.asarray(edge_index[1], dtype=np.int64)
    valid = (src >= 0) & (dst >= 0)
    vsrc, vdst = src[valid], dst[valid]
    vidx = np.nonzero(valid)[0]
    order_d = np.argsort(vdst, kind="stable")  # valid edges grouped by dst
    starts = np.searchsorted(vdst[order_d], np.arange(n_nodes + 1))
    indeg = starts[1:] - starts[:-1]
    counts = indeg[vsrc]  # per valid edge e=(j->i): in-degree of j
    if max_in_per_edge is not None:
        counts = np.minimum(counts, max_in_per_edge)
    total = int(counts.sum())
    t_out_v = np.repeat(np.arange(len(vsrc), dtype=np.int64), counts)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    within = np.arange(total, dtype=np.int64) - offsets[t_out_v]
    t_in_v = order_d[starts[vsrc[t_out_v]] + within]
    # drop degenerate triplets where k == i (message bouncing straight back)
    keep = vsrc[t_in_v] != vdst[t_out_v]
    t_in_v, t_out_v = t_in_v[keep], t_out_v[keep]
    if max_triplets is not None and len(t_in_v) > max_triplets:
        rng = np.random.default_rng(seed)
        sel = rng.choice(len(t_in_v), max_triplets, replace=False)
        t_in_v, t_out_v = t_in_v[sel], t_out_v[sel]
    # map back to original (padded) edge ids
    return vidx[t_in_v].astype(np.int32), vidx[t_out_v].astype(np.int32)


# ---------------------------------------------------------------------------
# bases (the reference's arithmetic, op for op)
# ---------------------------------------------------------------------------


def _ipow(x: torch.Tensor, y: int) -> torch.Tensor:
    """x ** y for an int y > 0 by binary powering, the products of jax's
    ``integer_pow``: the envelope's terms nearly cancel near the cutoff,
    where ``torch.pow``'s other rounding would show."""
    acc = None
    while y > 0:
        if y & 1:
            acc = x if acc is None else acc * x
        y >>= 1
        if y > 0:
            x = x * x
    return acc


def envelope(d: torch.Tensor, cutoff: float, p: int) -> torch.Tensor:
    """Smooth polynomial cutoff envelope u(d) (DimeNet eq. 8)."""
    x = d / cutoff
    a = -(p + 1) * (p + 2) / 2.0
    b = p * (p + 2)
    c = -p * (p + 1) / 2.0
    env = (1.0 / torch.clamp(x, min=1e-9) + a * _ipow(x, p - 1) + b * _ipow(x, p)
           + c * _ipow(x, p + 1))
    return torch.where(x < 1.0, env, 0.0)


def radial_basis(d: torch.Tensor, n_radial: int, cutoff: float, p: int) -> torch.Tensor:
    """e_RBF,n(d) = sqrt(2/c) sin(n pi d / c) / d, enveloped.  (E, n_radial)"""
    n = torch.arange(1, n_radial + 1, dtype=torch.float32, device=d.device)
    dd = torch.clamp(d[..., None], min=1e-9)
    # the reference takes the square root in float32
    norm = torch.sqrt(torch.tensor(2.0 / cutoff, dtype=torch.float32, device=d.device))
    basis = norm * torch.sin(n * math.pi * dd / cutoff) / dd
    return basis * envelope(d, cutoff, p)[..., None]


def _legendre(cos_t: torch.Tensor, l_max: int) -> torch.Tensor:
    """P_0..P_{l_max-1}(cos theta) by recurrence.  (..., l_max)"""
    p0 = torch.ones_like(cos_t)
    if l_max == 1:
        return p0[..., None]
    ps = [p0, cos_t]
    for l in range(2, l_max):
        ps.append(((2 * l - 1) * cos_t * ps[-1] - (l - 1) * ps[-2]) / l)
    return torch.stack(ps, dim=-1)


def spherical_basis(d, angle, n_spherical: int, n_radial: int, cutoff: float, p: int):
    """a_SBF,(l,n)(d, theta): radial sin-basis x Legendre angular.  Returns
    (T, n_spherical * n_radial)."""
    rb = radial_basis(d, n_radial, cutoff, p)  # (T, n_radial)
    ab = _legendre(torch.cos(angle), n_spherical)  # (T, n_spherical)
    return (ab[..., :, None] * rb[..., None, :]).reshape(*d.shape, n_spherical * n_radial)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _mlp2_init(gen, d_in, d_out, dtype):
    return {"w1": _init_dense(gen, (d_in, d_out), dtype),
            "w2": _init_dense(gen, (d_out, d_out), dtype)}


def init(cfg: DimeNetConfig, seed: int = 0, device=None) -> dict:
    """Random params in ``cfg.param_dtype``, drawn in float32 from a
    ``torch.Generator`` seeded with ``seed`` on the device (CUDA unless
    ``device="cpu"``), with the reference's leaves, scales and layout:
    ``blocks`` holds each block leaf stacked over ``n_blocks``."""
    gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    dtype = cfg.dtype()
    h, nb = cfg.d_hidden, cfg.n_bilinear
    d_in_node = cfg.d_node_feat if cfg.d_node_feat else cfg.n_species
    params = {
        "embed_node": _init_dense(gen, (d_in_node, h), dtype, scale=0.02),
        "embed_rbf": _init_dense(gen, (cfg.n_radial, h), dtype),
        "embed_msg": _mlp2_init(gen, 3 * h, h, dtype),
        "out_embed": _mlp2_init(gen, h, h, dtype),
        "out_final": _init_dense(gen, (h, cfg.out_dim), dtype),
    }
    blocks = []
    for _ in range(cfg.n_blocks):
        bilinear = torch.randn((h, nb, h), generator=gen, device=gen.device) / math.sqrt(h)
        blocks.append({
            "rbf_gate": _init_dense(gen, (cfg.n_radial, h), dtype),
            "sbf_proj": _init_dense(gen, (cfg.n_spherical * cfg.n_radial, nb), dtype),
            "bilinear": bilinear.to(dtype),
            "w_src": _init_dense(gen, (h, h), dtype),
            "w_msg": _init_dense(gen, (h, h), dtype),
            "w_update1": _init_dense(gen, (h, h), dtype),
            "w_update2": _init_dense(gen, (h, h), dtype),
            "out_proj": _init_dense(gen, (h, h), dtype),
        })
    params["blocks"] = {k: torch.stack([b[k] for b in blocks]) for k in blocks[0]}
    return params


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w in the dtype jnp promotes the two to (a bf16 weight meeting a
    float32 operand computes in float32)."""
    dt = torch.promote_types(a.dtype, w.dtype)
    return a.to(dt) @ w.to(dt)


def _block(m, node_out, bp, rbf, sbf, e_valid, t_valid, fi_ti, fi_to, fi_dst, ctx=NULL_CTX):
    """One interaction block (the reference's ``block``): directional
    message passing, then the block's output summed to the nodes."""
    gate = _mm(rbf, bp["rbf_gate"])  # (E, h)
    m_gated = F.silu(_mm(m, bp["w_msg"])) * gate
    m_in = gather(m_gated, fi_ti)  # (T, h) the incoming messages
    sb = _mm(sbf, bp["sbf_proj"])  # (T, n_bilinear)
    # the bilinear layer unrolled over its small axis: the einsum form
    # "th,hbk,tb->tk" would hold a (T, n_bilinear, h) intermediate
    inter = torch.zeros((m_in.shape[0], m_in.shape[-1]), dtype=m_in.dtype, device=m_in.device)
    for b in range(bp["bilinear"].shape[-2]):
        inter = inter + _mm(m_in, bp["bilinear"][:, b, :]) * sb[:, b:b + 1]
    inter = torch.where(t_valid[:, None], inter, 0.0)
    agg = segment_sum(inter, fi_to)  # (E, h)
    mm = F.silu(_mm(m, bp["w_src"])) + agg
    mm = F.silu(_mm(mm, bp["w_update1"]))
    m_new = m + F.silu(_mm(mm, bp["w_update2"]))  # residual
    m_new = torch.where(e_valid[:, None], m_new, 0.0)
    m_new = ctx.constrain(m_new, "batch", None)
    contrib = _mm(segment_sum(m_new * gate, fi_dst), bp["out_proj"])
    return m_new, node_out + contrib


def apply_batched(
    params: dict,
    cfg: DimeNetConfig,
    *,
    positions,  # (B, n, 3) tensor, as every input here
    edge_index,  # (B, 2, E) int, -1 padded
    t_in,  # (B, T) int, -1 padded
    t_out,  # (B, T) int, -1 padded
    z=None,  # (B, n) species
    node_feat=None,  # (B, n, d_feat) when cfg.d_node_feat
    node_mask=None,  # (B, n) bool
    ctx=NULL_CTX,
):
    """The reference's ``apply`` vmapped over B lanes (independent graphs of
    one padded shape), run as one disjoint graph: each lane's -1 entries
    are clipped to 0 first, then its node, edge and triplet indices are
    offset by the lane's start, so a padded entry lands on the lane's own
    node 0 or edge 0 as under ``vmap``.  Returns (node_pred (B, n,
    out_dim), graph_pred (B, out_dim)), the latter each lane's sum."""
    B, n = positions.shape[:2]
    E = edge_index.shape[-1]
    dev = positions.device
    lane = torch.arange(B, device=dev)[:, None]
    src, dst = edge_index[:, 0].long(), edge_index[:, 1].long()
    e_valid = ((src >= 0) & (dst >= 0)).reshape(-1)
    srcc = (src.clamp(min=0) + lane * n).reshape(-1)
    dstc = (dst.clamp(min=0) + lane * n).reshape(-1)
    t_in, t_out = t_in.long(), t_out.long()
    t_valid = ((t_in >= 0) & (t_out >= 0)).reshape(-1)
    ti = (t_in.clamp(min=0) + lane * E).reshape(-1)
    to = (t_out.clamp(min=0) + lane * E).reshape(-1)
    positions = positions.reshape(B * n, 3)
    N = B * n
    fi_src, fi_dst = FixedIndex(srcc, N), FixedIndex(dstc, N)
    fi_ti, fi_to = FixedIndex(ti, B * E), FixedIndex(to, B * E)

    # geometry (positions carry no gradient: plain gathers)
    vec = positions.index_select(0, dstc) - positions.index_select(0, srcc)  # (E, 3)
    dist = torch.sqrt(torch.clamp(torch.sum(vec**2, dim=-1), min=1e-12))
    rbf = radial_basis(dist, cfg.n_radial, cfg.cutoff, cfg.envelope_p)
    rbf = torch.where(e_valid[:, None], rbf, 0.0).to(positions.dtype)
    # angle at the shared node j between edges (k->j) and (j->i)
    v_in = -vec.index_select(0, ti)  # j -> k
    v_out = vec.index_select(0, to)  # j -> i
    norms = torch.sqrt(torch.sum(v_in * v_in, dim=-1)) * torch.sqrt(torch.sum(v_out * v_out,
                                                                               dim=-1))
    cos_a = torch.sum(v_in * v_out, dim=-1) / torch.clamp(norms, min=1e-9)
    angle = torch.arccos(torch.clamp(cos_a, -1.0 + 1e-7, 1.0 - 1e-7))
    sbf = spherical_basis(dist.index_select(0, ti), angle, cfg.n_spherical, cfg.n_radial,
                          cfg.cutoff, cfg.envelope_p)
    sbf = torch.where(t_valid[:, None], sbf, 0.0).to(positions.dtype)

    # node embedding
    if cfg.d_node_feat:
        hN = _mm(node_feat.reshape(N, -1), params["embed_node"])
    else:
        zc = z.long().clamp(min=0).reshape(-1)
        hN = gather(params["embed_node"], FixedIndex(zc, params["embed_node"].shape[0]))
    if node_mask is not None:
        node_mask = node_mask.reshape(N).bool()
        hN = torch.where(node_mask[:, None], hN, 0.0)

    # initial edge message: MLP([h_src, h_dst, rbf_embed])
    rbf_emb = _mm(rbf, params["embed_rbf"])
    dt = torch.promote_types(hN.dtype, rbf_emb.dtype)
    m = torch.cat([gather(hN, fi_src).to(dt), gather(hN, fi_dst).to(dt), rbf_emb.to(dt)], dim=-1)
    m = F.silu(_mm(m, params["embed_msg"]["w1"]))
    m = F.silu(_mm(m, params["embed_msg"]["w2"]))  # (E, h)
    m = torch.where(e_valid[:, None], m, 0.0)
    m = ctx.constrain(m, "batch", None)

    node_out = torch.zeros((N, cfg.d_hidden), dtype=m.dtype, device=dev)
    names = list(params["blocks"])
    for vals in zip(*(params["blocks"][k].unbind(0) for k in names)):
        m, node_out = checkpoint(_block, m, node_out, dict(zip(names, vals)), rbf, sbf, e_valid,
                                 t_valid, fi_ti, fi_to, fi_dst, ctx, use_reentrant=False)

    h = F.silu(_mm(node_out, params["out_embed"]["w1"]))
    h = F.silu(_mm(h, params["out_embed"]["w2"]))
    node_pred = _mm(h, params["out_final"])
    if node_mask is not None:
        node_pred = torch.where(node_mask[:, None], node_pred, 0.0)
    node_pred = node_pred.reshape(B, n, -1)
    return node_pred, node_pred.sum(dim=1)


def apply(params: dict, cfg: DimeNetConfig, *, positions, edge_index, t_in, t_out, z=None,
          node_feat=None, node_mask=None, ctx=NULL_CTX):
    """One graph: positions (n, 3), edge_index (2, E) and t_in / t_out (T,)
    -1 padded, z (n,) species or node_feat (n, d_feat), node_mask (n,)
    bool.  Returns (node_pred (n, out_dim), graph_pred (out_dim,)); padded
    entries contribute nothing."""
    lane = lambda a: None if a is None else torch.as_tensor(a)[None]
    node_pred, graph_pred = apply_batched(
        params, cfg, positions=lane(positions), edge_index=lane(edge_index), t_in=lane(t_in),
        t_out=lane(t_out), z=lane(z), node_feat=lane(node_feat), node_mask=lane(node_mask),
        ctx=ctx)
    return node_pred[0], graph_pred[0]
