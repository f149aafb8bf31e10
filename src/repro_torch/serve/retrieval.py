"""Distributed LANNS serving over a ``torch.distributed`` mesh (paper §7).

The port of ``repro.serve.retrieval``.  Topology: the corpus is sharded
along the ``model`` mesh axis (one LANNS *shard* per rank of the corpus
axes) and the query batch along the ``data`` axis.  Each rank holds its own
``(1, m, N_seg, d)`` shard (``shard_arrays``) and its own rows of the query
batch (``info["query_block"]`` of ``info["query_blocks"]``).  The paper's
broker is a collective: each shard computes its segment-routed, locally
merged perShardTopK candidates, and the shard merge is an
``all_gather_into_tensor`` over each corpus axis's group followed by one
top-k.  perShardTopK (Eq. 5-6) directly multiplies down the payload.

Segment routing on the device is MoE-style capacity dispatch: the
virtual-spill tree router gives a (B, m) segment mask; each segment takes
up to ``capacity`` queries (the first by query index), scans its own row
block, and the results scatter back per query; a query spilled to s
segments merges its s copies there, the paper's merge within the shard.

The segment scan: on a float32 corpus each segment is one K1 launch
(``kernels.ops.distance_topk`` with ``n_valid`` the segment's row count;
``build_device_index`` puts each block's padding rows at its end), and
CPU tensors run its plain version.  K1 recomputes ``||x||^2`` where the
reference adds the build-time norms, so distances agree within the parity
contract, not bit for bit.  bfloat16 and int8 corpora follow the
reference's arithmetic in torch ops (``q`` cast to the compute dtype, int8
dequantized as ``x.bf16 * scale.bf16``, products accumulated in float32,
the build-time norms added).

Two scan modes: ``routed`` (capacity-dispatched per-segment scan) and
``full`` (every query scans the whole shard: one scan per segment, the m
lists merged in the reference's flattened order, duplicates of a
physically spilled row kept as the reference keeps them).

Ties: every merge keeps the k smallest with ties to the earlier entry, as
``jax.lax.top_k`` does (``core.merge._stable_order``): the level-1 merge
over a segment-major row, the broker's over a shard-major one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.common.utils import resolve_device, round_up
from repro_torch.core.lanns import LannsConfig
from repro_torch.core.merge import _stable_order, per_shard_topk
from repro_torch.core.sharding import TwoLevelPartitioner
from repro_torch.distributed.collectives import all_gather_stacked, all_reduce_sum
from repro_torch.kernels import ops

_TREE_KEYS = ("hyperplanes", "split", "lo", "hi")


# ---------------------------------------------------------------------------
# On-device tree router
# ---------------------------------------------------------------------------


def route_queries_tree(tree: dict, q: torch.Tensor, spill: bool = True) -> torch.Tensor:
    """(B, d) queries -> (B, m) bool segment mask on ``q``'s device.

    tree: heap-order arrays {hyperplanes (m-1, d), split, lo, hi} (numpy or
    tensors; moved to ``q``'s device) and the int ``depth``.  spill=True
    routes into the [lo, hi] band both ways (virtual spill / Figure 3);
    spill=False is the median split.
    """
    depth = int(tree["depth"])
    H, split, lo, hi = (torch.as_tensor(tree[k], device=q.device) for k in _TREE_KEYS)
    proj = q.to(torch.float32) @ H.T  # (B, n_internal)
    B = q.shape[0]
    mask = torch.ones((B, 1), dtype=torch.bool, device=q.device)
    for lvl in range(depth):
        nodes = slice(2**lvl - 1, 2 ** (lvl + 1) - 1)  # this level, heap order
        p = proj[:, nodes]
        if spill:
            gl = p <= hi[nodes][None, :]
            gr = p >= lo[nodes][None, :]
        else:
            gl = p < split[nodes][None, :]
            gr = ~gl
        mask = torch.stack([mask & gl, mask & gr], dim=-1).reshape(B, 2 ** (lvl + 1))
    return mask


# ---------------------------------------------------------------------------
# Device-resident index
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DeviceIndex:
    """Stacked per-(shard, segment) corpus blocks, built on the host.

    corpus  (S, m, N_seg, d) float32 | int8 | uint16 (the bits of bfloat16,
            which numpy lacks) — padded row blocks, padding rows last and zero
    ids     (S, m, N_seg) int32 — global keys, -1 padding
    norms   (S, m, N_seg) float32 — BUILD-TIME row norms of the f32 rows
    scale   (d,) float32 | None — int8 per-dimension dequant scale (SQ8)
    tree    dict | None — the shared segmenter's arrays (every rank's)
    """

    corpus: np.ndarray
    ids: np.ndarray
    norms: np.ndarray
    tree: Optional[dict]
    config: LannsConfig
    scale: Optional[np.ndarray] = None

    @property
    def num_shards(self):
        return self.corpus.shape[0]

    @property
    def num_segments(self):
        return self.corpus.shape[1]


def build_device_index(
    data: np.ndarray,
    config: LannsConfig,
    keys: Optional[np.ndarray] = None,
    *,
    pad_multiple: int = 8,
    corpus_dtype: str = "float32",  # 'float32' | 'bfloat16' | 'int8'
) -> DeviceIndex:
    """Two-level partition the corpus and pack it into stacked blocks,
    array-equal to ``repro.serve.retrieval.build_device_index``'s.

    Physical spill duplicates rows into both children.  corpus_dtype='int8'
    applies symmetric per-dimension scalar quantization (FAISS SQ8); norms
    come from the ORIGINAL f32 rows, so quantization only perturbs the
    cross term of the distance.  Routing of the points runs on the host.
    """
    if corpus_dtype not in ("float32", "bfloat16", "int8"):
        raise ValueError(corpus_dtype)
    data = np.asarray(data, dtype=np.float32)
    n = data.shape[0]
    if keys is None:
        keys = np.arange(n, dtype=np.int64)
    part = TwoLevelPartitioner(config.num_shards, config.segmenter_config(),
                               torch.device("cpu"))
    part.fit(data)
    assignment = part.assign(data, keys)
    S, m = config.num_shards, config.num_segments
    sizes = assignment.partition_sizes()
    n_seg = round_up(max(int(sizes.max()), 1), pad_multiple)
    scale = None
    store_dtype = {"float32": np.float32, "bfloat16": np.uint16, "int8": np.int8}[corpus_dtype]
    if corpus_dtype == "int8":
        scale = (np.abs(data).max(axis=0) / 127.0).astype(np.float32)
        scale = np.maximum(scale, 1e-12)
    store = np.zeros((S, m, n_seg, data.shape[1]), dtype=store_dtype)
    ids = np.full((S, m, n_seg), -1, dtype=np.int32)
    norms = np.zeros((S, m, n_seg), dtype=np.float32)
    for s in range(S):
        for g in range(m):
            rows = assignment.rows[s][g]
            block = data[rows]
            if corpus_dtype == "int8":
                store[s, g, : len(rows)] = np.clip(
                    np.round(block / scale[None, :]), -127, 127
                ).astype(np.int8)
            elif corpus_dtype == "bfloat16":  # round to nearest even, as ml_dtypes
                bits = torch.from_numpy(block).to(torch.bfloat16).view(torch.int16)
                store[s, g, : len(rows)] = bits.numpy().view(np.uint16)
            else:
                store[s, g, : len(rows)] = block
            ids[s, g, : len(rows)] = keys[rows]
            norms[s, g, : len(rows)] = np.einsum("nd,nd->n", block, block)
    tree = part.segmenter.tree_arrays()
    if tree is not None:
        tree = {k: tree[k] for k in (*_TREE_KEYS, "depth")}
    return DeviceIndex(corpus=store, ids=ids, norms=norms, tree=tree, config=config,
                       scale=scale)


def shard_arrays(index: DeviceIndex, shard: int, device=None) -> dict:
    """Shard ``shard`` of ``index`` on ``device`` (CUDA unless asked):
    the keyword arguments of ``serve_fn`` after the queries — corpus
    (1, m, N_seg, d) float32 / bfloat16 / int8, ids, norms, the tree's
    tensors and the int8 scale."""
    dev = resolve_device(device)
    block = index.corpus[shard: shard + 1]
    if block.dtype == np.uint16:
        corpus = torch.from_numpy(block.view(np.int16)).view(torch.bfloat16)
    else:
        corpus = torch.from_numpy(np.ascontiguousarray(block))
    tree = None
    if index.tree is not None:
        tree = {k: torch.from_numpy(np.asarray(index.tree[k], np.float32)).to(dev)
                for k in _TREE_KEYS}
        tree["depth"] = int(index.tree["depth"])
    return {
        "corpus": corpus.to(dev),
        "ids": torch.from_numpy(np.ascontiguousarray(index.ids[shard: shard + 1])).to(dev),
        "norms": torch.from_numpy(np.ascontiguousarray(index.norms[shard: shard + 1])).to(dev),
        "tree": tree,
        "scale": None if index.scale is None else torch.from_numpy(index.scale).to(dev),
    }


# ---------------------------------------------------------------------------
# Local (per-shard) search
# ---------------------------------------------------------------------------


def _scan_dequant(qg, xg, ig, xng, k, metric, block_n, scale):
    """One bfloat16 / int8 segment: the reference's blocked scan in torch
    ops -> (C, k) ascending scores and global ids, (inf, -1) past the
    valid rows.  Products of bfloat16 values are exact in float32, so the
    float32 product of the cast operands is the reference's bf16 MXU
    product with float32 accumulation.  Ties inside a block follow
    ``torch.topk`` (unspecified), so these corpora are held to id-set
    agreement, not id equality."""
    cdt = torch.bfloat16
    qc = qg.to(cdt).to(torch.float32)
    q_norm = (qc * qc).sum(-1, keepdim=True)
    C = qg.shape[0]
    run_d = torch.full((C, k), float("inf"), dtype=torch.float32, device=qg.device)
    run_i = torch.full((C, k), -1, dtype=torch.int32, device=qg.device)
    for s in range(0, xg.shape[0], block_n):
        xb = xg[s: s + block_n]
        ib = ig[s: s + block_n]
        xb = (xb.to(cdt) * scale.to(cdt)) if scale is not None else xb.to(cdt)
        qx = qc @ xb.to(torch.float32).T  # (C, bn)
        sc = (q_norm - 2.0 * qx + xng[s: s + block_n][None, :]) if metric == "l2" else -qx
        sc = torch.where((ib >= 0)[None, :], sc, float("inf"))
        kb = min(k, sc.shape[1])
        blk_d, blk_r = torch.topk(sc, kb, dim=1, largest=False, sorted=True)
        cat_d = torch.cat([run_d, blk_d], 1)
        cat_i = torch.cat([run_i, ib[blk_r]], 1)
        sel = _stable_order(cat_d)[:, :k]
        run_d, run_i = torch.gather(cat_d, 1, sel), torch.gather(cat_i, 1, sel)
    return run_d, torch.where(torch.isinf(run_d), -1, run_i)


def _segment_scan_topk(q_seg, x_seg, ids_seg, xn_seg, k, metric, block_n=2048,
                       scale=None):
    """Per-segment scan.  q_seg (m, C, d) float32; x_seg (m, N, d);
    ids_seg (m, N); xn_seg (m, N) BUILD-TIME row norms
    -> (m, C, k) dists / global ids, (inf, -1) padding.

    float32: one ``ops.distance_topk`` (K1 on CUDA tensors, its plain
    version on CPU tensors) per segment over its valid rows, which come
    first in each block.  bfloat16 / int8: ``_scan_dequant``."""
    m = x_seg.shape[0]
    if x_seg.dtype not in (torch.float32, torch.bfloat16, torch.int8):
        raise ValueError(f"corpus dtype {x_seg.dtype}")
    if (x_seg.dtype == torch.int8) != (scale is not None):
        raise ValueError("an int8 corpus needs its scale, and only it takes one")
    if x_seg.dtype == torch.float32:
        from torch._subclasses.fake_tensor import is_fake

        if is_fake(ids_seg):  # a traced step (the dry run): every row counts
            counts = [x_seg.shape[1]] * m
        else:
            counts = (ids_seg >= 0).sum(-1).tolist()  # one host read a call
        out_d, out_i = [], []
        for g in range(m):
            d, r = ops.distance_topk(q_seg[g], x_seg[g], k, metric, n_valid=counts[g])
            gid = ids_seg[g][r.clamp_min(0).long()]
            out_d.append(d)
            out_i.append(torch.where(r >= 0, gid, -1))
        return torch.stack(out_d), torch.stack(out_i)
    outs = [_scan_dequant(q_seg[g], x_seg[g], ids_seg[g], xn_seg[g], k, metric, block_n,
                          scale) for g in range(m)]
    return torch.stack([d for d, _ in outs]), torch.stack([i for _, i in outs])


def _local_shard_search_routed(
    q, corpus, ids, norms, tree, *, k_local, metric, capacity, depth,
    block_n=2048, scale=None,
):
    """Segment-routed search of ONE shard.  q (B, d); corpus (m, N, d)
    -> (B, k_local) dists, ids and the overflow count."""
    B = q.shape[0]
    m = corpus.shape[0]
    dev = q.device
    mask = route_queries_tree(dict(tree, depth=depth), q, spill=True)  # (B, m)
    # capacity dispatch: the first `capacity` routed queries per segment.
    pos = torch.cumsum(mask.to(torch.int32), dim=0) - 1  # (B, m) slot per seg
    keep = mask & (pos < capacity)
    overflow = (mask & ~keep).sum()
    prio = torch.where(keep, torch.arange(B, device=dev)[:, None], B)
    sorted_prio, order = torch.sort(prio, dim=0, stable=True)  # routed queries first
    C = min(capacity, B)
    sel = order[:C].T  # (m, C) query indices
    valid_slot = sorted_prio[:C].T < B  # (m, C)
    q_seg = q[sel]  # (m, C, d)
    d_seg, i_seg = _segment_scan_topk(q_seg, corpus, ids, norms, k_local, metric,
                                      block_n=block_n, scale=scale)
    d_seg = torch.where(valid_slot[..., None], d_seg, float("inf"))
    i_seg = torch.where(valid_slot[..., None], i_seg, -1)
    # combine: scatter back to (B, m, k_local); invalid slots land on the
    # extra row B, which is dropped (the reference's scatter mode="drop").
    buf_d = torch.full((B + 1, m, k_local), float("inf"), dtype=torch.float32, device=dev)
    buf_i = torch.full((B + 1, m, k_local), -1, dtype=torch.int32, device=dev)
    flat_q = torch.where(valid_slot, sel, B).reshape(-1)
    flat_g = torch.arange(m, device=dev)[:, None].expand(m, C).reshape(-1)
    buf_d[flat_q, flat_g] = d_seg.reshape(-1, k_local)
    buf_i[flat_q, flat_g] = i_seg.reshape(-1, k_local)
    buf_d = buf_d[:B].reshape(B, m * k_local)
    buf_i = buf_i[:B].reshape(B, m * k_local)
    # level-1 merge (inside the shard): across the <= m segment copies
    top = _stable_order(buf_d)[:, :k_local]
    return torch.gather(buf_d, 1, top), torch.gather(buf_i, 1, top), overflow


def _local_shard_search_full(q, corpus, ids, norms, *, k_local, metric,
                             block_n=8192, scale=None):
    """Scan of the whole shard (ground truth / RS segmenter): each segment
    over its own valid rows, then the m lists merged segment-major, which
    is the order of the reference's flattened (m * N) block."""
    m = corpus.shape[0]
    B = q.shape[0]
    d_seg, i_seg = _segment_scan_topk(q.expand(m, *q.shape), corpus, ids, norms, k_local,
                                      metric, block_n=block_n, scale=scale)
    cand_d = d_seg.permute(1, 0, 2).reshape(B, m * k_local)
    cand_i = i_seg.permute(1, 0, 2).reshape(B, m * k_local)
    top = _stable_order(cand_d)[:, :k_local]
    zero = torch.zeros((), dtype=torch.int64, device=q.device)
    return torch.gather(cand_d, 1, top), torch.gather(cand_i, 1, top), zero


# ---------------------------------------------------------------------------
# The distributed serve step
# ---------------------------------------------------------------------------


def make_serve_fn(
    mesh,
    config: LannsConfig,
    *,
    topk: int,
    mode: str = "routed",  # 'routed' | 'full'
    capacity_factor: float = 1.5,
    batch_per_device: int = 64,
    use_per_shard_topk: bool = True,
    corpus_axes: tuple = ("model",),
    query_axes: tuple = ("data",),
    depth: int = 0,
    block_n: int = 2048,
):
    """The distributed serve step of this rank over ``mesh`` (a named
    ``DeviceMesh``, ``launch.mesh``).

    Returns (serve_fn, info).  serve_fn signature:
      (queries (B_loc, d) float32 — this rank's rows of the batch, corpus
       (1, m, N, d), ids (1, m, N), norms (1, m, N), tree, scale=None) ->
      (dists (B_loc, topk), ids (B_loc, topk), overflow: the global count,
       an int64 tensor)
    with the shard's arguments from ``shard_arrays(index, info["shard"])``.
    info: ``per_shard_topk``, ``capacity``, this rank's ``shard`` (its
    index over the corpus axes, row-major) and ``query_block`` of
    ``query_blocks`` (its rows of the batch, over the query axes).
    """
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    num_shards = math.prod(sizes[a] for a in corpus_axes)
    if num_shards != config.num_shards:
        raise ValueError(
            f"config.num_shards={config.num_shards} must equal mesh corpus "
            f"axes product {num_shards}"
        )
    if mode not in ("routed", "full"):
        raise ValueError(mode)
    pstk = per_shard_topk(topk, num_shards, config.topk_confidence) if (
        use_per_shard_topk
    ) else topk
    m = config.num_segments
    if depth <= 0:
        depth = int(np.log2(m))
    # expected routed queries/segment: B * (1+2a)^depth / m, plus slack.
    spill_mult = (1.0 + 2.0 * config.alpha) ** depth
    capacity = int(np.ceil(batch_per_device * spill_mult / m * capacity_factor))
    capacity = max(8, min(capacity, batch_per_device))
    metric = "ip" if config.metric in ("ip", "cos") else "l2"
    groups = {a: mesh.get_group(a) for a in (*corpus_axes, *query_axes)}

    def linear(axes):  # this rank's row-major index over ``axes``
        idx = 0
        for a in axes:
            idx = idx * sizes[a] + mesh.get_local_rank(a)
        return idx

    def serve_fn(queries, corpus, ids, norms, tree, scale=None):
        corpus_l, ids_l, norms_l = corpus[0], ids[0], norms[0]
        q = queries.to(torch.float32)
        B = q.shape[0]
        if mode == "routed" and tree is not None:
            d_l, i_l, ovf = _local_shard_search_routed(
                q, corpus_l, ids_l, norms_l, tree,
                k_local=pstk, metric=metric, capacity=capacity, depth=depth,
                block_n=block_n, scale=scale,
            )
        else:
            d_l, i_l, ovf = _local_shard_search_full(
                q, corpus_l, ids_l, norms_l, k_local=pstk, metric=metric, scale=scale,
            )
        # ---- level-2 merge: the broker as a collective --------------------
        # all_gather over the corpus axes, innermost first; payload per query
        # = pstk pairs per shard, which is what Eq. (5)-(6) trims.
        d_g, i_g = d_l, i_l
        for ax in reversed(corpus_axes):
            d_g = all_gather_stacked(d_g, groups[ax])
            i_g = all_gather_stacked(i_g, groups[ax])
        cand_d = d_g.reshape(num_shards, B, pstk).permute(1, 0, 2).reshape(B, -1)
        cand_i = i_g.reshape(num_shards, B, pstk).permute(1, 0, 2).reshape(B, -1)
        top = _stable_order(cand_d)[:, :topk]
        ovf = ovf.to(torch.int64)
        for ax in (*corpus_axes, *query_axes):  # the global count
            ovf = all_reduce_sum(ovf, groups[ax])
        return torch.gather(cand_d, 1, top), torch.gather(cand_i, 1, top), ovf

    info = {
        "per_shard_topk": pstk,
        "capacity": capacity,
        "shard": linear(corpus_axes),
        "query_block": linear(query_axes),
        "query_blocks": math.prod(sizes[a] for a in query_axes),
    }
    return serve_fn, info
