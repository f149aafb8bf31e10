"""RecSys architectures: AutoInt, DIN, SASRec, xDeepFM — the port of
``repro.models.recsys``.

The shared substrate is the embedding layer over huge sparse tables:
gathers for single-hot lookups and segment sums for multi-hot bags (id -1
is padding and reads as a zero row), both in a fixed order
(``models.segment``: a lookup's backward sums each row's grads in index
order, where ``index_add`` would add them atomically, so a train step gives
the same bits every run).  Params are plain trees (dicts
and lists) of tensors with the reference's names, shapes and (d_in, d_out)
weight layout; each ``*_init`` draws from a ``torch.Generator`` on the
device where the params live.  Not JAX's numbers: tests that compare the
two packages carry the reference's params across with
``convert.recsys_params_from_jax``.

  AutoInt  (arXiv:1810.11921): field embeddings -> 3 residual self-attention
           layers (2 heads, d=32) -> concat -> logit.
  DIN      (arXiv:1706.06978): target attention over user behaviour history
           with the [h, t, h-t, h*t] MLP scorer -> 200-80 MLP.
  SASRec   (arXiv:1808.09781): causal 2-block transformer over the item
           sequence; next-item logits = hidden @ item_embeddings^T (the
           retrieval_cand cell scores 1M candidates through K1,
           ``serve/recsys.py``).
  xDeepFM  (arXiv:1803.05170): CIN (outer-product feature maps compressed by
           1x1 conv, 200-200-200) + deep MLP (400-400) + linear.

The attentions are plain torch ops with the reference's masks (K3 takes
neither AutoInt's field attention nor SASRec's padding mask).  Dtypes
follow the reference's promotion: bf16 params compute in bf16, except
SASRec, whose ``x * sqrt(d)`` by a float64 numpy scalar promotes the
reference's activations to float32 (its bf16 weights are upcast where they
meet them).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.common.utils import resolve_device
from repro_torch.distributed.sharding_rules import NULL_CTX, psum
from repro_torch.models.layers import _init_dense
from repro_torch.models.segment import FixedIndex, gather, segment_sum

_NEG_INF = float("-inf")


def _on(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device)


# ---------------------------------------------------------------------------
# EmbeddingBag substrate
# ---------------------------------------------------------------------------


def embedding_table_init(gen: torch.Generator, vocab: int, dim: int, dtype=torch.float32):
    return _init_dense(gen, (vocab, dim), dtype, scale=0.01)


def _lookup_rows(table: torch.Tensor, flat_ids: torch.Tensor, ctx) -> torch.Tensor:
    """``table[flat_ids]`` by the fixed-order gather.  Inside a sharded
    step's ``local_map`` body, where ``ctx.rows`` names ``table`` as a
    rank's row shard (``(mesh, axes, first row)``), the ids outside the
    shard are masked, the rest looked up locally, and the rows summed over
    the shard axes: the row-sharded table of the reference (LANNS's
    level-1 sharding applied to tables)."""
    shard = ctx.rows.get(id(table))
    if shard is None:
        return gather(table, FixedIndex(flat_ids, table.shape[0]))
    mesh, axes, r0 = shard
    rel = flat_ids - r0
    mine = (rel >= 0) & (rel < table.shape[0])
    rows = gather(table, FixedIndex(torch.where(mine, rel, 0), table.shape[0]))
    return psum(torch.where(mine[:, None], rows, 0.0).to(table.dtype), mesh, axes)


def row_shard_ctx(local_leaves, placements, n_rows, mesh):
    """The ctx of a ``local_map`` body (``ShardingCtx.rows``): for each of
    this rank's leaves sharded by row (``Shard(0)`` on some mesh axes, of
    ``n_rows`` rows whole), its axes and first row."""
    from torch.distributed.tensor import Shard

    from repro_torch.distributed.sharding_rules import ShardingCtx, shard_start

    names = tuple(mesh.mesh_dim_names)
    rows = {}
    for t, pls, n in zip(local_leaves, placements, n_rows):
        axes = [a for a, pl in zip(names, pls) if pl == Shard(0)]
        if axes:
            rows[id(t)] = (mesh, axes, shard_start(mesh, axes, n))
    return ShardingCtx(rows=rows)


def embedding_lookup(table: torch.Tensor, ids, ctx=NULL_CTX) -> torch.Tensor:
    """Single-hot lookup: ids (...,) -> (..., dim); id -1 gives zeros."""
    ids = _on(ids, table.device)
    out = _lookup_rows(table, ids.reshape(-1).clamp(min=0), ctx)
    return torch.where((ids >= 0)[..., None], out.reshape(*ids.shape, table.shape[1]), 0.0)


def embedding_bag(table: torch.Tensor, ids, segment_ids, num_segments: int,
                  mode: str = "sum") -> torch.Tensor:
    """EmbeddingBag: gather rows then segment-reduce.

    ids (nnz,) row indices (-1 = padding, dropped), segment_ids (nnz,) the
    output bag of each id -> (num_segments, dim).  mode 'sum' or 'mean'
    (divided by max(count, 1): an empty bag is zeros).
    """
    if mode not in ("sum", "mean"):
        raise ValueError(f"embedding_bag: mode={mode!r} (sum or mean)")
    dev, dtype = table.device, table.dtype
    ids = _on(ids, dev)
    valid = (ids >= 0).to(dtype)
    rows = gather(table, FixedIndex(ids.clamp(min=0), table.shape[0])) * valid[:, None]
    seg = torch.where(ids >= 0, _on(segment_ids, dev), num_segments)  # padding -> spare bag
    bags = FixedIndex(seg, num_segments + 1)
    out = segment_sum(rows, bags)[:num_segments]
    if mode == "mean":
        cnt = segment_sum(valid[:, None], bags)[:num_segments]
        out = out / torch.clamp(cnt, min=1.0)
    return out


def field_offsets(vocab_sizes) -> np.ndarray:
    """Per-field row offsets into the fused table (static, config-derived —
    NOT a parameter, so grads stay all-float)."""
    return np.concatenate([[0], np.cumsum(vocab_sizes)[:-1]]).astype(np.int32)


def multi_field_lookup(tables: dict, sparse_ids, vocab_sizes, ctx=NULL_CTX) -> torch.Tensor:
    """Per-field single-hot lookup: sparse_ids (B, F) against one fused table
    (total_rows, dim) with per-field row offsets — one gather instead of F.

    tables: {"table": (total_rows, dim)}
    """
    table = tables["table"]
    ids = _on(sparse_ids, table.device)
    flat = ids + _on(field_offsets(vocab_sizes), table.device)[None, :]
    out = _lookup_rows(table, flat.reshape(-1).clamp(min=0), ctx)
    return torch.where((ids >= 0)[..., None], out.reshape(*ids.shape, table.shape[1]), 0.0)


def fused_tables_init(gen: torch.Generator, vocab_sizes, dim: int, dtype=torch.float32):
    """{"table": (rows, dim)}, the rows padded to a multiple of 512 as the
    reference pads them (so the table row-shards evenly)."""
    total = int(np.sum(vocab_sizes))
    total_pad = -(-total // 512) * 512
    return {"table": embedding_table_init(gen, total_pad, dim, dtype)}


def _mlp_init(gen: torch.Generator, dims, dtype):
    return [{"w": _init_dense(gen, (dims[i], dims[i + 1]), dtype),
             "b": torch.zeros((dims[i + 1],), dtype=dtype, device=gen.device)}
            for i in range(len(dims) - 1)]


def _mlp_apply(layers, x, act=torch.relu, final_act: bool = False):
    for i, layer in enumerate(layers):
        x = x @ layer["w"] + layer["b"]
        if i < len(layers) - 1 or final_act:
            x = act(x)
    return x


# ---------------------------------------------------------------------------
# AutoInt
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AutoIntConfig:
    name: str = "autoint"
    n_sparse: int = 39
    embed_dim: int = 16
    n_attn_layers: int = 3
    n_heads: int = 2
    d_attn: int = 32
    vocab_sizes: tuple = ()
    param_dtype: str = "float32"
    compute_dtype: str = "float32"

    def dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def num_params(self) -> int:
        emb = int(np.sum(self.vocab_sizes)) * self.embed_dim
        d_in = self.embed_dim
        per = 3 * d_in * self.d_attn * self.n_heads + d_in * self.d_attn * self.n_heads
        # layer 0 maps embed_dim; later layers map d_attn*n_heads
        dh = self.d_attn * self.n_heads
        per_rest = 3 * dh * dh + dh * dh
        return emb + per + (self.n_attn_layers - 1) * per_rest + self.n_sparse * dh


def autoint_init(gen: torch.Generator, cfg: AutoIntConfig) -> dict:
    dtype = cfg.dtype()
    params = {"tables": fused_tables_init(gen, cfg.vocab_sizes, cfg.embed_dim, dtype)}
    dh = cfg.d_attn * cfg.n_heads
    layers = []
    for i in range(cfg.n_attn_layers):
        d_in = cfg.embed_dim if i == 0 else dh
        layers.append({name: _init_dense(gen, (d_in, dh), dtype)
                       for name in ("wq", "wk", "wv", "w_res")})
    params["attn_layers"] = layers
    params["head"] = _init_dense(gen, (cfg.n_sparse * dh, 1), dtype)
    return params


def autoint_apply(params: dict, cfg: AutoIntConfig, sparse_ids, ctx=NULL_CTX) -> torch.Tensor:
    """sparse_ids (B, F) -> logits (B,)."""
    x = multi_field_lookup(params["tables"], sparse_ids, cfg.vocab_sizes, ctx)  # (B, F, d)
    x = ctx.constrain(x, "batch", None, None)
    H, da = cfg.n_heads, cfg.d_attn
    for lp in params["attn_layers"]:
        B, F, _ = x.shape
        q = (x @ lp["wq"]).reshape(B, F, H, da)
        k = (x @ lp["wk"]).reshape(B, F, H, da)
        v = (x @ lp["wv"]).reshape(B, F, H, da)
        s = torch.einsum("bfhd,bghd->bhfg", q, k).to(torch.float32) / math.sqrt(da)
        p = torch.softmax(s, dim=-1).to(x.dtype)
        o = torch.einsum("bhfg,bghd->bfhd", p, v).reshape(B, F, H * da)
        x = torch.relu(o + x @ lp["w_res"])
    return (x.reshape(x.shape[0], -1) @ params["head"])[:, 0]


# ---------------------------------------------------------------------------
# DIN
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DINConfig:
    name: str = "din"
    embed_dim: int = 18
    seq_len: int = 100
    attn_mlp: tuple = (80, 40)
    mlp: tuple = (200, 80)
    n_items: int = 1_000_000
    n_context: int = 8  # additional context/profile fields
    context_vocab: int = 100_000
    param_dtype: str = "float32"
    compute_dtype: str = "float32"

    def dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def num_params(self) -> int:
        d = self.embed_dim
        emb = self.n_items * d + self.n_context * self.context_vocab * d
        att_in = 4 * d
        att = att_in * self.attn_mlp[0] + self.attn_mlp[0] * self.attn_mlp[1] + self.attn_mlp[1]
        mlp_in = d * 2 + self.n_context * d
        mlp = mlp_in * self.mlp[0] + self.mlp[0] * self.mlp[1] + self.mlp[1]
        return emb + att + mlp


def din_init(gen: torch.Generator, cfg: DINConfig) -> dict:
    dtype = cfg.dtype()
    d = cfg.embed_dim
    return {
        "item_table": embedding_table_init(gen, cfg.n_items, d, dtype),
        "ctx_tables": fused_tables_init(gen, [cfg.context_vocab] * cfg.n_context, d, dtype),
        "att_mlp": _mlp_init(gen, (4 * d,) + tuple(cfg.attn_mlp) + (1,), dtype),
        "mlp": _mlp_init(gen, (2 * d + cfg.n_context * d,) + tuple(cfg.mlp) + (1,), dtype),
    }


def din_apply(params: dict, cfg: DINConfig, *, history, hist_len, target_item,
              context_ids, ctx=NULL_CTX) -> torch.Tensor:
    """history (B, T) item ids; hist_len (B,); target_item (B,);
    context_ids (B, n_context) -> logits (B,).  Target attention:
    a(h, t) = MLP([h, t, h-t, h*t]), softmax over the first hist_len
    positions (the reference keeps softmax masking where the paper uses
    un-normalized sigmoid weights)."""
    table = params["item_table"]
    h = embedding_lookup(table, history, ctx)  # (B, T, d)
    t = embedding_lookup(table, target_item, ctx)  # (B, d)
    h = ctx.constrain(h, "batch", None, None)
    tb = t[:, None, :].expand_as(h)
    feats = torch.cat([h, tb, h - tb, h * tb], dim=-1)
    scores = _mlp_apply(params["att_mlp"], feats, act=torch.sigmoid)[..., 0]
    T = h.shape[1]
    mask = torch.arange(T, device=table.device)[None, :] < _on(hist_len, table.device)[:, None]
    scores = torch.where(mask, scores.to(torch.float32), _NEG_INF)
    w = torch.softmax(scores, dim=-1).to(h.dtype)
    user = torch.einsum("bt,btd->bd", w, h)
    c = multi_field_lookup(params["ctx_tables"], context_ids,
                           [cfg.context_vocab] * cfg.n_context, ctx)  # (B, C, d)
    feat = torch.cat([user, t, c.reshape(user.shape[0], -1)], dim=-1)
    return _mlp_apply(params["mlp"], feat)[:, 0]


# ---------------------------------------------------------------------------
# SASRec
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SASRecConfig:
    name: str = "sasrec"
    embed_dim: int = 50
    n_blocks: int = 2
    n_heads: int = 1
    seq_len: int = 50
    n_items: int = 2_000_000
    dropout: float = 0.0
    param_dtype: str = "float32"
    compute_dtype: str = "float32"

    def dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def num_params(self) -> int:
        d = self.embed_dim
        emb = self.n_items * d + self.seq_len * d
        per = 4 * d * d + 2 * d * d + 4 * d  # attn + pointwise ffn + norms
        return emb + self.n_blocks * per


def sasrec_init(gen: torch.Generator, cfg: SASRecConfig) -> dict:
    dtype = cfg.dtype()
    d = cfg.embed_dim
    params = {"item_table": embedding_table_init(gen, cfg.n_items, d, dtype),
              "pos_table": embedding_table_init(gen, cfg.seq_len, d, dtype)}
    ones = lambda: torch.ones((d,), dtype=dtype, device=gen.device)
    params["blocks"] = [
        {**{name: _init_dense(gen, (d, d), dtype)
            for name in ("wq", "wk", "wv", "wo", "ff1", "ff2")}, "ln1": ones(), "ln2": ones()}
        for _ in range(cfg.n_blocks)]
    return params


def _ln(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """LayerNorm without a bias, eps 1e-6, statistics in float32."""
    xf = x.to(torch.float32)
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + 1e-6) * scale).to(x.dtype)


def sasrec_encode(params: dict, cfg: SASRecConfig, item_seq, ctx=NULL_CTX) -> torch.Tensor:
    """item_seq (B, T), -1 = padding -> hidden (B, T, d), zero at padding.
    Causal self-attention; a query row whose keys are all masked attends to
    nothing (the softmax's NaN becomes 0, as in the reference)."""
    table = params["item_table"]
    dev = table.device
    item_seq = _on(item_seq, dev)
    B, T = item_seq.shape
    # the reference's ``x * np.sqrt(d)`` promotes to float32 (at least)
    dt = torch.promote_types(table.dtype, torch.float32)
    x = (embedding_lookup(table, item_seq, ctx).to(dt) * math.sqrt(cfg.embed_dim)
         + params["pos_table"][:T].to(dt)[None])
    x = ctx.constrain(x, "batch", None, None)
    H, d = cfg.n_heads, cfg.embed_dim
    dh = d // H
    pos = torch.arange(T, device=dev)
    causal = torch.where(pos[None, :] <= pos[:, None], 0.0, _NEG_INF).to(torch.float32)
    pad = item_seq >= 0
    for bp in params["blocks"]:
        w = {name: bp[name].to(dt) for name in ("wq", "wk", "wv", "wo", "ff1", "ff2")}
        h = _ln(x, bp["ln1"])
        q = (h @ w["wq"]).reshape(B, T, H, dh)
        k = (h @ w["wk"]).reshape(B, T, H, dh)
        v = (h @ w["wv"]).reshape(B, T, H, dh)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) / math.sqrt(dh)
        s = s + causal[None, None]
        s = torch.where(pad[:, None, None, :], s, _NEG_INF)
        p = torch.softmax(s, dim=-1)
        p = torch.where(torch.isnan(p), 0.0, p).to(x.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, T, d)
        x = x + o @ w["wo"]
        h = _ln(x, bp["ln2"])
        x = x + torch.relu(h @ w["ff1"]) @ w["ff2"]
    return torch.where(pad[..., None], x, 0.0)


def sasrec_apply(params: dict, cfg: SASRecConfig, item_seq, ctx=NULL_CTX) -> torch.Tensor:
    """Full-vocab logits for every position, (B, T, n_items): only for
    small-vocab evaluation (training at 10M items uses
    ``sasrec_sampled_logits``)."""
    hidden = sasrec_encode(params, cfg, item_seq, ctx)
    logits = hidden @ params["item_table"].to(hidden.dtype).T
    return ctx.constrain(logits, "batch", None, "vocab")


def sasrec_sampled_logits(params: dict, cfg: SASRecConfig, item_seq, pos_items,
                          neg_items, ctx=NULL_CTX) -> tuple[torch.Tensor, torch.Tensor]:
    """SASRec's training objective (paper eq. 6): the scores of the positive
    next item and of one sampled negative per position, (B, T) each."""
    hidden = sasrec_encode(params, cfg, item_seq, ctx)
    pe = embedding_lookup(params["item_table"], pos_items, ctx)
    ne = embedding_lookup(params["item_table"], neg_items, ctx)
    return (hidden * pe).sum(-1), (hidden * ne).sum(-1)


def sasrec_score_candidates(params: dict, cfg: SASRecConfig, item_seq,
                            candidates, ctx=NULL_CTX) -> torch.Tensor:
    """Scores of (n_cand,) or (B, n_cand) candidate items against the final
    hidden state: a batched dot.  The retrieval_cand cell's 1M-candidate scan
    goes through K1 instead (``serve.recsys.retrieval_step``)."""
    last = sasrec_encode(params, cfg, item_seq, ctx)[:, -1]  # (B, d)
    cand = embedding_lookup(params["item_table"], candidates, ctx).to(last.dtype)
    if cand.dim() == 2:
        return last @ cand.T
    return torch.einsum("bd,bcd->bc", last, cand)


# ---------------------------------------------------------------------------
# xDeepFM
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class XDeepFMConfig:
    name: str = "xdeepfm"
    n_sparse: int = 39
    embed_dim: int = 10
    cin_layers: tuple = (200, 200, 200)
    mlp: tuple = (400, 400)
    vocab_sizes: tuple = ()
    param_dtype: str = "float32"
    compute_dtype: str = "float32"

    def dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def num_params(self) -> int:
        emb = int(np.sum(self.vocab_sizes)) * self.embed_dim
        lin = int(np.sum(self.vocab_sizes))
        cin, hk_prev = 0, self.n_sparse
        for hk in self.cin_layers:
            cin += hk_prev * self.n_sparse * hk
            hk_prev = hk
        cin_out = sum(self.cin_layers)
        dims = (self.n_sparse * self.embed_dim,) + tuple(self.mlp) + (1,)
        mlp = sum(dims[i] * dims[i + 1] + dims[i + 1] for i in range(len(dims) - 1))
        return emb + lin + cin + cin_out + mlp


def xdeepfm_init(gen: torch.Generator, cfg: XDeepFMConfig) -> dict:
    dtype = cfg.dtype()
    params = {
        "tables": fused_tables_init(gen, cfg.vocab_sizes, cfg.embed_dim, dtype),
        "linear": fused_tables_init(gen, cfg.vocab_sizes, 1, dtype),
        "mlp": _mlp_init(gen, (cfg.n_sparse * cfg.embed_dim,) + tuple(cfg.mlp) + (1,), dtype),
        "cin_head": _init_dense(gen, (sum(cfg.cin_layers), 1), dtype),
    }
    cin, hk_prev = [], cfg.n_sparse
    for hk in cfg.cin_layers:
        cin.append(_init_dense(gen, (hk_prev * cfg.n_sparse, hk), dtype))
        hk_prev = hk
    params["cin"] = cin
    return params


def xdeepfm_apply(params: dict, cfg: XDeepFMConfig, sparse_ids, ctx=NULL_CTX) -> torch.Tensor:
    """sparse_ids (B, F) -> logits (B,): linear + CIN + deep MLP.

    CIN layer k: X^k_h = sum_{i,j} W^k_{h,i,j} (X^{k-1}_i * X^0_j), the
    outer product over feature maps contracted against the compress
    weights, in the reference's two einsums."""
    x0 = multi_field_lookup(params["tables"], sparse_ids, cfg.vocab_sizes, ctx)  # (B, F, D)
    x0 = ctx.constrain(x0, "batch", None, None)
    B, F, _ = x0.shape
    lin = multi_field_lookup(params["linear"], sparse_ids, cfg.vocab_sizes, ctx)  # (B, F, 1)
    logit = lin.sum(dim=(1, 2))
    xk, cin_outs = x0, []
    for w in params["cin"]:
        hk_prev = xk.shape[1]
        inter = torch.einsum("bhd,bfd->bhfd", xk, x0)  # (B, Hk-1, F, D)
        xk = torch.einsum("bhfd,hfk->bkd", inter, w.reshape(hk_prev, F, -1))  # (B, Hk, D)
        cin_outs.append(xk.sum(-1))  # sum pool over D
    logit = logit + (torch.cat(cin_outs, dim=-1) @ params["cin_head"])[:, 0]
    return logit + _mlp_apply(params["mlp"], x0.reshape(B, -1))[:, 0]


# ---------------------------------------------------------------------------
# per-config dispatch (the reference's ``RecsysArch`` helpers)
# ---------------------------------------------------------------------------

_INIT = {AutoIntConfig: autoint_init, DINConfig: din_init, SASRecConfig: sasrec_init,
         XDeepFMConfig: xdeepfm_init}


def init(cfg, seed: int = 0, device=None) -> dict:
    """Random params of a recsys config in its ``param_dtype``, drawn from a
    ``torch.Generator`` seeded with ``seed`` on the device (CUDA unless
    ``device="cpu"``)."""
    gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    return _INIT[type(cfg)](gen, cfg)


def forward(params: dict, cfg, batch: dict, ctx=NULL_CTX) -> torch.Tensor:
    """The serving forward of a cell (the reference's ``_forward_fn``): the
    logits (B,) of AutoInt, DIN and xDeepFM, SASRec's last hidden state
    (B, d), from a batch of the reference's keys."""
    if isinstance(cfg, AutoIntConfig):
        return autoint_apply(params, cfg, batch["sparse_ids"], ctx)
    if isinstance(cfg, DINConfig):
        return din_apply(params, cfg, history=batch["history"], hist_len=batch["hist_len"],
                         target_item=batch["target_item"], context_ids=batch["context_ids"],
                         ctx=ctx)
    if isinstance(cfg, SASRecConfig):
        return sasrec_encode(params, cfg, batch["item_seq"], ctx)[:, -1]
    if isinstance(cfg, XDeepFMConfig):
        return xdeepfm_apply(params, cfg, batch["sparse_ids"], ctx)
    raise TypeError(type(cfg))
