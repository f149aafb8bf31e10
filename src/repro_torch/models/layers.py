"""Transformer building blocks: the port of ``repro.models.layers``.

RMSNorm, RoPE, GQA attention (with optional QKV bias, Qwen style), MLA
(DeepSeek-V2's multi-head latent attention) and the SwiGLU MLP,
functional as in the reference: a layer's params are a mapping
(``nn.ParameterDict``, or a plain dict) with the reference's names and
(d_in, d_out) weight layout, so ``x @ params["wq"]`` reads as it does
there.  Norms and softmax run in float32.  Long sequences take
``chunked_attention``, which is K3 on the card (``ops.flash_attention_bhsd``,
MLA's q . k head dim 192 with v's 128 included) and its plain version on
the CPU.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.kernels import ops


def _init_dense(gen: torch.Generator, shape, dtype, scale: float | None = None) -> torch.Tensor:
    """normal x ``scale`` (default 1/sqrt(fan_in), fan_in = shape[0]), drawn
    in float32 from ``gen`` on its device and cast to ``dtype``, as the
    reference's ``_init_dense`` draws and casts."""
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    w = torch.randn(tuple(shape), generator=gen, device=gen.device, dtype=torch.float32) * scale
    return w.to(dtype)


def rms_norm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with float32 statistics; the result stays in x's dtype."""
    d = x.shape[-1]
    xf = x.to(torch.float32)
    ss = (xf * xf).sum(-1)
    inv = torch.rsqrt(ss / d + eps)[..., None].to(x.dtype)
    return x * inv * params["scale"].to(x.dtype)


def rope_frequencies(head_dim: int, theta: float = 10_000.0, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10_000.0):
    """x (..., S, H, hd); positions (..., S) integer.  Rotates pairs (even, odd)."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, device=x.device)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1 = x[..., 0::2].to(torch.float32)
    x2 = x[..., 1::2].to(torch.float32)
    r1 = x1 * cos - x2 * sin
    r2 = x1 * sin + x2 * cos
    return torch.stack([r1, r2], dim=-1).reshape(x.shape).to(x.dtype)


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    q_chunk: int = 0  # 0 = unchunked; >0 sends S > q_chunk to chunked_attention
    kv_chunk: int = 1024


def _split_heads(x: torch.Tensor, n_heads: int, hd: int) -> torch.Tensor:
    """(B, S, n_heads * hd) -> (B, S, n_heads, hd).  A DTensor whose last
    dim is sharded over more ranks than there are heads (qwen2-72b's 8 KV
    heads on 16-way TP) is made whole on those mesh dims first, as GSPMD
    replicates such a head axis."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    B, S = x.shape[:2]
    if isinstance(x, DTensor):
        mesh = x.device_mesh
        pl = [Replicate() if isinstance(p, Shard) and p.dim == 2 and n_heads % mesh.size(i)
              else p for i, p in enumerate(x.placements)]
        if pl != list(x.placements):
            x = x.redistribute(mesh, pl)
    return x.reshape(B, S, n_heads, hd)


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, KV, hd) -> (B, S, KV*n_rep, hd) by head repetition (GQA)."""
    if n_rep == 1:
        return x
    b, s, kv, hd = x.shape
    return x[:, :, :, None, :].expand(b, s, kv, n_rep, hd).reshape(b, s, kv * n_rep, hd)


def _causal_mask(sq: int, skv: int, q_offset, device) -> torch.Tensor:
    """Additive causal mask (sq, skv): q position i attends kv <= i+offset."""
    qi = torch.arange(sq, device=device)[:, None] + q_offset
    kj = torch.arange(skv, device=device)[None, :]
    return torch.where(kj <= qi, 0.0, float("-inf")).to(torch.float32)


def dot_attention(q, k, v, *, causal: bool, q_offset=0, scale=None):
    """q (B, Sq, H, hd), k/v (B, Skv, H, hd) -> (B, Sq, H, hd).  f32 softmax.
    DTensors (a sharded model) run it on each rank's own batch rows and
    heads, as K3 does (``ops.flash_attention_bhsd``)."""
    from torch.distributed.tensor import DTensor

    if isinstance(q, DTensor):
        return ops.local_heads(dot_attention, q, k, v, causal=causal, q_offset=q_offset,
                               scale=scale)
    hd = q.shape[-1]
    scale = scale or (1.0 / math.sqrt(hd))
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) * scale
    if causal:
        logits = logits + _causal_mask(q.shape[1], k.shape[1], q_offset, q.device)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def chunked_attention(q, k, v, *, causal: bool, q_chunk: int, kv_chunk: int, scale=None):
    """Exact attention with an online softmax, never materializing the
    (Sq, Skv) scores: K3 (``ops.flash_attention_bhsd``) on CUDA tensors, its
    plain blocked version on CPU tensors.

    Keeps the reference's signature; ``q_chunk`` / ``kv_chunk`` only decide,
    in ``attention_apply`` and ``mla_apply``, that this path is taken (the
    kernel tiles on its own).  q and k/v must have one length
    (self-attention over fresh tokens, as every caller passes them); v's
    head dim may differ from q's (MLA: 192 for q . k, 128 for v).
    """
    return ops.flash_attention_bhsd(q, k, v, causal=causal, scale=scale)


def _write_cache(cache: dict, new: dict, off, B: int, S: int, device) -> torch.Tensor:
    """Write each ``new[name]`` (B, S, ...) into ``cache[name]`` IN PLACE at
    ``off``: an int, a 0-d tensor, or a (B,) tensor of per-row offsets
    (slots).  Returns the new tokens' positions (B, S)."""
    from torch.distributed.tensor import DTensor

    ar = torch.arange(S, device=device)
    if isinstance(next(iter(cache.values())), DTensor):
        return _write_cache_sharded(cache, new, int(off), B, S, ar)
    if isinstance(off, torch.Tensor) and off.ndim == 1:
        rows = torch.arange(B, device=device)[:, None]
        cols = off.to(device=device, dtype=torch.long)[:, None] + ar[None, :]
        for name, t in new.items():
            cache[name][rows, cols] = t.to(cache[name].dtype)
        return cols
    o = int(off)
    for name, t in new.items():
        cache[name][:, o: o + S] = t.to(cache[name].dtype)
    return (o + ar)[None, :].expand(B, S)


def _write_cache_sharded(cache: dict, new: dict, o: int, B: int, S: int, ar):
    """:func:`_write_cache` into DTensor caches sharded by sequence (and by
    batch): each rank writes the new rows that fall in its own sequence
    shard, from the new values gathered over the sequence axes (their
    heads made whole)."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed.sharding_rules import shard_start

    for name, t in new.items():
        c = cache[name]
        mesh = c.device_mesh
        names = tuple(mesh.mesh_dim_names)
        pl = [Shard(0) if p == Shard(0) else Replicate() for p in c.placements]
        t_loc = t.redistribute(mesh, pl).to_local() if hasattr(t, "redistribute") else t
        c_loc = c.to_local()
        n_loc = c_loc.shape[1]
        s0 = shard_start(mesh, [a for a, p in zip(names, c.placements) if p == Shard(1)],
                         c.shape[1])
        lo, hi = max(o, s0), min(o + S, s0 + n_loc)
        if lo < hi:
            c_loc[:, lo - s0: hi - s0] = t_loc[:, lo - o: hi - o].to(c_loc.dtype)
    return (o + ar)[None, :].expand(B, S)


def _cache_mask(q_pos: torch.Tensor, S_kv: int, causal: bool) -> torch.Tensor:
    """(B, S, S_kv): the valid cache extent and causality per row, kv <= q
    position (bidirectional: kv <= the row's last position)."""
    kv_pos = torch.arange(S_kv, device=q_pos.device)
    return kv_pos[None, None, :] <= (q_pos[:, :, None] if causal else q_pos[:, -1:, None])


def _self_attention(cfg: AttentionConfig, q, k, v, causal: bool):
    """Attention of fresh q over fresh k/v (no cache before them)."""
    H, KV = cfg.n_heads, cfg.n_kv_heads
    k_full = _repeat_kv(k, H // KV)
    v_full = _repeat_kv(v, H // KV)
    if cfg.q_chunk and q.shape[1] > cfg.q_chunk:
        return chunked_attention(q, k_full, v_full, causal=causal, q_chunk=cfg.q_chunk,
                                 kv_chunk=cfg.kv_chunk)
    return dot_attention(q, k_full, v_full, causal=causal)


def attention_apply(params, cfg: AttentionConfig, x, *, positions, causal: bool = True,
                    kv_cache: dict | None = None, cache_offset=None):
    """GQA attention.  x (B, S, d).

    kv_cache: {"k": (B, S_max, KV, hd), "v": ...}.  When given, the new k/v
    are written into it IN PLACE at ``cache_offset`` (an int, a 0-d tensor,
    or a (B,) tensor of per-row offsets) and attention runs against the
    cache, except for a whole-sequence prefill (offset the int 0, S > 1),
    which attends over the fresh k/v.  Returns (out, cache).
    """
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    q = apply_rope(_split_heads(q, H, hd), positions, cfg.rope_theta)
    k = apply_rope(_split_heads(k, KV, hd), positions, cfg.rope_theta)
    v = _split_heads(v, KV, hd)

    if kv_cache is None:
        out = _self_attention(cfg, q, k, v, causal)
        return out.reshape(B, S, H * hd) @ params["wo"], None

    off = cache_offset if cache_offset is not None else 0
    q_pos = _write_cache(kv_cache, {"k": k, "v": v}, off, B, S, x.device)
    # whole-sequence prefill: nothing precedes these tokens, so attention
    # over the fresh k/v is exact and never scores the cache
    if isinstance(off, int) and off == 0 and S > 1:
        out = _self_attention(cfg, q, k, v, causal)
        return out.reshape(B, S, H * hd) @ params["wo"], kv_cache
    ck, cv = kv_cache["k"], kv_cache["v"]
    from torch.distributed.tensor import DTensor

    if isinstance(ck, DTensor):
        out = _cached_attention_sharded(q, ck, cv, q_pos, causal, KV, x.dtype)
    else:
        out = _cached_attention(q, ck, cv, q_pos, causal, KV, x.dtype)
    return out @ params["wo"], kv_cache


def _cached_attention(q, ck, cv, q_pos, causal: bool, KV: int, dtype, s0: int = 0):
    """GQA attention of q (B, S, H, hd) over a cache ck / cv (B, S_kv, KV,
    hd) whose first row is position ``s0``: (B, S, H * hd), by a grouped
    einsum (the repeated KV is never materialized)."""
    B, S, H, hd = q.shape
    kv_pos = s0 + torch.arange(ck.shape[1], device=q_pos.device)
    ok = kv_pos[None, None, :] <= (q_pos[:, :, None] if causal else q_pos[:, -1:, None])
    qg = q.reshape(B, S, KV, H // KV, hd)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, ck.to(dtype)).to(torch.float32)
    logits = logits / math.sqrt(hd)
    logits = torch.where(ok[:, None, None], logits, float("-inf"))
    probs = torch.softmax(logits, dim=-1).to(dtype)
    return torch.einsum("bkgst,btkd->bskgd", probs, cv.to(dtype)).reshape(B, S, H * hd)


def _cached_attention_sharded(q, ck, cv, q_pos, causal: bool, KV: int, dtype):
    """:func:`_cached_attention` on DTensors whose cache is sharded by
    sequence (the decode cells' layout) under ``local_map``: q's heads are
    gathered (one token a row), each rank scores its own cache rows, and
    the partial softmaxes merge across the sequence shards (flash
    decoding: the rows' max, then the rescaled sums, all-reduced), the
    merge GSPMD derives for the reference.  A cache sharded over no mesh
    dim of more than one rank takes the one-device arithmetic."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.distributed.sharding_rules import psum, shard_start

    mesh = ck.device_mesh
    names = tuple(mesh.mesh_dim_names)
    big = lambda a: mesh.size(names.index(a)) > 1
    seq_axes = [a for a, p in zip(names, ck.placements) if p == Shard(1) and big(a)]
    b_axes = [a for a, p in zip(names, ck.placements) if p == Shard(0) and big(a)]
    c_pl = [Shard(1) if a in seq_axes else Shard(0) if a in b_axes else Replicate()
            for a in names]
    q_pl = [Shard(0) if a in b_axes else Replicate() for a in names]
    S_kv = ck.shape[1]

    def local(q_l, k_l, v_l, pos):
        b0 = shard_start(mesh, b_axes, pos.shape[0])
        pos = pos[b0:b0 + q_l.shape[0]]
        if not seq_axes:
            return _cached_attention(q_l, k_l, v_l, pos, causal, KV, dtype)
        s0 = shard_start(mesh, seq_axes, S_kv)
        B, S, H, hd = q_l.shape
        kv_pos = s0 + torch.arange(k_l.shape[1], device=pos.device)
        ok = kv_pos[None, None, :] <= (pos[:, :, None] if causal else pos[:, -1:, None])
        qg = q_l.reshape(B, S, KV, H // KV, hd)
        logits = torch.einsum("bskgd,btkd->bkgst", qg, k_l.to(dtype)).to(torch.float32)
        logits = torch.where(ok[:, None, None], logits / math.sqrt(hd), float("-inf"))
        m = logits.amax(-1)
        for a in seq_axes:
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=mesh.get_group(a))
        p = torch.exp(logits - torch.where(torch.isinf(m), 0.0, m)[..., None])
        den = psum(p.sum(-1), mesh, seq_axes)  # (B, KV, G, S)
        num = psum(torch.einsum("bkgst,btkd->bskgd", p.to(dtype), v_l.to(dtype))
                   .to(torch.float32), mesh, seq_axes)
        out = num / den.permute(0, 3, 1, 2)[..., None]
        return out.to(dtype).reshape(B, S, H * hd)

    fn = local_map(local, out_placements=q_pl, in_placements=(q_pl, c_pl, c_pl, None),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(q, ck, cv, q_pos)


# ---------------------------------------------------------------------------
# MLA — Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    n_heads: int
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 10_000.0
    q_chunk: int = 0
    kv_chunk: int = 1024

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


def mla_init(gen: torch.Generator, cfg: MLAConfig, dtype) -> dict:
    """The reference's leaves, drawn from ``gen``: ``wq`` (full rank: V2-Lite
    has no q compression), the latent path ``w_dkv`` / ``w_krope`` /
    ``kv_norm``, the up-projections ``w_uk`` / ``w_uv`` and ``wo``."""
    d, H, r = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
    return {
        "wq": _init_dense(gen, (d, H * cfg.qk_head_dim), dtype),
        "w_dkv": _init_dense(gen, (d, r), dtype),
        "w_krope": _init_dense(gen, (d, cfg.qk_rope_head_dim), dtype),
        "kv_norm": {"scale": torch.ones(r, dtype=dtype, device=gen.device)},
        "w_uk": _init_dense(gen, (r, H * cfg.qk_nope_head_dim), dtype),
        "w_uv": _init_dense(gen, (r, H * cfg.v_head_dim), dtype),
        "wo": _init_dense(gen, (H * cfg.v_head_dim, d), dtype),
    }


def _mla_fresh(params, cfg: MLAConfig, q_nope, q_rope, latent, k_rope, causal: bool, scale):
    """Attention of fresh q over per-head k / v materialised from the fresh
    latent: (B, S, H * dv) before ``wo``."""
    B, S, H, _ = q_nope.shape
    k_nope = (latent @ params["w_uk"]).reshape(B, S, H, cfg.qk_nope_head_dim)
    v = (latent @ params["w_uv"]).reshape(B, S, H, cfg.v_head_dim)
    k_rope_b = k_rope.expand(B, S, H, cfg.qk_rope_head_dim)
    qh = torch.cat([q_nope, q_rope], dim=-1)
    kh = torch.cat([k_nope, k_rope_b], dim=-1)
    if cfg.q_chunk and S > cfg.q_chunk:
        out = chunked_attention(qh, kh, v, causal=causal, q_chunk=cfg.q_chunk,
                                kv_chunk=cfg.kv_chunk, scale=scale)
    else:
        out = dot_attention(qh, kh, v, causal=causal, scale=scale)
    return out.reshape(B, S, H * cfg.v_head_dim)


def mla_apply(params, cfg: MLAConfig, x, *, positions, causal: bool = True,
              latent_cache: dict | None = None, cache_offset=None):
    """MLA attention.  x (B, S, d).  The cache holds only ``latent`` (B,
    Smax, r) and ``k_rope`` (B, Smax, dr): 576 values a token for V2-Lite
    against 2 x 16 x 128 for the GQA equivalent.

    latent_cache: when given, the new latent and rope key are written into
    it IN PLACE at ``cache_offset`` (an int, a 0-d tensor, or a (B,) tensor
    of per-row offsets).  A whole-sequence prefill (offset the int 0,
    S > 1) attends over per-head k / v materialised from the fresh latent
    (K3 past ``q_chunk``); any other call takes the absorbed form: q_nope
    folded through W_uk scores the cached latent directly, and the latent
    output goes through W_uv, so per-head k / v of the cache never exist.
    Returns (out, cache)."""
    B, S, _ = x.shape
    H = cfg.n_heads
    dn, dr, dv, r = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim, cfg.kv_lora_rank
    q = (x @ params["wq"]).reshape(B, S, H, cfg.qk_head_dim)
    q_nope = q[..., :dn]
    q_rope = apply_rope(q[..., dn:], positions, cfg.rope_theta)
    latent = rms_norm(params["kv_norm"], x @ params["w_dkv"])  # (B, S, r)
    k_rope = apply_rope((x @ params["w_krope"]).reshape(B, S, 1, dr), positions,
                        cfg.rope_theta)  # (B, S, 1, dr), shared by the heads
    scale = 1.0 / math.sqrt(cfg.qk_head_dim)

    if latent_cache is None:
        out = _mla_fresh(params, cfg, q_nope, q_rope, latent, k_rope, causal, scale)
        return out @ params["wo"], None

    off = cache_offset if cache_offset is not None else 0
    q_pos = _write_cache(latent_cache, {"latent": latent, "k_rope": k_rope[:, :, 0]}, off, B, S,
                         x.device)
    # whole-sequence prefill: exact over the fresh latent; the cache is only
    # persisted
    if isinstance(off, int) and off == 0 and S > 1:
        out = _mla_fresh(params, cfg, q_nope, q_rope, latent, k_rope, causal, scale)
        return out @ params["wo"], latent_cache
    cl, cr = latent_cache["latent"], latent_cache["k_rope"]
    # absorbed scores: q_nope through W_uk (per head dn x r) against the latent
    q_lat = torch.einsum("bshd,rhd->bshr", q_nope, params["w_uk"].reshape(r, H, dn))
    lat = cl.to(x.dtype)
    s_lat = torch.einsum("bshr,btr->bhst", q_lat, lat)
    s_rope = torch.einsum("bshd,btd->bhst", q_rope, cr.to(x.dtype))
    logits = (s_lat + s_rope).to(torch.float32) * scale
    ok = _cache_mask(q_pos, cl.shape[1], causal)
    logits = torch.where(ok[:, None], logits, float("-inf"))
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    # absorbed values: the latent output through W_uv
    out_lat = torch.einsum("bhst,btr->bshr", probs, lat)
    out = torch.einsum("bshr,rhd->bshd", out_lat, params["w_uv"].reshape(r, H, dv))
    return out.reshape(B, S, H * dv) @ params["wo"], latent_cache


def mlp_apply(params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: silu(x W_gate) * (x W_up), then W_down."""
    gate = torch.nn.functional.silu(x @ params["w_gate"])
    return (gate * (x @ params["w_up"])) @ params["w_down"]
