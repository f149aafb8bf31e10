"""Transformer building blocks for dense GQA: the port of ``repro.models.layers``.

RMSNorm, RoPE, GQA attention (with optional QKV bias, Qwen style) and the
SwiGLU MLP, functional as in the reference: a layer's params are a mapping
(``nn.ParameterDict``) with the reference's names and (d_in, d_out) weight
layout, so ``x @ params["wq"]`` reads as it does there.  Norms and softmax
run in float32.  Long sequences take ``chunked_attention``, which is K3 on
the card (``ops.flash_attention_bhsd``) and its plain version on the CPU.

MLA (``mla_apply``) is not ported: it raises, naming ROADMAP item 10.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.kernels import ops

_ROADMAP_MLA = "MLA attention is not ported (ROADMAP item 10: MoE and MLA)"


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
    """q (B, Sq, H, hd), k/v (B, Skv, H, hd) -> (B, Sq, H, hd).  f32 softmax."""
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
    in ``attention_apply``, that this path is taken (the kernel tiles on its
    own).  q and k/v must have one length (self-attention over fresh
    tokens, as every caller passes them) and one head dim: a v head dim
    other than q's is MLA's case, which K3 does not take either.
    """
    if v.shape[-1] != q.shape[-1]:
        raise NotImplementedError(f"chunked_attention: v head dim {v.shape[-1]} != q head dim "
                                  f"{q.shape[-1]}; {_ROADMAP_MLA}")
    return ops.flash_attention_bhsd(q, k, v, causal=causal, scale=scale)


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
    q = apply_rope(q.reshape(B, S, H, hd), positions, cfg.rope_theta)
    k = apply_rope(k.reshape(B, S, KV, hd), positions, cfg.rope_theta)
    v = v.reshape(B, S, KV, hd)

    if kv_cache is None:
        out = _self_attention(cfg, q, k, v, causal)
        return out.reshape(B, S, H * hd) @ params["wo"], None

    ck, cv = kv_cache["k"], kv_cache["v"]
    off = cache_offset if cache_offset is not None else 0
    ar = torch.arange(S, device=x.device)
    if isinstance(off, torch.Tensor) and off.ndim == 1:  # per-row offsets (slots)
        rows = torch.arange(B, device=x.device)[:, None]
        cols = off.to(device=x.device, dtype=torch.long)[:, None] + ar[None, :]
        ck[rows, cols] = k.to(ck.dtype)
        cv[rows, cols] = v.to(cv.dtype)
        q_pos = cols  # (B, S)
    else:
        o = int(off)
        ck[:, o: o + S] = k.to(ck.dtype)
        cv[:, o: o + S] = v.to(cv.dtype)
        q_pos = (o + ar)[None, :].expand(B, S)
        # whole-sequence prefill: nothing precedes these tokens, so
        # attention over the fresh k/v is exact and never scores the cache
        if isinstance(off, int) and off == 0 and S > 1:
            out = _self_attention(cfg, q, k, v, causal)
            return out.reshape(B, S, H * hd) @ params["wo"], kv_cache
    S_kv = ck.shape[1]
    kv_pos = torch.arange(S_kv, device=x.device)
    # valid cache extent + causality, per row: kv <= q position
    ok = kv_pos[None, None, :] <= q_pos[:, :, None]  # (B, S, S_kv)
    if not causal:
        ok = kv_pos[None, None, :] <= q_pos[:, -1:, None]
    # grouped einsum: the repeated KV is never materialized
    G = H // KV
    qg = q.reshape(B, S, KV, G, hd)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, ck.to(x.dtype)).to(torch.float32)
    logits = logits / math.sqrt(hd)
    logits = torch.where(ok[:, None, None], logits, float("-inf"))
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, cv.to(x.dtype)).reshape(B, S, H * hd)
    return out @ params["wo"], kv_cache


def mla_apply(*args, **kwargs):
    raise NotImplementedError(_ROADMAP_MLA)


def mlp_apply(params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: silu(x W_gate) * (x W_up), then W_down."""
    gate = torch.nn.functional.silu(x @ params["w_gate"])
    return (gate * (x @ params["w_up"])) @ params["w_down"]
