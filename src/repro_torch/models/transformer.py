"""Decoder-only LM for the dense GQA architectures: the port of
``repro.models.transformer``.

One config class as in the reference; the port runs its dense GQA members
(SmolLM, CodeQwen, Qwen2 — ``qkv_bias`` toggles the Qwen variant).  A MoE
block or ``attention="mla"`` raises ``NotImplementedError`` (ROADMAP item
10).  The params are an ``nn.Module`` holding one block per layer (the
reference stacks them for ``scan``); ``forward`` runs the layers in a
Python loop and carries gradients (``remat`` / ``remat_group`` checkpoint
blocks or groups of blocks, as the reference's scan does), and ``apply``
is the same forward under ``torch.no_grad`` for serving.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.common.utils import resolve_device
from repro_torch.models.layers import AttentionConfig, attention_apply, mlp_apply, rms_norm

_ROADMAP_MOE_MLA = "ROADMAP item 10 (MoE and MLA are not ported)"


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str = "lm"
    n_layers: int = 12
    d_model: int = 768
    n_heads: int = 12
    n_kv_heads: int = 12
    head_dim: int = 64
    d_ff: int = 3072
    vocab: int = 32_000
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    attention: str = "gqa"  # 'gqa' | 'mla'
    mla_kv_lora_rank: int = 512
    mla_qk_nope_head_dim: int = 128
    mla_qk_rope_head_dim: int = 64
    mla_v_head_dim: int = 128
    moe: Optional[object] = None
    q_chunk: int = 0  # chunked (flash, K3) attention for prefill longer than this
    kv_chunk: int = 2048
    remat: bool = False
    remat_group: int = 0
    param_dtype: str = "float32"
    compute_dtype: str = "float32"

    @property
    def attn_config(self) -> AttentionConfig:
        return AttentionConfig(
            d_model=self.d_model,
            n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads,
            head_dim=self.head_dim,
            qkv_bias=self.qkv_bias,
            rope_theta=self.rope_theta,
            q_chunk=self.q_chunk,
            kv_chunk=self.kv_chunk,
        )

    def dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def num_params(self) -> int:
        """Total parameter count N of the dense GQA model (the reference's
        ``num_params``; MODEL_FLOPS = 6 N D)."""
        d = self.d_model
        attn = d * self.head_dim * (self.n_heads * 2 + self.n_kv_heads * 2)
        return self.vocab * d * (1 if self.tie_embeddings else 2) + self.n_layers * (
            attn + 3 * d * self.d_ff)


def check_supported(cfg: TransformerConfig) -> None:
    if cfg.moe is not None:
        raise NotImplementedError(f"{cfg.name}: MoE blocks; {_ROADMAP_MOE_MLA}")
    if cfg.attention != "gqa":
        raise NotImplementedError(f"{cfg.name}: attention={cfg.attention!r}; {_ROADMAP_MOE_MLA}")


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _pdict(tensors: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: _param(v) for k, v in tensors.items()})


class Transformer(nn.Module):
    """The params of a dense GQA LM, with the reference's names: ``embed``
    (V, d), ``final_norm["scale"]``, ``lm_head`` (d, V) unless tied, and
    ``blocks[l]`` with ``attn_norm``, ``attn`` (wq, wk, wv, wo [, bq, bk,
    bv]), ``mlp_norm`` and ``mlp`` (w_gate, w_up, w_down)."""

    def __init__(self, embed: torch.Tensor, final_norm: torch.Tensor, blocks: list[dict],
                 lm_head: torch.Tensor | None = None):
        super().__init__()
        self.embed = _param(embed)
        self.final_norm = _pdict({"scale": final_norm})
        self.lm_head = None if lm_head is None else _param(lm_head)
        self.blocks = nn.ModuleList(
            nn.ModuleDict({name: _pdict(group) for name, group in block.items()})
            for block in blocks
        )


def param_tree(params: Transformer) -> dict:
    """The params as a tree whose leaves are the module's own parameters:
    ``embed``, ``final_norm``, ``lm_head`` unless tied, and ``blocks`` as a
    list of per-layer dicts — the reference's pytree with its stacked
    blocks split by layer (``common.tree`` flattens it in the reference's
    order)."""
    tree = {
        "embed": params.embed,
        "final_norm": {"scale": params.final_norm["scale"]},
        "blocks": [{g: dict(pd.items()) for g, pd in blk.items()} for blk in params.blocks],
    }
    if params.lm_head is not None:
        tree["lm_head"] = params.lm_head
    return tree


def init(cfg: TransformerConfig, seed: int = 0, device=None) -> Transformer:
    """Random params with the reference's shapes and scales (normal x
    1/sqrt(fan_in), embed x 0.02, norm scales 1, biases 0), drawn from a
    seeded ``torch.Generator`` on the device.  Not JAX's numbers: tests that
    compare the two packages carry the reference's params across with
    ``convert.transformer_from_jax``."""
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = cfg.dtype()
    gen = torch.Generator(device=dev).manual_seed(seed)

    def dense(shape, scale=None):
        scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
        w = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32) * scale
        return w.to(dtype)

    ones = lambda n: torch.ones(n, dtype=dtype, device=dev)
    zeros = lambda n: torch.zeros(n, dtype=dtype, device=dev)
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    embed = dense((cfg.vocab, d), scale=0.02)
    blocks = []
    for _ in range(cfg.n_layers):
        attn = {"wq": dense((d, H * hd)), "wk": dense((d, KV * hd)), "wv": dense((d, KV * hd)),
                "wo": dense((H * hd, d))}
        if cfg.qkv_bias:
            attn.update(bq=zeros(H * hd), bk=zeros(KV * hd), bv=zeros(KV * hd))
        mlp = {"w_gate": dense((d, cfg.d_ff)), "w_up": dense((d, cfg.d_ff)),
               "w_down": dense((cfg.d_ff, d))}
        blocks.append({"attn_norm": {"scale": ones(d)}, "attn": attn,
                       "mlp_norm": {"scale": ones(d)}, "mlp": mlp})
    lm_head = None if cfg.tie_embeddings else dense((d, cfg.vocab))
    return Transformer(embed, ones(d), blocks, lm_head)


def _block_apply(cfg: TransformerConfig, bp, x, positions, cache, cache_offset):
    """One transformer block.  cache: this layer's {"k", "v"} or None."""
    h = rms_norm(bp["attn_norm"], x)
    attn_out, _ = attention_apply(bp["attn"], cfg.attn_config, h, positions=positions,
                                  kv_cache=cache, cache_offset=cache_offset)
    x = x + attn_out
    h = rms_norm(bp["mlp_norm"], x)
    return x + mlp_apply(bp["mlp"], h)


def _blocks_apply(cfg: TransformerConfig, blocks, x, positions):
    """Blocks in order over fresh tokens (no cache), each checkpointed when
    ``cfg.remat``: the reference's scan body under ``jax.checkpoint``."""
    for bp in blocks:
        if cfg.remat:
            x = checkpoint(_block_apply, cfg, bp, x, positions, None, None, use_reentrant=False)
        else:
            x = _block_apply(cfg, bp, x, positions, None, None)
    return x


def forward(params: Transformer, cfg: TransformerConfig, tokens, *, positions=None, cache=None,
            cache_offset=None):
    """tokens (B, S) integer -> (logits (B, S, V), cache, aux_loss), with
    gradients where autograd records.

    cache: ``make_cache`` output, {"k": (L, B, Smax, KV, hd), "v": ...},
    updated IN PLACE and returned.  cache_offset: the position of
    tokens[:, 0] — an int, or a (B,) tensor of per-row offsets.  aux_loss
    is 0.0 (no MoE).  Without a cache, ``cfg.remat`` checkpoints every
    block, and ``cfg.remat_group`` K > 1 dividing the depth checkpoints
    groups of K blocks as well (the reference's two-level scan: only group
    boundaries are saved, and a group's backward recomputes it with its
    blocks checkpointed once more).
    """
    check_supported(cfg)
    dev = params.embed.device
    tokens = torch.as_tensor(tokens).to(device=dev, dtype=torch.long)
    S = tokens.shape[1]
    compute_dtype = getattr(torch, cfg.compute_dtype)
    if positions is None:
        start = cache_offset if cache_offset is not None else 0
        ar = torch.arange(S, device=dev)
        if isinstance(start, torch.Tensor) and start.ndim == 1:  # per-row offsets
            positions = start.to(dev)[:, None] + ar[None, :]
        else:
            positions = int(start) + ar
    x = params.embed[tokens].to(compute_dtype)
    blocks = list(params.blocks)
    K = cfg.remat_group
    if cache is not None:
        for l, bp in enumerate(blocks):
            layer_cache = {"k": cache["k"][l], "v": cache["v"][l]}
            x = _block_apply(cfg, bp, x, positions, layer_cache, cache_offset)
    elif cfg.remat and K > 1 and len(blocks) % K == 0:
        for g in range(0, len(blocks), K):
            x = checkpoint(_blocks_apply, cfg, blocks[g:g + K], x, positions,
                           use_reentrant=False)
    else:
        x = _blocks_apply(cfg, blocks, x, positions)
    x = rms_norm(params.final_norm, x)
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    logits = x @ head.to(compute_dtype)
    return logits, cache, 0.0


@torch.no_grad()
def apply(params: Transformer, cfg: TransformerConfig, tokens, *, positions=None, cache=None,
          cache_offset=None):
    """:func:`forward` without gradients: the serving entry
    (``ServeEngine``)."""
    return forward(params, cfg, tokens, positions=positions, cache=cache,
                   cache_offset=cache_offset)


def make_cache(cfg: TransformerConfig, batch: int, max_seq: int, dtype=torch.bfloat16,
               device=None) -> dict:
    """Stacked-over-layers KV cache of zeros."""
    check_supported(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}
