"""Decoder-only LM: the port of ``repro.models.transformer``.

One config class spans the reference's five LMs: dense GQA (SmolLM,
CodeQwen, Qwen2 — ``qkv_bias`` toggles the Qwen variant), DeepSeekMoE
(fine-grained routed experts + shared experts, the first
``moe.first_k_dense`` layers dense) and DeepSeek-V2-Lite (MLA attention +
MoE).  The params are an ``nn.Module`` holding one block per layer (the
reference stacks them for ``scan``), the dense head layers of a MoE model
in ``dense_blocks`` before ``blocks``; ``forward`` runs the layers in a
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
from repro_torch.models import moe
from repro_torch.models.layers import (
    AttentionConfig,
    MLAConfig,
    _init_dense,
    attention_apply,
    mla_apply,
    mla_init,
    mlp_apply,
    rms_norm,
)
from repro_torch.models.moe import MoEConfig, moe_init


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
    moe: Optional[MoEConfig] = None
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

    @property
    def mla_config(self) -> MLAConfig:
        return MLAConfig(
            d_model=self.d_model,
            n_heads=self.n_heads,
            kv_lora_rank=self.mla_kv_lora_rank,
            qk_nope_head_dim=self.mla_qk_nope_head_dim,
            qk_rope_head_dim=self.mla_qk_rope_head_dim,
            v_head_dim=self.mla_v_head_dim,
            rope_theta=self.rope_theta,
            q_chunk=self.q_chunk,
            kv_chunk=self.kv_chunk,
        )

    @property
    def n_dense_layers(self) -> int:
        return self.moe.first_k_dense if self.moe else self.n_layers

    @property
    def n_scan_layers(self) -> int:
        return self.n_layers - (self.moe.first_k_dense if self.moe else 0)

    def dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def _attn_params(self) -> int:
        d = self.d_model
        if self.attention == "mla":
            qk = self.mla_qk_nope_head_dim + self.mla_qk_rope_head_dim
            return (d * self.n_heads * qk
                    + d * (self.mla_kv_lora_rank + self.mla_qk_rope_head_dim)
                    + self.mla_kv_lora_rank * self.n_heads
                    * (self.mla_qk_nope_head_dim + self.mla_v_head_dim)
                    + self.n_heads * self.mla_v_head_dim * d)
        return d * self.head_dim * (self.n_heads * 2 + self.n_kv_heads * 2)

    def num_params(self) -> int:
        """Total parameter count N (the reference's ``num_params``;
        MODEL_FLOPS = 6 N D): norms and biases are not counted, the router
        is."""
        d = self.d_model
        attn = self._attn_params()
        total = self.vocab * d * (1 if self.tie_embeddings else 2)
        per_dense = attn + 3 * d * self.d_ff
        if self.moe is None:
            return total + self.n_layers * per_dense
        m = self.moe
        moe_ff = 3 * d * m.d_ff_expert * (m.num_experts + m.n_shared) + d * m.num_experts
        return total + m.first_k_dense * per_dense + self.n_scan_layers * (attn + moe_ff)

    def num_active_params(self) -> int:
        """Parameters a token activates (MoE: its top-k experts and the
        shared ones), the reference's ``num_active_params``."""
        if self.moe is None:
            return self.num_params()
        d = self.d_model
        attn = self._attn_params()
        m = self.moe
        active_ff = 3 * d * m.d_ff_expert * (m.top_k + m.n_shared) + d * m.num_experts
        total = self.vocab * d * (1 if self.tie_embeddings else 2)
        total += m.first_k_dense * (attn + 3 * d * self.d_ff)
        return total + self.n_scan_layers * (attn + active_ff)


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _pdict(tensors: dict) -> nn.ParameterDict:
    """A group of params; a nested dict (MLA's ``kv_norm``, MoE's
    ``shared``) becomes a nested ``ParameterDict``, a submodule."""
    return nn.ParameterDict({k: _pdict(v) if isinstance(v, dict) else _param(v)
                             for k, v in tensors.items()})


def _blocks(blocks: list[dict]) -> nn.ModuleList:
    return nn.ModuleList(nn.ModuleDict({name: _pdict(group) for name, group in block.items()})
                         for block in blocks)


def _tree(group) -> dict:
    return {k: _tree(v) if isinstance(v, nn.ParameterDict) else v for k, v in group.items()}


class Transformer(nn.Module):
    """The params of an LM, with the reference's names: ``embed`` (V, d),
    ``final_norm["scale"]``, ``lm_head`` (d, V) unless tied, and per layer
    a block with ``attn_norm``, ``attn`` (GQA: wq, wk, wv, wo [, bq, bk,
    bv]; MLA: wq, w_dkv, w_krope, kv_norm, w_uk, w_uv, wo), ``mlp_norm``
    and ``mlp`` (w_gate, w_up, w_down) or ``moe`` (router, w_gate, w_up,
    w_down [, shared]).  A MoE model's first ``first_k_dense`` layers are
    ``dense_blocks`` (empty otherwise), the rest ``blocks``."""

    def __init__(self, embed: torch.Tensor, final_norm: torch.Tensor, blocks: list[dict],
                 lm_head: torch.Tensor | None = None, dense_blocks: list[dict] = ()):
        super().__init__()
        self.embed = _param(embed)
        self.final_norm = _pdict({"scale": final_norm})
        self.lm_head = None if lm_head is None else _param(lm_head)
        self.dense_blocks = _blocks(list(dense_blocks))
        self.blocks = _blocks(blocks)


def param_tree(params: Transformer) -> dict:
    """The params as a tree whose leaves are the module's own parameters:
    ``embed``, ``final_norm``, ``lm_head`` unless tied, ``dense_blocks``
    (a MoE model's) and ``blocks`` as lists of per-layer dicts — the
    reference's pytree with its stacked blocks split by layer
    (``common.tree`` flattens it in the reference's order)."""
    tree = {
        "embed": params.embed,
        "final_norm": {"scale": params.final_norm["scale"]},
        "blocks": [{g: _tree(pd) for g, pd in blk.items()} for blk in params.blocks],
    }
    if len(params.dense_blocks):
        tree["dense_blocks"] = [{g: _tree(pd) for g, pd in blk.items()}
                                for blk in params.dense_blocks]
    if params.lm_head is not None:
        tree["lm_head"] = params.lm_head
    return tree


def init(cfg: TransformerConfig, seed: int = 0, device=None) -> Transformer:
    """Random params with the reference's shapes and scales (normal x
    1/sqrt(fan_in), embed and router x 0.02, norm scales 1, biases 0; the
    router in float32 whatever ``param_dtype`` is), drawn from a seeded
    ``torch.Generator`` on the device.  Not JAX's numbers: tests that
    compare the two packages carry the reference's params across with
    ``convert.transformer_from_jax``."""
    dev = resolve_device(device)
    dtype = cfg.dtype()
    gen = torch.Generator(device=dev).manual_seed(seed)
    dense = lambda shape, scale=None: _init_dense(gen, shape, dtype, scale)
    ones = lambda n: torch.ones(n, dtype=dtype, device=dev)
    zeros = lambda n: torch.zeros(n, dtype=dtype, device=dev)
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def block(moe_layer: bool) -> dict:
        if cfg.attention == "mla":
            attn = mla_init(gen, cfg.mla_config, dtype)
        else:
            attn = {"wq": dense((d, H * hd)), "wk": dense((d, KV * hd)),
                    "wv": dense((d, KV * hd)), "wo": dense((H * hd, d))}
            if cfg.qkv_bias:
                attn.update(bq=zeros(H * hd), bk=zeros(KV * hd), bv=zeros(KV * hd))
        p = {"attn_norm": {"scale": ones(d)}, "attn": attn, "mlp_norm": {"scale": ones(d)}}
        if moe_layer:
            p["moe"] = moe_init(gen, d, cfg.moe, dtype)
        else:
            p["mlp"] = {"w_gate": dense((d, cfg.d_ff)), "w_up": dense((d, cfg.d_ff)),
                        "w_down": dense((cfg.d_ff, d))}
        return p

    embed = dense((cfg.vocab, d), scale=0.02)
    dense_blocks = [block(False) for _ in range(cfg.n_dense_layers)] if cfg.moe else []
    blocks = [block(cfg.moe is not None) for _ in range(cfg.n_scan_layers)]
    lm_head = None if cfg.tie_embeddings else dense((d, cfg.vocab))
    return Transformer(embed, ones(d), blocks, lm_head, dense_blocks)


def _block_apply(cfg: TransformerConfig, bp, x, positions, cache, cache_offset):
    """One transformer block -> (x, aux): aux the MoE layer's load-balance
    loss (float32), None for a dense MLP.  cache: this layer's slice of
    every cache entry, or None."""
    h = rms_norm(bp["attn_norm"], x)
    if cfg.attention == "mla":
        attn_out, _ = mla_apply(bp["attn"], cfg.mla_config, h, positions=positions,
                                latent_cache=cache, cache_offset=cache_offset)
    else:
        attn_out, _ = attention_apply(bp["attn"], cfg.attn_config, h, positions=positions,
                                      kv_cache=cache, cache_offset=cache_offset)
    x = x + attn_out
    h = rms_norm(bp["mlp_norm"], x)
    if "moe" in bp:
        # decode (one token against a cache) runs dropless, as the
        # reference does: capacity drops would part decode from prefill
        dropless = cache is not None and x.shape[1] == 1
        ff, aux = moe.moe_apply(bp["moe"], cfg.moe, h,
                                capacity_factor=-1.0 if dropless else 0.0)
        return x + ff, aux
    return x + mlp_apply(bp["mlp"], h), None


def _blocks_apply(cfg: TransformerConfig, blocks, x, positions, aux):
    """Blocks in order over fresh tokens (no cache), each checkpointed when
    ``cfg.remat``: the reference's scan body under ``jax.checkpoint``.
    Returns (x, aux + the blocks' aux)."""
    for bp in blocks:
        if cfg.remat:
            x, a = checkpoint(_block_apply, cfg, bp, x, positions, None, None,
                              use_reentrant=False)
        else:
            x, a = _block_apply(cfg, bp, x, positions, None, None)
        if a is not None:
            aux = aux + a
    return x, aux


def forward(params: Transformer, cfg: TransformerConfig, tokens, *, positions=None, cache=None,
            cache_offset=None):
    """tokens (B, S) integer -> (logits (B, S, V), cache, aux_loss), with
    gradients where autograd records.

    cache: ``make_cache`` output, stacked over all layers (``dense_blocks``
    first), updated IN PLACE and returned.  cache_offset: the position of
    tokens[:, 0] — an int, or a (B,) tensor of per-row offsets.  aux_loss
    is the float32 sum of the MoE layers' load-balance losses (0 without
    MoE).  Without a cache, ``cfg.remat`` checkpoints every block, and
    ``cfg.remat_group`` K > 1 dividing the depth of ``blocks`` checkpoints
    groups of K of them as well (the reference's two-level scan: only group
    boundaries are saved, and a group's backward recomputes it with its
    blocks checkpointed once more).
    """
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
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    blocks = list(params.dense_blocks) + list(params.blocks)
    K = cfg.remat_group
    if cache is not None:
        for l, bp in enumerate(blocks):
            layer_cache = {name: c[l] for name, c in cache.items()}
            x, a = _block_apply(cfg, bp, x, positions, layer_cache, cache_offset)
            if a is not None:
                aux = aux + a
    elif cfg.remat and K > 1 and len(params.blocks) % K == 0:
        n_dense = len(params.dense_blocks)
        x, aux = _blocks_apply(cfg, blocks[:n_dense], x, positions, aux)
        for g in range(n_dense, len(blocks), K):
            x, aux = checkpoint(_blocks_apply, cfg, blocks[g:g + K], x, positions, aux,
                                use_reentrant=False)
    else:
        x, aux = _blocks_apply(cfg, blocks, x, positions, aux)
    x = rms_norm(params.final_norm, x)
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    logits = x @ head.to(compute_dtype)
    return logits, cache, aux


@torch.no_grad()
def apply(params: Transformer, cfg: TransformerConfig, tokens, *, positions=None, cache=None,
          cache_offset=None):
    """:func:`forward` without gradients: the serving entry
    (``ServeEngine``)."""
    return forward(params, cfg, tokens, positions=positions, cache=cache,
                   cache_offset=cache_offset)


def make_cache(cfg: TransformerConfig, batch: int, max_seq: int, dtype=torch.bfloat16,
               device=None) -> dict:
    """Stacked-over-layers cache of zeros: {"k", "v"} (L, B, Smax, KV, hd),
    or for MLA {"latent": (L, B, Smax, r), "k_rope": (L, B, Smax, dr)}."""
    dev = resolve_device(device)
    L = cfg.n_layers
    if cfg.attention == "mla":
        return {"latent": torch.zeros((L, batch, max_seq, cfg.mla_kv_lora_rank), dtype=dtype,
                                      device=dev),
                "k_rope": torch.zeros((L, batch, max_seq, cfg.mla_qk_rope_head_dim), dtype=dtype,
                                      device=dev)}
    shape = (L, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}
