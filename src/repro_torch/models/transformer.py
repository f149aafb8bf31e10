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
from repro_torch.distributed.sharding_rules import NULL_CTX
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


# ---------------------------------------------------------------------------
# parameter specs (consumed by configs/families.py and the dry run)
# ---------------------------------------------------------------------------


def _spec_for(names: list, nd: int, M, D):
    """The reference's spec of one leaf (its ``param_specs`` table): names
    the leaf's path, nd its rank in the reference's layout (stacked block
    leaves one more than here)."""
    name = names[-1]
    stacked = "blocks" in names[0]
    lead = (None,) if stacked else ()
    mk = lambda *tail: lead + tail
    if name in ("wq", "wk", "wv", "w_gate", "w_up"):
        if nd - len(lead) == 3:  # expert-stacked (E, d, f)
            return mk(M, D, None)
        return mk(D, M)
    if name in ("wo", "w_down"):
        if nd - len(lead) == 3:  # (E, f, d)
            return mk(M, D, None)
        return mk(M, D)
    if name in ("bq", "bk", "bv"):
        return mk(M)
    if name == "embed":
        # no-TP: shard the vocab rows, not d
        return (M, D) if M is not None else (D, None)
    if name == "lm_head":
        return (D, M)
    if name == "w_dkv":
        return mk(D, None)  # latent down-proj: small, fsdp only
    if name == "w_krope":
        return mk(None, None)
    if name in ("w_uk", "w_uv"):
        return mk(D, M)  # up-proj column = heads
    if name == "router":
        return mk(None, None)
    return mk(*([None] * (nd - len(lead))))


def param_specs(params, cfg: TransformerConfig, ctx, *, fsdp: bool = True) -> dict:
    """The reference's spec tree (``transformer.param_specs``) of an LM's
    params, in the reference's layout: ``blocks`` / ``dense_blocks`` one
    dict of stacked leaves, each spec with a ``None`` lead for the layer
    axis.  A spec is a tuple (one entry a dim: None, a mesh axis or a tuple
    of axes).

    TP (Megatron): wq/wk/wv/w_gate/w_up column-sharded on 'model'; wo/w_down
    row-sharded; embed/lm_head vocab-sharded; experts sharded on E.
    FSDP: the other matrix dim additionally shards over the 'fsdp' axes
    ('data').  ``params`` is a ``Transformer`` (or its ``param_tree``);
    :func:`layer_specs` gives the specs of its own per-layer leaves.
    """
    M = ctx.spec("model")[0]  # mesh axis name (or None off-mesh)
    D = ctx.spec("fsdp")[0] if fsdp else None  # weight-sharding axis
    tree = param_tree(params) if isinstance(params, Transformer) else params

    def walk(t, names, stacked_extra):
        if isinstance(t, dict):
            return {k: walk(v, names + [k], stacked_extra) for k, v in t.items()}
        return _spec_for(names, t.ndim + stacked_extra, M, D)

    out = {}
    for key, sub in tree.items():
        if key in ("blocks", "dense_blocks"):
            out[key] = walk(sub[0], [key], 1)  # one layer's leaves, stacked there
        else:
            out[key] = walk(sub, [key], 0)
    return out


def layer_specs(params, cfg: TransformerConfig, ctx, *, fsdp: bool = True) -> dict:
    """:func:`param_specs` on the port's own layout, a tree of
    ``param_tree(params)``'s structure: each layer of ``blocks`` /
    ``dense_blocks`` takes the stacked spec without its layer lead."""
    tree = param_tree(params) if isinstance(params, Transformer) else params
    specs = param_specs(tree, cfg, ctx, fsdp=fsdp)

    def drop_lead(s):
        return {k: drop_lead(v) for k, v in s.items()} if isinstance(s, dict) else s[1:]

    out = dict(specs)
    for key in ("blocks", "dense_blocks"):
        if key in tree:
            out[key] = [drop_lead(specs[key]) for _ in tree[key]]
    return out


def map_params(params: Transformer, fn) -> Transformer:
    """Replace every parameter ``p`` of ``params`` (named by its path in
    ``param_tree``, ``blocks/3/attn/wq``) with ``fn(name, p)``, a tensor
    (a DTensor, to shard the model), in place; returns ``params``."""
    for mod_name, mod in params.named_modules():
        for key, p in list(mod._parameters.items()):
            if p is None:
                continue
            name = (f"{mod_name}.{key}" if mod_name else key).replace(".", "/")
            new = fn(name, p)
            mod._parameters[key] = nn.Parameter(new, requires_grad=p.requires_grad)
    return params


def gather_fsdp(group, ctx):
    """A block's params with their 'fsdp' mesh axes gathered (Shard ->
    Replicate; the TP shards stay): the FSDP all-gather of a layer before
    its use, which the reference leaves to GSPMD.  Its backward is the
    grads' reduce-scatter.  Off a mesh, or on plain tensors, ``group``
    itself."""
    from torch.distributed.tensor import DTensor, Replicate

    if ctx.mesh is None:
        return group
    fsdp = set(ctx.rules.get("fsdp", ()))
    names = ctx.mesh.mesh_dim_names

    def gather(t):
        if hasattr(t, "items"):  # a dict or a ParameterDict
            return {k: gather(v) for k, v in t.items()}
        if not isinstance(t, DTensor):
            return t
        target = [Replicate() if names[i] in fsdp else pl for i, pl in enumerate(t.placements)]
        return t if target == list(t.placements) else t.redistribute(ctx.mesh, target)

    return gather(group)


def _block_apply(cfg: TransformerConfig, bp, x, positions, cache, cache_offset, ctx=NULL_CTX):
    """One transformer block -> (x, aux): aux the MoE layer's load-balance
    loss (float32), None for a dense MLP.  cache: this layer's slice of
    every cache entry, or None.  On a mesh the block's params are gathered
    over the FSDP axes first (:func:`gather_fsdp`)."""
    bp = gather_fsdp(bp, ctx)
    h = rms_norm(bp["attn_norm"], x)
    if cfg.attention == "mla":
        attn_out, _ = mla_apply(bp["attn"], cfg.mla_config, h, positions=positions,
                                latent_cache=cache, cache_offset=cache_offset)
    else:
        attn_out, _ = attention_apply(bp["attn"], cfg.attn_config, h, positions=positions,
                                      kv_cache=cache, cache_offset=cache_offset)
    x = x + attn_out
    x = ctx.constrain(x, "batch", None, None)
    h = rms_norm(bp["mlp_norm"], x)
    if "moe" in bp:
        # decode (one token against a cache) runs dropless, as the
        # reference does: capacity drops would part decode from prefill
        dropless = cache is not None and x.shape[1] == 1
        on_mesh = {} if ctx.mesh is None else {"ctx": ctx}
        ff, aux = moe.moe_apply(bp["moe"], cfg.moe, h,
                                capacity_factor=-1.0 if dropless else 0.0, **on_mesh)
        return ctx.constrain(x + ff, "batch", None, None), aux
    return ctx.constrain(x + mlp_apply(bp["mlp"], h), "batch", None, None), None


def _blocks_apply(cfg: TransformerConfig, blocks, x, positions, aux, ctx=NULL_CTX):
    """Blocks in order over fresh tokens (no cache), each checkpointed when
    ``cfg.remat``: the reference's scan body under ``jax.checkpoint``.
    Returns (x, aux + the blocks' aux)."""
    for bp in blocks:
        if cfg.remat:
            x, a = checkpoint(_block_apply, cfg, bp, x, positions, None, None, ctx,
                              use_reentrant=False)
        else:
            x, a = _block_apply(cfg, bp, x, positions, None, None, ctx)
        if a is not None:
            aux = aux + a
    return x, aux


def _embed(params: Transformer, tokens, ctx):
    """The token rows of ``embed``; on a mesh the rows of the
    vocab-sharded (FSDP-gathered) table, each rank's own rows looked up
    there and summed over the vocab shards (``segment.sharded_lookup``)."""
    if ctx.mesh is None:
        return params.embed[tokens]
    from repro_torch.models.segment import sharded_lookup

    return sharded_lookup(gather_fsdp({"e": params.embed}, ctx)["e"], tokens)


def forward(params: Transformer, cfg: TransformerConfig, tokens, *, positions=None, cache=None,
            cache_offset=None, ctx=NULL_CTX):
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

    ``ctx`` (``distributed.sharding_rules``): on a mesh the params are
    DTensors (``families.LMArch.build_cell`` places them by
    :func:`layer_specs`), tokens a DTensor sharded over the batch axes, and
    the activations are constrained where the reference constrains them;
    with ``NULL_CTX`` (the default) nothing changes.
    """
    if ctx.mesh is not None:
        from torch.distributed.tensor import DTensor
        from repro_torch.distributed.sharding_rules import implicit_replication

        if not isinstance(tokens, DTensor):
            raise ValueError("forward on a mesh takes tokens as a DTensor")
        with implicit_replication():
            return _forward(params, cfg, tokens, positions, cache, cache_offset, ctx,
                            tokens.device)
    dev = params.embed.device
    tokens = torch.as_tensor(tokens).to(device=dev, dtype=torch.long)
    return _forward(params, cfg, tokens, positions, cache, cache_offset, ctx, dev)


def _forward(params, cfg, tokens, positions, cache, cache_offset, ctx, dev):
    S = tokens.shape[1]
    compute_dtype = getattr(torch, cfg.compute_dtype)
    if positions is None:
        start = cache_offset if cache_offset is not None else 0
        ar = torch.arange(S, device=dev)
        if isinstance(start, torch.Tensor) and start.ndim == 1:  # per-row offsets
            positions = start.to(dev)[:, None] + ar[None, :]
        else:
            positions = int(start) + ar
    x = _embed(params, tokens, ctx).to(compute_dtype)
    x = ctx.constrain(x, "batch", None, None)
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    blocks = list(params.dense_blocks) + list(params.blocks)
    K = cfg.remat_group
    if cache is not None:
        for l, bp in enumerate(blocks):
            layer_cache = {name: c[l] for name, c in cache.items()}
            x, a = _block_apply(cfg, bp, x, positions, layer_cache, cache_offset, ctx)
            if a is not None:
                aux = aux + a
    elif cfg.remat and K > 1 and len(params.blocks) % K == 0:
        n_dense = len(params.dense_blocks)
        x, aux = _blocks_apply(cfg, blocks[:n_dense], x, positions, aux, ctx)
        for g in range(n_dense, len(blocks), K):
            x, aux = checkpoint(_blocks_apply, cfg, blocks[g:g + K], x, positions, aux, ctx,
                                use_reentrant=False)
    else:
        x, aux = _blocks_apply(cfg, blocks, x, positions, aux, ctx)
    top = gather_fsdp({"norm": params.final_norm,
                       "head": params.embed.T if cfg.tie_embeddings else params.lm_head}, ctx)
    x = rms_norm(top["norm"], x)
    logits = x @ top["head"].to(compute_dtype)
    logits = ctx.constrain(logits, "batch", None, "vocab")
    return logits, cache, aux


@torch.no_grad()
def apply(params: Transformer, cfg: TransformerConfig, tokens, *, positions=None, cache=None,
          cache_offset=None, ctx=NULL_CTX):
    """:func:`forward` without gradients: the serving entry
    (``ServeEngine``)."""
    return forward(params, cfg, tokens, positions=positions, cache=cache,
                   cache_offset=cache_offset, ctx=ctx)


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
