"""The architectures the port runs, with their published configs.

A copy of the entries of ``repro.configs.registry`` (sources as there):

  codeqwen1.5-7b        [hf:Qwen/CodeQwen1.5-7B]
  qwen2-72b             [arXiv:2407.10671]
  smollm-360m           [hf:HuggingFaceTB/SmolLM-360M]
  deepseek-moe-16b      [arXiv:2401.06066]
  deepseek-v2-lite-16b  [arXiv:2405.04434]
  autoint               [arXiv:1810.11921]
  din                   [arXiv:1706.06978]
  sasrec                [arXiv:1808.09781]
  xdeepfm               [arXiv:1803.05170]
  dimenet               [arXiv:2003.03123]

with the reference's cell overrides (``serving_config``,
``training_config``, ``gnn_cell_config``), its reduced configs
(``reduced_config``, ``reduced_recsys_config``, ``reduced_gnn_config``),
the recsys cells' batch sizes (``RECSYS_CELLS``) and candidate widths
(``EMBED_DIM_RETRIEVAL``), and the GNN cells' shapes (``GNN_CELLS``).  The
cells themselves, their sharding and ``build_cell`` are in
``configs/families.py``.
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.dimenet import DimeNetConfig
from repro_torch.models.moe import MoEConfig
from repro_torch.models.recsys import AutoIntConfig, DINConfig, SASRecConfig, XDeepFMConfig
from repro_torch.models.transformer import TransformerConfig

# Criteo-style vocab mix for the 39-field archs: 13 integer-bucket fields
# (small vocab) + 26 categorical fields (large, hash-bucketed), ~26M rows.
CRITEO39_VOCABS = tuple([1000] * 13 + [1_000_000] * 26)

_CONFIGS = {
    # 32L d=4096 32H (GQA kv=32 => MHA-style kv) d_ff=13440 vocab=92416,
    # QKV bias (qwen1.5 arch)
    "codeqwen1.5-7b": TransformerConfig(
        name="codeqwen1.5-7b", n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32,
        head_dim=128, d_ff=13440, vocab=92416, qkv_bias=True, rope_theta=1_000_000.0,
    ),
    # 80L d=8192 64H GQA kv=8 d_ff=29568 vocab=152064, QKV bias
    "qwen2-72b": TransformerConfig(
        name="qwen2-72b", n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
        head_dim=128, d_ff=29568, vocab=152064, qkv_bias=True, rope_theta=1_000_000.0,
    ),
    # 32L d=960 15H GQA kv=5 d_ff=2560 vocab=49152 (llama-arch small, tied
    # embeddings)
    "smollm-360m": TransformerConfig(
        name="smollm-360m", n_layers=32, d_model=960, n_heads=15, n_kv_heads=5,
        head_dim=64, d_ff=2560, vocab=49152, tie_embeddings=True, rope_theta=10_000.0,
    ),
    # 28L d=2048 16H (kv=16) expert d_ff=1408 vocab=102400, 2 shared + 64
    # routed top-6, first layer dense (dense d_ff=10944)
    "deepseek-moe-16b": TransformerConfig(
        name="deepseek-moe-16b", n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
        head_dim=128, d_ff=10944, vocab=102400, rope_theta=10_000.0,
        moe=MoEConfig(num_experts=64, top_k=6, d_ff_expert=1408, n_shared=2, first_k_dense=1,
                      capacity_factor=1.25),
    ),
    # 27L d=2048 16H MLA kv_lora=512 rope_dim=64, expert d_ff=1408
    # vocab=102400, 2 shared + 64 routed top-6, first layer dense (the HF /
    # paper V2-Lite config, as the reference follows it)
    "deepseek-v2-lite-16b": TransformerConfig(
        name="deepseek-v2-lite-16b", n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
        head_dim=128, d_ff=10944, vocab=102400, attention="mla", mla_kv_lora_rank=512,
        mla_qk_nope_head_dim=128, mla_qk_rope_head_dim=64, mla_v_head_dim=128,
        rope_theta=10_000.0,
        moe=MoEConfig(num_experts=64, top_k=6, d_ff_expert=1408, n_shared=2, first_k_dense=1,
                      capacity_factor=1.25),
    ),
}
_RECSYS = {
    "autoint": AutoIntConfig(name="autoint", n_sparse=39, embed_dim=16, n_attn_layers=3,
                             n_heads=2, d_attn=32, vocab_sizes=CRITEO39_VOCABS),
    "din": DINConfig(name="din", embed_dim=18, seq_len=100, attn_mlp=(80, 40), mlp=(200, 80),
                     n_items=10_000_000, n_context=8, context_vocab=100_000),
    "sasrec": SASRecConfig(name="sasrec", embed_dim=50, n_blocks=2, n_heads=1, seq_len=50,
                           n_items=10_000_000),
    "xdeepfm": XDeepFMConfig(name="xdeepfm", n_sparse=39, embed_dim=10,
                             cin_layers=(200, 200, 200), mlp=(400, 400),
                             vocab_sizes=CRITEO39_VOCABS),
}
_GNN = {
    "dimenet": DimeNetConfig(name="dimenet", n_blocks=6, d_hidden=128, n_bilinear=8,
                             n_spherical=7, n_radial=6),
}
ARCH_IDS = tuple(_CONFIGS)
RECSYS_ARCH_IDS = tuple(_RECSYS)
GNN_ARCH_IDS = tuple(_GNN)
#: the retrieval_cand cell's candidate width a recsys arch (the reference's
#: ``embed_dim_retrieval or 64``)
EMBED_DIM_RETRIEVAL = {"autoint": 64, "din": 18, "sasrec": 50, "xdeepfm": 64}
#: the reference's recsys cells (``families.py`` ``RECSYS_CELLS``): kind,
#: global batch, and the retrieval cell's candidate count
RECSYS_CELLS = {
    "train_batch": {"kind": "train", "global_batch": 65_536},
    "serve_p99": {"kind": "forward", "global_batch": 512},
    "serve_bulk": {"kind": "forward", "global_batch": 262_144},
    "retrieval_cand": {"kind": "retrieval", "global_batch": 1, "n_candidates": 1_000_000},
}
#: the reference's GNN cells (``families.py`` ``GNN_CELLS``): kind, global
#: batch and shapes (``fanout`` the sampler's per hop; ``triplet_cap`` the
#: cap of ``build_triplets``; ``n_loc`` / ``e_loc`` a halo partition's)
GNN_CELLS = {
    "full_graph_sm": {"kind": "train", "n_nodes": 2708, "n_edges": 10556, "d_feat": 1433,
                      "triplet_cap": 8},
    "minibatch_lg": {"kind": "train", "n_nodes": 232_965, "n_edges": 114_615_892,
                     "batch_nodes": 1024, "fanout": (15, 10), "n_max": 16_384,
                     "e_max": 16_384, "t_max": 32_768},
    "ogb_products": {"kind": "train", "n_nodes": 2_449_029, "n_edges": 61_859_140,
                     "d_feat": 100, "triplet_cap": 4, "n_loc": 16_384, "e_loc": 262_144},
    "molecule": {"kind": "train", "global_batch": 128, "n_nodes": 30, "n_edges": 64,
                 "t_max": 256},
}
#: microbatches of a training step, and the two-level remat group
#: (``LMArch(num_micro=..., remat_group=...)`` in the reference's registry)
NUM_MICRO = {"codeqwen1.5-7b": 4, "qwen2-72b": 16, "smollm-360m": 1, "deepseek-moe-16b": 4,
             "deepseek-v2-lite-16b": 4}
REMAT_GROUP = {"codeqwen1.5-7b": 0, "qwen2-72b": 5, "smollm-360m": 0, "deepseek-moe-16b": 0,
               "deepseek-v2-lite-16b": 0}


def get_config(arch_id: str):
    """The published config of an LM (a ``TransformerConfig``), a recsys
    arch (its ``models.recsys`` config) or a GNN (a ``DimeNetConfig``)."""
    for table in (_CONFIGS, _RECSYS, _GNN):
        if arch_id in table:
            return table[arch_id]
    raise ValueError(f"unknown arch {arch_id!r}; the port has "
                     f"{ARCH_IDS + RECSYS_ARCH_IDS + GNN_ARCH_IDS}")


def serving_config(cfg: TransformerConfig, kind: str) -> TransformerConfig:
    """The reference's serving-cell overrides (``LMArch._dryrun_model_cfg``
    for a prefill or decode cell): bf16 params and compute, chunked (K3)
    attention with q_chunk 1024 for prefill and none for decode, kv_chunk
    2048."""
    if kind not in ("prefill", "decode"):
        raise ValueError(f"kind={kind!r}: 'prefill' or 'decode'")
    return dataclasses.replace(
        cfg, param_dtype="bfloat16", compute_dtype="bfloat16", remat=False, remat_group=0,
        q_chunk=0 if kind == "decode" else 1024, kv_chunk=2048,
    )


def training_config(cfg: TransformerConfig) -> TransformerConfig:
    """The reference's training-cell overrides (``LMArch._dryrun_model_cfg``
    for a train cell such as ``train_4k``): bf16 params and compute, remat
    with the arch's ``remat_group``, chunked (K3) attention with q_chunk
    1024 and kv_chunk 2048."""
    return dataclasses.replace(
        cfg, param_dtype="bfloat16", compute_dtype="bfloat16", remat=True,
        remat_group=REMAT_GROUP.get(cfg.name, 0), q_chunk=1024, kv_chunk=2048,
    )


def reduced_config(cfg: TransformerConfig) -> TransformerConfig:
    """The reference's reduced config (``LMArch.model_config(reduced=True)``):
    2 layers (plus the dense head layers of a MoE model), d_model 64, 4
    heads of 16, d_ff 128, vocab 512, MLA dims 32 / 16 / 8 / 16, float32,
    unchunked attention, no remat; a MoE model keeps 8 experts, top-2,
    d_ff_expert 64, 1 shared expert and capacity factor 8.0 (generous, so
    decode and prefill agree)."""
    moe = cfg.moe
    if moe is not None:
        moe = dataclasses.replace(moe, num_experts=8, top_k=2, d_ff_expert=64, n_shared=1,
                                  capacity_factor=8.0)
    return dataclasses.replace(
        cfg, n_layers=2 + (moe.first_k_dense if moe else 0), d_model=64, n_heads=4, moe=moe,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=16, d_ff=128, vocab=512, mla_kv_lora_rank=32, mla_qk_nope_head_dim=16,
        mla_qk_rope_head_dim=8, mla_v_head_dim=16, q_chunk=0, remat=False,
        param_dtype="float32", compute_dtype="float32",
    )


def reduced_recsys_config(cfg):
    """The reference's reduced recsys config (``RecsysArch.model_config(
    reduced=True)``): float32, vocabs of 64 a field (AutoInt, xDeepFM; xDeepFM
    also CIN 16-16 and MLP 32-32), 256 items and sequences of 16 (DIN with
    context vocabs of 64, SASRec)."""
    small = {"param_dtype": "float32", "compute_dtype": "float32"}
    if isinstance(cfg, AutoIntConfig):
        return dataclasses.replace(cfg, vocab_sizes=(64,) * cfg.n_sparse, **small)
    if isinstance(cfg, DINConfig):
        return dataclasses.replace(cfg, n_items=256, context_vocab=64, seq_len=16, **small)
    if isinstance(cfg, SASRecConfig):
        return dataclasses.replace(cfg, n_items=256, seq_len=16, **small)
    if isinstance(cfg, XDeepFMConfig):
        return dataclasses.replace(cfg, vocab_sizes=(64,) * cfg.n_sparse, cin_layers=(16, 16),
                                   mlp=(32, 32), **small)
    raise TypeError(type(cfg))


def reduced_gnn_config(cfg: DimeNetConfig) -> DimeNetConfig:
    """The reference's reduced GNN config (``GNNArch.model_config(
    reduced=True)``): 2 blocks, d_hidden 32, 4 bilinear, 4 spherical and 4
    radial bases."""
    return dataclasses.replace(cfg, n_blocks=2, d_hidden=32, n_bilinear=4, n_spherical=4,
                               n_radial=4)


def gnn_cell_config(cfg: DimeNetConfig, cell: str) -> DimeNetConfig:
    """The reference's config of a GNN cell (``GNNArch._cfg_for_cell``):
    bf16 params (the float32 inputs promote every product after the
    embedding to float32) and the cell's node features, if it has any."""
    return dataclasses.replace(cfg, d_node_feat=GNN_CELLS[cell].get("d_feat", 0),
                               param_dtype="bfloat16", compute_dtype="bfloat16")
