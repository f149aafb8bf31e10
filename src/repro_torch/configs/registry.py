"""The LM architectures the port runs, with their published configs.

A copy of the dense GQA entries of ``repro.configs.registry`` (sources as
there):

  codeqwen1.5-7b  [hf:Qwen/CodeQwen1.5-7B]
  qwen2-72b       [arXiv:2407.10671]
  smollm-360m     [hf:HuggingFaceTB/SmolLM-360M]

The reference's MoE / MLA LMs (deepseek-moe-16b, deepseek-v2-lite-16b)
raise ``NotImplementedError``; its GNN and recsys archs are not LMs and are
not part of the port.
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.transformer import TransformerConfig

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
}
_UNPORTED = {
    "deepseek-moe-16b": "MoE blocks",
    "deepseek-v2-lite-16b": "MLA attention and MoE blocks",
}
ARCH_IDS = tuple(_CONFIGS)
#: microbatches of a training step, and the two-level remat group
#: (``LMArch(num_micro=..., remat_group=...)`` in the reference's registry)
NUM_MICRO = {"codeqwen1.5-7b": 4, "qwen2-72b": 16, "smollm-360m": 1}
REMAT_GROUP = {"codeqwen1.5-7b": 0, "qwen2-72b": 5, "smollm-360m": 0}


def get_config(arch_id: str) -> TransformerConfig:
    """The published config of a dense GQA LM."""
    if arch_id in _UNPORTED:
        raise NotImplementedError(f"{arch_id}: {_UNPORTED[arch_id]} are not ported "
                                  "(ROADMAP item 10)")
    if arch_id not in _CONFIGS:
        raise ValueError(f"unknown LM arch {arch_id!r}; the port has {ARCH_IDS}")
    return _CONFIGS[arch_id]


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
    """The reference's reduced config (``LMArch.model_config(reduced=True)``
    of a dense arch): 2 layers, d_model 64, 4 heads of 16, d_ff 128,
    vocab 512, float32, unchunked attention, no remat."""
    return dataclasses.replace(
        cfg, n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=16, d_ff=128, vocab=512, mla_kv_lora_rank=32, mla_qk_nope_head_dim=16,
        mla_qk_rope_head_dim=8, mla_v_head_dim=16, q_chunk=0, remat=False,
        param_dtype="float32", compute_dtype="float32",
    )
