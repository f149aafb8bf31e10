"""Carry built state across from the JAX package's numpy state.

LANNS's counterpart of loading weights: the JAX index's config, fitted
segmenter tree and per-partition corpora become a port ``LannsIndex``
without refitting or re-partitioning, so both packages query the same
partitions; and the JAX LM's params become the port's ``Transformer``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.common.utils import resolve_device
from repro_torch.core.lanns import LannsConfig, LannsIndex, _Partition, _scan_metric
from repro_torch.models.transformer import Transformer, TransformerConfig, check_supported
from repro_torch.quant.codec import Q8Corpus


def index_from_numpy_state(config: dict, tree, partitions: dict, mips_M2=None, device=None):
    """Build a port index from numpy state.

    config: ``dataclasses.asdict`` of the reference ``LannsConfig``.
    tree: ``segmenter.tree_arrays()`` of the reference (None for RS).
    partitions: ``{(s, g): {"vectors": (n, d) float32, "keys": (n,) int}}``
    — every (shard, segment) the reference built, empty ones included.  For
    ``quantized="q8"`` an entry may add ``"q8_codes"``, ``"q8_scales"`` and
    ``"q8_norms2"`` (the reference partition's ``q8`` fields), so the port
    scans the reference's own codes; without them the port encodes.
    mips_M2: the reference's stored ``_mips_M2`` (metric 'mips' only).
    """
    cfg = LannsConfig(**config)
    index = LannsIndex(cfg, device=device)
    if tree is not None:
        index.partitioner.segmenter.set_tree(tree["hyperplanes"], tree["split"], tree["lo"], tree["hi"])
    index.partitioner._fitted = True
    for (s, g), part in partitions.items():
        q8 = None
        if cfg.quantized == "q8" and part.get("q8_codes") is not None:
            q8 = Q8Corpus(
                codes=part["q8_codes"], scales=part["q8_scales"], norms2=part["q8_norms2"],
                metric=_scan_metric(cfg),
            )
        index.partitions[(s, g)] = _Partition(part["vectors"], part["keys"], cfg, index.device,
                                              q8=q8)
    if mips_M2 is not None:
        index._mips_M2 = float(mips_M2)
    return index


def transformer_from_jax(cfg: TransformerConfig, params_np: dict, device=None) -> Transformer:
    """The port's params from the reference's ``transformer.init`` pytree
    as numpy arrays: the stacked (L, ...) ``blocks`` become one block per
    layer, each weight in ``cfg.param_dtype`` on the device."""
    check_supported(cfg)
    if "dense_blocks" in params_np:
        raise NotImplementedError("dense_blocks belong to a MoE model (ROADMAP item 10)")
    dev = resolve_device(device)
    dtype = cfg.dtype()
    t = lambda a: torch.from_numpy(np.array(a, dtype=np.float32)).to(device=dev, dtype=dtype)
    stacked = params_np["blocks"]
    blocks = [
        {group: {name: t(a[l]) for name, a in leaves.items()} for group, leaves in stacked.items()}
        for l in range(cfg.n_layers)
    ]
    lm_head = None if cfg.tie_embeddings else t(params_np["lm_head"])
    return Transformer(t(params_np["embed"]), t(params_np["final_norm"]["scale"]), blocks,
                       lm_head)
