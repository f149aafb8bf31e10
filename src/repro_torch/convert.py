"""Carry built state across from the JAX package's numpy state.

LANNS's counterpart of loading weights: the JAX index's config, fitted
segmenter tree and per-partition corpora (and, for the HNSW engine, its
frozen graphs) become a port ``LannsIndex`` without refitting,
re-partitioning or rebuilding, so both packages query the same partitions;
and the JAX LM's params (and AdamW state) become the port's
``Transformer`` (and optimizer state), and back.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.common.utils import resolve_device
from repro_torch.core.lanns import (
    LannsConfig,
    LannsIndex,
    _HNSWPartition,
    _Partition,
    _scan_metric,
)
from repro_torch.models.transformer import (
    Transformer,
    TransformerConfig,
    check_supported,
    param_tree,
)
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
    An HNSW partition is an entry with ``"kind": "hnsw"`` and the frozen
    graph's ``levels``, ``adj0``, ``upper_adj`` and ``entry`` beside its
    (frozen) ``vectors`` and ``keys`` — the reference's ``_build_one_partition``
    payload — plus the same optional q8 fields.
    mips_M2: the reference's stored ``_mips_M2`` (metric 'mips' only).
    """
    cfg = LannsConfig(**config)
    index = LannsIndex(cfg, device=device)
    if tree is not None:
        index.partitioner.segmenter.set_tree(tree["hyperplanes"], tree["split"], tree["lo"], tree["hi"])
    index.partitioner._fitted = True
    for (s, g), part in partitions.items():
        if part.get("kind") == "hnsw":
            index.partitions[(s, g)] = _HNSWPartition(part, cfg)
            continue
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
    index._invalidate_stack()
    return index


def index_numpy_state(index: LannsIndex):
    """A built port index's state in the form ``index_from_numpy_state``
    takes: ``(config, tree, partitions, mips_M2)``.  HNSW partitions carry
    their frozen graphs, so an index made from this state — on another
    device, or with another ``quantized`` setting — serves the same graphs
    without rebuilding them."""
    parts = {}
    for sg, p in index.partitions.items():
        if p.kind == "hnsw":
            fr = p.frozen
            parts[sg] = {"kind": "hnsw", "vectors": fr.vectors, "keys": fr.keys,
                         "levels": fr.levels, "adj0": fr.adj0, "upper_adj": fr.upper_adj,
                         "entry": fr.entry}
        else:
            vecs = p.host_vectors if p.vectors is None else p.vectors.cpu().numpy()
            parts[sg] = {"vectors": vecs, "keys": p.keys.cpu().numpy()}
    return (dataclasses.asdict(index.config), index.partitioner.segmenter.tree_arrays(), parts,
            getattr(index, "_mips_M2", None))


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


def transformer_to_numpy(params: Transformer) -> dict:
    """The inverse of :func:`transformer_from_jax`: the port's params as the
    reference's pytree of float32 numpy arrays, the per-layer blocks stacked
    into (L, ...) leaves."""
    f = lambda t: t.detach().to(torch.float32).cpu().numpy()
    tree = param_tree(params)
    blocks = tree["blocks"]
    out = {
        "embed": f(tree["embed"]),
        "final_norm": {"scale": f(tree["final_norm"]["scale"])},
        "blocks": {group: {name: np.stack([f(b[group][name]) for b in blocks])
                           for name in leaves_} for group, leaves_ in blocks[0].items()},
    }
    if "lm_head" in tree:
        out["lm_head"] = f(tree["lm_head"])
    return out


def adamw_state_from_jax(cfg: TransformerConfig, state_np: dict, device=None) -> dict:
    """The port's AdamW state (``train.optimizer.init_state``'s layout) from
    the reference's as numpy arrays: ``step``, and ``m`` / ``v`` whose
    stacked (L, ...) ``blocks`` become one float32 dict per layer."""
    check_supported(cfg)
    dev = resolve_device(device)
    t = lambda a: torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)

    def moments(tree):
        out = {"embed": t(tree["embed"]), "final_norm": {"scale": t(tree["final_norm"]["scale"])},
               "blocks": [{group: {name: t(a[l]) for name, a in leaves_.items()}
                           for group, leaves_ in tree["blocks"].items()}
                          for l in range(cfg.n_layers)]}
        if "lm_head" in tree:
            out["lm_head"] = t(tree["lm_head"])
        return out

    step = torch.tensor(int(np.asarray(state_np["step"])), dtype=torch.int32, device=dev)
    return {"step": step, "m": moments(state_np["m"]), "v": moments(state_np["v"])}
