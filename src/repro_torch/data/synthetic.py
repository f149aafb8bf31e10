"""Deterministic synthetic ANN datasets, LM token batches, graphs,
molecules and click-log batches, bit-identical to ``repro.data.synthetic``
for a fixed seed (numpy generators)."""

from __future__ import annotations

import numpy as np


def clustered_vectors(
    n: int,
    d: int,
    *,
    n_clusters: int = 64,
    cluster_std: float = 0.15,
    seed: int = 0,
    center_seed: int = None,
    spectrum_decay: float = 0.0,
    dtype=np.float32,
) -> np.ndarray:
    """Gaussian-mixture corpus: unit-norm centers + within-cluster noise.

    ``center_seed`` pins the centers independently of the noise (corpus and
    queries must share centers); ``spectrum_decay`` > 0 gives the
    coordinates a 1/i^decay eigenspectrum, as real descriptors have.
    """
    rng_c = np.random.default_rng(seed if center_seed is None else center_seed)
    rng = np.random.default_rng(seed)
    if spectrum_decay > 0:
        spec = 1.0 / np.arange(1, d + 1) ** spectrum_decay
        spec = spec / np.sqrt((spec**2).mean())
    else:
        spec = np.ones(d)
    centers = rng_c.standard_normal((n_clusters, d)).astype(np.float64) * spec
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    assign = rng.integers(0, n_clusters, size=n)
    x = centers[assign] + cluster_std * rng.standard_normal((n, d)) * spec
    return x.astype(dtype)


def sift_like(n: int = 100_000, d: int = 128, n_queries: int = 1000, seed: int = 0):
    """(corpus, queries) mirroring the SIFT1M protocol: queries are held-out
    draws from the same anisotropic mixture, ~300 points per cluster."""
    nc = max(32, n // 300)
    kw = {"n_clusters": nc, "center_seed": seed, "spectrum_decay": 1.0}
    corpus = clustered_vectors(n, d, seed=seed, **kw)
    queries = clustered_vectors(n_queries, d, seed=seed + 1, **kw)
    return corpus, queries


def token_batch(batch: int, seq_len: int, vocab: int, seed: int = 0):
    """(tokens, labels) int32 arrays — a next-token LM batch, the
    reference's numbers for the same seed."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, size=(batch, seq_len + 1), dtype=np.int64)
    return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)


def power_law_graph(
    n_nodes: int,
    n_edges: int,
    *,
    d_feat: int = 0,
    seed: int = 0,
    with_positions: bool = True,
):
    """Directed edge list with power-law-ish degree (sources drawn with a
    zipf rank weight 1 / rank^0.8, destinations uniform), optional features
    and positions.

    Returns dict(edge_index (2, E) int32, positions (n, 3) float32?,
    features (n, d_feat) float32?).  Self-loops are moved one node on;
    parallel edges stay (as real web graphs have them).
    """
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, n_nodes + 1, dtype=np.float64)
    w = 1.0 / ranks**0.8
    w /= w.sum()
    src = rng.choice(n_nodes, size=n_edges, p=w).astype(np.int64)
    dst = rng.integers(0, n_nodes, size=n_edges, dtype=np.int64)
    loops = src == dst
    dst[loops] = (dst[loops] + 1) % n_nodes
    out = {"edge_index": np.stack([src, dst]).astype(np.int32)}
    if with_positions:
        out["positions"] = rng.standard_normal((n_nodes, 3)).astype(np.float32)
    if d_feat:
        out["features"] = rng.standard_normal((n_nodes, d_feat)).astype(np.float32)
    return out


def random_molecule_batch(batch: int, n_nodes: int = 30, n_edges: int = 64, seed: int = 0):
    """Batched small molecules (the ``molecule`` cell): atom types z (B, n)
    in [1, 10), positions (B, n, 3), the ``n_edges`` nearest ordered pairs
    of each molecule as edges (B, 2, n_edges) (-1 padded), and a graph
    target y (B,)."""
    rng = np.random.default_rng(seed)
    z = rng.integers(1, 10, size=(batch, n_nodes), dtype=np.int32)
    pos = rng.standard_normal((batch, n_nodes, 3)).astype(np.float32) * 1.5
    edges = np.full((batch, 2, n_edges), -1, dtype=np.int32)
    for b in range(batch):
        d = np.linalg.norm(pos[b][:, None] - pos[b][None, :], axis=-1)
        np.fill_diagonal(d, np.inf)
        flat = np.argsort(d, axis=None)[:n_edges]
        src, dst = np.unravel_index(flat, d.shape)
        edges[b, 0, : len(src)] = src
        edges[b, 1, : len(dst)] = dst
    y = rng.standard_normal((batch,)).astype(np.float32)
    return {"z": z, "positions": pos, "edge_index": edges, "y": y}


def criteo_like_batch(
    batch: int,
    *,
    n_sparse: int = 39,
    n_dense: int = 0,
    vocab_sizes=None,
    hist_len: int = 0,
    n_items: int = 0,
    seed: int = 0,
):
    """Click-log style batch: per-field categorical ids (+ optional dense
    features, behaviour history, candidate item) with a clicked label whose
    logit depends on a hidden linear model, so training losses decrease."""
    rng = np.random.default_rng(seed)
    if vocab_sizes is None:
        vocab_sizes = [100_000] * n_sparse
    sparse = np.stack(
        [rng.integers(0, v, size=batch, dtype=np.int64) for v in vocab_sizes], axis=1
    ).astype(np.int32)
    out = {"sparse_ids": sparse}
    if n_dense:
        out["dense"] = rng.standard_normal((batch, n_dense)).astype(np.float32)
    if hist_len:
        out["history"] = rng.integers(0, max(n_items, 2), size=(batch, hist_len), dtype=np.int32)
        out["hist_len"] = rng.integers(1, hist_len + 1, size=batch, dtype=np.int32)
        out["target_item"] = rng.integers(0, max(n_items, 2), size=batch, dtype=np.int32)
    # hidden ground truth: logit from hashed field ids
    h = (sparse * (np.arange(sparse.shape[1]) + 1)[None, :]).sum(axis=1)
    logit = ((h % 97) / 97.0 - 0.5) * 4.0
    p = 1.0 / (1.0 + np.exp(-logit))
    out["label"] = (rng.random(batch) < p).astype(np.float32)
    return out
