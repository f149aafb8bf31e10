"""Deterministic synthetic ANN datasets and LM token batches, bit-identical to
``repro.data.synthetic`` for a fixed seed (numpy generators)."""

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
