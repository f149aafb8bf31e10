"""LANNS segmenters (paper §4.3): RS, RH, APD with virtual/physical spill.

Fitting is host-side numpy on ``numpy.random.default_rng(seed)``, a copy of
``repro.core.segmenter``, so a fitted tree is bit-identical to the
reference's for a fixed seed.  Routing runs in torch on the device: one
(n, m-1) projection against the heap-ordered hyperplanes, then level-by-level
mask propagation.  With the spill band a row goes left when ``p <= hi`` and
right when ``p >= lo`` (both, inside the band); without it, left when
``p < split``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.common.utils import stable_hash_u64

#: rows per host-to-device upload when routing a host corpus
ROUTE_CHUNK = 1 << 20


@dataclasses.dataclass(frozen=True)
class SegmenterConfig:
    kind: str = "rh"  # 'rs' | 'rh' | 'apd'
    num_segments: int = 8  # must be a power of two for tree segmenters
    alpha: float = 0.15  # spill fractile (paper uses 0.15 => ~30% spill/level)
    spill: str = "virtual"  # 'virtual' | 'physical' | 'none'
    seed: int = 0
    apd_power_iters: int = 20  # power-iteration steps for the APD direction
    sample_size: int = 250_000  # subsample for learning (paper uses 250k)

    @property
    def depth(self) -> int:
        d = int(np.log2(self.num_segments))
        if 2**d != self.num_segments:
            raise ValueError("tree segmenters need power-of-two num_segments")
        return d


class RandomSegmenter:
    """RS (§4.3.1): points go to ``hash(key) % m``; queries go everywhere."""

    def __init__(self, config: SegmenterConfig):
        self.config = config
        self.kind = "rs"

    def fit(self, data: np.ndarray) -> "RandomSegmenter":
        return self  # nothing to learn

    def route_points(self, x: np.ndarray, keys: Optional[np.ndarray] = None) -> np.ndarray:
        """(n, m) host bool mask, exactly one True per row."""
        m = self.config.num_segments
        n = x.shape[0]
        if keys is None:
            keys = np.arange(n, dtype=np.uint64)
        seg = (stable_hash_u64(keys, salt=self.config.seed) % np.uint64(m)).astype(np.int64)
        mask = np.zeros((n, m), dtype=bool)
        mask[np.arange(n), seg] = True
        return mask

    def route_queries(self, q: torch.Tensor) -> torch.Tensor:
        return torch.ones((q.shape[0], self.config.num_segments), dtype=torch.bool, device=q.device)

    def tree_arrays(self):
        return None


def _rh_direction(rng: np.random.Generator, d: int) -> np.ndarray:
    h = rng.standard_normal(d).astype(np.float32)
    return h / np.linalg.norm(h)


def _apd_direction(x: np.ndarray, iters: int, rng: np.random.Generator) -> np.ndarray:
    """Second-largest right singular vector of x (exact SVD for small
    problems, 2-column subspace iteration otherwise)."""
    n, d = x.shape
    if n * d <= 2_000_000 or d <= 64:
        _, _, vt = np.linalg.svd(x, full_matrices=False)
        v = vt[1] if vt.shape[0] > 1 else vt[0]
        return (v / np.linalg.norm(v)).astype(np.float32)
    v = rng.standard_normal((d, 2)).astype(np.float64)
    v, _ = np.linalg.qr(v)
    xf = x.astype(np.float64)
    for _ in range(iters):
        w = xf.T @ (xf @ v)  # (d, 2)
        v, _ = np.linalg.qr(w)
    scores = np.einsum("dk,dk->k", v, xf.T @ (xf @ v))
    order = np.argsort(-scores)
    v2 = v[:, order[1]]
    return (v2 / np.linalg.norm(v2)).astype(np.float32)


class TreeSegmenter:
    """RH / APD hyperplane-tree segmenter with spill (paper §4.3.2-4.3.3).

    Flat-array tree in heap order, ``n_internal = num_segments - 1``:
      hyperplanes  (n_internal, d) float32
      split        (n_internal,)  — median of projections at that node
      lo, hi       (n_internal,)  — 0.5∓/±alpha fractiles (spill band)
    """

    def __init__(self, config: SegmenterConfig, device: torch.device):
        if config.kind not in ("rh", "apd"):
            raise ValueError(config.kind)
        self.config = config
        self.device = device
        self.kind = config.kind
        self.hyperplanes: Optional[np.ndarray] = None
        self.split: Optional[np.ndarray] = None
        self.lo: Optional[np.ndarray] = None
        self.hi: Optional[np.ndarray] = None
        self._dev: dict = {}  # device copies of the tree, by device

    def fit(self, data: np.ndarray) -> "TreeSegmenter":
        cfg = self.config
        rng = np.random.default_rng(cfg.seed)
        data = np.asarray(data, dtype=np.float32)
        if data.shape[0] > cfg.sample_size:
            idx = rng.choice(data.shape[0], cfg.sample_size, replace=False)
            data = data[idx]
        d = data.shape[1]
        n_internal = cfg.num_segments - 1
        H = np.zeros((n_internal, d), dtype=np.float32)
        S = np.zeros(n_internal, dtype=np.float32)
        LO = np.zeros(n_internal, dtype=np.float32)
        HI = np.zeros(n_internal, dtype=np.float32)

        def build(node: int, rows: np.ndarray):
            if node >= n_internal:
                return
            x = data[rows]
            if self.kind == "rh":
                h = _rh_direction(rng, d)
            else:
                h = _apd_direction(x, cfg.apd_power_iters, rng)
            u = x @ h
            S[node] = np.median(u)
            LO[node] = np.quantile(u, 0.5 - cfg.alpha)
            HI[node] = np.quantile(u, 0.5 + cfg.alpha)
            H[node] = h
            build(2 * node + 1, rows[u < S[node]])
            build(2 * node + 2, rows[u >= S[node]])

        build(0, np.arange(data.shape[0]))
        self.set_tree(H, S, LO, HI)
        return self

    def set_tree(self, hyperplanes, split, lo, hi) -> None:
        self.hyperplanes = np.asarray(hyperplanes, np.float32)
        self.split = np.asarray(split, np.float32)
        self.lo = np.asarray(lo, np.float32)
        self.hi = np.asarray(hi, np.float32)
        self._dev = {}

    def _tree_on(self, device: torch.device):
        if self.hyperplanes is None:
            raise RuntimeError("segmenter not fitted")
        key = str(device)
        if key not in self._dev:
            self._dev[key] = tuple(
                torch.from_numpy(a).to(device)
                for a in (self.hyperplanes.T.copy(), self.split, self.lo, self.hi)
            )
        return self._dev[key]

    def _route(self, x: torch.Tensor, spill_band: bool) -> torch.Tensor:
        """(n, num_segments) bool mask on ``x``'s device."""
        cfg = self.config
        h_t, split, lo, hi = self._tree_on(x.device)
        if x.is_cuda:
            torch.backends.cuda.matmul.allow_tf32 = False
        proj = x.to(torch.float32) @ h_t  # (n, n_internal)
        mask = {0: torch.ones(x.shape[0], dtype=torch.bool, device=x.device)}
        for _ in range(cfg.depth):
            nxt = {}
            for node, m in mask.items():  # a complete tree: one parent per child
                p = proj[:, node]
                if spill_band:
                    go_left = p <= hi[node]
                    go_right = p >= lo[node]
                else:
                    go_left = p < split[node]
                    go_right = ~go_left
                nxt[2 * node + 1] = m & go_left
                nxt[2 * node + 2] = m & go_right
            mask = nxt
        n_internal = cfg.num_segments - 1
        return torch.stack([mask[n_internal + g] for g in range(cfg.num_segments)], dim=1)

    def route_points(self, x: np.ndarray, keys: Optional[np.ndarray] = None) -> np.ndarray:
        """(n, m) host bool mask — one leaf per point (virtual) or the spill
        band (physical).  Rows are routed on this segmenter's device in
        chunks of ``ROUTE_CHUNK``."""
        physical = self.config.spill == "physical"
        x = np.asarray(x, dtype=np.float32)
        out = np.empty((x.shape[0], self.config.num_segments), dtype=bool)
        for s in range(0, x.shape[0], ROUTE_CHUNK):
            chunk = torch.from_numpy(x[s: s + ROUTE_CHUNK]).to(self.device)
            out[s: s + ROUTE_CHUNK] = self._route(chunk, physical).cpu().numpy()
        return out

    def route_queries(self, q: torch.Tensor) -> torch.Tensor:
        """(B, m) bool on ``q``'s device — spill band for virtual spill,
        single leaf otherwise."""
        return self._route(q, spill_band=self.config.spill == "virtual")

    def tree_arrays(self):
        if self.hyperplanes is None:
            raise RuntimeError("segmenter not fitted")
        return {
            "hyperplanes": self.hyperplanes,
            "split": self.split,
            "lo": self.lo,
            "hi": self.hi,
            "depth": self.config.depth,
        }


def make_segmenter(config: SegmenterConfig, device: torch.device):
    if config.kind == "rs":
        return RandomSegmenter(config)
    return TreeSegmenter(config, device)


def expected_spill_fraction(alpha: float, depth: int) -> float:
    """Expected fraction of queries routed to >1 segment after `depth` levels.

    Per level a query falls in the band with probability ~2*alpha; the paper
    quotes "~30% queries to both partitions at any level" for alpha=0.15.
    """
    return 1.0 - (1.0 - 2.0 * alpha) ** depth


def failure_probability(levels: np.ndarray, alpha: float, n: int) -> np.ndarray:
    """Paper Figure 4: P(L) ≈ sum_{l=1..L} 1 / (2 (0.5+alpha)^l n), the
    curve the paper plots for n = 10_000."""
    levels = np.asarray(levels)
    out = np.zeros(levels.shape, dtype=np.float64)
    for i, L in np.ndenumerate(levels):
        ls = np.arange(1, int(L) + 1, dtype=np.float64)
        out[i] = np.sum(1.0 / (2.0 * (0.5 + alpha) ** ls * n))
    return out
