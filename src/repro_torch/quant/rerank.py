"""Shared exact re-rank stage (fp32 originals -> exact candidate distances).

The port of ``repro.quant.rerank``.  A small per-lane candidate set from the
int8 stage is re-scored against the EXACT fp32 vectors, so returned
distances carry no quantization error.

``ExactStore`` owns the fp32 originals (+ squared norms + key table) for one
partition, as host numpy, with a device copy uploaded at first use;
``exact_candidate_distances`` scores a (b, C) candidate matrix against it:

* ``mode='host'`` — the reference's numpy code: when the candidate volume
  ``b * C`` rivals the store size N, ONE dense BLAS gemm + a
  take_along_axis beats b*C row gathers; otherwise gather only the
  candidate rows.  Host placement keeps the originals off the device.
* ``mode='device'`` — a gather + batched contraction in torch against the
  device copy; no host round trip.

Distance convention (``exact_from_dots``): lower is better; 'l2' OMITS the
per-query ||q||^2 constant (it cannot change any within-query ordering) —
the query executor adds it back once after its final merge.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def exact_from_dots(dots, n2, metric):
    """Exact distance from raw <q, x> dots and ||x||^2 (numpy arrays or
    torch tensors).  l2 omits the per-query ||q||^2 constant."""
    if metric == "l2":
        return n2 - 2.0 * dots
    if metric == "cos":
        if isinstance(dots, torch.Tensor):
            return -dots / torch.sqrt(torch.clamp_min(n2, 1e-24))
        return -dots / np.sqrt(np.maximum(n2, 1e-24))
    return -dots  # ip


class ExactStore:
    """fp32 originals + norms + keys for one partition's exact re-rank."""

    def __init__(self, vectors: np.ndarray, keys: Optional[np.ndarray] = None):
        self.vectors = np.asarray(vectors, np.float32)
        self.norms2 = np.einsum("nd,nd->n", self.vectors, self.vectors).astype(np.float32)
        self.keys = (
            np.asarray(keys, np.int64)
            if keys is not None
            else np.arange(len(self.vectors), dtype=np.int64)
        )
        self._dev: Optional[tuple] = None

    @property
    def size(self) -> int:
        return self.vectors.shape[0]

    def device(self, device: torch.device):
        """(vectors, norms2) on ``device``, uploaded at the first call and
        kept for the store's lifetime."""
        if self._dev is None or self._dev[0].device != device:
            self._dev = (
                torch.from_numpy(self.vectors).to(device),
                torch.from_numpy(self.norms2).to(device),
            )
        return self._dev

    def nbytes(self) -> int:
        return int(self.vectors.nbytes) + int(self.norms2.nbytes)

    def device_nbytes(self) -> int:
        """Bytes of the device copy (0 until it is uploaded)."""
        if self._dev is None:
            return 0
        return sum(t.numel() * t.element_size() for t in self._dev)


def resolve_store_mode(rerank_store: str, device: torch.device) -> str:
    """'auto' -> concrete placement: device when the index lives on CUDA,
    host otherwise (the reference's "device on TPU, host elsewhere")."""
    if rerank_store == "auto":
        return "device" if torch.device(device).type == "cuda" else "host"
    if rerank_store not in ("host", "device"):
        raise ValueError(
            f"rerank_store={rerank_store!r} — expected 'auto', 'host' or 'device'"
        )
    return rerank_store


def _host_distances(q: np.ndarray, cand: np.ndarray, store: ExactStore, metric: str):
    b, C = cand.shape
    v, n2 = store.vectors, store.norms2
    if b * C >= store.size:  # dense regime: one BLAS gemm beats b*C gathers
        full = exact_from_dots(q @ v.T, n2[None, :], metric)
        return np.take_along_axis(full, cand, axis=1)
    g = np.take(v, cand.reshape(-1), axis=0).reshape(b, C, -1)
    dots = np.matmul(g, q[:, :, None])[:, :, 0]
    return exact_from_dots(dots, np.take(n2, cand), metric)


# lanns: dims[b<=16_384, C<=1024, l_pad<=16_384]
def exact_candidate_distances(q, cand, store: ExactStore, metric: str, *, mode: str = "host"):  # lanns: hotpath
    """Exact distances (b, C) for candidate rows ``cand`` (b, C) of ``store``.

    ``q`` (b, d) must already be metric-prepped (normalized for 'cos',
    mips-augmented -> 'l2').  Takes numpy arrays or torch tensors and
    returns a float32 tensor on ``q``'s device (CPU for numpy input).
    """
    q = torch.as_tensor(q)
    cand = torch.as_tensor(cand)
    dev = q.device
    if mode == "device":
        vecs, n2 = store.device(dev)
        if dev.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False  # full fp32 products
        idx = cand.to(device=dev, dtype=torch.int64)
        g = vecs[idx]  # (b, C, d)
        dots = torch.matmul(g, q.to(torch.float32)[:, :, None])[:, :, 0]
        return exact_from_dots(dots, n2[idx], metric)
    if mode != "host":
        raise ValueError(f"mode={mode!r} — expected 'host' or 'device'")
    q_h = q.detach().cpu().numpy().astype(np.float32, copy=False)  # lanns: noqa[LANNS003] -- mode='host' re-ranks against the host store by design (the originals stay off the device); mode='device' reads nothing back
    c_h = cand.detach().cpu().numpy()  # lanns: noqa[LANNS003] -- mode='host' re-ranks against the host store by design (the originals stay off the device); mode='device' reads nothing back
    ex = _host_distances(q_h, c_h, store, metric)
    return torch.from_numpy(np.ascontiguousarray(ex, dtype=np.float32)).to(dev)
