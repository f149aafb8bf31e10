"""Recall@k — the paper's quality metric ("the fraction of true k-nearest
neighbors returned in a result set of size k", §1).  Host numpy, as in
``repro.core.recall``."""

from __future__ import annotations

import numpy as np


def recall_at_k(pred_ids: np.ndarray, true_ids: np.ndarray, k: int) -> float:
    """Mean fraction of true top-k found in predicted top-k.

    pred_ids, true_ids: (B, >=k) int arrays; -1 entries are ignored.
    """
    pred = np.asarray(pred_ids)[:, :k]
    true = np.asarray(true_ids)[:, :k]
    hits = 0
    total = 0
    for p, t in zip(pred, true):
        ts = {int(x) for x in t if x >= 0}
        if not ts:
            continue
        ps = {int(x) for x in p if x >= 0}
        hits += len(ts & ps)
        total += len(ts)
    return hits / max(total, 1)


def recall_table(pred_ids: np.ndarray, true_ids: np.ndarray, ks=(1, 5, 10, 15, 50, 100)):
    """Dict {k: R@k} — the row format of paper Tables 1 and 4."""
    kmax = min(pred_ids.shape[1], true_ids.shape[1])
    return {k: recall_at_k(pred_ids, true_ids, k) for k in ks if k <= kmax}
