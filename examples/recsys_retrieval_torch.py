"""RecSys retrieval serving on the port: SASRec user tower + LANNS candidate index.

The twin of ``examples/recsys_retrieval.py`` on ``repro_torch``: the paper's
PYMK use case shape, where a sequential recommender encodes the user and
LANNS retrieves top-K candidates from an item-embedding corpus (the
retrieval_cand cell at a small scale).  Runs on the card unless asked for
the CPU:

    PYTHONPATH=src python examples/recsys_retrieval_torch.py [--device cpu]
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced_recsys_config
from repro_torch.core import LannsConfig, LannsIndex, brute_force_topk, recall_at_k
from repro_torch.data.synthetic import clustered_vectors
from repro_torch.models import recsys as rs


def retrieve(device=None, topk: int = 50) -> dict:
    """Index the item table, retrieve for 64 users; returns the index's
    ``ids``, the exact cosine top-k ``truth``, ``ms_per_user`` and the
    recall ``r_at_k``."""
    cfg = reduced_recsys_config(get_config("sasrec"))  # small item vocab
    params = rs.init(cfg, seed=0, device=device)
    dev = params["item_table"].device

    # a *trained* item space is clustered (items of a taste cluster
    # co-embed); random-init tables are the known worst case for hyperplane
    # segmenters, so simulate the trained structure the way ANN benchmarks do
    item_embs = clustered_vectors(cfg.n_items, cfg.embed_dim, n_clusters=16, cluster_std=0.2,
                                  seed=3)
    params["item_table"] = torch.from_numpy(item_embs).to(dev)

    # user histories -> user vectors.  An untrained SASRec tower emits
    # arbitrary (out-of-distribution) vectors; production plugs the TRAINED
    # tower here.  The demo uses the mean-of-history tower (YouTube-DNN
    # style), in-distribution by construction.
    rng = np.random.default_rng(0)
    histories = rng.integers(0, cfg.n_items, size=(64, cfg.seq_len)).astype(np.int32)
    user_vecs = item_embs[histories].mean(axis=1)
    # (the SASRec tower path, identical plumbing:)
    with torch.no_grad():
        rs.sasrec_encode(params, cfg, histories)[:, -1]

    # candidate corpus = the item embedding table, indexed with LANNS on the
    # cosine metric (production two-towers serve normalized embeddings)
    index = LannsIndex(LannsConfig(num_shards=1, num_segments=4, segmenter="apd",
                                   engine="scan", metric="cos"), device=dev).build(item_embs)
    index.query(user_vecs[:1], topk=topk)  # warm-up: the kernel library loads
    t0 = time.perf_counter()
    _, ids = index.query(user_vecs, topk=topk)
    dt = time.perf_counter() - t0
    _, truth = brute_force_topk(user_vecs, item_embs, topk, metric="cos", device=dev)
    return {"ids": ids, "truth": truth, "ms_per_user": 1e3 * dt / len(user_vecs),
            "r_at_k": recall_at_k(ids, truth, topk)}


def main(device=None) -> float:
    """Run the example; returns its R@50 against exact cosine retrieval."""
    out = retrieve(device)
    print(f"retrieval: {out['ms_per_user']:.2f} ms/user, "
          f"R@50 vs exact cosine retrieval = {out['r_at_k']:.3f}")
    return out["r_at_k"]


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    main(p.parse_args().device)
