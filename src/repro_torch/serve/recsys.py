"""The recsys ``retrieval_cand`` cell: user tower -> projection -> K1 scan
over the candidate corpus -> top-100.

The port of the reference's retrieval step (``repro.configs.families``,
``RecsysArch.build_cell`` for a ``retrieval`` cell): the paper's PYMK
retrieval (§7) served by the system.  The user tower is the cell's forward
(``models.recsys.forward``: SASRec's last hidden state, the other archs'
logit), rounded to bf16 and mapped by a learned bf16 projection into the
candidate space (the two-tower serving layout).  The reference then takes
a bf16 matmul against all candidates and ``lax.top_k``; the port scans
through K1 (``kernels.ops.distance_topk``, metric ``ip``, rows at or past
``n_cand`` masked as padding), as the reference's SASRec docstring says the
cell should.

K1 is float32, so the bf16 user vector and the bf16 candidates are upcast
(exactly): the port's scores are the float32 dot of the bf16 values, where
the reference rounds each score to bf16.  That rounding ties candidates at
the 100th place, so the two id sets may differ only among candidates whose
bf16 scores tie with the 100th (ROADMAP §3).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models import recsys as rs

TOPK = 100


def padded_candidates(n_cand: int) -> int:
    """The corpus's row count: ``n_cand`` rounded up to a multiple of 512,
    as the reference pads it to shard over every chip."""
    return -(-n_cand // 512) * 512


@torch.no_grad()
def user_vector(params: dict, cfg, batch: dict, user_proj: torch.Tensor) -> torch.Tensor:
    """(1, d_emb) float32 holding bf16 values: the tower's output for one
    user, rounded to bf16, times ``user_proj`` ((tower width, d_emb)) in
    bf16."""
    u = rs.forward(params, cfg, batch).reshape(1, -1).to(torch.bfloat16)
    return (u @ user_proj.to(torch.bfloat16)).to(torch.float32)


def scan_candidates(u: torch.Tensor, candidates: torch.Tensor, n_cand: int, topk: int = TOPK):
    """Top-``topk`` candidates of ``u`` (1, d) by inner product over the
    first ``n_cand`` rows of ``candidates`` (n_cand_pad, d), through K1 on
    the card and its plain version on the CPU.  Pass the corpus as float32
    (the bf16 values upcast once), or it is upcast at each call.  Returns
    (scores (1, topk) float32 descending, ids (1, topk) int32)."""
    d, i = ops.distance_topk(u, candidates, topk, "ip", n_valid=n_cand)
    return -d, i


def retrieval_step(params: dict, cfg, batch: dict, candidates: torch.Tensor,
                   user_proj: torch.Tensor, n_cand: int, topk: int = TOPK):
    """One retrieval_cand request: ``batch`` holds one user (the cell's
    forward batch at B = 1).  Returns (scores (1, topk) descending, ids
    (1, topk) int32) on the candidates' device."""
    return scan_candidates(user_vector(params, cfg, batch, user_proj), candidates, n_cand, topk)
