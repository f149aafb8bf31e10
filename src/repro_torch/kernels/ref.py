"""Plain PyTorch versions of the kernels in this package.

They are what the kernel wrappers run on CPU tensors, and the versions the
kernels are held against on the card.  On CUDA tensors they run with TF32
off, so a float32 product keeps full float32 precision.
"""

from __future__ import annotations

import math

import torch


def _no_tf32(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False


def distance_matrix(q: torch.Tensor, x: torch.Tensor, metric: str) -> torch.Tensor:
    """(B, d) x (N, d) -> (B, N) distances, lower is better.

    l2:  true squared euclidean distance.
    ip:  negative inner product.
    cos: negative cosine similarity (inputs need not be normalized).
    """
    _no_tf32(q)
    if metric == "l2":
        qn = (q * q).sum(-1, keepdim=True)
        xn = (x * x).sum(-1)
        return qn - 2.0 * (q @ x.T) + xn[None, :]
    if metric == "ip":
        return -(q @ x.T)
    if metric == "cos":
        qn = q / q.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        xn = x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        return -(qn @ xn.T)
    raise ValueError(metric)


def distance_topk_ref(q: torch.Tensor, x: torch.Tensor, k: int, metric: str = "l2"):
    """Full (B, N) distance matrix + top-k.  Returns (dists (B, k)
    ascending, ids (B, k) int32)."""
    d = distance_matrix(q, x, metric)
    vals, idx = torch.topk(d, k, dim=1, largest=False, sorted=True)
    return vals, idx.to(torch.int32)


def distance_topk_blocked(
    q: torch.Tensor,
    x: torch.Tensor,
    k: int,
    metric: str = "l2",
    block_n: int = 4096,
    n_valid: int | None = None,
):
    """Scan over N blocks carrying a running top-k; rows >= ``n_valid`` are
    padding and never win.

    Same result as ``distance_topk_ref`` without the full (B, N) matrix.
    Blocks wholly past ``n_valid`` are not scored at all (they could only
    contribute (inf, -1)).  Returns (dists (B, k) ascending, ids (B, k)
    int32), (inf, -1) where fewer than k valid rows exist.
    """
    B = q.shape[0]
    N = x.shape[0]
    nv = N if n_valid is None else min(int(n_valid), N)
    run_d = torch.full((B, k), float("inf"), dtype=torch.float32, device=q.device)
    run_i = torch.full((B, k), -1, dtype=torch.int32, device=q.device)
    for start in range(0, nv, block_n):
        xb = x[start: start + block_n]
        d = distance_matrix(q, xb, metric).to(torch.float32)
        gid = torch.arange(
            start, start + xb.shape[0], dtype=torch.int32, device=q.device
        )
        d = torch.where((gid < nv)[None, :], d, float("inf"))
        cat_d = torch.cat([run_d, d], dim=1)
        cat_i = torch.cat([run_i, gid[None, :].expand(B, -1)], dim=1)
        run_d, idx = torch.topk(cat_d, k, dim=1, largest=False, sorted=True)
        run_i = torch.gather(cat_i, 1, idx)
    run_i = torch.where(torch.isinf(run_d), -1, run_i)
    return run_d, run_i


def q8_score_matrix(
    q_codes: torch.Tensor,  # (B, D) int8
    x_codes: torch.Tensor,  # (N, D) int8
    q_scale: torch.Tensor,  # (B,) float32
    norms2: torch.Tensor,  # (N,) float32
    metric: str,
) -> torch.Tensor:
    """(B, N) stage-1 quantized scores, lower is better: the plain version
    of K2's per-tile arithmetic.

    The dot is exact on every device: CUDA has no general int32 matmul, so
    it runs as a float64 matmul of the codes (|dot| <= 2048 * 127^2 < 2^53,
    so every partial sum is an exact integer) and is converted to float32
    once — the same value as the reference's int32 -> float32 rounding.
    Then ONE float32 rescale, and the metric term, in the reference's order.
    """
    dots = (q_codes.to(torch.float64) @ x_codes.to(torch.float64).T).to(torch.float32)  # lanns: noqa[LANNS020] -- the plain version's exact int8 dot: float64 holds every int32 partial sum exactly; not a kernel, it runs only in tests and on the CPU
    qx = dots * q_scale[:, None]
    if metric == "l2":
        return norms2[None, :] - 2.0 * qx
    if metric == "ip":
        return -qx
    raise ValueError(metric)


def distance_topk_q8_blocked(
    q_codes: torch.Tensor,
    x_codes: torch.Tensor,
    q_scale: torch.Tensor,
    norms2: torch.Tensor,
    k: int,
    metric: str = "l2",
    block_n: int = 4096,
    n_valid: int | None = None,
):
    """Int8 scan over N blocks carrying a running top-k; rows >= ``n_valid``
    are padding and never win.

    Scores are bit-equal to K2's; ties at the k boundary may be broken
    differently.  Returns (dists (B, k) ascending, ids (B, k) int32), with
    (inf, -1) where fewer than k valid rows exist.
    """
    B = q_codes.shape[0]
    N = x_codes.shape[0]
    nv = N if n_valid is None else min(int(n_valid), N)
    dev = q_codes.device
    run_d = torch.full((B, k), float("inf"), dtype=torch.float32, device=dev)
    run_i = torch.full((B, k), -1, dtype=torch.int32, device=dev)
    for start in range(0, nv, block_n):
        stop = min(start + block_n, nv)
        d = q8_score_matrix(q_codes, x_codes[start:stop], q_scale, norms2[start:stop], metric)
        gid = torch.arange(start, stop, dtype=torch.int32, device=dev)
        cat_d = torch.cat([run_d, d], dim=1)
        cat_i = torch.cat([run_i, gid[None, :].expand(B, -1)], dim=1)
        run_d, idx = torch.topk(cat_d, k, dim=1, largest=False, sorted=True)
        run_i = torch.gather(cat_i, 1, idx)
    run_i = torch.where(torch.isinf(run_d), -1, run_i)
    return run_d, run_i


def flash_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: float | None = None,
    block_q: int = 1024,
    block_k: int = 1024,
    with_lse: bool = False,
):
    """Attention forward over q, k (BH, S, D) and v (BH, S, Dv) as a blocked
    online softmax: the plain version of K3 (``repro/kernels/flash_attention.py::
    _flash_fwd_kernel``), with its masking and guards.

    All math is float32 (q, k, v, p and the (m, l, acc) carry); the output
    (BH, S, Dv) takes q's dtype.  Future kv gets -inf (causal); the ragged last block is
    simply shorter, so no kv past S exists to mask.  ``m_safe`` guards
    fully masked rows and ``l`` is floored at 1e-30, as in the kernel.  kv
    blocks wholly above the diagonal are skipped.  Memory is
    O(BH x block_q x block_k), so it runs at S = 32k on the card.

    With ``with_lse`` it returns (out, lse): lse (BH, S) float32 is each
    row's log-sum-exp of the scaled scores, ``m_safe + log(l)`` with the
    same guards, in natural-log units, as K3 writes it for the backward.
    """
    BH, S, D = q.shape
    Dv = v.shape[-1]
    scale = scale or 1.0 / math.sqrt(D)
    _no_tf32(q)
    out = q.new_empty((BH, S, Dv))
    dev = q.device
    lse = torch.empty((BH, S), dtype=torch.float32, device=dev) if with_lse else None
    for q0 in range(0, S, block_q):
        q1 = min(q0 + block_q, S)
        qb = q[:, q0:q1].to(torch.float32)
        q_pos = torch.arange(q0, q1, device=dev)[:, None]
        m = torch.full((BH, q1 - q0, 1), float("-inf"), dtype=torch.float32, device=dev)
        l = torch.zeros((BH, q1 - q0, 1), dtype=torch.float32, device=dev)
        acc = torch.zeros((BH, q1 - q0, Dv), dtype=torch.float32, device=dev)
        for k0 in range(0, q1 if causal else S, block_k):
            k1 = min(k0 + block_k, S)
            kb = k[:, k0:k1].to(torch.float32)
            vb = v[:, k0:k1].to(torch.float32)
            s = torch.bmm(qb, kb.transpose(1, 2)) * scale
            if causal:
                valid = torch.arange(k0, k1, device=dev)[None, :] <= q_pos
                s = torch.where(valid, s, float("-inf"))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.exp(s - m_safe)
            if causal:
                p = torch.where(valid, p, 0.0)
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
            l = l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + torch.bmm(p, vb)
            m = m_new
        out[:, q0:q1] = (acc / l.clamp_min(1e-30)).to(q.dtype)
        if with_lse:
            m_safe = torch.where(torch.isfinite(m), m, 0.0)
            lse[:, q0:q1] = (m_safe + torch.log(l.clamp_min(1e-30)))[..., 0]
    return (out, lse) if with_lse else out


def flash_attention_bwd_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    *,
    causal: bool = True,
    scale: float | None = None,
    block_q: int = 1024,
    block_k: int = 1024,
):
    """The gradient of attention over q, k (BH, S, D) and v (BH, S, Dv): the
    plain version of K3-bwd (``csrc/flash_attention_bwd.cu``), the function
    the JAX package gets from autodiff of ``chunked_attention``.

    From q, k, v, the forward's output o and its gradient ``do`` (both
    (BH, S, Dv)) and the row log-sum-exp ``lse`` of
    :func:`flash_attention_ref` (``with_lse``),
    rebuilds ``p = exp(scale q k^T - lse)`` block by block with the
    forward's masks (future kv when causal; kv blocks wholly above the
    diagonal skipped), then ``delta = rowsum(do o)``, ``ds = p (do v^T -
    delta)``, ``dv = p^T do``, ``dk = scale ds^T q``, ``dq = scale ds k``.
    All math and every sum is float32; the results take q's dtype.
    Returns (dq, dk, dv), dv of v's shape.
    """
    BH, S, D = q.shape
    Dv = v.shape[-1]
    scale = scale or 1.0 / math.sqrt(D)
    _no_tf32(q)
    dev = q.device
    f = lambda t: t.to(torch.float32)
    delta = (f(do) * f(o)).sum(-1)
    dq = torch.empty_like(q)
    dk = torch.zeros((BH, S, D), dtype=torch.float32, device=dev)
    dv = torch.zeros((BH, S, Dv), dtype=torch.float32, device=dev)
    for q0 in range(0, S, block_q):
        q1 = min(q0 + block_q, S)
        qb, dob = f(q[:, q0:q1]), f(do[:, q0:q1])
        lse_b, delta_b = f(lse[:, q0:q1, None]), delta[:, q0:q1, None]
        q_pos = torch.arange(q0, q1, device=dev)[:, None]
        dq_acc = torch.zeros((BH, q1 - q0, D), dtype=torch.float32, device=dev)
        for k0 in range(0, q1 if causal else S, block_k):
            k1 = min(k0 + block_k, S)
            kb, vb = f(k[:, k0:k1]), f(v[:, k0:k1])
            p = torch.exp(torch.bmm(qb, kb.transpose(1, 2)) * scale - lse_b)
            if causal:
                p = torch.where(torch.arange(k0, k1, device=dev)[None, :] <= q_pos, p, 0.0)
            ds = p * (torch.bmm(dob, vb.transpose(1, 2)) - delta_b)
            dv[:, k0:k1] += torch.bmm(p.transpose(1, 2), dob)
            dk[:, k0:k1] += torch.bmm(ds.transpose(1, 2), qb) * scale
            dq_acc += torch.bmm(ds, kb) * scale
        dq[:, q0:q1] = dq_acc.to(q.dtype)
    return dq, dk.to(q.dtype), dv.to(q.dtype)


def bf16_agreement(out: torch.Tensor, want_f32: torch.Tensor) -> float:
    """How far a bf16 result is from the float32 result of the same
    function, in units of what a correct rounding may cost: the largest
    ``|out - want_f32| / (2**-8 * |want_f32| + 1e-4)``.  It passes at <= 1.

    ``2**-8 * |x|`` bounds half a bf16 ulp of x, the error of rounding x
    correctly; the 1e-4 takes float32-grade differences of summation order.
    ``want_f32`` is the plain version run in float32 on the same
    bf16-valued inputs.  A kernel that rounds an intermediate to bf16 (p
    before p @ v, say) misses it where an absolute limit does not."""
    if out.shape != want_f32.shape:
        raise ValueError(f"bf16_agreement: shapes {tuple(out.shape)}, {tuple(want_f32.shape)}")
    want = want_f32.float()
    err = (out.float() - want).abs() / (2.0 ** -8 * want.abs() + 1e-4)
    return float(err.max()) if err.numel() else 0.0
