"""Approximate Earth Mover's Distance (Fan / Mo approxmatch) — port of
pcfm/ops/emd.py, in plain torch as the JAX package computes it outside any
Pallas kernel.

``approxmatch`` runs 10 rounds of a Sinkhorn-like soft assignment with
temperatures ``level = -4^j`` for j = 7..-1 and a final level 0, with the
reference kernel's integer-division multiplicities; ``matchcost`` is
``sum(match * d^2)``; ``earth_mover_distance`` divides by N (reference
PyTorchEMD/emd.py:27-51) and differentiates with the analytic
matchcostgrad formulas (emd_kernel.cu:285-353), the match held constant.
It materialises the (B, M, N) match, as the reference kernel does.

``earth_mover_distance_streamed`` needs O(N + M) memory: the match is a sum
over levels of ``exp(level d^2) * ratioL (x) ratioR``, so only the (N,) and
(M,) vectors are kept and every (N, M) interaction is recomputed in chunks
of ``chunk`` targets, including the gradients (streamed match moments).
Both run batched over the clouds (``bmm``), with fp32 matrix products in
full precision (TF32 off), as JAX's HIGHEST.
"""
from __future__ import annotations

import torch

from pcfm_torch.ops.chamfer import full_fp32_matmul, pairwise_sqdist

LEVELS = tuple(-float(4.0 ** j) for j in range(7, -2, -1)) + (0.0,)


def _multiplicities(n: int, m: int):
    """(mult_l, mult_r), integer division as the reference's C++ ints."""
    return (1.0, float(n // m)) if n >= m else (float(m // n), 1.0)


def _as_batch(x: torch.Tensor) -> torch.Tensor:
    return (x[None] if x.dim() == 2 else x).to(torch.float32)


def approxmatch(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    """The (B, M, N) soft match between xyz1 (B, N, 3) and xyz2 (B, M, 3)
    (emd_kernel.cu:24-156)."""
    xyz1, xyz2 = xyz1.to(torch.float32), xyz2.to(torch.float32)
    b, n, m = xyz1.shape[0], xyz1.shape[1], xyz2.shape[1]
    mult_l, mult_r = _multiplicities(n, m)
    d2 = pairwise_sqdist(xyz1, xyz2)                                # (B,N,M)
    match = torch.zeros_like(d2)
    remain_l = torch.full((b, n), mult_l, device=d2.device)
    remain_r = torch.full((b, m), mult_r, device=d2.device)
    with full_fp32_matmul():
        for level in LEVELS:
            w = torch.exp(level * d2)
            suml = 1e-9 + torch.bmm(w, remain_r[..., None])[..., 0]
            ratio_l = remain_l / suml                               # (B,N)
            sumr = torch.bmm(ratio_l[:, None, :], w)[:, 0] * remain_r
            consumption = (remain_r / (sumr + 1e-9)).clamp_max(1.0)
            ratio_r = consumption * remain_r                        # (B,M)
            remain_r = (remain_r - sumr).clamp_min(0.0)
            delta = w * ratio_l[:, :, None] * ratio_r[:, None, :]
            match += delta
            remain_l = (remain_l - delta.sum(dim=2)).clamp_min(0.0)
    return match.transpose(1, 2)


def matchcost(xyz1: torch.Tensor, xyz2: torch.Tensor,
              match: torch.Tensor) -> torch.Tensor:
    """cost_b = sum_{l,k} match[b,l,k] * d2(xyz1[b,k], xyz2[b,l]) -> (B,)."""
    d2 = pairwise_sqdist(xyz1, xyz2)                                # (B,N,M)
    return (d2 * match.transpose(1, 2)).sum(dim=(1, 2))


def _moment_grads(xyz1, xyz2, rowsum, colsum, wx2, wx1, g):
    """matchcostgrad1 / 2 from the match's row and column sums and its
    match-weighted coordinates."""
    g = g[:, None, None]
    return (2.0 * (xyz1 * rowsum[..., None] - wx2) * g,
            2.0 * (xyz2 * colsum[..., None] - wx1) * g)


class _EMDCost(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xyz1, xyz2):
        match = approxmatch(xyz1, xyz2)
        ctx.save_for_backward(xyz1, xyz2, match)
        return matchcost(xyz1, xyz2, match)

    @staticmethod
    def backward(ctx, g):
        xyz1, xyz2, match = ctx.saved_tensors
        w = match.transpose(1, 2)                                   # (B,N,M)
        with full_fp32_matmul():
            wx2 = torch.bmm(w, xyz2)
            wx1 = torch.bmm(match, xyz1)
        return _moment_grads(xyz1, xyz2, w.sum(dim=2), w.sum(dim=1), wx2,
                             wx1, g)


def earth_mover_distance(xyz1: torch.Tensor,
                         xyz2: torch.Tensor) -> torch.Tensor:
    """Approximate EMD of (B, N, 3) / (B, M, 3) clouds (or one cloud each,
    (N, 3) / (M, 3)), normalised by N: (B,) cost / N."""
    xyz1, xyz2 = _as_batch(xyz1), _as_batch(xyz2)
    return _EMDCost.apply(xyz1, xyz2) / float(xyz1.shape[1])


# ------------------------------------------------------------ streamed

def _chunk_sqdist(x1: torch.Tensor, xc: torch.Tensor) -> torch.Tensor:
    """(B, N, 3), (B, c, 3) -> (B, N, c) dot-trick squared distances,
    clamped >= 0, in the JAX package's order."""
    d2 = (x1 * x1).sum(-1)[:, :, None] + (xc * xc).sum(-1)[:, None, :] \
        - 2.0 * torch.bmm(x1, xc.transpose(1, 2))
    return d2.clamp_min(0.0)


def _chunked_exp_matvec(x1, x2, level: float, vec_m, chunk: int):
    """sum_l exp(level * d2[:, :, l]) * vec_m[:, l] per row of x1, over
    chunks of x2: (B, N)."""
    out = torch.zeros(x1.shape[:2], dtype=torch.float32, device=x1.device)
    for s in range(0, x2.shape[1], chunk):
        w = torch.exp(level * _chunk_sqdist(x1, x2[:, s:s + chunk]))
        out = out + torch.bmm(w, vec_m[:, s:s + chunk, None])[..., 0]
    return out


def _emd_streamed(x1, x2, chunk: int):
    """Batched streamed approxmatch: (cost (B,), ratio_l per level
    (10, B, N), ratio_r per level (10, B, M))."""
    b, n, m = x1.shape[0], x1.shape[1], x2.shape[1]
    mult_l, mult_r = _multiplicities(n, m)
    remain_l = torch.full((b, n), mult_l, device=x1.device)
    remain_r = torch.full((b, m), mult_r, device=x1.device)
    rls, rrs = [], []
    for level in LEVELS:
        suml = 1e-9 + _chunked_exp_matvec(x1, x2, level, remain_r, chunk)
        ratio_l = remain_l / suml
        sumr = _chunked_exp_matvec(x2, x1, level, ratio_l, chunk) * remain_r
        consumption = (remain_r / (sumr + 1e-9)).clamp_max(1.0)
        ratio_r = consumption * remain_r
        new_remain_r = (remain_r - sumr).clamp_min(0.0)
        # delta's row sums for remainL: sum_l w * ratio_l * ratio_r
        delta_rows = ratio_l * _chunked_exp_matvec(x1, x2, level, ratio_r,
                                                   chunk)
        remain_l = (remain_l - delta_rows).clamp_min(0.0)
        remain_r = new_remain_r
        rls.append(ratio_l)
        rrs.append(ratio_r)
    # cost = sum_lev sum_{k,l} d2 * w * rL_k * rR_l
    cost = torch.zeros(b, dtype=torch.float32, device=x1.device)
    for s in range(0, m, chunk):
        d2 = _chunk_sqdist(x1, x2[:, s:s + chunk])
        acc = cost
        for lev, level in enumerate(LEVELS):
            w = torch.exp(level * d2)
            acc = acc + ((rls[lev][:, :, None] * w
                          * rrs[lev][:, None, s:s + chunk]) * d2).sum((1, 2))
        cost = acc
    return cost, torch.stack(rls), torch.stack(rrs)


def _streamed_match_moments(x1, x2, rls, rrs, chunk: int):
    """Row / column sums of the match and its match-weighted coordinates,
    streamed: rowsum (B, N), colsum (B, M), wx2 (B, N, 3) = sum_l match_lk
    x2_l, wx1 (B, M, 3) = sum_k match_lk x1_k."""
    b, n, m = x1.shape[0], x1.shape[1], x2.shape[1]
    rowsum = torch.zeros((b, n), dtype=torch.float32, device=x1.device)
    wx2 = torch.zeros((b, n, 3), dtype=torch.float32, device=x1.device)
    colsum, wx1 = [], []
    for s in range(0, m, chunk):
        xc = x2[:, s:s + chunk]
        d2 = _chunk_sqdist(x1, xc)
        match_c = torch.zeros_like(d2)                      # (B, N, chunk)
        for lev, level in enumerate(LEVELS):
            match_c = match_c + torch.exp(level * d2) \
                * rls[lev][:, :, None] * rrs[lev][:, None, s:s + chunk]
        rowsum = rowsum + match_c.sum(dim=2)
        wx2 = wx2 + torch.bmm(match_c, xc)
        colsum.append(match_c.sum(dim=1))
        wx1.append(torch.bmm(match_c.transpose(1, 2), x1))
    return rowsum, wx2, torch.cat(colsum, dim=1), torch.cat(wx1, dim=1)


class _EMDStreamedCost(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xyz1, xyz2, chunk):
        with full_fp32_matmul():
            cost, rls, rrs = _emd_streamed(xyz1, xyz2, chunk)
        ctx.save_for_backward(xyz1, xyz2, rls, rrs)
        ctx.chunk = chunk
        return cost

    @staticmethod
    def backward(ctx, g):
        xyz1, xyz2, rls, rrs = ctx.saved_tensors
        with full_fp32_matmul():
            rowsum, wx2, colsum, wx1 = _streamed_match_moments(
                xyz1, xyz2, rls, rrs, ctx.chunk)
        g1, g2 = _moment_grads(xyz1, xyz2, rowsum, colsum, wx2, wx1, g)
        return g1, g2, None


def earth_mover_distance_streamed(xyz1: torch.Tensor, xyz2: torch.Tensor,
                                  chunk: int = 2048) -> torch.Tensor:
    """O(N + M)-memory approxmatch EMD for large clouds (20k+ points): the
    semantics of ``earth_mover_distance`` up to fp summation order,
    gradients included.  N and M must be multiples of ``chunk`` (padding
    would bias the match); callers pick a common divisor."""
    xyz1, xyz2 = _as_batch(xyz1), _as_batch(xyz2)
    n, m = xyz1.shape[1], xyz2.shape[1]
    chunk = min(chunk, n, m)
    if n % chunk or m % chunk:
        raise ValueError(f"streamed EMD needs N, M divisible by "
                         f"chunk={chunk}; got N={n}, M={m}")
    return _EMDStreamedCost.apply(xyz1, xyz2, chunk) / float(n)
