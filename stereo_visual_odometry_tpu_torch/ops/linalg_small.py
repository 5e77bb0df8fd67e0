"""Unrolled tiny-matrix linear algebra for batched geometry solves.

Port of ``stereo_visual_odometry_tpu/ops/linalg_small.py``: the Cholesky
factorization and triangular solves are unrolled over the static matrix
dimension, so each step is one batched elementwise op over the leading
dims (PnP solves hundreds of 6x6 and 12x12 systems at once).
"""
from __future__ import annotations

import torch


def cholesky_unrolled(A: torch.Tensor, eps: float = 1e-20):
    """Batched Cholesky of (..., n, n) SPD matrices; returns the lower factor
    as a list of lists of (...,) tensors. Non-positive pivots are floored at
    ``eps`` (finite garbage, the caller filters)."""
    return _chol(A, eps)[0]


def cholesky_unrolled_flagged(A: torch.Tensor, eps: float = 1e-20):
    """Like ``cholesky_unrolled`` but also returns ``ok`` (...,) bool, False
    where a pivot was non-positive (the matrix was not SPD)."""
    return _chol(A, eps)


def _chol(A, eps):
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    ok = None
    for i in range(n):
        for j in range(i + 1):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                good = s > 0
                ok = good if ok is None else (ok & good)
                L[i][j] = torch.sqrt(torch.clamp(s, min=eps))
            else:
                L[i][j] = s / L[j][j]
    return L, ok


def cho_solve_unrolled(L, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b given ``cholesky_unrolled`` output; b is (..., n)."""
    n = len(L)
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


def spd_solve(A: torch.Tensor, b: torch.Tensor, jitter: float = 0.0) -> torch.Tensor:
    """Batched SPD solve of (..., n, n) @ (..., n) with an optional ridge."""
    if jitter:
        A = A + jitter * torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return cho_solve_unrolled(cholesky_unrolled(A), b)
