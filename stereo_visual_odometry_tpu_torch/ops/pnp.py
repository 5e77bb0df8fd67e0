"""Batched RANSAC-PnP: fixed-budget parallel hypotheses + Gauss-Newton polish.

Port of ``stereo_visual_odometry_tpu/ops/pnp.py``. The JAX ``vmap`` over
hypotheses becomes a leading batch dimension. The hypothesis draws are
``u`` (H, 6) uniforms: a caller may inject them (tests hand both packages
the same JAX-drawn ``u``; a CUDA graph of the step takes them as an input),
otherwise ``draw_uniforms`` draws them from a ``torch.Generator``.
"""
from __future__ import annotations

import torch

from . import se3
from .camera import Pinhole
from .linalg_small import (cholesky_unrolled, cholesky_unrolled_flagged,
                           cho_solve_unrolled)

MIN_SAMPLE = 6


def _normalize_pixels(cam: Pinhole, px: torch.Tensor) -> torch.Tensor:
    """Pixels -> normalized image-plane coords (K^{-1} applied)."""
    return torch.stack([(px[..., 0] - cam.cx) / cam.fx,
                        (px[..., 1] - cam.cy) / cam.fy], dim=-1)


def _dlt_pose(pts3d: torch.Tensor, norm2d: torch.Tensor,
              wmask: torch.Tensor) -> torch.Tensor:
    """Linear 6+ point pose from 3D points and normalized 2D, weighted.

    Batched over leading dims: pts3d (..., S, 3), norm2d (..., S, 2),
    wmask (..., S). Solves the 2S x 12 DLT system by shifted inverse
    iteration on A^T A, fixes scale and sign by cheirality of the sample
    centroid, and projects R onto SO(3). Returns (..., 4, 4).
    """
    X = pts3d
    u = norm2d[..., 0]
    v = norm2d[..., 1]
    Xh = torch.cat([X, torch.ones_like(u)[..., None]], dim=-1)    # (..., S, 4)
    z4 = torch.zeros_like(Xh)
    row_u = torch.cat([Xh, z4, -u[..., None] * Xh], dim=-1)        # (..., S, 12)
    row_v = torch.cat([z4, Xh, -v[..., None] * Xh], dim=-1)
    A = torch.cat([row_u * wmask[..., None], row_v * wmask[..., None]], dim=-2)
    AtA = A.transpose(-1, -2) @ A
    trace = torch.diagonal(AtA, dim1=-2, dim2=-1).sum(-1)
    jitter = 1e-9 * trace + 1e-12
    eye12 = torch.eye(12, dtype=AtA.dtype, device=AtA.device)
    L = cholesky_unrolled(AtA + jitter[..., None, None] * eye12)
    p = torch.full(AtA.shape[:-1], 1.0 / (12.0 ** 0.5), dtype=AtA.dtype,
                   device=AtA.device)
    for _ in range(3):
        p = cho_solve_unrolled(L, p)
        p = p / torch.clamp(torch.linalg.vector_norm(p, dim=-1, keepdim=True),
                            min=1e-30)
    P = p.reshape(p.shape[:-1] + (3, 4))
    Rr = P[..., :, :3]
    det3 = (Rr[..., 0, 0] * (Rr[..., 1, 1] * Rr[..., 2, 2] - Rr[..., 1, 2] * Rr[..., 2, 1])
            - Rr[..., 0, 1] * (Rr[..., 1, 0] * Rr[..., 2, 2] - Rr[..., 1, 2] * Rr[..., 2, 0])
            + Rr[..., 0, 2] * (Rr[..., 1, 0] * Rr[..., 2, 1] - Rr[..., 1, 1] * Rr[..., 2, 0]))
    scale = torch.abs(det3) ** (1.0 / 3.0)
    scale = torch.where(scale < 1e-12, 1.0, scale)
    P = P / scale[..., None, None]
    centroid = (torch.sum(X * wmask[..., None], dim=-2) /
                torch.clamp(torch.sum(wmask, dim=-1), min=1.0)[..., None])
    z_c = torch.sum(P[..., 2, :3] * centroid, dim=-1) + P[..., 2, 3]
    P = P * torch.where(z_c < 0, -1.0, 1.0)[..., None, None]
    R = se3.orthonormalize_newton(P[..., :, :3])
    return se3.from_Rt(R, P[..., :, 3])


def _reproj_err2(cam: Pinhole, T: torch.Tensor, pts3d: torch.Tensor,
                 px: torch.Tensor) -> torch.Tensor:
    pc = se3.transform_points(T, pts3d)
    behind = pc[..., 2] <= 1e-6
    e2 = torch.sum((cam.project(pc) - px) ** 2, dim=-1)
    return torch.where(behind, torch.inf, e2)


def gauss_newton_pose(cam: Pinhole, T0: torch.Tensor, pts3d: torch.Tensor,
                      px: torch.Tensor, weights: torch.Tensor, iters: int = 10,
                      huber_px: float = 2.0) -> torch.Tensor:
    """Masked, Huber-weighted Gauss-Newton refinement of a pose.

    Batched over leading dims: T0 (..., 4, 4), pts3d (..., N, 3),
    px (..., N, 2), weights (..., N). Left-multiplied SE(3) updates; a step
    whose normal matrix is not SPD or whose delta is not finite is skipped.
    """
    T = T0
    fx, fy = cam.fx, cam.fy
    eye6 = torch.eye(6, dtype=pts3d.dtype, device=pts3d.device)
    for _ in range(iters):
        pc = se3.transform_points(T, pts3d)
        x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
        inv_z = 1.0 / torch.clamp(z, min=1e-6)
        u = fx * x * inv_z + cam.cx
        v = fy * y * inv_z + cam.cy
        r = torch.stack([u, v], dim=-1) - px
        rn = torch.sqrt(torch.sum(r * r, dim=-1) + 1e-12)
        wh = torch.where(rn <= huber_px, 1.0, huber_px / rn) * weights
        wh = wh * (z > 1e-6)
        inv_z2 = inv_z * inv_z
        zero = torch.zeros_like(z)
        J = torch.stack([
            torch.stack([fx * inv_z, zero, -fx * x * inv_z2,
                         -fx * x * y * inv_z2, fx * (1 + x * x * inv_z2),
                         -fx * y * inv_z], -1),
            torch.stack([zero, fy * inv_z, -fy * y * inv_z2,
                         -fy * (1 + y * y * inv_z2), fy * x * y * inv_z2,
                         fy * x * inv_z], -1),
        ], dim=-2)                                           # (..., N, 2, 6)
        Jw = J * wh[..., None, None]
        H = torch.einsum("...nij,...nik->...jk", Jw, J) + 1e-6 * eye6
        g = torch.einsum("...nij,...ni->...j", Jw, r)
        L, spd_ok = cholesky_unrolled_flagged(H)
        delta = cho_solve_unrolled(L, -g)
        T_new = se3.se3_exp(delta) @ T
        good = spd_ok & torch.all(torch.isfinite(delta), dim=-1)
        T = torch.where(good[..., None, None], T_new, T)
    return T


def draw_uniforms(num_hypotheses: int, generator: torch.Generator | None = None,
                  dtype: torch.dtype = torch.float32, device=None,
                  batch: int | None = None) -> torch.Tensor:
    """The (num_hypotheses, 6) uniforms in [0, 1) that ``ransac_pnp`` draws
    when it is given no ``u``; a caller that draws them outside the step
    (``models/step_graph.py``) calls this, so both routes take the same
    values from ``generator`` in the same order. ``batch``: one frame's
    draws for that many sequences, (batch, num_hypotheses, 6), in one call
    (``parallel/``)."""
    lead = () if batch is None else (batch,)
    return torch.rand(lead + (num_hypotheses, MIN_SAMPLE), generator=generator, dtype=dtype,
                      device=device)


def ransac_pnp(cam: Pinhole, pts3d: torch.Tensor, px: torch.Tensor,
               valid: torch.Tensor, num_hypotheses: int = 512,
               inlier_px: float = 2.0, refine_iters: int = 10,
               T_init: torch.Tensor | None = None,
               weights: torch.Tensor | None = None,
               u: torch.Tensor | None = None,
               generator: torch.Generator | None = None):
    """Fixed-budget parallel RANSAC-PnP.

    Args:
      pts3d: (N, 3) previous-camera points; px: (N, 2) current-left pixels;
      valid: (N,) bool live correspondences.
      T_init: optional initial pose, scored as one extra hypothesis and used
        as the seed of the Gauss-Newton hypotheses.
      u: optional (num_hypotheses, 6) uniforms in [0, 1) for the samples;
        drawn from ``generator`` when None.
    Returns:
      dict(T (4, 4), inliers (N,) bool, num_inliers, inlier_ratio, ok).
    """
    n = pts3d.shape[0]
    dev, dt = pts3d.device, pts3d.dtype
    if weights is None:
        weights = torch.ones(n, dtype=dt, device=dev)
    if u is None:
        u = draw_uniforms(num_hypotheses, generator, dt, dev)
    elif u.shape != (num_hypotheses, MIN_SAMPLE):
        raise ValueError(f"u must be {(num_hypotheses, MIN_SAMPLE)}, got {tuple(u.shape)}")
    norm2d = _normalize_pixels(cam, px)

    # Compact-then-draw: valid indices first (stable), then (H, 6) uniform
    # positions over the valid prefix, with replacement.
    perm = torch.argsort((~valid).to(torch.int32), stable=True)
    n_valid = torch.clamp(torch.sum(valid), min=1)
    pos = torch.minimum((u * n_valid).to(torch.int64), n_valid - 1)
    samp_idx = perm[pos]                                     # (H, 6)
    pos_sorted = torch.sort(pos, dim=-1).values
    samp_dup = torch.any(pos_sorted[:, 1:] == pos_sorted[:, :-1], dim=-1)

    n_dlt = min(64, num_hypotheses)
    T_seed = torch.eye(4, dtype=dt, device=dev) if T_init is None else T_init
    m = valid[samp_idx].to(dt)
    T_dlt = _dlt_pose(pts3d[samp_idx[:n_dlt]], norm2d[samp_idx[:n_dlt]], m[:n_dlt])
    n_gn = num_hypotheses - n_dlt
    T_gn = gauss_newton_pose(cam, T_seed.expand(n_gn, 4, 4),
                             pts3d[samp_idx[n_dlt:]], px[samp_idx[n_dlt:]],
                             m[n_dlt:], iters=4, huber_px=1e6)
    T_hyp = torch.cat([T_dlt, T_gn], dim=0)
    if T_init is not None:
        T_hyp = torch.cat([T_hyp, T_init[None]], dim=0)

    e2 = _reproj_err2(cam, T_hyp, pts3d, px)                 # (H', N)
    thr2 = inlier_px * inlier_px
    inl = (e2 <= thr2) & valid[None, :]
    msac = torch.sum(torch.where(valid[None, :], torch.clamp(e2, max=thr2), 0.0) *
                     weights[None, :], dim=-1)
    hyp_dup = torch.cat([samp_dup, torch.zeros(T_hyp.shape[0] - num_hypotheses,
                                               dtype=torch.bool, device=dev)])
    msac = torch.where(torch.isnan(msac) | hyp_dup, torch.inf, msac)
    best = torch.argmin(msac).reshape(1)  # a 1-d index: no read back to the host
    T_out, inl_out = T_hyp.index_select(0, best)[0], inl.index_select(0, best)[0]

    # Two rounds of (Gauss-Newton polish -> inlier recount).
    for _ in range(2):
        T_ref = gauss_newton_pose(cam, T_out, pts3d, px,
                                  inl_out.to(dt) * weights,
                                  iters=refine_iters, huber_px=inlier_px)
        inliers_ref = (_reproj_err2(cam, T_ref, pts3d, px) <= thr2) & valid
        use_ref = torch.sum(inliers_ref) >= torch.sum(inl_out)
        T_out = torch.where(use_ref, T_ref, T_out)
        inl_out = torch.where(use_ref, inliers_ref, inl_out)

    num_valid = torch.clamp(torch.sum(valid), min=1)
    num_inl = torch.sum(inl_out)
    return {"T": T_out, "inliers": inl_out, "num_inliers": num_inl,
            "inlier_ratio": num_inl / num_valid, "ok": num_inl >= MIN_SAMPLE}
