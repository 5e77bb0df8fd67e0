"""Schur marginalization of keyframes sliding out of the BA window.

Port of ``stereo_visual_odometry_tpu/models/marg.py``. When keyframe 0
leaves the window, the landmarks it consumes and the pose itself are
Schur-eliminated from the normal equations over all observations of those
landmarks, leaving a dense quadratic prior over the surviving window poses.

Prior (fixed window capacity K), a dict of tensors:
  H     (K, K, 6, 6)  information over pose deltas (dense cross blocks)
  b     (K, 6)        gradient at the linearization points
  T_lin (K, 4, 4)     camera_from_world linearization points
  mask  (K,)          which slots the prior constrains

Pose deltas use the BA update's left-multiplicative twist
(``ba._apply``: ``T <- se3_exp(dx) @ T``): ``delta_k = se3_log(T_k @
T_lin_k^-1)``. As in ``ba``, no call waits for the device (``solve_ex``,
``inv_ex``).
"""
from __future__ import annotations

import torch

from . import ba
from ..ops import se3
from ..ops.camera import Pinhole


def empty_prior(window: int, dtype=torch.float32, device=None) -> dict:
    return {
        "H": torch.zeros((window, window, 6, 6), dtype=dtype, device=device),
        "b": torch.zeros((window, 6), dtype=dtype, device=device),
        "T_lin": torch.eye(4, dtype=dtype, device=device).expand(window, 4, 4).clone(),
        "mask": torch.zeros((window,), dtype=torch.bool, device=device),
    }


def prior_deltas(prior: dict, poses: torch.Tensor) -> torch.Tensor:
    """(K, 6) left-mult twists of ``poses`` with respect to the prior's
    linearization points, zero where the prior constrains nothing."""
    d = se3.se3_log(poses.to(prior["b"].dtype) @ se3.se3_inv(prior["T_lin"]))
    return d * prior["mask"][:, None]


def _energy(prior: dict, delta: torch.Tensor) -> torch.Tensor:
    return (0.5 * torch.einsum("ka,kjab,jb->", delta, prior["H"], delta)
            + torch.sum(prior["b"] * delta))


def prior_energy(prior: dict, poses: torch.Tensor) -> torch.Tensor:
    """The prior's quadratic at ``poses`` (the LM cost probe's share)."""
    return _energy(prior, prior_deltas(prior, poses))


def prior_gradient(prior: dict, delta: torch.Tensor) -> torch.Tensor:
    """The prior's masked (K, 6) gradient at the pose deltas ``delta``."""
    return (torch.einsum("kjab,jb->ka", prior["H"], delta) + prior["b"]) * prior["mask"][:, None]


def add_prior_to_eqs(eqs: dict, prior: dict, poses: torch.Tensor) -> dict:
    """Fold the prior into assembled normal equations: its gradient into
    ``bp``, its dense cross blocks into ``Hpp_cross`` (read by
    ``ba.solve_schur``), its energy into ``cost``."""
    delta = prior_deltas(prior, poses)
    eqs = dict(eqs)
    eqs["bp"] = eqs["bp"] + prior_gradient(prior, delta)
    eqs["Hpp_cross"] = eqs.get("Hpp_cross", 0.0) + prior["H"]
    eqs["cost"] = eqs["cost"] + _energy(prior, delta)
    return eqs


def _schur_poses(cam: Pinhole, poses, points, obs_kf, obs_lm, obs_uv, obs_w, huber_px,
                 obs_right=None, T_rl=None, prior_H=None, prior_b=None):
    """The normal equations over (poses, points) with the points
    eliminated: dense (K, K, 6, 6) pose information and (K, 6) gradient."""
    n_kf, n_lm = poses.shape[0], points.shape[0]
    eqs = ba.assemble_normal_eqs(cam, poses, points, obs_kf, obs_lm, obs_uv, obs_w,
                                 huber_px, n_kf, n_lm, obs_right=obs_right, T_rl=T_rl)
    eye3 = torch.eye(3, dtype=eqs["Hll"].dtype, device=eqs["Hll"].device)
    Hll_inv = torch.linalg.inv_ex(eqs["Hll"] + 1e-6 * eye3).inverse
    W = eqs["Hpl"]                                        # (K, L, 6, 3)
    WHinv = torch.einsum("klab,lbc->klac", W, Hll_inv)
    S = ba.add_diagonal_blocks(-torch.einsum("klac,jlbc->kjab", WHinv, W), eqs["Hpp"])
    g = eqs["bp"] - torch.einsum("klac,lc->ka", WHinv, eqs["bl"])
    if prior_H is not None:
        S = S + prior_H
        g = g + prior_b
    return S, g


def build_prior(cam: Pinhole, poses: torch.Tensor, points: torch.Tensor,
                obs_kf: torch.Tensor, obs_lm: torch.Tensor, obs_uv: torch.Tensor,
                obs_w: torch.Tensor, huber_px, obs_right: torch.Tensor | None = None,
                T_rl: torch.Tensor | None = None, carry_H: torch.Tensor | None = None,
                carry_b: torch.Tensor | None = None) -> dict:
    """Marginalize pose slot 0 out of the consumed-observation system.

    ``poses`` (K, 4, 4) camera_from_world window poses at marginalization
    (the new linearization points, shifted left one slot); ``points`` (L,
    3) the landmarks being marginalized (padded, dead rows zero-weighted
    through ``obs_w``); ``obs_*`` every observation of them;
    ``carry_H`` / ``carry_b`` an earlier prior already re-expressed at
    ``poses`` (``shift_prior``), folded in before the elimination. Returns
    a prior indexed for the slid window: slot k holds what was slot k+1,
    the last slot is empty."""
    K = poses.shape[0]
    S, g = _schur_poses(cam, poses, points, obs_kf, obs_lm, obs_uv, obs_w, huber_px,
                        obs_right, T_rl, carry_H, carry_b)
    # Eliminate pose slot 0: H' = S11 - S10 S00^-1 S01.
    S_flat = S.permute(0, 2, 1, 3).reshape(6 * K, 6 * K)
    g_flat = g.reshape(6 * K)
    A = S_flat[:6, :6] + 1e-6 * torch.eye(6, dtype=S.dtype, device=S.device)
    B = S_flat[:6, 6:]                        # (6, 6(K-1))
    Ainv_B = torch.linalg.solve_ex(A, B).result
    H_red = S_flat[6:, 6:] - B.T @ Ainv_B     # (6(K-1), 6(K-1))
    g_red = g_flat[6:] - Ainv_B.T @ g_flat[:6]
    H_red = 0.5 * (H_red + H_red.T)           # symmetric up to the solve's rounding

    H_out = S.new_zeros((K, K, 6, 6))
    H_out[:K - 1, :K - 1] = H_red.reshape(K - 1, 6, K - 1, 6).permute(0, 2, 1, 3)
    b_out = S.new_zeros((K, 6))
    b_out[:K - 1] = g_red.reshape(K - 1, 6)
    eye4 = torch.eye(4, dtype=poses.dtype, device=poses.device)
    return {"H": H_out, "b": b_out, "T_lin": torch.cat([poses[1:], eye4[None]]),
            "mask": torch.arange(K, device=poses.device) < (K - 1)}


def shift_prior(prior: dict, poses_now: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Re-express a prior at new linearization points ``poses_now`` (same
    slot indexing): returns (H, b') with b' = b + H delta, delta =
    log(poses_now @ T_lin^-1), so the quadratic relinearized at
    ``poses_now`` carries the same information."""
    delta = prior_deltas(prior, poses_now)
    return prior["H"], prior["b"] + torch.einsum("kjab,jb->ka", prior["H"], delta)
