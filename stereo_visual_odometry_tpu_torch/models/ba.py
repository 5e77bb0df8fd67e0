"""Sliding-window bundle adjustment: Levenberg-Marquardt with a Schur complement.

Port of ``stereo_visual_odometry_tpu/models/ba.py``, in plain torch ops (the
JAX module is dense XLA, no Pallas kernel):

* Fixed problem capacities: K keyframes, L landmarks, M observations, all
  masked (an observation of weight 0 is dead).
* Batched residuals and Jacobians; per-block sums by ``index_add`` (the
  JAX ``segment_sum``): landmark 3x3 blocks, pose 6x6 blocks and the dense
  (K, L, 6, 3) pose-landmark coupling, so the Schur complement
  ``S = H_pp - H_pl H_ll^-1 H_pl^T`` is two einsums.
* The reduced camera system is a (6K, 6K) solve; landmarks are
  back-substituted in closed form (batched 3x3 inverses).
* LM with multiplicative damping; each step is accepted or rejected on the
  device with ``torch.where``, over a fixed iteration count.
* The first ``n_fixed`` poses are frozen (the gauge).

No call here waits for the device: the inverses and solves are the ``_ex``
forms (no ``info`` check on the host), no value is read back and no branch
depends on a tensor, so a solve needs no host sync and could be captured
in a CUDA graph. On CUDA ``index_add_`` sums with atomics, in an order that
changes from run to run, so two solves agree to float32 rounding, not bit
for bit. Float32 throughout, TF32 off (the package's numerics policy), the
counterpart of JAX's ``Precision.HIGHEST``.
"""
from __future__ import annotations

import torch

from ..ops import se3
from ..ops.camera import Pinhole


def project_residuals(cam: Pinhole, T_cw: torch.Tensor, pts_w: torch.Tensor,
                      obs_uv: torch.Tensor, obs_right: torch.Tensor | None = None,
                      T_rl: torch.Tensor | None = None):
    """Residuals and Jacobians of a batch of observations.

    ``T_cw`` (M, 4, 4) left-camera_from_world pose per observation, ``pts_w``
    (M, 3) its landmark, ``obs_uv`` (M, 2) the measured pixel; ``obs_right``
    (M,) bool marks observations of the rig's right camera (they pin the
    scale a monocular window leaves free), with ``T_rl`` (4, 4)
    right_from_left. Returns (r (M, 2), Jp (M, 2, 6) with respect to the
    left-multiplied pose twist, Jl (M, 2, 3) with respect to the landmark,
    z (M,) the observing camera's depth)."""
    R = T_cw[..., :3, :3]
    t = T_cw[..., :3, 3]
    pl = torch.einsum("mij,mj->mi", R, pts_w) + t  # left-camera point
    if obs_right is not None:
        if T_rl is None:
            raise ValueError("obs_right needs T_rl")
        R_rl, t_rl = T_rl[:3, :3], T_rl[:3, 3]
        pr = torch.einsum("ij,mj->mi", R_rl, pl) + t_rl
        pc = torch.where(obs_right[:, None], pr, pl)
        eye = torch.eye(3, dtype=R.dtype, device=R.device)
        R_pre = torch.where(obs_right[:, None, None], R_rl[None], eye[None])
    else:
        pc, R_pre = pl, None

    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    inv_z = 1.0 / torch.clamp(z, min=1e-6)
    inv_z2 = inv_z * inv_z
    fx, fy = cam.fx, cam.fy
    u = fx * x * inv_z + cam.cx
    v = fy * y * inv_z + cam.cy
    r = torch.stack([u, v], dim=-1) - obs_uv

    zeros = torch.zeros_like(z)
    # d(pixel) / d(observing-camera point)
    Jc = torch.stack([
        torch.stack([fx * inv_z, zeros, -fx * x * inv_z2], -1),
        torch.stack([zeros, fy * inv_z, -fy * y * inv_z2], -1),
    ], dim=-2)  # (M, 2, 3)
    # Through the rig extrinsics: d pc / d pl = R_pre.
    Jcl = Jc if R_pre is None else torch.einsum("mij,mjk->mik", Jc, R_pre)
    # d pl / d(left-mult twist [v, w]) = [I | -hat(pl)]
    Jp = torch.cat([Jcl, torch.einsum("mij,mjk->mik", Jcl, -se3.hat(pl))], dim=-1)
    # d pl / d(landmark) = R
    Jl = torch.einsum("mij,mjk->mik", Jcl, R)
    return r, Jp, Jl, z


def _segment_sum(values: torch.Tensor, index: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.ops.segment_sum``: rows of ``values`` summed by ``index`` into
    ``n`` segments."""
    out = values.new_zeros((n,) + values.shape[1:])
    return out.index_add_(0, index, values)


def assemble_normal_eqs(cam: Pinhole, poses: torch.Tensor, points: torch.Tensor,
                        obs_kf: torch.Tensor, obs_lm: torch.Tensor, obs_uv: torch.Tensor,
                        obs_w: torch.Tensor, huber_px, n_kf: int, n_lm: int,
                        robust: str = "huber", obs_right: torch.Tensor | None = None,
                        T_rl: torch.Tensor | None = None) -> dict:
    """The BA normal equations of an observation table.

    ``poses`` (K, 4, 4) camera_from_world, ``points`` (L, 3); ``obs_kf`` /
    ``obs_lm`` (M,) indices into them, ``obs_uv`` (M, 2) pixels, ``obs_w``
    (M,) weights (0 = dead). ``robust``: 'huber' or 'gm' (Geman-McClure,
    bounded influence: the graduated phases of ``_solve_phases``).
    Returns dict(Hpp (K, 6, 6), Hll (L, 3, 3), Hpl (K, L, 6, 3), bp (K, 6),
    bl (L, 3), cost, n_active)."""
    obs_kf, obs_lm = obs_kf.long(), obs_lm.long()
    r, Jp, Jl, z = project_residuals(cam, poses[obs_kf], points[obs_lm], obs_uv,
                                     obs_right, T_rl)
    rn = torch.sqrt(torch.sum(r * r, dim=-1) + 1e-12)
    if robust == "gm":
        s = (rn / huber_px) ** 2
        rw = 1.0 / (1.0 + s) ** 2
    else:
        rw = torch.where(rn <= huber_px, 1.0, huber_px / rn)
    w = obs_w * rw * (z > 1e-6)

    cost = 0.5 * torch.sum(w * rn * rn)
    n_active = torch.sum(obs_w > 0)
    Jpw = Jp * w[:, None, None]
    Jlw = Jl * w[:, None, None]
    Hpp_m = torch.einsum("mia,mib->mab", Jpw, Jp)   # (M, 6, 6)
    Hll_m = torch.einsum("mia,mib->mab", Jlw, Jl)   # (M, 3, 3)
    Hpl_m = torch.einsum("mia,mib->mab", Jpw, Jl)   # (M, 6, 3)
    bp_m = torch.einsum("mia,mi->ma", Jpw, r)       # (M, 6)
    bl_m = torch.einsum("mia,mi->ma", Jlw, r)       # (M, 3)
    # The dense coupling blocks: summed into the (K*L) flattened pair index.
    pair = obs_kf * n_lm + obs_lm
    return {"Hpp": _segment_sum(Hpp_m, obs_kf, n_kf),
            "Hll": _segment_sum(Hll_m, obs_lm, n_lm),
            "Hpl": _segment_sum(Hpl_m, pair, n_kf * n_lm).reshape(n_kf, n_lm, 6, 3),
            "bp": _segment_sum(bp_m, obs_kf, n_kf), "bl": _segment_sum(bl_m, obs_lm, n_lm),
            "cost": cost, "n_active": n_active}


def _damped(H: torch.Tensor, lam, eps: float) -> torch.Tensor:
    """``H + lam * diag(H) + eps * I`` over a batch of square blocks."""
    eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
    return H + lam * torch.diag_embed(torch.diagonal(H, dim1=-2, dim2=-1)) + eps * eye


def schur_partials(eqs: dict, lm_damping):
    """Landmark elimination (JAX ``ba.py:153``). Returns (reduced, local):
    ``reduced`` the reduced camera system's parts S_part (K, K, 6, 6),
    b_part (K, 6), Hpp, bp; ``local`` what back-substitution needs
    (Hll_inv, W, bl)."""
    Hll, W = eqs["Hll"], eqs["Hpl"]
    Hll_inv = torch.linalg.inv_ex(_damped(Hll, lm_damping, 1e-8)).inverse  # (L, 3, 3)
    WHinv = torch.einsum("klab,lbc->klac", W, Hll_inv)
    S_part = -torch.einsum("klac,jlbc->kjab", WHinv, W)  # (K, K, 6, 6)
    b_part = -torch.einsum("klac,lc->ka", WHinv, eqs["bl"])
    reduced = {"S_part": S_part, "b_part": b_part, "Hpp": eqs["Hpp"], "bp": eqs["bp"]}
    local = {"Hll_inv": Hll_inv, "W": W, "bl": eqs["bl"]}
    return reduced, local


def add_diagonal_blocks(S: torch.Tensor, blocks: torch.Tensor) -> torch.Tensor:
    """``S[k, k] + blocks[k]`` on the block diagonal of a (K, K, n, n) block
    matrix (a copy; JAX's ``S.at[k, k].add``)."""
    out = S.clone()
    out.diagonal(dim1=0, dim2=1).add_(blocks.permute(1, 2, 0))
    return out


def solve_reduced(reduced: dict, lm_damping, n_fixed: int, Hpp_cross=None) -> torch.Tensor:
    """Solve the reduced camera system -> dx_pose (K, 6). Pose damping goes
    on the summed ``Hpp``; ``Hpp_cross`` is a marginalization prior's dense
    pose-pose information (its gradient already sits in ``bp``)."""
    Hpp = reduced["Hpp"]
    K = Hpp.shape[0]
    S_blocks = add_diagonal_blocks(reduced["S_part"], _damped(Hpp, lm_damping, 1e-8))
    if Hpp_cross is not None:
        S_blocks = S_blocks + Hpp_cross
    b = (reduced["bp"] + reduced["b_part"]).reshape(6 * K)
    S = S_blocks.permute(0, 2, 1, 3).reshape(6 * K, 6 * K)
    if n_fixed > 0:
        # Gauge: pin the first n_fixed poses' rows and columns.
        free = torch.arange(6 * K, device=S.device) >= 6 * n_fixed
        S = torch.where(free[:, None] & free[None, :], S,
                        torch.eye(6 * K, dtype=S.dtype, device=S.device))
        b = torch.where(free, b, 0.0)
    return -torch.linalg.solve_ex(S, b).result.reshape(K, 6)


def back_substitute(local: dict, dx_pose: torch.Tensor) -> torch.Tensor:
    """dx_l = -Hll^-1 (bl + W^T dx_p)."""
    Wt_dx = torch.einsum("klab,ka->lb", local["W"], dx_pose)
    return -torch.einsum("lab,lb->la", local["Hll_inv"], local["bl"] + Wt_dx)


def solve_schur(eqs: dict, lm_damping, n_fixed: int):
    """Schur-complement solve of the damped normal equations -> (dx_pose
    (K, 6), dx_point (L, 3)); the first ``n_fixed`` pose updates are 0."""
    reduced, local = schur_partials(eqs, lm_damping)
    dx_pose = solve_reduced(reduced, lm_damping, n_fixed, Hpp_cross=eqs.get("Hpp_cross"))
    return dx_pose, back_substitute(local, dx_pose)


def _apply(poses, points, dx_pose, dx_point):
    return se3.se3_exp(dx_pose) @ poses, points + dx_point


def _lm_loop(cam, poses, points, obs_kf, obs_lm, obs_uv, obs_w, n_iters, n_fixed,
             huber_px, init_damping, robust="huber", obs_right=None, T_rl=None,
             reduce_tree=None, prior=None, schur_reduce=False):
    """One LM phase of ``n_iters`` damped Schur steps, each accepted on the
    device iff the cost is finite and lower. ``prior``: a marginalization
    prior (``models/marg.py``) or None. Returns (poses, points, damping,
    cost, cost0).

    ``reduce_tree`` (JAX ``models/ba.py:240-310``) sums trees of tensors
    across observation shards: None on one device, an all-reduce in the
    distributed solve (``parallel/dist_ba.py``). A cost probe reduces only
    its scalar. ``schur_reduce`` moves a step's reduction after landmark
    elimination (shards must then be landmark-coherent,
    ``dist_ba.partition_obs_by_landmark``): the reduced camera system
    (S_part (K, K, 6, 6), b_part, Hpp, bp) and each shard's landmark
    update are reduced, never the dense (K, L, 6, 3) coupling, and the
    prior's gradient and cross blocks join after the reduction. Without
    it the assembled equations are reduced whole."""
    from . import marg

    n_kf, n_lm = poses.shape[0], points.shape[0]
    red = (lambda t: t) if reduce_tree is None else reduce_tree

    def eqs_of(p, x):
        return assemble_normal_eqs(cam, p, x, obs_kf, obs_lm, obs_uv, obs_w, huber_px,
                                   n_kf, n_lm, robust=robust, obs_right=obs_right, T_rl=T_rl)

    def cost_of(p, x):
        c = red(eqs_of(p, x)["cost"])
        if prior is not None:
            c = c + marg.prior_energy(prior, p)
        return c

    def step_of(p, x, lam):
        e = eqs_of(p, x)
        if schur_reduce and reduce_tree is not None:
            reduced, local = schur_partials(e, lam)
            reduced = red(reduced)
            cross = None
            if prior is not None:
                reduced = dict(reduced, bp=reduced["bp"] + marg.prior_gradient(
                    prior, marg.prior_deltas(prior, p)))
                cross = prior["H"]
            dxp = solve_reduced(reduced, lam, n_fixed, Hpp_cross=cross)
            # Each shard back-substitutes its own landmarks (the others give
            # zero); the sum is the whole update on every shard.
            return dxp, red(back_substitute(local, dxp))
        e = red(e)
        if prior is not None:
            e = marg.add_prior_to_eqs(e, prior, p)
        return solve_schur(e, lam, n_fixed)

    cost0 = cost_of(poses, points)
    p, x, cost = poses, points, cost0
    lam = torch.full((), init_damping, dtype=poses.dtype, device=poses.device)
    for _ in range(n_iters):
        dxp, dxl = step_of(p, x, lam)
        p_new, x_new = _apply(p, x, dxp, dxl)
        new_cost = cost_of(p_new, x_new)
        ok = torch.isfinite(new_cost) & (new_cost < cost)
        # Damping: down on success, up on failure.
        lam = torch.where(ok, torch.clamp(lam * 0.3, min=1e-9), torch.clamp(lam * 4.0, max=1e4))
        p = torch.where(ok, p_new, p)
        x = torch.where(ok, x_new, x)
        cost = torch.where(ok, new_cost, cost)
    return p, x, lam, cost, cost0


def _solve_phases(cam, poses, points, obs_kf, obs_lm, obs_uv, obs_w, n_iters, n_fixed,
                  huber_px, init_damping, gm_polish, prune_px, obs_right=None, T_rl=None,
                  reduce_tree=None, prior=None, schur_reduce=False):
    """The whole solve schedule (JAX ``ba.py:333``): graduated
    non-convexity (Geman-McClure at 16, 4 and 1 times ``huber_px``) or one
    Huber phase, then optionally prune-and-repolish (a decision per
    observation, local to a shard). ``reduce_tree`` and ``schur_reduce``
    as in ``_lm_loop``. Returns (poses, points, damping, cost_final,
    cost_initial, obs_w)."""
    if gm_polish:
        schedule = [("gm", 16.0, n_iters), ("gm", 4.0, max(n_iters // 2, 2)),
                    ("gm", 1.0, max(n_iters // 2, 2))]
    else:
        schedule = [("huber", 1.0, n_iters)]
    kw = dict(obs_right=obs_right, T_rl=T_rl, prior=prior, reduce_tree=reduce_tree,
              schur_reduce=schur_reduce)
    poses_f, points_f, cost0 = poses, points, None
    for robust, mult, iters in schedule:
        poses_f, points_f, lam_f, cost_f, c0 = _lm_loop(
            cam, poses_f, points_f, obs_kf, obs_lm, obs_uv, obs_w, iters, n_fixed,
            huber_px * mult, init_damping, robust=robust, **kw)
        if cost0 is None:
            cost0 = c0

    if prune_px is not None:
        r, _, _, z = project_residuals(cam, poses_f[obs_kf.long()], points_f[obs_lm.long()],
                                       obs_uv, obs_right, T_rl)
        rn = torch.linalg.vector_norm(r, dim=-1)
        obs_w = obs_w * ((rn <= prune_px) & (z > 1e-6))
        poses_f, points_f, lam_f, cost_f, _ = _lm_loop(
            cam, poses_f, points_f, obs_kf, obs_lm, obs_uv, obs_w, max(n_iters // 2, 2),
            n_fixed, huber_px, init_damping, **kw)
    return poses_f, points_f, lam_f, cost_f, cost0, obs_w


def bundle_adjust(cam: Pinhole, poses: torch.Tensor, points: torch.Tensor,
                  obs_kf: torch.Tensor, obs_lm: torch.Tensor, obs_uv: torch.Tensor,
                  obs_w: torch.Tensor, n_iters: int = 10, n_fixed: int = 1,
                  huber_px: float = 2.0, init_damping: float = 1e-3,
                  prune_px: float | None = None, gm_polish: bool = True,
                  obs_right: torch.Tensor | None = None, T_rl: torch.Tensor | None = None,
                  prior: dict | None = None) -> dict:
    """Windowed LM bundle adjustment on the tensors' device.

    ``poses`` (K, 4, 4) camera_from_world initial keyframe poses, ``points``
    (L, 3) initial landmarks, ``obs_*`` the (M,) observation table (indices,
    pixels, weights); ``n_fixed`` leading poses stay fixed; ``prune_px``:
    after the main solve, observations with a residual above it are
    zero-weighted and a short re-polish runs; ``prior``: a marginalization
    prior (``models/marg.py``). Returns dict(poses, points, cost_initial,
    cost_final, damping, obs_w), all tensors."""
    poses_f, points_f, lam_f, cost_f, cost0, obs_w = _solve_phases(
        cam, poses, points, obs_kf, obs_lm, obs_uv, obs_w, n_iters, n_fixed, huber_px,
        init_damping, gm_polish, prune_px, obs_right, T_rl, prior=prior)
    return {"poses": poses_f, "points": points_f, "cost_initial": cost0,
            "cost_final": cost_f, "damping": lam_f, "obs_w": obs_w}
