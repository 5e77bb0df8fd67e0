"""A plain reference of the sliding-window solve and of the prior a slide
leaves, in float64.

The same problems as the program's ``models/ba.py`` ``bundle_adjust`` and
``models/marg.py`` (``shift_prior``, ``build_prior``, as the backend chains
them at each slide), written again in plain ``torch`` from their contracts.
It imports nothing of the program.

What it solves is what ``bundle_adjust`` solves:

* the cost: each observation's pixel residual in the left camera, or in
  the rig's right camera (``obs_right``, through ``T_rl``), weighted by
  ``obs_w`` and a robust kernel, ``0.5 * sum(w * (|r|^2 + 1e-12))``; a
  point at depth 1e-6 or less weighs nothing; plus the marginalization
  prior's quadratic over the window's pose slots;
* the robust kernel: Huber at ``huber_px`` (weight ``min(1, huber_px /
  |r|)``), or Geman-McClure (weight ``1 / (1 + (|r| / s)^2)^2``);
* the phases: with ``gm_polish`` Geman-McClure at 16, 4 and 1 times
  ``huber_px`` (``n_iters``, then ``max(n_iters // 2, 2)`` twice), else
  one Huber phase of ``n_iters``; then, with ``prune_px``, every
  observation whose residual exceeds ``prune_px`` (or whose depth is 1e-6
  or less) is zero-weighted and a Huber phase of ``max(n_iters // 2, 2)``
  re-polishes;
* a phase: Levenberg-Marquardt from damping ``init_damping``; each step
  solves ``(H + lam * diag(H) + 1e-8 I + H_prior) dx = -g`` (the prior's
  information undamped), with the first ``n_fixed`` poses held fixed;
  it moves each pose by ``exp(dx_pose) @ T`` and each landmark by
  ``dx_point``; a step is kept iff its cost is finite and lower, and the
  damping goes to ``max(0.3 lam, 1e-9)`` on a kept step, ``min(4 lam,
  1e4)`` on a refused one.

The prior a slide leaves (``build_prior``): the window before the slide,
W + 1 poses, and the landmarks the slide consumes with every observation of
them; their Huber normal equations at the poses and landmarks as they are;
the prior carried from the slide before, re-expressed at these poses (``b +
H delta``, ``delta`` the masked left twist from its linearization points to
them) and scaled by ``decay``, added over the first W slots; then pose 0
and every landmark eliminated together (Schur complement, 1e-6 added to
their diagonal). What is left is a quadratic over the W poses that stay,
linearized at them, in the layout the program keeps (``H`` (W, W, 6, 6),
``b`` (W, 6), ``T_lin``, ``mask``).

Departures from ``models/ba.py`` and ``models/marg.py``, each on purpose:

* the normal equations are built whole from a dense Jacobian (2 rows per
  observation, 6K + 3L columns) and solved whole with
  ``torch.linalg.solve``: no Schur complement in the solve (the prior's
  is one dense elimination of pose 0 and the landmarks together, where
  ``marg.py`` eliminates the landmarks first), no fixed-capacity tables,
  no padding. Dead observations (weight 0) and the landmarks no live
  observation sees are left out of the system (``bundle_adjust`` carries
  them with a zero update); the fixed poses' columns are left out (it
  pins them with identity rows);
* float64 by default (``dtype``); TF32 off;
* each step's accept decision is a Python branch, read on the host;
* the SE(3) exponential and logarithm are written here, the logarithm's
  angle as atan2 of the skew part's norm over the symmetric part's; no
  special case near a half turn (a window's steps and prior deltas are
  small);
* in a dtype that ``torch.linalg.solve`` does not take (bfloat16: the
  benchmark's control), the linear solve runs in float32 on the rounded
  system and its answer is rounded back.
"""
from __future__ import annotations

import torch


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def hat(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrices."""
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Twists (..., 6) ``[v, w]`` -> (..., 4, 4) transforms."""
    v, w = xi[..., :3], xi[..., 3:]
    th2 = (w * w).sum(-1)[..., None, None]
    th = torch.sqrt(th2)
    small = th2 < 1e-10
    safe = torch.where(small, torch.ones_like(th), th)
    A = torch.where(small, 1.0 - th2 / 6.0, torch.sin(safe) / safe)
    B = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(safe)) / (safe * safe))
    C = torch.where(small, 1.0 / 6.0 - th2 / 120.0, (safe - torch.sin(safe)) / safe ** 3)
    W = hat(w)
    WW = W @ W
    I = _eye(3, w)
    R = I + A * W + B * WW
    t = ((I + B * W + C * WW) @ v[..., None])[..., 0]
    T = torch.zeros(xi.shape[:-1] + (4, 4), dtype=xi.dtype, device=xi.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def angle_axis(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotations -> (..., 3) rotation vectors."""
    s = 0.5 * torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                           R[..., 1, 0] - R[..., 0, 1]], -1)
    sn = torch.linalg.vector_norm(s, dim=-1)
    c = 0.5 * (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0)
    th = torch.atan2(sn, c)
    small = sn < 1e-10
    scale = torch.where(small, 1.0 + th * th / 6.0, th / torch.where(small, 1.0, sn))
    return s * scale[..., None]


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) transforms -> twists (..., 6) ``[v, w]``."""
    w = angle_axis(T[..., :3, :3])
    th2 = (w * w).sum(-1)[..., None, None]
    th = torch.sqrt(th2)
    small = th2 < 1e-10
    safe = torch.where(small, torch.ones_like(th), th)
    D = torch.where(small, 1.0 / 12.0 + th2 / 720.0,
                    (1.0 - safe * torch.sin(safe) / (2.0 * (1.0 - torch.cos(safe))))
                    / (safe * safe))
    W = hat(w)
    v = ((_eye(3, w) - 0.5 * W + D * (W @ W)) @ T[..., :3, 3][..., None])[..., 0]
    return torch.cat([v, w], -1)


def invert(T: torch.Tensor) -> torch.Tensor:
    """Inverses of (..., 4, 4) rigid transforms."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    out = torch.zeros_like(T)
    out[..., :3, :3] = Rt
    out[..., :3, 3] = -(Rt @ T[..., :3, 3][..., None])[..., 0]
    out[..., 3, 3] = 1.0
    return out


class Problem:
    """One window's problem in ``dtype``, without its padding: the poses,
    the landmarks live observations see, those observations, and the
    prior as a dense (6K, 6K) matrix."""

    def __init__(self, cam, poses, points, obs_kf, obs_lm, obs_uv, obs_w, obs_right=None,
                 T_rl=None, prior=None, dtype=torch.float64):
        dev = poses.device
        cast = lambda a: torch.as_tensor(a, device=dev).to(dtype)
        self.dtype, self.K = dtype, poses.shape[0]
        self.fx, self.fy, self.cx, self.cy = (cast(getattr(cam, k)) for k in ("fx", "fy",
                                                                             "cx", "cy"))
        live = torch.as_tensor(obs_w, device=dev) > 0
        lms, lm_of = torch.unique(torch.as_tensor(obs_lm, device=dev)[live].long(),
                                  return_inverse=True)
        self.lms, self.L = lms, len(lms)
        self.live = live
        self.kf = torch.as_tensor(obs_kf, device=dev)[live].long()
        self.lm = lm_of
        self.uv = cast(obs_uv)[live]
        self.w = cast(obs_w)[live]
        self.right = (None if obs_right is None
                      else torch.as_tensor(obs_right, device=dev)[live].bool())
        self.T_rl = None if T_rl is None else cast(T_rl)
        self.poses0 = cast(poses)
        self.points0 = cast(points)[lms]
        self.prior = None
        if prior is not None:
            K = self.K
            self.prior = {"H": cast(prior["H"]).permute(0, 2, 1, 3).reshape(6 * K, 6 * K),
                          "b": cast(prior["b"]).reshape(6 * K),
                          "T_lin": cast(prior["T_lin"]),
                          "mask": torch.as_tensor(prior["mask"], device=dev).bool()}

    @property
    def n(self) -> int:
        return 6 * self.K + 3 * self.L

    def project(self, poses, points):
        """Residuals (M, 2), pose Jacobians (M, 2, 6) in the left-multiplied
        twist, landmark Jacobians (M, 2, 3), observing-camera depths (M,)."""
        T = poses[self.kf]
        R, t = T[:, :3, :3], T[:, :3, 3]
        pl = (R @ points[self.lm][..., None])[..., 0] + t
        pre = _eye(3, pl).expand(len(pl), 3, 3)
        pc = pl
        if self.right is not None:
            if self.T_rl is None:
                raise ValueError("obs_right needs T_rl")
            R_rl, t_rl = self.T_rl[:3, :3], self.T_rl[:3, 3]
            pc = torch.where(self.right[:, None], pl @ R_rl.T + t_rl, pl)
            pre = torch.where(self.right[:, None, None], R_rl, pre)
        x, y, z = pc.unbind(-1)
        zc = torch.clamp(z, min=1e-6)
        r = torch.stack([self.fx * x / zc + self.cx, self.fy * y / zc + self.cy], -1) - self.uv
        zero = torch.zeros_like(z)
        Jc = torch.stack([torch.stack([self.fx / zc, zero, -self.fx * x / (zc * zc)], -1),
                          torch.stack([zero, self.fy / zc, -self.fy * y / (zc * zc)], -1)], -2)
        Jcl = Jc @ pre
        return r, torch.cat([Jcl, -Jcl @ hat(pl)], -1), Jcl @ R, z

    def weights(self, r, z, w, robust: str, scale):
        """Per observation: the robust weight times ``w`` (zero behind the
        camera), and ``|r|^2 + 1e-12``."""
        rn2 = (r * r).sum(-1) + 1e-12
        rn = torch.sqrt(rn2)
        if robust == "gm":
            rw = 1.0 / (1.0 + rn2 / (scale * scale)) ** 2
        else:
            rw = torch.where(rn <= scale, torch.ones_like(rn), scale / rn)
        return w * rw * (z > 1e-6), rn2

    def prior_delta(self, poses):
        d = se3_log(poses @ invert(self.prior["T_lin"])) * self.prior["mask"][:, None]
        return d.reshape(-1)

    def cost(self, poses, points, w, robust="huber", scale=None):
        """The observations' robust cost plus the prior's quadratic."""
        r, _, _, z = self.project(poses, points)
        wt, rn2 = self.weights(r, z, w, robust, scale)
        c = 0.5 * (wt * rn2).sum()
        if self.prior is not None:
            d = self.prior_delta(poses)
            c = c + 0.5 * d @ (self.prior["H"] @ d) + self.prior["b"] @ d
        return c

    def system(self, poses, points, w, robust, scale):
        """The dense normal equations: H (n, n) from the observations, the
        prior's information (n, n) apart, and g (n,) with the prior's
        gradient in it."""
        r, Jp, Jl, z = self.project(poses, points)
        wt, _ = self.weights(r, z, w, robust, scale)
        M, K = len(r), self.K
        J = torch.zeros((M, 2, self.n), dtype=self.dtype, device=r.device)
        pcol = 6 * self.kf[:, None] + torch.arange(6, device=r.device)
        lcol = 6 * K + 3 * self.lm[:, None] + torch.arange(3, device=r.device)
        J.scatter_(2, pcol[:, None, :].expand(M, 2, 6), Jp)
        J.scatter_(2, lcol[:, None, :].expand(M, 2, 3), Jl)
        J = J.reshape(2 * M, self.n)
        w2 = wt.repeat_interleave(2)
        H = J.T @ (w2[:, None] * J)
        g = J.T @ (w2 * r.reshape(-1))
        Hp = torch.zeros_like(H)
        if self.prior is not None:
            P = self.prior["H"]
            Hp[:6 * K, :6 * K] = P
            g[:6 * K] += (P @ self.prior_delta(poses) + self.prior["b"]) * \
                self.prior["mask"].repeat_interleave(6)
        return H, Hp, g


def _solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if A.dtype in (torch.float32, torch.float64):
        return torch.linalg.solve(A, b)
    return torch.linalg.solve(A.float(), b.float()).to(A.dtype)


def _phase(pb: Problem, poses, points, w, robust, scale, iters, n_fixed, init_damping):
    """One LM phase. Returns (poses, points, damping, cost, cost at the
    start, steps kept)."""
    n, K = pb.n, pb.K
    free = torch.arange(n, device=poses.device) >= 6 * n_fixed
    cost0 = cost = pb.cost(poses, points, w, robust, scale)
    lam, kept = init_damping, 0
    for _ in range(iters):
        H, Hp, g = pb.system(poses, points, w, robust, scale)
        A = H + lam * torch.diag(torch.diagonal(H)) + 1e-8 * _eye(n, H) + Hp
        dx = torch.zeros_like(g)
        dx[free] = -_solve(A[free][:, free], g[free])
        p_new = se3_exp(dx[:6 * K].reshape(K, 6)) @ poses
        x_new = points + dx[6 * K:].reshape(-1, 3)
        new = pb.cost(p_new, x_new, w, robust, scale)
        if bool(torch.isfinite(new)) and bool(new < cost):
            poses, points, cost, kept = p_new, x_new, new, kept + 1
            lam = max(lam * 0.3, 1e-9)
        else:
            lam = min(lam * 4.0, 1e4)
    return poses, points, lam, cost, cost0, kept


def bundle_adjust(cam, poses, points, obs_kf, obs_lm, obs_uv, obs_w, n_iters: int = 10,
                  n_fixed: int = 1, huber_px: float = 2.0, init_damping: float = 1e-3,
                  prune_px: float | None = None, gm_polish: bool = True, obs_right=None,
                  T_rl=None, prior: dict | None = None, dtype=torch.float64) -> dict:
    """``models/ba.py``'s ``bundle_adjust`` (the same arguments), worked out
    plainly in ``dtype`` on the inputs' device. Returns dict(poses (K, 4,
    4), points (L, 3), cost_initial, cost_final, damping, obs_w (M,),
    lm_iters, lm_accepted), in ``dtype``; landmarks no live observation
    sees come back as they went in."""
    _no_tf32()
    pb = Problem(cam, poses, points, obs_kf, obs_lm, obs_uv, obs_w, obs_right, T_rl, prior,
                 dtype)
    if gm_polish:
        schedule = [("gm", 16.0, n_iters), ("gm", 4.0, max(n_iters // 2, 2)),
                    ("gm", 1.0, max(n_iters // 2, 2))]
    else:
        schedule = [("huber", 1.0, n_iters)]
    p, x, w = pb.poses0, pb.points0, pb.w
    cost0, iters, kept = None, 0, 0
    for robust, mult, n in schedule:
        p, x, lam, cost, c0, k = _phase(pb, p, x, w, robust, huber_px * mult, n, n_fixed,
                                        init_damping)
        cost0 = c0 if cost0 is None else cost0
        iters, kept = iters + n, kept + k
    if prune_px is not None:
        r, _, _, z = pb.project(p, x)
        w = w * ((torch.linalg.vector_norm(r, dim=-1) <= prune_px) & (z > 1e-6))
        n = max(n_iters // 2, 2)
        p, x, lam, cost, _, k = _phase(pb, p, x, w, "huber", huber_px, n, n_fixed,
                                       init_damping)
        iters, kept = iters + n, kept + k
    points_out = torch.as_tensor(points, device=p.device).to(dtype).clone()
    points_out[pb.lms] = x
    w_out = torch.zeros(pb.live.shape, dtype=dtype, device=p.device)
    w_out[pb.live] = w
    return {"poses": p, "points": points_out, "cost_initial": cost0, "cost_final": cost,
            "damping": lam, "obs_w": w_out, "lm_iters": iters, "lm_accepted": kept}


def final_cost(cam, poses, points, obs_kf, obs_lm, obs_uv, obs_w, huber_px: float = 2.0,
               obs_right=None, T_rl=None, prior: dict | None = None,
               dtype=torch.float64) -> torch.Tensor:
    """The cost of a solve's last phase at ``poses`` and ``points``: Huber
    at ``huber_px`` over the observations ``obs_w`` weighs (a solve's
    pruned weights), plus the prior's quadratic, in ``dtype``."""
    _no_tf32()
    pb = Problem(cam, poses, points, obs_kf, obs_lm, obs_uv, obs_w, obs_right, T_rl, prior,
                 dtype)
    return pb.cost(pb.poses0, pb.points0, pb.w, "huber", huber_px)


def pose_gaps(poses_a: torch.Tensor, poses_b: torch.Tensor) -> tuple[float, float]:
    """The largest distance between the camera centres of two sets of
    camera_from_world poses, and the largest angle between their
    rotations (atan2 of the skew part's norm over the symmetric part's)."""
    a, b = poses_a.to(torch.float64), poses_b.to(torch.float64)
    ca = -(a[:, :3, :3].transpose(-1, -2) @ a[:, :3, 3][..., None])[..., 0]
    cb = -(b[:, :3, :3].transpose(-1, -2) @ b[:, :3, 3][..., None])[..., 0]
    turn = angle_axis(a[:, :3, :3] @ b[:, :3, :3].transpose(-1, -2))
    return (float(torch.linalg.vector_norm(ca - cb, dim=-1).max()),
            float(torch.linalg.vector_norm(turn, dim=-1).max()))


def _dense(H: torch.Tensor) -> torch.Tensor:
    """(K, K, 6, 6) blocks -> (6K, 6K)."""
    K = H.shape[0]
    return H.permute(0, 2, 1, 3).reshape(6 * K, 6 * K)


def _blocks(H: torch.Tensor) -> torch.Tensor:
    """(6K, 6K) -> (K, K, 6, 6) blocks."""
    K = H.shape[0] // 6
    return H.reshape(K, 6, K, 6).permute(0, 2, 1, 3)


def build_prior(cam, poses, points, obs_kf, obs_lm, obs_uv, obs_w, huber_px: float = 2.0,
                obs_right=None, T_rl=None, carried: dict | None = None, decay: float = 0.5,
                dtype=torch.float64) -> dict:
    """The prior a slide leaves, in ``dtype`` on the inputs' device (see the
    top of the file). ``poses`` (W + 1, 4, 4) camera_from_world, the window
    before the slide; ``points`` and ``obs_*`` the consumed landmarks and
    every observation of them; ``carried`` the prior over the W slots
    before the slide (what this function returned at the slide before), or
    None. Returns dict(H (W, W, 6, 6), b (W, 6), T_lin (W, 4, 4), mask (W,))."""
    _no_tf32()
    pb = Problem(cam, poses, points, obs_kf, obs_lm, obs_uv, obs_w, obs_right, T_rl, None,
                 dtype)
    H, _, g = pb.system(pb.poses0, pb.points0, pb.w, "huber", huber_px)
    W, n = pb.K - 1, pb.n
    dev = H.device
    if carried is not None:
        cast = lambda a: torch.as_tensor(a, device=dev).to(dtype)
        Hc, bc = _dense(cast(carried["H"])), cast(carried["b"]).reshape(-1)
        mask = torch.as_tensor(carried["mask"], device=dev).bool()
        delta = se3_log(pb.poses0[:W] @ invert(cast(carried["T_lin"]))) * mask[:, None]
        H[:6 * W, :6 * W] += decay * Hc
        g[:6 * W] += decay * (bc + Hc @ delta.reshape(-1))
    gone = torch.cat([torch.arange(6, device=dev), torch.arange(6 * pb.K, n, device=dev)])
    stay = torch.arange(6, 6 * pb.K, device=dev)
    M = H[gone][:, gone] + 1e-6 * _eye(len(gone), H)
    X = _solve(M, torch.cat([H[gone][:, stay], g[gone][:, None]], 1))
    H_red = H[stay][:, stay] - H[stay][:, gone] @ X[:, :-1]
    g_red = g[stay] - H[stay][:, gone] @ X[:, -1]
    return {"H": _blocks(0.5 * (H_red + H_red.T)), "b": g_red.reshape(W, 6),
            "T_lin": pb.poses0[1:], "mask": torch.ones(W, dtype=torch.bool, device=dev)}


def prior_gap(got: dict, want: dict) -> float:
    """How far a prior ``got`` lies from ``want``: the Frobenius norm of the
    difference of their ``[H | b]`` (6W rows, 6W + 1 columns), over that of
    ``want``'s, in float64."""
    def aug(p):
        H = torch.as_tensor(p["H"]).to(torch.float64)
        b = torch.as_tensor(p["b"]).to(torch.float64)
        return torch.cat([_dense(H), b.reshape(-1, 1)], 1)
    a, w = aug(got), aug(want).to("cpu")
    return float(torch.linalg.matrix_norm(a.cpu() - w) / torch.linalg.matrix_norm(w))
