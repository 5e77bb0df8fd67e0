"""Frame-to-frame stereo VO frontends: the LK and ORB pipelines.

Port of ``stereo_visual_odometry_tpu/models/frontend.py``. Both steps run
as eager tensor ops on the frontend's device, with no host synchronisation
inside the step:

* LK (``mode='lk'``): 2x pyramids, the LK prior (plane-sweep map or
  disparity grid), 4-way circular LK, closed-form triangulation,
  RANSAC-PnP, the gates and pose composition, then fresh FAST detection.
  ``lk_backend`` 'auto' and 'pallas' run the level kernels
  (``lk_kernel``: 'dense' on K1, 'cell' on K3, 'v1' on K4), 'xla' the XLA
  formulation ``lk._level_track`` (its window reads on K1); the JAX
  'auto' picks by platform instead. State: ``pyr_l``/``pyr_r`` (tuples
  of levels), ``kp``, ``kp_valid``, ``T_wc``, ``T_21_prev``, ``status``,
  ``n_detected``, and ``dmap`` (``lk_predictive`` with ``lk_sweep``) or
  ``disp_grid`` (``lk_predictive`` without it).
* ORB (``mode='orb'``, the reference's default): ORB on the current pair
  (K1 and K2 on every level), stereo + temporal Hamming association,
  triangulation of the t-1 matches, RANSAC-PnP weighted by detection
  octave, the same gates. State: ``feat_l``/``feat_r`` (feature dicts of
  the previous pair), ``T_wc``, ``T_21_prev``, ``status``, ``n_detected``.

With ``persistent_tracks`` both keep track slots across frames, the
observations the BA backend (``models/backend.py``) consumes: LK refills
the slots its tracks lost with fresh detections away from live tracks; ORB
hands each previous track's id to the current feature its temporal match
landed on. The state gains ``track_id``, ``track_age`` (int32, -1 / 0 on
an empty slot) and ``next_id`` (int32); a frame's outputs gain
``TRACK_KEEP``, with the current pair's triangulation of every slot.

RANSAC draws come from the frontend's ``torch.Generator`` (JAX carries a
PRNG key in the state instead); ``step_fn`` also takes the draws ``u``
directly. ``make_buffer_step`` gives the step in buffer form, the form a
CUDA graph captures (``models/step_graph.py``): it reads the state, the pair
and ``u`` from tensors it does not own and writes the new state back into
the state's tensors. The factories build on ``device="cuda"`` unless told otherwise,
raise without a GPU, and raise for a rig on another device.
"""
from __future__ import annotations

import dataclasses

import torch

from ..ops import (fast, lk, match, orb, pnp, pyramid, se3, select,
                   stereo_sweep, triangulate)
from ..ops.camera import StereoRig


@dataclasses.dataclass(frozen=True)
class VOConfig:
    """Static pipeline configuration: the same fields and defaults as the
    JAX ``VOConfig`` (a test holds them equal)."""

    mode: str = "lk"
    height: int = 384
    width: int = 1248
    max_features: int = 1024
    # FAST / detection
    fast_threshold: float = 20.0
    cell: int = 32
    k_per_cell: int = 8
    # LK
    lk_win: int = 21
    lk_levels: int = 3
    lk_iters: int = 30
    pyr_levels: int = 4
    feature_match_error: float = 2.0
    cycle_error: float = 2.0
    # ORB
    orb_levels: int = 8
    orb_scale: float = 1.2
    orb_ini_th: float = 20.0
    orb_min_th: float = 7.0
    orb_dist_floor: float = 50.0
    orb_dist_ratio: float = 2.0
    orb_mutual: bool = False
    orb_dedup_radius: float = 0.0
    orb_max_level_diff: int | None = 1
    orb_stereo_premask: bool = True
    orb_max_disparity: float = 128.0
    orb_temporal_radius: float | None = 150.0
    orb_upright: bool = True
    # Triangulation depth gate
    z_min: float = 0.5
    z_max: float = 200.0
    # RANSAC-PnP; inlier_px None = 0.5 px for LK, 2.0 px for ORB.
    num_hypotheses: int = 256
    inlier_px: float | None = None
    refine_iters: int = 6

    @property
    def inlier_px_resolved(self) -> float:
        if self.inlier_px is not None:
            return self.inlier_px
        return 0.5 if self.mode == "lk" else 2.0
    # Quality gates
    min_features_detect: int = 30
    min_features_track: int = 10
    min_inlier_rate: float = 0.05
    min_move: float = 0.0005
    max_move: float = 10.0
    max_euler: float = 0.1
    # Persistent track slots
    persistent_tracks: bool = False
    replenish_min_dist: float = 8.0
    # LK backend / kernel: 'auto' and 'pallas' run the level kernels
    # (lk_kernel 'dense', 'cell' or 'v1'), 'xla' the XLA formulation.
    lk_backend: str = "auto"
    lk_kernel: str = "dense"
    lk_predictive: bool = True
    disp_cell: int = 64
    lk_sweep: bool = True
    lk_sweep_d_max: int = 48
    lk_stereo_levels: int = 1
    lk_temporal_levels: int = 2
    lk_rounds_prior: int = 4
    lk_rounds_coarse: int = 8
    lk_rounds_refine: int = 2


# Tracking status values (``tracking.h:22-27``).
INITING, TRACKING_GOOD, LOST = 0, 1, 2


# Sentinel for the persistent-track id scatters (larger than any real id).
_ID_BIG = 1 << 30


def check_supported(cfg: VOConfig) -> None:
    """Raise ValueError for a mode the JAX package does not have."""
    if cfg.mode not in ("lk", "orb"):
        raise ValueError(f"unknown mode {cfg.mode!r} (expected 'lk' or 'orb')")


def _detect_left(cfg: VOConfig, img_l: torch.Tensor):
    """Dense FAST + spatially-uniform top-K + subpixel on the left image:
    (xy, score, valid)."""
    score = fast.detect(img_l, cfg.fast_threshold)
    xy, sc, valid = select.grid_top_k(score, cfg.max_features, cell=cfg.cell,
                                      k_per_cell=cfg.k_per_cell)
    return select.subpixel_refine(score, xy, valid), sc, valid


def _new_tracks(valid: torch.Tensor) -> dict:
    """Persistent-track state for a fresh detection: compact ids
    0..n_valid-1 (valid slots need not be a prefix, so slot-index ids would
    exceed ``next_id`` and collide with later fresh ids), age 0."""
    ids = torch.where(valid, torch.cumsum(valid, 0) - 1, -1)
    return {"track_id": ids.to(torch.int32),
            "track_age": torch.zeros(valid.shape, dtype=torch.int32, device=valid.device),
            "next_id": torch.sum(valid).to(torch.int32)}


def _fresh_ids(next_id: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``next_id``, ``next_id`` + 1, ... in the order of ``mask``'s set
    entries (int32; the other entries hold junk)."""
    return (next_id + torch.cumsum(mask, 0) - 1).to(torch.int32)


def _depth_ok(cfg: VOConfig, pts3d: torch.Tensor) -> torch.Tensor:
    return (pts3d[:, 2] > cfg.z_min) & (pts3d[:, 2] < cfg.z_max)


def _refill_slots(cfg: VOConfig, state: dict, quad: dict, xy, score, det_valid, tri):
    """LK persistent slots (JAX ``models/frontend.py:338-386``): surviving
    tracks keep their slot, id and age + 1; the slots they lost are refilled
    with the best fresh detections at least ``replenish_min_dist`` from a
    live track, under new ids. Both orders are stable sorts, as
    ``jnp.argsort``: FAST scores tie often. Returns (state, metric)
    updates."""
    k = cfg.max_features
    tracked_xy, tracked_ok = quad["t2l"], quad["valid"]
    cand_keep = select.mask_min_distance(xy, det_valid, tracked_xy, tracked_ok,
                                         cfg.replenish_min_dist)
    # Invalid slots first, best candidates first.
    slot_order = torch.sort(tracked_ok.to(torch.int32), stable=True).indices
    n_invalid = k - torch.sum(tracked_ok)
    cand_order = torch.sort(torch.where(cand_keep, -score, torch.inf), stable=True).indices
    write_mask = ((torch.arange(k, device=xy.device) < n_invalid)
                  & cand_keep[cand_order])

    def scatter(dst, src_sorted):
        """Write ``src_sorted`` into the slots ``slot_order`` lists where
        ``write_mask`` is set (a permutation: one writer per slot)."""
        fill = write_mask.reshape((-1,) + (1,) * (dst.ndim - 1))
        return dst.index_copy(0, slot_order, torch.where(fill, src_sorted, dst[slot_order]))

    new_kp = scatter(tracked_xy, xy[cand_order])
    new_valid = scatter(tracked_ok, write_mask)
    ids = torch.where(tracked_ok, state["track_id"], -1)
    new_ids = scatter(ids, _fresh_ids(state["next_id"], write_mask))
    ages = torch.where(tracked_ok, state["track_age"] + 1, 0)
    new_ages = scatter(ages, torch.zeros_like(ages))

    # The current pair's depth of the surviving tracks (landmark init).
    pts3d_cur, tri_cur_ok = tri(quad["t2l"], quad["t2r"])
    stereo_ok = tracked_ok & tri_cur_ok & _depth_ok(cfg, pts3d_cur)
    state_upd = {"kp": new_kp, "kp_valid": new_valid, "track_id": new_ids,
                 "track_age": new_ages,
                 "next_id": (state["next_id"] + torch.sum(write_mask)).to(torch.int32)}
    # Right-image position of surviving tracks; refilled slots have
    # stereo_ok False.
    metric_upd = {"track_id": new_ids, "track_xy": new_kp, "track_valid": new_valid,
                  "track_age": new_ages, "pts3d_cur": pts3d_cur,
                  "pts3d_cur_valid": stereo_ok, "track_xy_r": quad["t2r"],
                  "track_stereo_valid": stereo_ok,
                  "track_id_prev_slots": state["track_id"]}
    return state_upd, metric_upd


def _accept(cfg: VOConfig, res: dict, n_tracked: torch.Tensor,
            T_21: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The quality gates (``tracking.cpp:305-329`` with config bounds) ->
    (accept, |t|)."""
    t_norm = torch.linalg.vector_norm(T_21[:3, 3])
    eulers = torch.abs(se3.euler_zyx(T_21[:3, :3]))
    accept = ((n_tracked >= cfg.min_features_track) & res["ok"] &
              (res["inlier_ratio"] >= cfg.min_inlier_rate) &
              (t_norm > cfg.min_move) & (t_norm < cfg.max_move) &
              torch.all(eulers < cfg.max_euler))
    return accept, t_norm


def _make_tri(rig: StereoRig):
    """Pick the triangulation routine once, from the concrete rig."""
    if triangulate.is_rectified(rig):
        return lambda a, b: triangulate.stereo_depth_closed_form(rig, a, b)
    return lambda a, b: triangulate.triangulate_dlt(rig.P_left, rig.P_right, a, b)


def resolve_device(device, tensors, what: str = "frontend",
                   inputs: str = "rig") -> torch.device:
    """The device of a ``what`` (a frontend, the BA backend): the card
    unless the caller asks for another; raises without a GPU, and for
    ``inputs`` (the rig, the camera) whose ``tensors`` lie elsewhere."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"a {what} on device={str(device)!r} needs an NVIDIA GPU and "
                "torch.cuda.is_available() is False; pass device='cpu' to run "
                "on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    devs = {t.device for t in tensors}
    if devs != {dev}:
        raise ValueError(f"the {inputs}'s tensors are on {sorted(map(str, devs))}, the "
                         f"{what} on {dev}: build the {inputs} on the {what}'s device")
    return dev


def make_lk_frontend(cfg: VOConfig, rig: StereoRig, device="cuda",
                     generator: torch.Generator | None = None):
    """Build (init_fn, step_fn) for the LK pipeline on ``device``.

    ``init_fn(img_l, img_r) -> state``;
    ``step_fn(state, img_l, img_r, u=None) -> (state, metrics)`` where ``u``
    optionally injects the (num_hypotheses, 6) RANSAC draws.
    """
    check_supported(cfg)
    device = resolve_device(device, (rig.T_rl, rig.left.fx, rig.right.fx))
    tri = _make_tri(rig)
    eye4 = lambda: torch.eye(4, dtype=torch.float32, device=device)
    sweep_level = min(2, cfg.pyr_levels - 1)
    use_pallas = cfg.lk_backend in ("auto", "pallas")
    grid_shape = (-(-cfg.height // cfg.disp_cell), -(-cfg.width // cfg.disp_cell))

    def _as_img(img) -> torch.Tensor:
        return torch.as_tensor(img, device=device).to(torch.float32)

    def _build_pyrs(img_l, img_r):
        return (tuple(pyramid.build_pyramid(img_l, cfg.pyr_levels)),
                tuple(pyramid.build_pyramid(img_r, cfg.pyr_levels)))

    def init_fn(img_l, img_r):
        """StereoInit_f2f (``tracking.cpp:78-92``): detect on frame 0."""
        img_l, img_r = _as_img(img_l), _as_img(img_r)
        pl, pr = _build_pyrs(img_l, img_r)
        xy, _, valid = _detect_left(cfg, img_l)
        n_det = torch.sum(valid)
        status = torch.where(n_det >= cfg.min_features_detect,
                             TRACKING_GOOD, INITING).to(torch.int32)
        state = {
            "pyr_l": pl, "pyr_r": pr, "kp": xy, "kp_valid": valid,
            "T_wc": eye4(), "T_21_prev": eye4(),
            "status": status, "n_detected": n_det,
        }
        if cfg.persistent_tracks:
            state.update(_new_tracks(valid))
        if cfg.lk_predictive and cfg.lk_sweep:
            # The next step's t1-pair disparity map.
            state["dmap"] = stereo_sweep.disparity_sweep(
                pl[sweep_level], pr[sweep_level], d_max=cfg.lk_sweep_d_max)
        elif cfg.lk_predictive:
            # No prior yet: a mid-range constant (fx*B / ~15 m on KITTI).
            state["disp_grid"] = torch.full(grid_shape, 24.0, dtype=torch.float32,
                                            device=device)
        return state

    def step_fn(state, img_l, img_r, u: torch.Tensor | None = None):
        img_l, img_r = _as_img(img_l), _as_img(img_r)
        pyr_cur_l, pyr_cur_r = _build_pyrs(img_l, img_r)

        # 4-way circular LK t1L -> t1R -> t2R -> t2L (tracking.cpp:583-622),
        # started from the LK prior and the constant-velocity model.
        pred_kw = dict(rounds_prior=cfg.lk_rounds_prior,
                       rounds_coarse=cfg.lk_rounds_coarse,
                       rounds_refine=cfg.lk_rounds_refine)
        if cfg.lk_predictive:
            pred_kw.update(rig=rig, T_pred=state["T_21_prev"])
            if cfg.lk_sweep:
                pred_kw.update(use_sweep=True, sweep_d_max=cfg.lk_sweep_d_max,
                               stereo_levels=cfg.lk_stereo_levels,
                               temporal_levels=cfg.lk_temporal_levels,
                               dmap_prev=state["dmap"])
            else:
                pred_kw.update(disp_prior=lk.sample_disparity(
                    state["disp_grid"], state["kp"], cfg.disp_cell))
        quad = lk.circular_track(
            (state["pyr_l"], state["pyr_r"], pyr_cur_r, pyr_cur_l),
            state["kp"], state["kp_valid"],
            feature_match_error=cfg.feature_match_error,
            cycle_error=cfg.cycle_error, win=cfg.lk_win, levels=cfg.lk_levels,
            iters=cfg.lk_iters, use_pallas=use_pallas, pallas_kernel=cfg.lk_kernel,
            **pred_kw)

        # Triangulate the t-1 stereo pair (tracking.cpp:292-294).
        pts3d, tri_ok = tri(quad["t1l"], quad["t1r"])
        corr_valid = quad["valid"] & tri_ok & _depth_ok(cfg, pts3d)
        n_tracked = torch.sum(corr_valid)

        # RANSAC-PnP of the t-1 cloud vs current-left pixels (tracking.cpp:299).
        res = pnp.ransac_pnp(rig.left, pts3d, quad["t2l"], corr_valid,
                             num_hypotheses=cfg.num_hypotheses,
                             inlier_px=cfg.inlier_px_resolved,
                             refine_iters=cfg.refine_iters,
                             T_init=state["T_21_prev"], u=u, generator=generator)
        T_21 = res["T"]
        accept, t_norm = _accept(cfg, res, n_tracked, T_21)

        # Pose composition: frame_pose_ *= T^{-1} (tracking.cpp:313-318).
        T_wc = torch.where(accept, state["T_wc"] @ se3.se3_inv(T_21), state["T_wc"])

        # Fresh detection on the current left image (tracking.cpp:260).
        xy, score, det_valid = _detect_left(cfg, img_l)
        n_det = torch.sum(det_valid)
        status = torch.where(n_det >= cfg.min_features_detect,
                             TRACKING_GOOD, LOST).to(torch.int32)

        # Constant-velocity motion model for the next frame (identity after
        # a rejected frame).
        new_state = {
            "pyr_l": pyr_cur_l, "pyr_r": pyr_cur_r,
            "kp": xy, "kp_valid": det_valid,
            "T_wc": T_wc, "T_21_prev": torch.where(accept, T_21, eye4()),
            "status": status, "n_detected": n_det,
        }
        if cfg.lk_predictive and cfg.lk_sweep:
            new_state["dmap"] = quad["dmap"]
        elif cfg.lk_predictive:
            # Refresh the prior from this frame's tracked stereo pairs.
            new_state["disp_grid"] = lk.disparity_grid(
                quad["t2l"], quad["t2l"][:, 0] - quad["t2r"][:, 0], quad["valid"],
                cfg.height, cfg.width, cfg.disp_cell)
        metrics = {
            "T_21": T_21, "accept": accept, "n_tracked": n_tracked,
            "n_detected": n_det, "n_inliers": res["num_inliers"],
            "inlier_ratio": res["inlier_ratio"], "t_norm": t_norm,
            "tracked_prev": quad["t1l"], "tracked_cur": quad["t2l"],
            "tracked_valid": corr_valid,
        }
        if cfg.persistent_tracks:
            state_upd, metric_upd = _refill_slots(cfg, state, quad, xy, score,
                                                  det_valid, tri)
            new_state.update(state_upd)
            metrics.update(metric_upd)
        return new_state, metrics

    step_fn.cfg = cfg  # the config of the step a CUDA graph captures (parallel/sequences.py)
    return init_fn, step_fn


def make_orb_frontend(cfg: VOConfig, rig: StereoRig, device="cuda",
                      generator: torch.Generator | None = None):
    """Build (init_fn, step_fn) for the ORB pipeline on ``device``.

    Each step detects on the current pair, associates t1L<->t1R (stereo)
    and t1L<->t2L (temporal) by brute-force Hamming
    (``tracking.cpp:534-581``), triangulates the t-1 stereo matches and
    PnPs them against current-left pixels (``tracking.cpp:186-247``), each
    point weighted by its detection octave. Same signatures as
    ``make_lk_frontend``.
    """
    check_supported(cfg)
    device = resolve_device(device, (rig.T_rl, rig.left.fx, rig.right.fx))
    tri = _make_tri(rig)
    eye4 = lambda: torch.eye(4, dtype=torch.float32, device=device)
    orb_kw = dict(n_features=cfg.max_features, levels=cfg.orb_levels,
                  scale_factor=cfg.orb_scale, ini_th=cfg.orb_ini_th,
                  min_th=cfg.orb_min_th, cell=cfg.cell, k_per_cell=cfg.k_per_cell,
                  dedup_radius=cfg.orb_dedup_radius, upright=cfg.orb_upright)
    match_kw = dict(feature_match_error=cfg.feature_match_error,
                    dist_floor=cfg.orb_dist_floor, dist_ratio=cfg.orb_dist_ratio,
                    max_level_diff=cfg.orb_max_level_diff,
                    stereo_premask=cfg.orb_stereo_premask,
                    max_disparity=cfg.orb_max_disparity)
    inv_scale2 = torch.tensor(1.0 / cfg.orb_scale ** 2, dtype=torch.float32,
                              device=device)

    def _detect(img_l, img_r):
        img_l = torch.as_tensor(img_l, device=device).to(torch.float32)
        img_r = torch.as_tensor(img_r, device=device).to(torch.float32)
        return orb.detect_and_describe_pair(img_l, img_r, **orb_kw)

    def init_fn(img_l, img_r):
        """Detect and describe frame 0."""
        fl, fr = _detect(img_l, img_r)
        n_det = torch.sum(fl["valid"])
        status = torch.where(n_det >= cfg.min_features_detect,
                             TRACKING_GOOD, INITING).to(torch.int32)
        state = {"feat_l": fl, "feat_r": fr, "T_wc": eye4(), "T_21_prev": eye4(),
                 "status": status, "n_detected": n_det}
        if cfg.persistent_tracks:
            state.update(_new_tracks(fl["valid"]))
        return state

    def step_fn(state, img_l, img_r, u: torch.Tensor | None = None):
        fl_cur, fr_cur = _detect(img_l, img_r)
        feat_l, feat_r = state["feat_l"], state["feat_r"]
        assoc = match.stereo_temporal_match(
            feat_l, feat_r, fl_cur, use_mutual=cfg.orb_mutual,
            temporal_radius=cfg.orb_temporal_radius, **match_kw)

        xy_l = feat_l["xy"]
        xy_r = feat_r["xy"][assoc["idx_r"].long()]
        xy_cur = fl_cur["xy"][assoc["idx_t2l"].long()]
        pts3d, tri_ok = tri(xy_l, xy_r)
        corr_valid = assoc["valid"] & tri_ok & _depth_ok(cfg, pts3d)
        n_tracked = torch.sum(corr_valid)

        # Per-point confidence by detection octave (ORB-SLAM invSigma2): a
        # feature found at pyramid level l is localised ~scale^l worse.
        inv_sigma2 = torch.pow(inv_scale2, feat_l["level"].to(torch.float32))
        res = pnp.ransac_pnp(rig.left, pts3d, xy_cur, corr_valid,
                             num_hypotheses=cfg.num_hypotheses,
                             inlier_px=cfg.inlier_px_resolved,
                             refine_iters=cfg.refine_iters,
                             T_init=state["T_21_prev"], weights=inv_sigma2,
                             u=u, generator=generator)
        T_21 = res["T"]
        accept, t_norm = _accept(cfg, res, n_tracked, T_21)
        T_wc = torch.where(accept, state["T_wc"] @ se3.se3_inv(T_21), state["T_wc"])
        n_det = torch.sum(fl_cur["valid"])
        status = torch.where(n_det >= cfg.min_features_detect,
                             TRACKING_GOOD, LOST).to(torch.int32)
        new_state = {
            "feat_l": fl_cur, "feat_r": fr_cur, "T_wc": T_wc,
            "T_21_prev": torch.where(accept, T_21, eye4()),
            "status": status, "n_detected": n_det,
        }
        metrics = {
            "T_21": T_21, "accept": accept, "n_tracked": n_tracked,
            "n_detected": n_det, "n_inliers": res["num_inliers"],
            "inlier_ratio": res["inlier_ratio"], "t_norm": t_norm,
            "tracked_prev": xy_l, "tracked_cur": xy_cur,
            "tracked_valid": corr_valid,
        }
        if cfg.persistent_tracks:
            state_upd, metric_upd = _inherit_ids(state, assoc, corr_valid, fl_cur, fr_cur)
            new_state.update(state_upd)
            metrics.update(metric_upd)
        return new_state, metrics

    def _inherit_ids(state, assoc, surv, fl_cur, fr_cur):
        """ORB persistent tracks (JAX ``models/frontend.py:504-548``): the
        current feature j inherits the id of the previous slot i whose
        temporal match landed on it (``idx_t2l[i] == j``) and survived the
        association; on a collision the oldest track (smallest id) wins.
        The rest get fresh ids. Returns (state, metric) updates."""
        track_id, track_age = state["track_id"], state["track_age"]
        prev_id = torch.where(surv & (track_id >= 0), track_id, _ID_BIG)
        cand = torch.full_like(track_id, _ID_BIG).scatter_reduce(
            0, assoc["idx_t2l"].long(), prev_id, reduce="amin", include_self=True)
        inherited = (cand < _ID_BIG) & fl_cur["valid"]
        # The winning parent's age: ids are unique per frame, so a (k, k)
        # one-hot lookup finds its slot exactly.
        eq = (track_id[None, :] == cand[:, None]) & surv[None, :]
        age_prev = torch.amax(torch.where(eq, track_age[None, :], -1), dim=1)
        fresh = fl_cur["valid"] & ~inherited
        new_ids = torch.where(inherited, cand,
                              torch.where(fresh, _fresh_ids(state["next_id"], fresh), -1))
        new_ages = torch.where(inherited, age_prev + 1, 0).to(torch.int32)

        # The current pair's stereo association -> each slot's depth
        # (landmark init; LK gets it from its t2l/t2r legs).
        cur_st = match.stereo_match(fl_cur, fr_cur, **match_kw)
        xy_r_cur = fr_cur["xy"][cur_st["idx_r"].long()]
        pts3d_cur, tri_cur_ok = tri(fl_cur["xy"], xy_r_cur)
        stereo_ok = cur_st["valid"] & tri_cur_ok & _depth_ok(cfg, pts3d_cur)
        state_upd = {"track_id": new_ids, "track_age": new_ages,
                     "next_id": (state["next_id"] + torch.sum(fresh)).to(torch.int32)}
        metric_upd = {"track_id": new_ids, "track_xy": fl_cur["xy"],
                      "track_valid": fl_cur["valid"], "track_age": new_ages,
                      "pts3d_cur": pts3d_cur, "pts3d_cur_valid": stereo_ok,
                      "track_xy_r": xy_r_cur, "track_stereo_valid": stereo_ok,
                      "track_id_prev_slots": track_id}
        return state_upd, metric_upd

    step_fn.cfg = cfg  # the config of the step a CUDA graph captures (parallel/sequences.py)
    return init_fn, step_fn


def make_frontend(cfg: VOConfig, rig: StereoRig, device="cuda",
                  generator: torch.Generator | None = None):
    """Dispatch on ``cfg.mode`` (the ``track_mode`` switch,
    ``tracking.cpp:115-126``); both ``make_*_frontend`` check ``cfg`` first."""
    make = make_lk_frontend if cfg.mode == "lk" else make_orb_frontend
    return make(cfg, rig, device=device, generator=generator)


CHUNK_KEEP = ("T_21", "accept", "n_tracked", "n_inliers", "inlier_ratio",
              "t_norm", "n_detected")
# What the host takes from a frame: the chunk metrics, the pose and the status.
FRAME_KEEP = CHUNK_KEEP + ("T_wc", "status")
# With persistent tracks also the track slots: what the BA backend consumes
# (JAX ``models/system.py:110-117``) and their ages.
TRACK_KEEP = ("track_id", "track_xy", "track_valid", "track_age", "pts3d_cur",
              "pts3d_cur_valid", "track_xy_r", "track_stereo_valid")


def frame_outputs(state: dict, metrics: dict) -> dict:
    """The ``FRAME_KEEP`` tensors of one step's (new state, metrics), and
    ``TRACK_KEEP``'s with persistent tracks."""
    keep = FRAME_KEEP + (TRACK_KEEP if "track_id" in metrics else ())
    return {k: metrics[k] if k in metrics else state[k] for k in keep}


def write_back(state: dict, new_state: dict) -> None:
    """Copy ``new_state`` into the tensors of ``state`` (one structure, equal
    shapes and dtypes). Every leaf of ``new_state`` is computed before the
    first copy, so a copy never feeds a later read of the old state; a new
    leaf that shares memory with another leaf of ``state`` raises, as its
    value could change under an earlier copy."""
    from ..utils.tree import tree_pairs  # utils imports this module (VOConfig)

    pairs = tree_pairs(state, new_state)
    owned = {dst.untyped_storage().data_ptr() for _, dst, _ in pairs}
    todo = []
    for path, dst, src in pairs:
        if dst.shape != src.shape or dst.dtype != src.dtype:
            raise ValueError(f"state{path}: the step gives {src.dtype} {tuple(src.shape)}, "
                             f"the buffer is {dst.dtype} {tuple(dst.shape)}")
        if src.data_ptr() == dst.data_ptr() and src.stride() == dst.stride():
            continue  # the buffer itself
        if src.untyped_storage().data_ptr() in owned:
            raise ValueError(f"state{path}: the new value shares memory with the state")
        todo.append((dst, src))
    for dst, src in todo:
        dst.copy_(src)


def make_buffer_step(step_fn):
    """The step in buffer form: ``buffer_step(state, img_l, img_r, u, out)``
    runs ``step_fn`` on the tensors it is handed (the RANSAC draws ``u``
    included), copies the frame's ``FRAME_KEEP`` tensors into ``out`` and,
    as its last ops, the new state into the tensors of ``state``. Built on
    ``step_fn``, not a second copy of the pipeline."""

    def buffer_step(state, img_l, img_r, u, out):
        new_state, metrics = step_fn(state, img_l, img_r, u)
        for k, v in frame_outputs(new_state, metrics).items():
            out[k].copy_(v)
        write_back(state, new_state)

    return buffer_step


def make_chunked_frontend(cfg: VOConfig, rig: StereoRig, device="cuda",
                          generator: torch.Generator | None = None):
    """(init_fn, chunk_fn): advance a whole frame chunk per call.

    ``chunk_fn(state, imgs_l (T, H, W), imgs_r (T, H, W))`` runs the step
    over the chunk and returns (state, metrics with a leading T axis): the
    ``CHUNK_KEEP`` metrics plus ``T_wc`` after each frame, as the JAX scan.
    """
    init_fn, step_fn = make_frontend(cfg, rig, device=device, generator=generator)

    def chunk_fn(state, imgs_l, imgs_r):
        out = {k: [] for k in CHUNK_KEEP + ("T_wc",)}
        for il, ir in zip(imgs_l, imgs_r):
            state, m = step_fn(state, il, ir)
            for k in CHUNK_KEEP:
                out[k].append(m[k])
            out["T_wc"].append(state["T_wc"])
        return state, {k: torch.stack(v) for k, v in out.items()}

    return init_fn, chunk_fn
