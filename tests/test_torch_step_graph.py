"""The pieces of the step's CUDA graph that run on the CPU, and the two
utilities ported with it.

* The step in buffer form (``frontend.make_buffer_step``, what
  ``models/step_graph.py`` captures) against ``step_fn`` over 4 steps on
  every LK path and ORB, and both with persistent tracks: the same state and the same frame outputs bit for
  bit (the same ops on the same inputs), written into the buffers it was
  handed.
* RANSAC draws taken outside ``ransac_pnp`` with ``pnp.draw_uniforms`` (as
  ``System`` does under the graph) against ``ransac_pnp``'s own draw from a
  generator with the same seed: equal results and generator states.
* ``utils/hostcopy.device_get_tree`` against the JAX one on the same nested
  arrays: equal structure, dtypes and values.
* ``utils/profiling``: ``StageTimer`` gives the JAX one's ``summary()``
  keys and ``report()`` layout; ``trace`` and ``time_jitted`` on the CPU.
* ``probes/step_nodes``: one step's ops by stage and function add up, and
  the step is left as it was.

The card's side (capture, replay, launch counts) is in
``tests/test_torch_cuda.py``.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_visual_odometry_tpu.utils import hostcopy as jhostcopy
from stereo_visual_odometry_tpu.utils import profiling as jprofiling
from stereo_visual_odometry_tpu_torch.models import frontend as tfront
from stereo_visual_odometry_tpu_torch.models import step_graph
from stereo_visual_odometry_tpu_torch.models.system import System
from stereo_visual_odometry_tpu_torch.ops import pnp as tpnp
from stereo_visual_odometry_tpu_torch.ops import se3
from stereo_visual_odometry_tpu_torch.ops.camera import Pinhole
from stereo_visual_odometry_tpu_torch.probes import step_nodes
from stereo_visual_odometry_tpu_torch.utils import hostcopy, profiling, synthetic
from stereo_visual_odometry_tpu_torch.utils.config import (CameraConfig, RunConfig,
                                                           rig_from_config)
from stereo_visual_odometry_tpu_torch.utils.tree import tree_map, tree_pairs
from torch_jax_kernels import with_sensor_noise

SMALL = dict(height=192, width=256, max_features=256, num_hypotheses=128,
             min_features_track=8, min_inlier_rate=0.3)
ORB_SMALL = dict(SMALL, mode="orb", height=128, width=320, orb_levels=4)
PATHS = {"dense": SMALL, "cell": dict(SMALL, lk_kernel="cell"),
         "v1": dict(SMALL, lk_kernel="v1"), "xla": dict(SMALL, lk_backend="xla"),
         "no_sweep": dict(SMALL, lk_sweep=False),
         "not_predictive": dict(SMALL, lk_predictive=False), "orb": ORB_SMALL,
         "lk_persistent": dict(SMALL, persistent_tracks=True),
         "orb_persistent": dict(ORB_SMALL, persistent_tracks=True)}
STEPS = 4


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))  # the suite runs several workers at once
    yield
    torch.set_num_threads(n)


def _sequence(vo):
    seq = synthetic.render_sequence(n_frames=STEPS + 1, h=vo["height"], w=vo["width"],
                                    fx=300.0)
    if vo.get("mode") == "orb":  # no flat regions (test_torch_system.py)
        seq["images_l"] = with_sensor_noise(seq["images_l"], seed=1)
        seq["images_r"] = with_sensor_noise(seq["images_r"], seed=2)
    rp = seq["rig"]
    cam = CameraConfig(fx=rp["fx"], fy=rp["fy"], cx=rp["cx"], cy=rp["cy"],
                       baseline=rp["baseline"])
    return seq, cam


def _assert_trees_equal(got, want):
    for path, g, w in tree_pairs(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), path


@pytest.mark.parametrize("path", list(PATHS))
def test_buffer_step_matches_step_fn(path):
    vo = PATHS[path]
    seq, cam = _sequence(vo)
    cfg = tfront.VOConfig(**vo)
    init_fn, step_fn = tfront.make_frontend(cfg, rig_from_config(cam, device="cpu"),
                                            device="cpu")
    buffer_step = tfront.make_buffer_step(step_fn)
    frames = [(torch.from_numpy(l), torch.from_numpy(r))
              for l, r in zip(seq["images_l"], seq["images_r"])]
    draws = np.random.default_rng(3).random((STEPS, cfg.num_hypotheses, 6))
    state = init_fn(*frames[0])
    buf = tree_map(torch.clone, state)  # tensors the buffer form does not own
    img_l, img_r = torch.empty_like(frames[0][0]), torch.empty_like(frames[0][1])
    u = torch.empty((cfg.num_hypotheses, 6))
    out = None
    ptrs = [t.data_ptr() for _, t, _ in tree_pairs(buf, buf)]
    accepted = 0
    for (il, ir), draw in zip(frames[1:], draws):
        u_t = torch.from_numpy(draw.astype(np.float32))
        state, metrics = step_fn(state, il, ir, u_t)
        want = tfront.frame_outputs(state, metrics)
        if out is None:
            out = tree_map(torch.empty_like, want)
        img_l.copy_(il)
        img_r.copy_(ir)
        u.copy_(u_t)
        buffer_step(buf, img_l, img_r, u, out)
        _assert_trees_equal(buf, state)
        _assert_trees_equal(out, want)
        accepted += bool(out["accept"])
    assert [t.data_ptr() for _, t, _ in tree_pairs(buf, buf)] == ptrs
    assert accepted >= STEPS - 1  # the chain really tracks


def test_write_back_checks_shapes_and_aliasing():
    state = {"a": torch.zeros(3), "b": (torch.zeros(2, dtype=torch.int32),)}
    tfront.write_back(state, {"a": torch.ones(3), "b": (torch.full((2,), 7, dtype=torch.int32),)})
    assert state["a"].tolist() == [1.0] * 3 and state["b"][0].tolist() == [7, 7]
    with pytest.raises(ValueError, match="buffer is"):
        tfront.write_back(state, {"a": torch.ones(4), "b": state["b"]})
    with pytest.raises(ValueError, match="buffer is"):
        tfront.write_back(state, {"a": torch.ones(3, dtype=torch.float64), "b": state["b"]})
    with pytest.raises(ValueError, match="keys"):
        tfront.write_back(state, {"a": torch.ones(3)})
    with pytest.raises(ValueError, match="shares memory"):  # "a" read after "b" changed
        tfront.write_back({"a": state["a"], "b": state["a"][:1]},
                          {"a": state["a"][:1].expand(3), "b": torch.zeros(1)})


def test_step_graph_needs_a_card():
    """The CPU runs the step eagerly: ``System(device='cpu')`` has no graph,
    and a ``StepGraph`` refuses the CPU."""
    cfg = tfront.VOConfig(**SMALL)
    sys_ = System(RunConfig(vo=cfg), device="cpu")
    assert sys_.graph is None
    with pytest.raises(ValueError, match="cuda"):
        step_graph.StepGraph(sys_.step_fn, cfg, "cpu")


def test_draws_outside_ransac_equal_its_own_draw():
    rng = np.random.default_rng(4)
    cam = Pinhole.create(300.0, 300.0, 128.0, 96.0)
    n = 200
    pts = torch.from_numpy(np.c_[rng.uniform(-4, 4, (n, 2)), rng.uniform(4, 20, n)]
                           .astype(np.float32))
    T = se3.from_Rt(torch.eye(3), torch.tensor([0.05, -0.02, 0.9]))
    px = cam.project(se3.transform_points(T, pts)) + torch.from_numpy(
        rng.normal(0, 0.3, (n, 2)).astype(np.float32))
    valid = torch.from_numpy(rng.random(n) > 0.1)
    kw = dict(num_hypotheses=64, inlier_px=1.0, refine_iters=4)
    g_out, g_own = (torch.Generator().manual_seed(11) for _ in range(2))
    u = tpnp.draw_uniforms(64, g_out)
    got = tpnp.ransac_pnp(cam, pts, px, valid, u=u, **kw)
    want = tpnp.ransac_pnp(cam, pts, px, valid, generator=g_own, **kw)
    assert torch.equal(g_out.get_state(), g_own.get_state())
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert int(want["num_inliers"]) > 0.5 * n  # a real pose was found


def test_device_get_tree_matches_jax():
    rng = np.random.default_rng(5)
    tree = {"T": rng.random((4, 4)).astype(np.float32),
            "pair": (rng.integers(0, 9, (3, 2)).astype(np.int32), np.bool_(True)),
            "levels": [rng.random((2, 3)).astype(np.float32),
                       {"n": np.int32(7), "img": rng.integers(0, 255, (5, 6)).astype(np.uint8)}],
            "none": None}
    want = jhostcopy.device_get_tree(tree_map(jnp.asarray, tree))
    got = hostcopy.device_get_tree(tree_map(lambda a: torch.from_numpy(np.asarray(a)), tree))
    assert type(got["pair"]) is tuple and type(got["levels"]) is list and got["none"] is None
    pairs = tree_pairs(got, want)
    assert len(pairs) == 6
    for path, g, w in pairs:
        assert isinstance(g, np.ndarray) and g.dtype == w.dtype and g.shape == w.shape, path
        np.testing.assert_array_equal(g, w, err_msg=path)


def _timed_stages(timer):
    for name in ("detect", "track", "detect", "pnp"):
        with timer.stage(name):
            sum(range(2000))
    return timer


def test_stage_timer_matches_jax_layout():
    want = _timed_stages(jprofiling.StageTimer())
    got = _timed_stages(profiling.StageTimer(device="cpu"))
    s_got, s_want = got.summary(), want.summary()
    assert s_got.keys() == s_want.keys() == {"detect", "track", "pnp"}
    for k in s_want:
        assert s_got[k].keys() == s_want[k].keys()
        assert s_got[k]["calls"] == s_want[k]["calls"]
        assert s_got[k]["total_s"] > 0
    row = re.compile(r"^(\S+) +\d+\.\d\d ms x(\d+)$")
    lines_got, lines_want = got.report().split("\n"), want.report().split("\n")
    assert len(lines_got) == len(lines_want) == 3
    parse = lambda lines: sorted(row.match(ln).groups() for ln in lines)
    assert parse(lines_got) == parse(lines_want)
    assert all(len(ln.split(" ms")[0]) == len(lw.split(" ms")[0])
               for ln, lw in zip(lines_got, lines_want))


def test_trace_and_time_jitted_on_cpu(tmp_path):
    x = torch.rand(64, 64)
    with profiling.trace(str(tmp_path)) as prof:
        x @ x
    assert (tmp_path / "trace.json").stat().st_size > 0
    act = profiling.device_activity(prof)
    assert act == {"ops": 0, "busy_ms": 0.0, "span_ms": 0.0, "names": {}}
    calls = []
    t = profiling.time_jitted(lambda a: calls.append(a @ a), x, iters=3, warmup=2,
                              device="cpu")
    assert t > 0 and len(calls) == 5
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="NVIDIA GPU"):
            profiling.StageTimer()


def test_step_nodes_counts_one_step():
    vo = dict(SMALL, height=96, max_features=64)
    seq, cam = _sequence(vo)
    init_fn, step_fn = tfront.make_frontend(tfront.VOConfig(**vo),
                                            rig_from_config(cam, device="cpu"), device="cpu")
    frames = [(torch.from_numpy(l), torch.from_numpy(r))
              for l, r in zip(seq["images_l"], seq["images_r"])]
    state = init_fn(*frames[0])
    kept = tree_map(torch.clone, state)
    got = step_nodes.count(step_fn, state, *frames[1])
    _assert_trees_equal(state, kept)
    assert got["total"] == sum(got["by_stage"].values()) == sum(got["by_function"].values())
    stages = " ".join(got["by_stage"])
    assert "lk.circular_track" in stages and "pnp.ransac_pnp" in stages
    assert "outside step_fn" not in stages
    assert got["kernels"] == {}  # the plain versions on the CPU: no hand-written kernel
    assert list(got["by_stage"].values()) == sorted(got["by_stage"].values(), reverse=True)
    assert got["by_function"]["ops/lk_dense.py:level_track_dense"] > 0.25 * got["total"]
