"""Every cell's driver at a tiny size on the CPU, sound and with the timed
path broken underneath: a sound run comes out correct, and each fault the
cell can have makes ``correct`` false (a step that returns its state
unchanged; half of the batch left out; the exchange between cards left out,
over a mesh of CPU shards; an answer altered where it is produced; K1 and K2
in bfloat16, the control; K1 and K2 losing a row)."""
from __future__ import annotations

import itertools

import pytest
import torch

from stereo_visual_odometry_tpu_torch.models import frontend
from stereo_visual_odometry_tpu_torch.parallel import sequences
from vobench import control, run, trace
from vobench.tests.tiny import SECONDS, TRAFFIC, run_tiny

CELLS = sorted(TRAFFIC)


@pytest.fixture(autouse=True)
def fresh_frontends():
    """Batched frontends are cached per configuration: none may outlive a
    test (a fault's patched step would)."""
    sequences.clear()
    yield
    sequences.clear()


@pytest.mark.parametrize("workload,shards", [(c, 1) for c in CELLS]
                         + [("lk_dense.offline_s11", 2)])
def test_sound_run_is_correct(workload, shards):
    out = run_tiny(workload, shards=shards)
    assert out["correct"], out["numbers"]
    assert out["numbers"]["segments"] >= 2 and out["frames"] > 0
    # The kernels' calls were held to the plain ones: K1 exactly, K2 to rounding.
    assert out["numbers"]["k1_checked"] > 0 and out["numbers"]["k1_err"] == 0.0
    if workload.startswith("orb"):
        assert out["numbers"]["k2_checked"] > 0 and out["numbers"]["k2_err"] < 1e-4
    assert out["numbers"]["tracked_min"] > 0
    assert out["window_s"] > 0 and out["setup_s"] > 0
    if workload.endswith("online_10hz"):
        assert len(out["latencies_s"]) == out["frames"] and out["unanswered"] == 0
    else:
        assert out["window_s"] >= SECONDS.get(workload, 2.0)


def _wrap_step(monkeypatch, change):
    """Every frontend made from now on steps through ``change(state,
    new_state, metrics) -> (new_state, metrics)``."""
    make = frontend.make_frontend

    def make_frontend(*args, **kw):
        init_fn, step_fn = make(*args, **kw)

        def step(state, *a, **k):
            new, m = step_fn(state, *a, **k)
            return change(state, new, m)
        return init_fn, step

    monkeypatch.setattr(frontend, "make_frontend", make_frontend)


def unchanged(monkeypatch):
    _wrap_step(monkeypatch, lambda state, new, m: (state, m))


def altered(monkeypatch):
    """Every fourth answer moved 2 m sideways where the step produces it: its
    T_21 and the pose composed from it."""
    calls = itertools.count()

    def change(state, new, m):
        if next(calls) % 4:
            return new, m
        shift = torch.zeros_like(m["T_21"])
        shift[..., 0, 3] = 2.0
        return dict(new, T_wc=new["T_wc"] + shift), dict(m, T_21=m["T_21"] + shift)
    _wrap_step(monkeypatch, change)


def half_batch(monkeypatch):
    """The batched step leaves the second half of its sequences out: their
    state is not advanced and their answer is no motion."""
    call = sequences.BatchedStep.__call__

    def step(self, state, imgs_l, imgs_r, u=None):
        new, m = call(self, state, imgs_l, imgs_r, u)
        k = imgs_l.shape[0] // 2

        def keep(a, b):
            if isinstance(a, torch.Tensor):
                return torch.cat([a[:k], b[k:]])
            return type(a)(keep(x, y) for x, y in zip(a, b))
        m = dict(m, T_21=torch.cat([m["T_21"][:k],
                                    torch.eye(4).expand_as(m["T_21"][k:])]))
        return {key: keep(new[key], state[key]) for key in new}, m
    monkeypatch.setattr(sequences.BatchedStep, "__call__", step)


def kernels_bf16(monkeypatch):
    """The control: K1 and K2 worked out by the reference in bfloat16."""
    return trace.KernelCalls(**control.bf16_kernels())


def kernels_lose_a_row(monkeypatch):
    """K1 and K2 with the last row of each window and patch lost."""
    return trace.KernelCalls(**control.edge_fault_kernels())


def no_exchange(monkeypatch):
    """The host reads every shard's answers from the first card only."""
    gather = sequences.gather

    def first_only(batch, keys, axis=0):
        parts = sequences.shards_of(batch)
        return gather(sequences.Shards([parts[0]] * len(parts)), keys, axis)
    monkeypatch.setattr(sequences, "gather", first_only)


FAULTS = [(cell, fault, 1) for cell in CELLS
          for fault in (unchanged, altered, kernels_bf16, kernels_lose_a_row)]
FAULTS += [("lk_dense.offline_s11", half_batch, 1), ("lk_dense.offline_s11", half_batch, 2),
           ("lk_dense.offline_s11", no_exchange, 2)]


@pytest.mark.parametrize("workload,fault,shards", FAULTS,
                         ids=[f"{c}-{f.__name__}-{n}" for c, f, n in FAULTS])
def test_fault_is_not_correct(monkeypatch, workload, fault, shards):
    calls = fault(monkeypatch)
    out = run_tiny(workload, shards=shards, calls=calls)
    assert not out["correct"], out["numbers"]
    # Judged and failed, not merely empty: the window completed its segments.
    assert out["numbers"]["segments"] >= 2
    assert not run.passes(out["numbers"], out["limits"])
