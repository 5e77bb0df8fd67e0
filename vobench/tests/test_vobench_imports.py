"""What a run loads and what the harness refuses, each in a fresh
interpreter; and, on the card, one short run of each one-card cell."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]

AFTER_A_RUN = """
import json, sys
from vobench import run
from vobench.tests.tiny import run_tiny
out = run_tiny("lk_dense.offline_s11", seconds=1.0)
print(json.dumps({"correct": out["correct"], "forbidden": run.loaded_forbidden(),
                  "port": "stereo_visual_odometry_tpu_torch" in sys.modules}))
"""


def test_a_run_loads_no_jax_and_no_jax_package():
    """After a run, no module whose top-level name is exactly jax, jaxlib,
    flax or stereo_visual_odometry_tpu (the port's name begins with it)."""
    proc = subprocess.run([sys.executable, "-c", AFTER_A_RUN], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"correct": True, "forbidden": [], "port": True}


def test_loaded_forbidden_compares_whole_top_level_names(monkeypatch):
    from vobench import run
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    found = run.loaded_forbidden()
    assert "jaxlib.xla_client" in found and "jaxtyping_like" not in found
    assert not [m for m in found if m.startswith("stereo_visual_odometry_tpu_torch")]


def _harness(cwd, env=None):
    return subprocess.run([sys.executable, "-m", "vobench.run", "--workload",
                           "lk_dense.offline_s11", "--seed", "5", "--seconds", "1"],
                          cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_refuses_without_a_card_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = _harness(ROOT)
    assert proc.returncode == 2 and proc.stdout == ""
    assert "needs 1 CUDA card" in proc.stderr


def test_refuses_with_only_the_benchmarks_files(tmp_path):
    """In a directory that holds only BENCHMARK.json and vobench/, a run
    fails and prints no result (the program is not there)."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "vobench", tmp_path / "vobench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _harness(tmp_path, env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert proc.returncode != 0 and proc.stdout == ""


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["lk_dense.offline_s11", "orb.offline_s1",
                                      "lk_dense.online_10hz"])
def test_card_run(workload):
    """A short run of the cell on the card: correct, with its end-to-end
    metrics and the device block."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    proc = subprocess.run([sys.executable, "-m", "vobench.run", "--workload", workload,
                           "--seed", "3000000001", "--seconds", "8", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu" and out["attempted"] > 0
    assert "setup_s" in out["metrics"] and list(out)[-1] == "checks"
