"""ba_solve_idle.ba (device layer): 1 - busy / wall, in %, of a window solve.
busy: the mean device-busy time of the solves profiled alone after the
window (``run_frames``' ``solves``: the union of each one's device
intervals; the profiler lengthens a solve's wall, not its kernels). wall:
the median device time of the window's own ``backend.solve`` spans that
solved (those holding a ``backend.lm`` span; a CUDA event pair, no profiler
on), from the table's upload to the copy back. None where either is
missing (a program without those spans, or no card)."""
from vobench.arith import idle_share, percentile


def read(run):
    spans, solves = run.get("spans"), run.get("solves")
    if not spans or not solves:
        return None
    solved = {s["parent"] for s in spans if s["name"] == "backend.lm"}
    walls = [s["device_ms"] / 1e3 for s in spans
             if s["name"] == "backend.solve" and s["id"] in solved and s.get("device_ms")]
    busy = sum(s["busy_s"] for s in solves) / len(solves)
    if not walls or busy <= 0:
        return None
    return idle_share(busy, percentile(walls, 50))
