"""ba_solve_ms_p50.ba (backend layer): the median host time, in ms, of the
window's ``backend.solve`` spans that solved (those holding a ``backend.lm``
span): the keyframe's table put on the device, the eager LM solve, the copy
back and the host's update. Read from the program's spans (``run_frames``,
``--trace 1``); None where the program records none."""
from vobench.arith import percentile


def read(run):
    spans = run.get("spans")
    if not spans:
        return None
    solved = {s["parent"] for s in spans if s["name"] == "backend.lm"}
    took = [(s["end_ns"] - s["start_ns"]) / 1e6 for s in spans
            if s["name"] == "backend.solve" and s["id"] in solved]
    return percentile(took, 50) if took else None
