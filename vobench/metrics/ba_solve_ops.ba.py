"""ba_solve_ops.ba (ops layer): the mean count of device ops (kernels,
copies, fills) of one window solve, over the solves profiled alone after the
window (``run_frames``' ``solves``)."""


def read(run):
    solves = run.get("solves")
    if not solves or not any(s["ops"] for s in solves):
        return None
    return sum(s["ops"] for s in solves) / len(solves)
