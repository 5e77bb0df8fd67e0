"""k2_roofline.frames: K2's share of its roofline over a few profiled
replays, in %: the sum over its calls of each call's least time (arith.k2_work:
distinct bytes over the HBM rate against operations over the float32 rate)
divided by its device time by kernel name (trace.K2_KERNEL)."""


def read(run):
    rep = run.get("replays")
    if not rep or rep["k2_time_s"] <= 0 or rep["k2_bound_s"] <= 0:
        return None
    return 100.0 * rep["k2_bound_s"] / rep["k2_time_s"]
