"""device_idle.latency: 1 - busy / wall over the profiled stretch of the cell's
path, in %, busy being the union of device intervals (the mean over the
cards used)."""
from vobench.arith import idle_share


def read(run):
    st = run.get("stretch")
    if not st or st["busy_s"] <= 0:
        return None
    return idle_share(st["busy_s"], st["window_s"])
