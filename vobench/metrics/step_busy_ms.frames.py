"""step_busy_ms.frames: device-busy ms of one replay of the step graph (the
union of its device intervals, the mean over a few replays profiled alone and
over the cards used)."""


def read(run):
    rep = run.get("replays")
    return rep["busy_ms"] if rep and rep["busy_ms"] > 0 else None
