"""frames_per_s: every frame the window completed (each sequence's init frame and
frames a gate rejected included; a pair an online feed dropped is not) over the
window's whole time."""


def read(run):
    done = run.get("completed", run["frames"])
    return done / run["window_s"] if run.get("window_s") else None
