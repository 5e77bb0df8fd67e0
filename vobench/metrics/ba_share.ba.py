"""ba_share.ba (backend layer): the share of the window, in %, that the BA
backend's window work took on the host's clock: every ``backend.solve`` span
of the window (``optimize``: the table put on the device, the solve, the copy
back) and every ``backend.marginalize`` span (a slide's prior build, made when
the keyframe is added), over ``window_s``. Read from the program's spans
(``run_frames``, ``--trace 1``); None where the program records none."""


def read(run):
    spans = run.get("spans")
    if not spans or not run.get("window_s"):
        return None
    took = [s["end_ns"] - s["start_ns"] for s in spans
            if s["name"] in ("backend.solve", "backend.marginalize")]
    if not took:
        return None
    return 100.0 * sum(took) / 1e9 / run["window_s"]
