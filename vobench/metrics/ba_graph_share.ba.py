"""ba_graph_share.ba (backend layer): the share, in %, of the window's
``backend.solve`` spans that solved (those holding a ``backend.lm`` span)
whose solve replayed from a CUDA graph: those holding a ``backend.replay``
span (the graphed window solve, ``models/ba_graph.py``). It says whether the
graph engages: 100 where every solve of the window replays, less where some
ran another way. Read from the program's spans (``run_frames``,
``--trace 1``); None where the program records none, or records no
``backend.replay`` span at all (a program without the graphed solve)."""


def read(run):
    spans = run.get("spans")
    if not spans or not any(s["name"] == "backend.replay" for s in spans):
        return None
    by_id = {s["id"]: s for s in spans}

    def solve_of(s):
        while s is not None and s["name"] != "backend.solve":
            s = by_id.get(s["parent"])
        return None if s is None else s["id"]

    solved = {solve_of(s) for s in spans if s["name"] == "backend.lm"} - {None}
    graphed = {solve_of(s) for s in spans if s["name"] == "backend.replay"} & solved
    return 100.0 * len(graphed) / len(solved) if solved else None
