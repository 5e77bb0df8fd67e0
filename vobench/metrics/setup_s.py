"""setup_s: from the process's start to the first timed frame: imports, the
render, kernel builds, the warm-up and the graph captures."""


def read(run):
    return run["setup_s"]
