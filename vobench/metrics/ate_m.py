"""ate_m: the mean ATE RMSE (SE(3)-aligned, m) over every segment the window
completed, against the circuit's true poses (reference.judge)."""


def read(run):
    return run["numbers"]["ate_m"]
