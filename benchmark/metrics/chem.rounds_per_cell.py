"""BDF rounds of the pool (BDFResult.n_rounds) per cell swept, over the
window's untraced sweeps."""


def read(run):
    t = run.record["timed"]
    return t["rounds"] / t["cells"]
