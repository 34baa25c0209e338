"""Share of the window's lane-rounds that took a step: accepted steps
over rounds x pool width, in %, over the window's untraced sweeps."""


def read(run):
    t = run.record["timed"]
    return 100.0 * t["steps"] / (t["rounds"] * run.record["width"])
