"""ms of one BDF round: the sweeps' time less their fields' time, over
their rounds (the untraced sweeps of the window).  With evolT=False it
holds the equilibrium-T solve too, which has no timer of its own."""


def read(run):
    t = run.record["timed"]
    return 1e3 * (t["wall_s"] - t["fields_s"]) / t["rounds"]
