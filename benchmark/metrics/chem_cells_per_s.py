"""Cells integrated to the configuration's t_max in the window, over all
the window's time (whole sweeps: the last one crosses the window's
seconds and counts in full)."""


def read(run):
    r = run.record
    return r["cells_done"] / r["window_s"]
