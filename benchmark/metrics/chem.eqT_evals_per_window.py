"""Net-heating evaluations (entries of the span chem.eqT.eval) per window
of the equilibrium-T solve, over the window's untraced sweeps: a sweep
solves its cells in windows of the pool's width, ceil(cells / width) of
them.  None where the tables hold chem.eqT without chem.eqT.eval
(harness/eqt_spans.py)."""

from harness import eqt_spans


def read(run):
    w = eqt_spans.window(run)
    if w is None:
        return None
    r = run.record
    windows = sum(-(-len(s["cells"]) // r["width"]) for s in r["sweeps"])
    return w.get("chem.eqT.eval", (0.0, 0))[1] / windows
