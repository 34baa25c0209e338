"""The chemistry path's host-time spans (rac2d_torch.utils.spans) over
the window's untraced sweeps, for the per-layer metrics that read them.

Each DiskModel.chemistry_step is the program's kept span chem.sweep: the
program keeps the table of the spans that ran inside it, {name: (self
seconds, entries)} (spans.kept(), the last 16).  The window's sweeps are
the last kept ones before the traced sweep (a traced run traces one more
sweep after the window), and each has to have entered chem.step once per
BDF round of its record.  None where the program has no span registry or
the tables do not match the window's sweeps.
"""


def window(run):
    """{name: (self seconds, entries)} summed over the window's untraced
    sweeps, or None."""
    try:
        from rac2d_torch.utils import spans
    except ImportError:
        return None
    tables = [t for name, t in spans.kept() if name == "chem.sweep"]
    if run.trace is not None:
        tables = tables[:-1]
    sweeps = run.record["sweeps"]
    if len(tables) < len(sweeps):
        return None
    total = {}
    for t, sw in zip(tables[len(tables) - len(sweeps):], sweeps):
        if t.get("chem.step", (0.0, 0))[1] != sw["rounds"]:
            return None
        for k, (s, n) in t.items():
            s0, n0 = total.get(k, (0.0, 0))
            total[k] = (s0 + s, n0 + n)
    return total


def ms_per_round(run, *names):
    """The spans' self time, in ms per BDF round of the window."""
    w = window(run)
    if w is None:
        return None
    s = sum(w.get(n, (0.0, 0))[0] for n in names)
    return 1e3 * s / run.record["timed"]["rounds"]


def entries_per_round(run, name):
    """The span's entries per BDF round of the window."""
    w = window(run)
    if w is None:
        return None
    return w.get(name, (0.0, 0))[1] / run.record["timed"]["rounds"]
