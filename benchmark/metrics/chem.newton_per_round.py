"""Newton iterations of the window (entries of the span chem.rhs, one
right-hand side and two K2 solves each) a BDF round, over the window's
untraced sweeps."""

from harness import chem_spans


def read(run):
    return chem_spans.entries_per_round(run, "chem.rhs")
