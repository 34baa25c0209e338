"""ms a BDF round of host self time in the span chem.rhs: the Newton
loop's right-hand sides (rates, species RHS, dT/dt), over the window's
untraced sweeps."""

from harness import chem_spans


def read(run):
    return chem_spans.ms_per_round(run, "chem.rhs")
