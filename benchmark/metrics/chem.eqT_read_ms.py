"""ms a sweep of host self time in the span chem.eqT.read: the host
blocked on the card in the equilibrium-T bisection's loop tests, over
the window's untraced sweeps.  None where the tables hold chem.eqT
without chem.eqT.eval (harness/eqt_spans.py)."""

from harness import eqt_spans


def read(run):
    return eqt_spans.ms_per_sweep(run, "chem.eqT.read")
