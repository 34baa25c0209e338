"""ms a BDF round of host self time in the spans chem.factor (bdf._bfac:
equilibration and K1) and chem.solve (bdf._bsolve: K2 twice and the f64
residual), over the window's untraced sweeps."""

from harness import chem_spans


def read(run):
    return chem_spans.ms_per_round(run, "chem.factor", "chem.solve")
