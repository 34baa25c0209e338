"""ms a BDF round of host self time in the span chem.jac: the Jacobians
(species block, the temperature column through the RHS, the key
species' row), over the window's untraced sweeps."""

from harness import chem_spans


def read(run):
    return chem_spans.ms_per_round(run, "chem.jac")
