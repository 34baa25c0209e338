"""ms a BDF round of host self time in the span chem.step: the round
outside its right-hand sides, Jacobian, LU and host reads (predict,
refresh decisions, error test, order and step adaptation, dense-output
recording), over the window's untraced sweeps."""

from harness import chem_spans


def read(run):
    return chem_spans.ms_per_round(run, "chem.step")
