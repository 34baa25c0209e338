"""ms a BDF round of host self time in the span chem.pool: the pool
sweep around the rounds (tolerance ladder, batch set-up, flush, refill,
ladder roll-back, write-back), over the window's untraced sweeps."""

from harness import chem_spans


def read(run):
    return chem_spans.ms_per_round(run, "chem.pool")
