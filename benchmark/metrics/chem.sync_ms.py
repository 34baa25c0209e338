"""ms a BDF round of host self time in the span chem.sync: the host
blocked on the card in the reads back to the host of the round and of
the pool's loop, over the window's untraced sweeps."""

from harness import chem_spans


def read(run):
    return chem_spans.ms_per_round(run, "chem.sync")
