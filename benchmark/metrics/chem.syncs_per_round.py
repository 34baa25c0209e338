"""Reads back to the host (entries of the span chem.sync) a BDF round,
over the window's untraced sweeps."""

from harness import chem_spans


def read(run):
    return chem_spans.entries_per_round(run, "chem.sync")
