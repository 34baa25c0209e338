"""K2's share of its roofline in the traced sweep, in %, as k1_roofline
with benchmark/bounds/k2.py."""

from harness import kernel_share


def read(run):
    return kernel_share.share(run, "k2")
