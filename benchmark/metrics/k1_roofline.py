"""K1's share of its roofline in the traced sweep, in %: each launch's
bound (benchmark/bounds/k1.py at the pool's width and NEQ, over the
card's published peaks) over the launch's device time, summed over the
launches.  None where the trace holds no K1 launch."""

from harness import kernel_share


def read(run):
    return kernel_share.share(run, "k1")
