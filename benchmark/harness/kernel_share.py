"""A kernel's share of its roofline from the trace: the bound of the
work its launches needed (benchmark/bounds/<kernel>.py) over their device
time.  Every launch in a chemistry window has the pool's shape: width
lanes at order NEQ."""

from harness import peaks, spec


def share(run, kernel):
    b = spec.load_module("bounds", kernel)
    hits = [v for name, v in run.trace["kernels"].items()
            if b.KERNEL in name]
    launches = sum(v[0] for v in hits)
    device_s = sum(v[1] for v in hits)
    if launches == 0 or device_s <= 0.0:
        return None
    flop, nbytes = b.work(run.record["width"], run.record["neq"])
    bound, _ = peaks.bound_s(flop, nbytes, run.kind)
    return 100.0 * launches * bound / device_s
