"""Published peaks of the cards a run may report, by the name that
torch.cuda.get_device_name() gives (NVIDIA's data sheet, SXM part, dense
rates, at the full 700 W power limit).  A kernel's bound is the larger of
its operations over the peak rate and its bytes over the memory's
bandwidth."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(f32_flops=67e12, hbm_bps=3.35e12),
}


def peaks_of(kind):
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for {kind!r} in "
                       "benchmark/harness/peaks.py")
    return PEAKS[kind]


def bound_s(flop, nbytes, kind):
    """(seconds, "operations" or "bytes"): the least time the card could
    take for this work."""
    p = peaks_of(kind)
    t_op, t_by = flop / p["f32_flops"], nbytes / p["hbm_bps"]
    return (t_op, "operations") if t_op >= t_by else (t_by, "bytes")
