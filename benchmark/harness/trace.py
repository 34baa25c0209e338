"""The traced run's device timeline: torch.profiler over the traced
window, reduced to the device's busy time, the time of each kernel and
the idle gaps by what the host was doing.

The reduction reads the profiler's raw events (kineto_results), not its
function-event tree, which would take minutes at a million launches.
"""

import collections

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

WINDOW = "bench.window"
LABEL_PREFIXES = ("bench.", "mc.")


def union_s(starts, ends, lo, hi):
    """Length of the union of [start, end) intervals clipped to [lo, hi],
    in the intervals' unit (the union of kernel, copy and memset
    intervals, as mc_pass_profile.py measured the device's busy share)."""
    order = np.argsort(starts, kind="stable")
    total, end = 0.0, lo
    for s, e in zip(starts[order], ends[order]):
        s, e = max(s, end), min(e, hi)
        if e > s:
            total += e - s
            end = e
    return total


def is_label(name):
    return name.startswith(LABEL_PREFIXES)


class Trace:
    """with Trace(on, dev) as tr: ... ; tr.summary() after the block.  Off,
    it records nothing and summary() is None.  On a CPU device (the
    harness's own tests) it traces the host alone."""

    def __init__(self, on, dev):
        self.on = on
        self.cuda = dev.type == "cuda"
        self.prof = None
        self._summary = None

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def __enter__(self):
        if self.on:
            self._sync()
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if self.cuda else [])
            self.prof = profile(activities=acts)
            self.prof.__enter__()
            self.rf = record_function(WINDOW)
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.on:
            self._sync()
            self.rf.__exit__(*exc)
            self.prof.__exit__(*exc)
        return False

    def summary(self):
        if not self.on:
            return None
        if self._summary is None:
            self._summary = summarize(self.prof.profiler.kineto_results
                                      .events())
            self.prof = None
        return self._summary


def summarize(events, top=10):
    """busy_s, window_s, kernels {name: [launches, seconds]}, device_ops
    and idle_gaps (each at most `top` [name, seconds] pairs)."""
    win = [e for e in events if e.name() == WINDOW
           and e.device_type() == torch.autograd.DeviceType.CPU]
    if not win:
        raise RuntimeError(f"no {WINDOW} span in the trace")
    lo, hi = win[0].start_ns(), win[0].end_ns()
    cuda = torch.autograd.DeviceType.CUDA
    dev_name, dev_s, dev_e = [], [], []
    cpu_name, cpu_s, cpu_e = [], [], []
    labels = []
    for e in events:
        name = e.name()
        if e.device_type() == cuda:
            if is_label(name) or e.is_user_annotation():
                continue
            dev_name.append(name)
            dev_s.append(e.start_ns())
            dev_e.append(e.end_ns())
        elif is_label(name):
            if name != WINDOW:
                labels.append((e.start_ns(), e.end_ns(), name))
        else:
            cpu_name.append(name)
            cpu_s.append(e.start_ns())
            cpu_e.append(e.end_ns())
    dev_s, dev_e = np.asarray(dev_s, np.int64), np.asarray(dev_e, np.int64)
    inside = (dev_s >= lo) & (dev_s <= hi)
    kernels = collections.defaultdict(lambda: [0, 0.0])
    for n, s, e in zip(np.asarray(dev_name, object)[inside], dev_s[inside],
                       dev_e[inside]):
        k = kernels[n]
        k[0] += 1
        k[1] += (e - s) / 1e9
    busy = union_s(dev_s[inside], dev_e[inside], lo, hi) / 1e9
    return dict(
        busy_s=busy, window_s=(hi - lo) / 1e9, device_events=int(inside.sum()),
        kernels=dict(kernels),
        device_ops=[[n[:120], v[1]] for n, v in sorted(
            kernels.items(), key=lambda kv: -kv[1][1])[:top]],
        idle_gaps=idle_gaps(dev_s[inside], dev_e[inside], lo, hi,
                            np.asarray(cpu_s, np.int64),
                            np.asarray(cpu_e, np.int64),
                            np.asarray(cpu_name, object), labels, top))


def idle_gaps(ds, de, lo, hi, cs, ce, cn, labels, top):
    """The device's idle time summed by what the host was doing at each
    gap's midpoint: the innermost harness or program label open there and
    the outermost host operator open there ("python" where none is)."""
    if len(ds) == 0:
        return [["no device work", (hi - lo) / 1e9]]
    order = np.argsort(ds, kind="stable")
    ds, de = ds[order], np.maximum.accumulate(de[order])
    g_lo = np.concatenate([[lo], de])
    g_hi = np.concatenate([ds, [hi]])
    keep = g_hi > g_lo
    g_lo, g_hi = g_lo[keep], g_hi[keep]
    mid = (g_lo + g_hi) // 2
    # outermost host operators: those that start after every earlier one
    # has ended
    o = np.argsort(cs, kind="stable")
    cs, ce, cn = cs[o], ce[o], cn[o]
    prev_end = np.concatenate([[np.iinfo(np.int64).min],
                               np.maximum.accumulate(ce)[:-1]])
    outer = cs >= prev_end
    os_, oe, on = cs[outer], ce[outer], cn[outer]
    j = np.searchsorted(os_, mid, side="right") - 1
    op = np.where((j >= 0) & (oe[np.maximum(j, 0)] > mid),
                  on[np.maximum(j, 0)], "python")
    lab = np.full(len(mid), "", dtype=object)
    # labels are few; the innermost is the latest-starting one open
    for s, e, n in sorted(labels):
        lab[(mid >= s) & (mid < e)] = n
    sums = collections.defaultdict(float)
    for a, b, l_, o_ in zip(g_lo, g_hi, lab, op):
        sums[f"{l_ or 'none'} | {o_}"[:120]] += (b - a) / 1e9
    return [[n, s] for n, s in sorted(sums.items(), key=lambda kv: -kv[1])
            [:top]]
