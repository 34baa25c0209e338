#!/usr/bin/env python3
"""Where one Monte Carlo pass spends its time, on one NVIDIA GPU.

    python3 mc_pass_profile.py

On the bench disk of chip_smoke.py (bench_disk: 4739 cells, batch 262144)
it runs one warm pass through DiskModel.mc_pass, then one pass of 1e6
packets (chip_smoke.MC_NPH, as phase 9) under torch.profiler with the CPU
and CUDA activities, and prints:
  - the pass's wall time and the device's busy share over the pass's
    window (the union of the kernel, copy and memset intervals on the
    device, over the host interval of the pass);
  - device time by kernel, the top 10 (the walk K3, the fold K4 and the
    ATen kernels);
  - host time per label of the pass (the `mc.*` record_function labels of
    mcrt.mc_pass_streamed and DiskModel.mc_pass): calls and total, and
    the host operators and runtime calls with the most self time;
  - the number of device-to-host and host-to-device copies in the pass.
If the trace holds no device events, it says so and times the pass with
CUDA events instead.  The last lines are one JSON object and the card's
nvidia-smi name and power limit.  Needs a CUDA device; it exits non-zero
without one.
"""

import collections
import json
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

import chip_smoke as cs

PASS_LABEL = "mc_pass_profile.pass"


def union_ms(intervals, lo, hi):
    """Length in ms of the union of (start, end) µs intervals clipped to
    [lo, hi]."""
    total, end = 0.0, lo
    for s, e in sorted(intervals):
        s, e = max(s, end), min(e, hi)
        if e > s:
            total += e - s
            end = e
    return total / 1e3


def is_label(name):
    return name.startswith("mc.") or name == PASS_LABEL


def host_ops(prof, top=12):
    """The host operators and runtime calls with the most self time over
    the trace (ms), labels excluded."""
    rows = [(e.key, e.count, e.self_cpu_time_total / 1e3)
            for e in prof.key_averages() if not is_label(e.key)]
    rows.sort(key=lambda r: -r[2])
    return [dict(name=n[:96], calls=c, ms=t) for n, c, t in rows[:top]]


def summarize(events):
    """The pass's window, busy share, kernels, labels and copies from the
    profiler's function events."""
    win = [e for e in events if e.name == PASS_LABEL]
    if not win:
        raise RuntimeError(f"no {PASS_LABEL} span in the trace")
    lo, hi = win[0].time_range.start, win[0].time_range.end
    # device events: kernels, copies and memsets (the labels' GPU-side
    # annotation spans, which run from a label's first kernel to its
    # last, are not device work)
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and lo <= e.time_range.start <= hi and not is_label(e.name)]
    kern = collections.defaultdict(lambda: [0, 0.0])
    for e in dev:
        k = kern[e.name[:96]]
        k[0] += 1
        k[1] += (e.time_range.end - e.time_range.start) / 1e3
    labels = collections.defaultdict(lambda: [0, 0.0])
    for e in events:
        if e.device_type == DeviceType.CPU and is_label(e.name) \
                and e.name != PASS_LABEL:
            lb = labels[e.name]
            lb[0] += 1
            lb[1] += (e.time_range.end - e.time_range.start) / 1e3
    busy = union_ms([(e.time_range.start, e.time_range.end) for e in dev],
                    lo, hi)
    window = (hi - lo) / 1e3
    copies = {d: sum(1 for e in dev if e.name.startswith(f"Memcpy {d}"))
              for d in ("DtoH", "HtoD", "DtoD")}
    top = sorted(kern.items(), key=lambda kv: -kv[1][1])[:10]
    return dict(window_ms=window, device_busy_ms=busy,
                busy_share=busy / window if window > 0 else 0.0,
                device_events=len(dev),
                kernels=[dict(name=n, calls=c, ms=t) for n, (c, t) in top],
                labels={n: dict(calls=c, ms=t)
                        for n, (c, t) in sorted(labels.items())},
                copies=copies)


def main():
    nph = cs.MC_NPH
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False")
        return 1
    smi = cs.nvidia_smi()
    print(f"card: {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    dev = torch.device("cuda")
    t0 = time.time()
    m = cs.bench_disk(dev)
    _, _, warm = m.mc_pass(0, nph)
    print(f"setup and warm pass: {time.time() - t0:.1f} s (warm pass "
          f"{warm['wall_s']:.3f} s)", flush=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(PASS_LABEL):
            _, fates, st = m.mc_pass(1, nph)
            torch.cuda.synchronize()
    s = summarize(prof.events())
    s["host_ops"] = host_ops(prof)
    keep = ("packets", "chunks", "refills", "compactions", "steps",
            "wall_s", "k3_launches", "k4_launches", "k3_host_s",
            "k4_host_s", "host_reads")
    s["pass"] = {k: st[k] for k in keep if k in st}
    s["fates"] = fates
    print(f"pass under the profiler: {st['packets']} packets, "
          f"{st['chunks']} chunks, {st['refills']} refills, "
          f"{st['compactions']} compactions, wall {st['wall_s']:.4f} s; "
          f"window {s['window_ms']:.3f} ms, device busy "
          f"{s['device_busy_ms']:.3f} ms = {s['busy_share']:.2%} of it "
          f"({s['device_events']} device events); copies {s['copies']}",
          flush=True)
    if s["device_events"] == 0:
        print("the trace holds no device events: the pass timed with CUDA "
              "events instead", flush=True)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        m.mc_pass(1, nph)
        e1.record()
        torch.cuda.synchronize()
        s["event_ms"] = e0.elapsed_time(e1)
        print(f"pass: {s['event_ms']:.3f} ms by CUDA events", flush=True)
    for k in s["kernels"]:
        print(f"  device {k['ms']:9.4f} ms {k['calls']:6d} calls  "
              f"{k['name']}")
    for n, v in s["labels"].items():
        print(f"  host {v['ms']:9.4f} ms {v['calls']:6d} calls  {n}")
    for k in s["host_ops"]:
        print(f"  host self {k['ms']:9.4f} ms {k['calls']:6d} calls  "
              f"{k['name']}")
    print(json.dumps({"mc_pass_profile": s, "nph": nph}))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
