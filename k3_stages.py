#!/usr/bin/env python3
"""Where kernel K3 (the Monte Carlo packet walk) spends its time, on one
NVIDIA GPU.

    python3 k3_stages.py [--reps N]

On the input of chip_smoke.py phase 7 (the bench disk, 4739 cells, a warm
Tdust profile, B=262144 packets from the 1e6-packet ladder, one 64-step
chunk):
  - K3's launch plan (CTAs per SM, grid, registers, spill bytes) and its
    SASS instruction count by opcode (cuobjdump -sass on the library);
  - the chunk's time from the default build, two ways: CUDA events around
    one call (host time of the wrapper included), and the device's alone
    with the calls queued behind a spin kernel;
  - from a build with -DRAC2D_K3_STAGES (clock() timers around each stage
    of the step), each stage's share of the threads' cycles; its lanes
    are held against the default build's (status, cell and e_count on
    >= 99% of lanes).
The last lines are one JSON object and the card's nvidia-smi name and
power limit.
"""

import argparse
import collections
import ctypes
import json
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

import chip_smoke as cs


def sass_counts(path, kernel_pat="mc_walk_kernel"):
    """Static SASS instruction counts of the library's K3 functions:
    {function: (total, Counter of opcodes)}."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([exe, "-sass", str(path)], capture_output=True,
                         text=True, timeout=300).stdout
    funcs, cur = {}, None
    for line in out.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            cur = m.group(1) if kernel_pat in m.group(1) else None
            if cur:
                funcs[cur] = collections.Counter()
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)",
                     line)
        if cur and m:
            funcs[cur][m.group(2)] += 1
    return {f: (sum(c.values()), c) for f, c in funcs.items()}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    opt = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False")
        return 1
    from rac2d_torch.ops import kernels, mcrt
    smi = cs.nvidia_smi()
    dev = torch.device("cuda")
    print(f"card: {smi}", flush=True)

    t0 = time.time()
    # the default build of mcwalk.cu alone first, for its ptxas report
    (so,), log = kernels._build([kernels.CSRC / "mcwalk.cu"])
    lib = kernels.load()
    lib_st, _, _ = kernels.load_stage_timers()
    print(f"builds: {time.time() - t0:.1f} s", flush=True)

    m = cs.bench_disk(dev)
    tdust = np.clip(150.0 * m.r_cells ** -0.5, 10.0, 1500.0)[None, :]
    cells = m.mc_cells()._replace(Tdust=torch.as_tensor(tdust, device=dev))
    model = mcrt.McModel(m.tab, m.gi, cells, m.cfg.star_mass)
    ws = mcrt.WalkSetup(model, m.mc_cfg.n_quantile)
    lam, en, _ = m.packet_pool(cs.MC_NPH)
    pick = np.linspace(0, len(lam) - 1, cs.MC_BATCH).astype(np.int64)
    gen = torch.Generator(device=dev).manual_seed(7)
    pk0 = mcrt.launch_packets(model, gen,
                              torch.as_tensor(lam[pick], device=dev),
                              torch.as_tensor(en[pick], device=dev), 0.0,
                              m.cfg.maxw)
    kw = cs.walk_kw(m)
    nlam = len(m.tab.lam)

    def zeros():
        return mcrt.McTallies.zeros(m.grid.n_cells, nlam, m.n_dust, 5,
                                    device=dev)

    def run(clk=None):
        """K3's launch object, prepared on fresh packets and tallies; the
        caller keeps the tensors alive until the launch has run."""
        pk, tl = pk0.clone(), zeros()
        wl = kernels.WalkLaunch(ws, tl, stage_clk=clk, **kw)
        wl.prepare(pk, cs.MC_STEPS)
        return wl, pk, wl.counters, tl

    def launch(lib, wl):
        stream = torch.cuda.current_stream().cuda_stream
        kernels._launch(lib.rac2d_mc_walk, ctypes.addressof(wl.args), stream)

    wl, ref, cnt, _tl = run()
    plan = wl.plan()
    launch(lib, wl)
    torch.cuda.synchronize()
    sass = sass_counts(so)
    n_sass = {f: n for f, (n, _) in sass.items()}
    top = collections.Counter()
    for _, c in sass.values():
        top.update(c)
    # ptxas -v on the default build: registers, stack frame and spills
    ptxas = [ln.strip() for ln in log.splitlines()
             if "spill" in ln or ("Used" in ln and "registers" in ln)]
    out = dict(plan=plan, active=int(cnt[0]), sass=n_sass,
               sass_top=dict(top.most_common(12)), ptxas=ptxas)
    print(f"plan {plan}; active after {int(cnt[0])}; SASS {n_sass}; top "
          f"opcodes {dict(top.most_common(12))}; ptxas {ptxas}", flush=True)

    # each job keeps its packets and tallies alive until its launch
    def timed(e0):
        job = run()
        torch.cuda.synchronize()
        e0.record()
        launch(lib, job[0])

    def queued():
        jobs = [run() for _ in range(opt.reps)]
        return cs.queued_ms([lambda j=j: launch(lib, j[0]) for j in jobs])

    ms_a = cs.event_ms(timed, opt.reps)
    (q_a, h_a), (q_b, h_b) = queued(), queued()
    ms_b = cs.event_ms(timed, opt.reps)
    out.update(ms=[ms_a, ms_b], device_ms=[q_a, q_b], host_ms=[h_a, h_b])

    clk = torch.zeros(kernels.K3_STAGES, dtype=torch.int64, device=dev)
    wl, pk, _, _tl = run(clk)
    launch(lib_st, wl)
    torch.cuda.synchronize()
    agree = float(((pk.status == ref.status) & (pk.cell == ref.cell)
                   & (pk.e_count == ref.e_count)).float().mean())
    c = clk.cpu().numpy().astype(np.float64)
    tot = c.sum()
    out.update(agree=agree, stage_cycles=float(tot), stage_share={
        s: float(v / tot) for s, v in zip(kernels.K3_STAGE_NAMES, c)})
    print(f"chunk {ms_a:.4f}/{ms_b:.4f} ms (events around one call), "
          f"{q_a:.4f}/{q_b:.4f} ms on the device (queued; host enqueue "
          f"{h_a:.3f}/{h_b:.3f} ms a call); timed build agrees with the "
          f"default on {agree:.6f} of lanes; stage shares of {tot:.4e} "
          "thread-cycles: " + ", ".join(
              f"{s} {v / tot:.1%}" for s, v in
              zip(kernels.K3_STAGE_NAMES, c)), flush=True)
    print(json.dumps({"k3_stages": out, "B": cs.MC_BATCH,
                      "steps": cs.MC_STEPS}))
    print(smi)
    if agree < 0.99:
        print("FAIL: the stage-timer build disagrees with the default build")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
