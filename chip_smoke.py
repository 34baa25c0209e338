#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (rac2d_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its result and seconds; any failure exits non-zero):
  1. the card: nvidia-smi name and power limit; CUDA must be available;
  2. build the hand-written CUDA kernels from rac2d_torch/csrc/ (nvcc,
     sm_90a) and print the compiler's register/shared-memory report;
  3. kernels K1 (blocked LU factor) and K2 (block substitution) against
     their plain PyTorch versions on the card, at the shapes of the main
     path: B=256 lanes (phase 5's window) and B=RUN_CHUNK=1024 lanes
     (phase 11's), n=485 (padded to N=512), on row/column-equilibrated
     I - cJ matrices made from a numpy seed; then K1 and K2 at B in {1, 3}
     and n in {1, 64, 65, 130, 512, 600} (600: K1 takes the trailing
     columns in two slabs), on matrices whose pivots reach the 1e-20
     floor (the floored pivot must keep its sign), and K2 on factors at
     B in {1, 256} and n in {65, 485, 600} whose unneeded entries are NaN
     (x must stay finite and equal to x on the clean factor);
  4. time K1/K2 at both main-path shapes, their plain versions and their
     library yardsticks
     (torch.linalg.lu_factor_ex(pivot=False), torch.linalg.lu_solve with
     identity pivots; CUDA events, in turns plain, kernel, library,
     library, kernel, plain; beside them the host's time to enqueue a
     kernel call, since an event time near it would be the host's), and
     print each kernel's bound: the larger of its f32 FMA work over 67
     TFLOP/s and its bytes (inputs read once, outputs written once) over
     3.35 TB/s;
  5. the slice: the coupled chemistry+temperature pool sweep through
     ChemicalODE(net, thermal=ThermalBalance(net)).solve_pool on the
     shipped network (NEQ=485), window W=256, per-lane retry ladder of 3
     levels, over a pool of 512 random disk cells (the bench.py recipe,
     seed 0) plus the 3 production cells of tests/test_chem_production.py,
     1e-8 -> T_MAX = 1 yr; the kernels' launch counts over this run must
     be > 0 (printed with the BDF round count and launches per round), and the
     final states must be finite, physical and conserve elements;
  6. 8 of those lanes re-solved with the plain LU on the card: key
     species within 5% of phase 5's final states;
  7. kernel K3 (the Monte Carlo packet walk) against its plain version on
     the card: the production-shaped disk of bench.py (TW Hya-like,
     ncol=200, <=10000 cells, one silicate component, L_X=1e30,
     McConfig(nlen_lut=256, n_quantile=128)) with a warm Tdust(r)
     profile, B=262144 packets taken evenly from the 1e6-packet ladder
     and launched from one torch.Generator seed, one 64-step chunk each
     way; lanes agreeing on status, cell and e_count >= 99%, equal RNG
     words on live agreeing lanes, flux and mrw_path totals within 1e-3,
     and on the agreeing lanes every bin of every tally channel the walk
     writes within 1e-4 of the channel's largest bin; CUDA-event times of
     the chunk (plain, kernel, kernel, plain, each an event pair around one
     call of a launch object built once, kernels.WalkLaunch, on a new
     Packets object; between the kernel's, its device time with five
     chunks at a time queued behind a spin kernel, and the host's time to
     enqueue a call, through the launch object and through the one-call
     function kernels.mc_walk); K3's launch (registers,
     local bytes, CTAs per SM, grid, shared memory and the tables staged
     in it); and the hand-built lanes that the JAX walk never ends
     (mcrt.edge_lanes: grazing descents onto a bottom face, lanes aimed at
     a cell corner) through K3 and the plain walk, 8 steps: each must
     leave its cell or end, the same way in both;
  8. kernel K4 (the terminal tally fold) against its plain version on the
     lanes phase 7 walked (B=262144) and on 4096 of them as a compaction
     tier holds them (the last quarter padding): every bin of the
     collector, the image-plane bins and the water deposit within 1e-5 of
     its array's largest, and K4's count of lanes per status code equal to
     the plain fold's and to mcrt.packet_fates; at both sizes the times as
     in phase 7 (through kernels.FoldLaunch), K4's launch (grid, CTAs
     per SM, registers), and its bound on two bases: the bytes the fold needs
     (the status of every lane, the eight fields of escaped lanes, cell
     and en of water-destroyed ones, the touched bins) and, as the
     earlier versions of this script did, all ten lane fields of every
     lane;
  9. the slice: DiskModel(cfg, device="cuda").prepare() and
     run_mc(n_passes=2, nph=1_000_000) on that disk (streamed pass, batch
     262144, refill and compaction tail); per pass the wall time,
     packets/s, chunks, refills, K3/K4 launches, the tail of <= 64 live
     lanes and its share of the pass, fates and Tdust range, the host
     seconds spent in K3's and K4's launch objects and the reads back to
     the host by the pass loop; every packet
     counted, no lane still active at the 100000-step cap (those that are
     get printed with their cell's bounds), premature <= 1e-3, Tdust
     finite inside [TdustMin, TdustMax], flux finite and >= 0, K3/K4
     launched;
 10. the second pass re-run at nph=65536 (one batch, no refill, at most
     8192 steps) with the kernels and with the plain walk and fold, from
     the same cells and generator seed: median |dTdust|/Tdust < 3% over
     active cells, total absorbed energy in active cells within 2%, and
     en_gain finite in every cell;
 11. the main path: DiskModel(cfg, "cuda").prepare() then run(n_iter=1)
     on the bench disk with the JAX package's chemistry defaults
     (evolT=True, chem_stream=True, the 4-level ladder): the initial
     run_mc (2 passes of 1e6 packets, K3/K4), reduce_fields, the columns
     and self-shielding through the path matrices, env assembly, and the
     pool sweep over all 4557 active cells at NEQ=485 (K1/K2) to
     RUN_T_MAX in windows of RUN_CHUNK, with a sweep wall budget of
     RUN_BUDGET_S (chunk_wall_s from it); then the convergence
     bookkeeping.  It prints the prepare and path-trace times, the nnz of
     both path matrices, the depth cuts, the stage timing line, K1-K4
     launches during run (each must be > 0), the MC fates, the converged
     fraction and the cells at quality 512 (at most 5% of active cells);
     it fails on a non-finite X or Tgas, an abundance >= 1.5 or Tgas
     outside (2, 3e4) K in a clean cell, element drift >= 1%, max H2 over
     active cells <= 0.1, Tdust outside [TdustMin, TdustMax], or any
     column, shielding factor or Av_toISM of prepare_sweep_fields on the
     card more than 1e-12 relative from the same computed on the CPU from
     the same X.
Phases 7 and 8 also print the bounds of K3 and K4 (bytes: for K3 the
packet state read and written once, the tables read once, the tally bins
the run touched read and written once; for K4 the two bases above); no
single PyTorch call computes either.
Phases 5-6 run to T_MAX = 1 yr (1e2 yr until phase 11 was added): at 1e2
yr they took 644 s on an H100 80GB HBM3 (700 W) and the whole script
1018 s.
The second-to-last lines are the kernels' JSON record (K1, K2 and one line
for each TPU probe kernel that K3 or K4 replaces, each with its time,
bound, plain and library times and launches: `launches` over phase 11's
run, `launches_slice` over phase 5 (K1/K2) or phase 9 (K3/K4); the K1/K2
rows hold their check and times at phase 11's window B=RUN_CHUNK and,
under "slice", at phase 5's B=W; K3/K4
rows add device_ms, the queued device time) and the card's nvidia-smi
line; the last line is {"ok": true, "device": {...}}.  Where a pass's
host time goes: mc_pass_profile.py (run by hand).
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

D2G = 2.8e-12
W = 256
T_MAX = 1.0
RTOL0, ATOL0 = 1e-4, 1e-30
# production cells (tests/test_chem_production.py COUPLED_CELLS)
COUPLED_CELLS = [
    dict(T=20.0, Tdust=20.0, n=1e6, Av=5.0),
    dict(T=50.0, Tdust=30.0, n=1e7, Av=2.0, G0star=1e2, lya=1e6,
         zetaX=1e-16),
    dict(T=300.0, Tdust=80.0, n=1e9, Av=0.5, G0star=1e4),
]
K1_REPLACES = "rac2d_tpu/ops/pallas/blocklu_pallas.py:235"
K2_REPLACES = "rac2d_tpu/ops/pallas/blocklu_pallas.py:278"
SOURCE = "rac2d_torch/csrc/blocklu.cu"
MC_SOURCE = "rac2d_torch/csrc/mcwalk.cu"
# the TPU probe kernels (each function that reaches pl.pallas_call) and
# the kernel of this package that takes their place
PROBES = [
    ("P1-A", "tools/probe_pallas2.py:42", "mc_walk"),
    ("P1-B", "tools/probe_pallas2.py:67", "mc_walk"),
    ("P1-C", "tools/probe_pallas2.py:102", "fold_terminal"),
    ("P1-D", "tools/probe_pallas2.py:141", "mc_walk"),
    ("P1-E", "tools/probe_pallas2.py:181", "mc_walk"),
    ("P2-a", "tools/probe_pallas3.py:37", "mc_walk"),
    ("P2-b", "tools/probe_pallas3.py:61", "mc_walk"),
    ("P2-c", "tools/probe_pallas3.py:85", "mc_walk"),
    ("P2-d", "tools/probe_pallas3.py:119", "mc_walk"),
    ("P3-1", "tools/probe_pallas_gather.py:50", "mc_walk"),
    ("P3-2", "tools/probe_pallas_gather.py:74", "mc_walk"),
    ("P3-3", "tools/probe_pallas_gather.py:98", "mc_walk"),
    # a scatter-add of per-lane weights into a table in one pass over a
    # batch, outside any walk step: what K4 does, not K3's in-step tallies
    ("P3-4", "tools/probe_pallas_gather.py:122", "fold_terminal"),
    ("P3-5", "tools/probe_pallas_gather.py:163", "mc_walk"),
    ("P3-6", "tools/probe_pallas_gather.py:194", "mc_walk"),
]
MC_BATCH = 262_144
MC_STEPS = 64
# the card's published peaks (H100 SXM data sheet, 700 W): f32 outside the
# tensor cores and device-memory bandwidth
F32_FLOPS = 67e12
HBM_BPS = 3.35e12


def say(msg):
    print(msg, flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def bench_cells(n, seed, device):
    """The random disk-cell recipe of bench.py (bench_chem, evolT)."""
    from rac2d_torch.ops.rates import CellEnv
    from rac2d_torch.ops.thermal import ThermalEnv
    from rac2d_torch.utils.tree import stack
    rng = np.random.default_rng(seed)
    n_gas = 10 ** rng.uniform(4, 8, n)
    Tg = 10 ** rng.uniform(1, 2, n)
    envs = stack([CellEnv.default(
        device, Tgas=Tg[i], Tdust=Tg[i], n_gas=n_gas[i], Av_toISM=5.0,
        Av_toStar=5.0, G0_UV_toISM=1.0, Ncol_toISM=n_gas[i] * 1e17,
        GrainRadius_CGS=1e-5, sigdust_ave=np.pi * 1e-10,
        ndust_tot=D2G * n_gas[i], ratioDust2HnucNum=D2G,
        SitesPerGrain=4 * np.pi * 1e-10 * 1e15) for i in range(n)])
    tenvs = stack([ThermalEnv.default(
        device, omega_Kepler=2e-9, velo_width_turb=3e4,
        coherent_length=1e13,
        n_dusts=np.array([D2G * n_gas[i], 0, 0, 0]),
        sig_dusts=np.array([np.pi * 1e-10, 0, 0, 0]),
        Tdusts=np.array([Tg[i], 0, 0, 0])) for i in range(n)])
    return envs, tenvs, Tg


def coupled_cells(device):
    """COUPLED_CELLS with the environment recipe of
    tests/test_parity_oracle.py (_env_pairs)."""
    from rac2d_torch.ops.rates import CellEnv
    from rac2d_torch.ops.thermal import ThermalEnv
    from rac2d_torch.utils.tree import stack
    envs, tenvs = [], []
    for p in COUPLED_CELLS:
        envs.append(CellEnv.default(
            device, Tgas=p["T"], Tdust=p["Tdust"], n_gas=p["n"],
            zeta_cosmicray_H2=1.36e-17, zeta_Xray_H2=p.get("zetaX", 0.0),
            Ncol_toISM=p["n"] * 1e17, Av_toISM=p["Av"], Av_toStar=p["Av"],
            G0_UV_toISM=1.0, G0_UV_toStar=p.get("G0star", 0.0),
            G0_UV_H2phd=p.get("G0star", 0.0) * 0.5,
            G0_UV_toStar_photoDesorb=p.get("G0star", 0.0),
            phflux_Lya=p.get("lya", 0.0), omega_albedo=0.5,
            GrainRadius_CGS=1e-5, sigdust_ave=np.pi * 1e-10,
            ndust_tot=D2G * p["n"], ratioDust2HnucNum=D2G,
            SitesPerGrain=4.0 * np.pi * 1e-10 * 1e15,
            f_selfshielding_toISM=np.array([1.0, 0.3, 0.6, 1.0, 1.0]),
            f_selfshielding_toStar=np.array([1.0, 0.2, 0.5, 1.0, 1.0])))
        tenvs.append(ThermalEnv.default(
            device, omega_Kepler=2e-9, velo_width_turb=3e4,
            coherent_length=1e13,
            n_dusts=np.array([D2G * p["n"], 0, 0, 0]),
            sig_dusts=np.array([np.pi * 1e-10, 0, 0, 0]),
            Tdusts=np.array([p["Tdust"], 0, 0, 0])))
    return stack(envs), stack(tenvs), np.array([p["T"] for p in
                                                COUPLED_CELLS])


def newton_matrices(B, n, seed, device):
    """Row/column-equilibrated f32 I - cJ (as bdf._bfac builds them) from a
    numpy seed: J ~ N(0, 1/n), c log-uniform in [1e-3, 0.5], column scales
    log-uniform over 3 decades."""
    rng = np.random.default_rng(seed)
    J = torch.as_tensor(rng.standard_normal((B, n, n)) / np.sqrt(n),
                        device=device)
    c = torch.as_tensor(10 ** rng.uniform(-3, np.log10(0.5), B),
                        device=device)
    cs = torch.as_tensor(10 ** rng.uniform(-2, 1, (B, n)), device=device)
    eye = torch.eye(n, dtype=torch.float64, device=device)
    Ac = (eye[None] - c[:, None, None] * J) * cs[:, None, :]
    amax = torch.amax(torch.abs(Ac), dim=2)
    rs = torch.where(amax > 0.0, 1.0 / amax, 1.0)
    A = (Ac * rs[:, :, None]).to(torch.float32).contiguous()
    b = torch.as_tensor(rng.standard_normal((B, n)), dtype=torch.float32,
                        device=device)
    return A, b


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() over reps runs (after one warm-up)."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def host_ms(fn, reps):
    """Mean host milliseconds to enqueue fn() (no synchronize inside the
    clock): where it nears cuda_ms, that time is the host's, not the
    device's."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return t


def element_drift(net, y0, y):
    """Max relative drift of the real elements' totals (slots 3+) per
    lane, where the initial total is > 1e-12."""
    comp = np.asarray(net.elements, dtype=float)[:, 3:]
    e0 = comp.T @ y0
    e = y @ comp
    big = e0 > 1e-12
    return (np.abs(e[:, big] - e0[big]) / e0[big]).max(axis=1)


class Fail(Exception):
    """A phase failed; the message says which and why."""


def rel_per_lane(a, b):
    """max over lanes of max |a - b| / max(max |b|, 1) within the lane."""
    dims = tuple(range(1, a.dim()))
    return float(((a - b).abs().amax(dim=dims)
                  / b.abs().amax(dim=dims).clamp_min(1.0)).max())


def k1_k2_case(A, b):
    """K1 then K2 on (A, b) against block_lu / block_lu_solve: the largest
    relative difference per lane of lu, linv, uinv and x."""
    from rac2d_torch.ops import blocklu, kernels
    fac = kernels.block_lu_factor(A)
    x = kernels.block_lu_solve(fac, b)
    torch.cuda.synchronize()
    ref = blocklu.block_lu(A)
    xr = blocklu.block_lu_solve(ref, b)
    rel = {k: rel_per_lane(getattr(fac, k), getattr(ref, k))
           for k in ("lu", "linv", "uinv")}
    rel["x"] = rel_per_lane(x, xr)
    return fac, ref, x, xr, rel


def check_shape(dev, B, n=485):
    """Phase 3 at one main-path shape: K1/K2 vs their plain versions on
    B lanes of n x n Newton matrices."""
    A, b = newton_matrices(B, n, 0, dev)
    fac, ref, x, xr, rel = k1_k2_case(A, b)
    err_fac = max(float((getattr(fac, k) - getattr(ref, k)).abs().amax())
                  for k in ("lu", "linv", "uinv"))
    for name in ("lu", "linv", "uinv"):
        say(f"phase 3 B={B} K1 {name}: max rel {rel[name]:.3e} (tol 1e-4)")
        if not rel[name] <= 1e-4:
            raise Fail(f"phase 3: K1 {name} disagrees with block_lu at "
                       f"B={B}")
    err_x = float((x - xr).abs().amax())
    res = float(((A.double() @ x.double()[..., None])[..., 0]
                 - b.double()).abs().amax())
    say(f"phase 3 B={B} K2: max abs diff {err_x:.3e}, max rel "
        f"{rel['x']:.3e} (tol 1e-4); max |A x - b| {res:.3e}")
    if not rel["x"] <= 1e-4 or not np.isfinite(res):
        raise Fail(f"phase 3: K2 disagrees with block_lu_solve at B={B}")
    return dict(A=A, b=b, fac=fac, ref=ref, err_fac=err_fac, err_x=err_x)


def check_kernels(dev, B=W, n=485):
    """Phase 3: K1/K2 vs their plain versions on the card, at phase 5's
    shape and at the edges of the shape range."""
    from rac2d_torch.ops import blocklu, kernels
    t0 = time.time()
    out = check_shape(dev, B, n)
    # the edges of the shape range: one lane, a few lanes, n from 1 to
    # a whole number of panels and just past one
    worst = {}
    for Bs in (1, 3):
        for ns in (1, 64, 65, 130, 512, 600):
            As, bs = newton_matrices(Bs, ns, ns + Bs, dev)
            r = k1_k2_case(As, bs)[-1]
            worst[(Bs, ns)] = max(r.values())
    say("phase 3 K1+K2 shapes, max rel over lu, linv, uinv, x (tol 1e-4): "
        + ", ".join(f"B={k[0]} n={k[1]} {v:.2e}" for k, v in worst.items()))
    if not max(worst.values()) <= 1e-4:
        raise Fail("phase 3: K1/K2 disagree with their plain versions")
    # pivots below the floor, with their signs
    Af, want = blocklu.floored_pivot_matrices(dev)
    bf = torch.ones(Af.shape[:2], dtype=torch.float32, device=dev)
    facf, _, _, _, rf = k1_k2_case(Af, bf)
    got = {k: float(facf.lu[k[0], k[1], k[1]]) for k in want}
    exact = all(got[k] == float(np.float32(v)) for k, v in want.items())
    say(f"phase 3 pivot floor: {len(want)} floored pivots exact with sign: "
        f"{exact}; max rel " + ", ".join(f"{k} {v:.2e}" for k, v in
                                         rf.items()) + " (tol 1e-4)")
    if not exact or not max(rf.values()) <= 1e-4:
        raise Fail("phase 3: K1 floors a pivot unlike block_lu")
    # K2 reads only what the function needs: NaN in every other entry of
    # the factor leaves its x unchanged
    poison = {}
    for Bs in (1, W):
        for ns in (65, 485, 600):
            As, bs = newton_matrices(Bs, ns, ns + Bs + 1, dev)
            fs, _, xs, xr, _ = k1_k2_case(As, bs)
            xp = kernels.block_lu_solve(blocklu.poison_unneeded(fs, ns), bs)
            torch.cuda.synchronize()
            poison[(Bs, ns)] = (bool(torch.isfinite(xp).all())
                                and torch.equal(xp, xs), rel_per_lane(xp, xr))
    say("phase 3 K2 on factors with NaN in every unneeded entry (lu's "
        "padding and diagonal blocks, the zero triangles and pads of linv "
        "and uinv): x finite and equal to x on the clean factor, max rel "
        "to block_lu_solve (tol 1e-4): " + ", ".join(
            f"B={k[0]} n={k[1]} {v[0]} {v[1]:.2e}" for k, v in poison.items()))
    if not all(ok and r <= 1e-4 for ok, r in poison.values()):
        raise Fail("phase 3: K2 reads an entry the function does not need")
    say(f"phase 3 done: B={B} n={n} and {len(worst) + 1 + len(poison)} more "
        f"cases, {time.time() - t0:.1f} s")
    return out


def k1_work(B, n, N):
    """(flop, bytes) that K1's function needs at [B, n, n], whatever the
    algorithm: the no-pivot LU of the n x n matrix (at a trailing size m,
    m multipliers and an m x m rank-1 update: m + 2 m^2 flop, ~2/3 n^3 in
    all) and, for each diagonal block of real size s, the inverses of its
    unit-lower (s(s-1)(s-2)/3 flop) and upper (s(s-1)(s+1)/3 + s)
    triangles.  Bytes: A read once, lu, linv and uinv written once."""
    bk = 64
    flop = sum(m + 2 * m * m for m in range(n))
    for kb in range(0, n, bk):
        s = min(bk, n - kb)
        flop += s * (s - 1) * (s - 2) // 3 + s * (s - 1) * (s + 1) // 3 + s
    nbytes = 4 * (n * n + N * N + 2 * N * bk)
    return B * flop, B * nbytes


def k2_work(B, n, N):
    """(flop, bytes) that K2's function needs: each entry of the n x n
    factor once (the off-diagonal blocks of lu inside n, and the unit-lower
    triangle of linv and the upper triangle of uinv at each diagonal
    block's real size: n^2 floats in all), b read and x written; one FMA
    an entry."""
    return B * 2 * n * n, B * 4 * (n * n + 2 * n)


def bound(flop, nbytes):
    """(bound_ms, bound_by): the larger of f32 FMA work over F32_FLOPS and
    bytes over HBM_BPS."""
    t_op, t_by = flop / F32_FLOPS * 1e3, nbytes / HBM_BPS * 1e3
    return (t_op, "operations") if t_op >= t_by else (t_by, "bytes")


def time_kernels(A, b, fac, ref, **_):
    """Phase 4: mean ms of K1/K2, their plain versions and their library
    yardsticks, in turns plain, kernel, library, library, kernel, plain;
    and their bounds."""
    from rac2d_torch.ops import blocklu, kernels
    t0 = time.time()
    B, n = b.shape
    N = fac.lu.shape[-1]

    def k1_lib():
        return torch.linalg.lu_factor_ex(A, pivot=False)

    piv = torch.arange(1, N + 1, dtype=torch.int32,
                       device=A.device).expand(B, N).contiguous()
    bp = torch.zeros(B, N, 1, dtype=torch.float32, device=A.device)
    bp[:, :n, 0] = b

    def k2_lib():
        return torch.linalg.lu_solve(fac.lu, piv, bp)

    lib = {}
    for name, fn in (("K1", k1_lib), ("K2", k2_lib)):
        try:
            out = fn()
            torch.cuda.synchronize()
            lib[name] = None
        except Exception as e:          # a refusal is recorded, not fatal
            lib[name] = f"{type(e).__name__}: {e}".splitlines()[0]
            say(f"phase 4 {name} library call refused: {lib[name]}")
            continue
        if name == "K1":
            d = rel_per_lane(out[0], fac.lu[:, :n, :n])
            say(f"phase 4 K1 library: lu_factor_ex(pivot=False) LU within "
                f"{d:.2e} of K1's lu per lane, info max "
                f"{int(out[2].max())}")
        else:
            d = rel_per_lane(out[:, :n, 0],
                             kernels.block_lu_solve(fac, b))
            say(f"phase 4 K2 library: lu_solve within {d:.2e} of K2")

    def turns(plain, kern, libfn, reps_p, reps_k):
        t = {"plain": [cuda_ms(plain, reps_p)], "kernel": [],
             "library": []}
        t["kernel"].append(cuda_ms(kern, reps_k))
        if libfn is not None:
            t["library"] += [cuda_ms(libfn, reps_k), cuda_ms(libfn, reps_k)]
        t["kernel"].append(cuda_ms(kern, reps_k))
        t["plain"].append(cuda_ms(plain, reps_p))
        t["host"] = host_ms(kern, reps_k)
        return t

    t1 = turns(lambda: blocklu.block_lu(A),
               lambda: kernels.block_lu_factor(A),
               k1_lib if lib["K1"] is None else None, 3, 10)
    t2 = turns(lambda: blocklu.block_lu_solve(ref, b),
               lambda: kernels.block_lu_solve(fac, b),
               k2_lib if lib["K2"] is None else None, 10, 50)
    out = {}
    for name, t, work in (("K1", t1, k1_work(B, n, N)),
                          ("K2", t2, k2_work(B, n, N))):
        b_ms, b_by = bound(*work)
        ms = float(np.mean(t["kernel"]))
        lib_ms = float(np.mean(t["library"])) if t["library"] else None
        fmt = "/".join(f"{v:.4f}" for v in t["kernel"])
        lfmt = ("/".join(f"{v:.4f}" for v in t["library"]) + " ms"
                if t["library"] else f"— ({lib[name]})")
        say(f"phase 4 {name} B={B} n={n} N={N}: kernel {fmt} ms (host "
            f"enqueue {t['host']:.4f} ms a call), plain "
            + "/".join(f"{v:.3f}" for v in t["plain"]) + f" ms, library "
            f"{lfmt}; bound {b_ms:.4f} ms by {b_by} ({work[0]:.4e} flop, "
            f"{work[1]:.4e} B), kernel at {b_ms / ms:.1%} of it")
        out[name] = dict(ms=ms, plain_ms=float(np.mean(t["plain"])),
                         library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
    say(f"phase 4 done: {time.time() - t0:.1f} s")
    return out


def run_slice(dev, n_bench=512, width=W, t_max=T_MAX):
    """Phases 5 and 6: the pool sweep through the kernels, its checks, and
    8 of its lanes re-solved with the plain LU."""
    from rac2d_torch import defaults
    from rac2d_torch.io import umist
    from rac2d_torch.ops import bdf, kernels, odesys
    from rac2d_torch.ops.thermal import ThermalBalance
    from rac2d_torch.utils.tree import tree_map

    t0 = time.time()
    net = umist.load_network(defaults.NETWORK,
                             enthalpy_path=defaults.ENTHALPIES)
    y0 = umist.load_initial_abundances(net, defaults.INIT_ABUNDANCES)
    ode = odesys.ChemicalODE(net, thermal=ThermalBalance(net, device=dev),
                             device=dev)
    e1, t1, T1 = bench_cells(n_bench, 0, dev)
    e2, t2, T2 = coupled_cells(dev)
    envs = tree_map(lambda a, b_: torch.cat([a, b_]), e1, e2)
    tenvs = tree_map(lambda a, b_: torch.cat([a, b_]), t1, t2)
    T0 = np.concatenate([T1, T2])
    N = len(T0)
    y0b = torch.as_tensor(np.tile(y0, (N, 1)), device=dev)
    T0t = torch.as_tensor(T0, device=dev)
    rtol, atol = odesys.tolerance_ladder(net, 1, RTOL0, ATOL0, D2G, dev)
    touts = bdf.log_output_times(1e-8, t_max, 1.5)
    kw = dict(first_step=1e-8, evolT=True, max_steps_per_interval=500,
              retry_tols=ode.retry_ladder(3, RTOL0, ATOL0, D2G))
    say(f"phase 5 setup: {N} cells, NEQ {ode.neq}, width {width}, "
        f"{len(touts)} record times to {t_max:g} yr, "
        f"{time.time() - t0:.1f} s")
    t0 = time.time()
    calls = [0]

    def progress(k, st):
        calls[0] += 1

    kernels.reset_launches()
    out = ode.solve_pool(envs, y0b, T0t, touts, rtol, atol, width=width,
                         tenvs=tenvs, progress_cb=progress, **kw)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = (kernels.block_lu_factor.launches,
                kernels.block_lu_solve.launches)
    fail = out.fail.numpy()
    steps = int(out.n_steps.sum())
    levels = np.bincount(out.retry_level.numpy(), minlength=4).tolist()
    say(f"phase 5 slice: {N} lanes, {int(fail.sum())} failed, ladder levels "
        f"{levels}, {steps} steps (max {int(out.n_steps.max())} per lane), "
        f"{int(out.n_lu.sum())} lane-LUs, {int(out.n_jeval.sum())} "
        f"lane-Jacobians, {calls[0]} advance calls, wall {wall:.1f} s, "
        f"{steps / wall:.1f} lane-steps/s")
    rounds = out.n_rounds
    say(f"phase 5 launches: K1 {launches[0]}, K2 {launches[1]} over "
        f"{rounds} BDF rounds ({launches[0] / max(rounds, 1):.3f} and "
        f"{launches[1] / max(rounds, 1):.3f} a round)")
    if min(launches) <= 0:
        raise Fail("phase 5: the slice did not go through both kernels")
    yf = out.ys[:, -1].numpy()
    t_fin = out.t_final.numpy()
    nS = net.n_species
    ok = ~fail
    if not np.isfinite(yf).all():
        raise Fail("phase 5: non-finite final states")
    Tg = yf[ok, nS]
    drift = element_drift(net, y0, yf[ok, :nS])
    say(f"phase 5 checks: Tgas in [{Tg.min():.3g}, {Tg.max():.3g}] K, "
        f"max element drift {drift.max():.2e}, min abundance "
        f"{yf[ok, :nS].min():.2e}, t_final min {t_fin[ok].min():.4g} yr")
    if not ((Tg > 2.0) & (Tg < 3e4)).all() or not (drift < 0.01).all() \
            or not (t_fin[ok] >= t_max * (1 - 1e-12)).all():
        raise Fail("phase 5: unphysical final states")
    if fail.sum() > 0.05 * N:
        raise Fail("phase 5: more than 5% of the lanes failed")

    # phase 6: 8 of those lanes re-solved with the plain LU, held against
    # phase 5's final states (the pool keeps no earlier record)
    t0 = time.time()
    pick = np.concatenate([np.arange(N - 3, N),
                           np.nonzero(ok[:N - 3])[0][:5]])
    sel = torch.as_tensor(pick, device=dev)
    res = ode.solve_pool(
        tree_map(lambda a: a[sel], envs), y0b[sel], T0t[sel], touts, rtol,
        atol, width=len(pick), tenvs=tree_map(lambda a: a[sel], tenvs),
        lu_backend="block", **kw)
    yb = res.ys[:, -1].numpy()
    ki = net.key_species_idx
    worst = 0.0
    for j, i in enumerate(pick):
        if fail[i] or bool(res.fail[j]):
            raise Fail(f"phase 6: lane {i} failed (kernel {fail[i]}, "
                       f"plain {bool(res.fail[j])})")
        big = np.abs(yb[j, ki]) > 1e-12
        rel = np.abs(yf[i, ki] - yb[j, ki])[big] / np.abs(yb[j, ki])[big]
        worst = max(worst, float(rel.max()))
    say(f"phase 6 plain LU re-solve of {len(pick)} lanes to {t_max:g} yr "
        f"against phase 5's final states: worst key-species rel diff "
        f"{worst:.3e} (tol 5e-2), {time.time() - t0:.1f} s")
    if not worst < 0.05:
        raise Fail("phase 6: the slice and the plain LU re-solve disagree")
    return launches, rounds


# --------------------------------------------------------------------
# the Monte Carlo dust pass (phases 7-10)

MC_NPH = 1_000_000        # packets per pass (bench.py: 4e6 in production)
MC_NPH_CHECK = 65_536     # phase 10: one batch, no refill
MC_STEP_CAP = 100_000     # a pass's step cap (DiskModel.mc_pass max_steps)
# phase 10's step cap: the plain walk costs about 0.5 s per 64-step chunk
# at any width; both walks stop at the same step
MC_STEPS_CHECK = 8192


def bench_disk(dev, **chem):
    """The production-shaped disk of bench.py:76-104 (build_bench_model)
    on the card; chem: DiskConfig chemistry and iteration fields."""
    from rac2d_torch import defaults
    from rac2d_torch.models import density, driver
    from rac2d_torch.models.grid import GridConfig
    from rac2d_torch.ops import optics
    cfg = driver.DiskConfig(
        star_mass=0.6, star_radius=1.0, star_T=4000.0, lumi_Xray=1e30,
        andrews=density.AndrewsDisk(Md=0.01, rin=1.0, rout=100.0, rc=50.0,
                                    hc=10.0),
        grid=GridConfig(rmin=1.0, rmax=100.0, zmax=100.0, ncol=200,
                        max_num_of_cells=10_000),
        dust=[driver.DustComponent(opti_files=[defaults.SILICATE_OPTI],
                                   weights=[1.0], d2g_mass=0.01)],
        network_file=defaults.NETWORK, enthalpy_file=defaults.ENTHALPIES,
        init_abundances_file=defaults.INIT_ABUNDANCES,
        h2o_cross_file=defaults.H2O_PHOTOXS,
        mc=optics.McConfig(nph=MC_NPH, nlen_lut=256, n_quantile=128),
        nph_per_pass=MC_NPH, n_mc_passes=2, **chem)
    m = driver.DiskModel(cfg, dev)
    m.prepare()
    return m


def walk_kw(m):
    mc = m.mc_cfg
    return dict(nmax_encounter=mc.nmax_encounter, use_mrw=mc.use_mrw,
                mrw_gamma=mc.mrw_gamma, mrw_lam_min=mc.mrw_lam_min,
                save_dir=mc.save_dir_flux,
                save_counts=mc.save_counts or mc.do_fill_blank)


def event_ms(fn, reps):
    """Mean CUDA-event milliseconds of fn(), each rep on fresh inputs
    (fn builds them before it starts the clock through `start`)."""
    out = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        fn(e0)
        e1.record()
        torch.cuda.synchronize()
        out.append(e0.elapsed_time(e1))
    return float(np.mean(out))


def queued_ms(calls):
    """(mean device ms, mean host ms to enqueue) of the calls, queued
    behind a spin kernel so that the device runs them back to back while
    the host is still enqueueing: the event time is the device's alone,
    without the wrappers' host time (argument checks, the ctypes call)."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)      # about 0.1 s of the SM clock
    e0.record()
    t0 = time.perf_counter()
    for fn in calls:
        fn()
    host = (time.perf_counter() - t0) * 1e3 / len(calls)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / len(calls), host


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def touched_bytes(tl, fields):
    """Bytes of the tally bins a run made non-zero, read and written once."""
    return sum(2 * int((getattr(tl, f) != 0).sum())
               * getattr(tl, f).element_size() for f in fields)


def check_walk(m, dev):
    """Phase 7: K3 against _walk_plain on one 64-step chunk."""
    from rac2d_torch.ops import kernels, mcrt
    t0 = time.time()
    # a warm Tdust(r) so that re-emission and MRW run: 150 K (r/AU)^-1/2
    tdust = np.clip(150.0 * m.r_cells ** -0.5, 10.0, 1500.0)[None, :]
    cells = m.mc_cells()._replace(Tdust=torch.as_tensor(tdust, device=dev))
    model = mcrt.McModel(m.tab, m.gi, cells, m.cfg.star_mass)
    ws = mcrt.WalkSetup(model, m.mc_cfg.n_quantile)
    lam, en, _ = m.packet_pool(MC_NPH)
    pick = np.linspace(0, len(lam) - 1, MC_BATCH).astype(np.int64)
    gen = torch.Generator(device=dev).manual_seed(7)
    pk0 = mcrt.launch_packets(model, gen, torch.as_tensor(lam[pick],
                                                          device=dev),
                              torch.as_tensor(en[pick], device=dev), 0.0,
                              m.cfg.maxw)
    nlam = len(m.tab.lam)

    def zeros():
        return mcrt.McTallies.zeros(m.grid.n_cells, nlam, m.n_dust, 5,
                                    device=dev)

    kw = walk_kw(m)
    pk_k, pk_p, tk, tp = pk0.clone(), pk0.clone(), zeros(), zeros()
    na_k = int(kernels.mc_walk(ws, pk_k, tk, MC_STEPS, **kw))
    na_p = int(mcrt._walk_plain(ws, pk_p, tp, MC_STEPS, **kw))
    torch.cuda.synchronize()
    agree = (pk_k.status == pk_p.status) & (pk_k.cell == pk_p.cell) \
        & (pk_k.e_count == pk_p.e_count)
    share = float(agree.float().mean())
    live = agree & (pk_k.status == mcrt.ST_ACTIVE)
    rng_eq = all(torch.equal(getattr(pk_k, f)[live], getattr(pk_p, f)[live])
                 for f in ("rs0", "rs1", "rs2", "rs3"))
    diffs = {}
    for f in ("x", "y", "z", "lam", "tau"):
        a, b = getattr(pk_k, f)[agree], getattr(pk_p, f)[agree]
        diffs[f] = float(((a - b).abs() / b.abs().clamp_min(1e-3)).max())
    tot = {f: (float(getattr(tk, f).double().sum()),
               float(getattr(tp, f).double().sum()))
           for f in ("flux", "mrw_path")}
    fields = ["flux", "mrw_path"]
    fields += ["phc", "en_gain_abso", "cr_count"] if kw["save_counts"] else []
    fields += ["dir_flux"] if kw["save_dir"] else []
    # K3's bound for this chunk: the packet state read and written once,
    # the tables read once, the tally bins it touched read and written
    pk_bytes = 2 * nbytes(*(getattr(pk0, f) for f in kernels._PK_F32
                            + kernels._PK_I32))
    tab_bytes = nbytes(ws.cellmat, ws.tabmat, ws.lya_pair, ws.reemit_lam,
                       ws.mrw_lnx, ws.gi.r_lut_pack, ws.gi.zc_pack)
    tal_bytes = touched_bytes(tk, fields)
    bound_ms = (pk_bytes + tab_bytes + tal_bytes) / HBM_BPS * 1e3
    rel = {f: abs(a - b) / max(abs(b), 1e-30) for f, (a, b) in tot.items()}
    fates = mcrt.packet_fates(pk_k.status)
    say(f"phase 7 K3 walk: B={MC_BATCH}, {MC_STEPS} steps, {m.grid.n_cells} "
        f"cells ({int(m.grid.using.sum())} active), nlam {nlam}; active "
        f"after: kernel {na_k}, plain {na_p}; kernel fates {fates}")
    say(f"phase 7 agreement: status+cell+e_count on {share:.6f} of lanes "
        f"(tol 0.99); RNG words equal on {int(live.sum())} live agreeing "
        f"lanes: {rng_eq}; max rel diff on agreeing lanes (|ref| floored "
        f"at 1e-3) " + ", ".join(f"{k} {v:.2e}" for k, v in diffs.items()))
    say(f"phase 7 tallies: flux total kernel {tot['flux'][0]:.6e} plain "
        f"{tot['flux'][1]:.6e} (rel {rel['flux']:.2e}), mrw_path "
        f"{tot['mrw_path'][0]:.6e} / {tot['mrw_path'][1]:.6e} (rel "
        f"{rel['mrw_path']:.2e}), tol 1e-3")
    # every bin of every tally channel the walk writes, on the agreeing
    # lanes (a lane's tallies never feed back into its walk, so the
    # agreeing lanes re-walked alone add what they added before)
    if not bool(agree.all()):
        sub = pk0.take(agree)
        pk_k, pk_p, tk, tp = sub.clone(), sub.clone(), zeros(), zeros()
        kernels.mc_walk(ws, pk_k, tk, MC_STEPS, **kw)
        mcrt._walk_plain(ws, pk_p, tp, MC_STEPS, **kw)
    bins = {}
    for f in fields:
        a, b = getattr(tk, f), getattr(tp, f)
        d = float((a - b).abs().max())
        bins[f] = (d, d / max(float(b.abs().max()), 1e-30))
    err = max(d for d, _ in bins.values())
    say(f"phase 7 per-bin tallies on {int(agree.sum())} agreeing lanes: max "
        f"|kernel - plain| / max |plain|: " + ", ".join(
            f"{f} {r:.2e} (abs {d:.2e})" for f, (d, r) in bins.items())
        + " (tol 1e-4)")

    def run(walk):
        def fn(e0):
            pk, tl = pk0.clone(), zeros()
            torch.cuda.synchronize()
            e0.record()
            walk(ws, pk, tl, MC_STEPS, **kw)
        return fn

    # the pass's way: a launch object built once for the tallies, called
    # on a new Packets object each time (its checks run, as after a
    # refill or a compaction)
    tl_q = zeros()
    launch = kernels.WalkLaunch(ws, tl_q, **kw)

    def launched(e0):
        pk = pk0.clone()
        torch.cuda.synchronize()
        e0.record()
        launch(pk, tl_q, MC_STEPS)

    def kernel_chunks(reps, one_call=False):
        jobs = [pk0.clone() for _ in range(reps)]
        if one_call:
            return queued_ms([
                lambda pk=pk: kernels.mc_walk(ws, pk, tl_q, MC_STEPS, **kw)
                for pk in jobs])
        return queued_ms([lambda pk=pk: launch(pk, tl_q, MC_STEPS)
                          for pk in jobs])

    # two times of the kernel: an event pair around one call (the method
    # of every earlier run, host time of the launch included) and the
    # device's alone, with calls queued behind a spin kernel; the host's
    # time to enqueue a call through the launch object and through the
    # one-call function kernels.mc_walk (which builds one per call)
    p_a = event_ms(run(mcrt._walk_plain), 2)
    k_a = event_ms(launched, 5)
    (q_a, h_a), (q_b, h_b) = kernel_chunks(5), kernel_chunks(5)
    _, h_one = kernel_chunks(5, one_call=True)
    k_b = event_ms(launched, 5)
    p_b = event_ms(run(mcrt._walk_plain), 2)
    say(f"phase 7 times, one {MC_STEPS}-step chunk at B={MC_BATCH}: kernel "
        f"{k_a:.4f}/{k_b:.4f} ms (events around one call), "
        f"{q_a:.4f}/{q_b:.4f} ms on the device (queued; host enqueue "
        f"{h_a:.4f}/{h_b:.4f} ms a call through the launch object, "
        f"{h_one:.4f} ms through kernels.mc_walk), plain "
        f"{p_a:.1f}/{p_b:.1f} ms; "
        f"bound {bound_ms:.4f} ms by bytes (packets {pk_bytes}, tables "
        f"{tab_bytes}, touched tally bins {tal_bytes} B), kernel at "
        f"{bound_ms / ((k_a + k_b) / 2):.2%} of it by the one-call time, "
        f"{bound_ms / ((q_a + q_b) / 2):.2%} by the device time; library "
        f"call: none")
    # K3's launch: registers, shared memory, the persistent grid
    launch.prepare(pk0.clone(), MC_STEPS)
    plan = launch.plan()
    say(f"phase 7 K3 launch: {plan['regs']} registers and "
        f"{plan['local_bytes']} B of local memory a thread, "
        f"{plan['threads']} threads a CTA, {plan['blocks_per_sm']} CTAs per "
        f"SM, grid {plan['grid']} on {plan['sms']} SMs; {plan['smem']} B of "
        f"shared memory a CTA, tables staged in it: none (all {tab_bytes} B "
        f"through __ldg: staging the locate and optics tables measured no "
        f"faster, PERF.md)")
    # the hand-built lanes that the JAX walk never ends (ROADMAP.md §3),
    # 8 steps through K3 and through the plain walk
    edge, kinds = mcrt.edge_lanes(ws)
    c0 = edge.cell.clone()
    ends = {}
    for name, walk in (("kernel", kernels.mc_walk),
                       ("plain", mcrt._walk_plain)):
        pk, tl = edge.clone(), zeros()
        gone = torch.zeros_like(c0, dtype=torch.bool)
        for _ in range(8):
            walk(ws, pk, tl, 1, **kw)
            gone |= (pk.cell != c0) | (pk.status != mcrt.ST_ACTIVE)
        ends[name] = (pk, gone)
    (pe, ge), (pp, gp) = ends["kernel"], ends["plain"]
    edge_same = all(torch.equal(getattr(pe, f), getattr(pp, f))
                    for f in ("status", "cell", "e_count"))
    edge_ok = bool(ge.all()) and bool(gp.all()) and edge_same
    say(f"phase 7 edge lanes ({kinds.count('grazing')} grazing on a bottom "
        f"face, {kinds.count('corner')} aimed at a corner): left their cell "
        f"or ended within 8 steps: kernel {int(ge.sum())}, plain "
        f"{int(gp.sum())} of {len(kinds)}; status, cell and e_count equal: "
        f"{edge_same}; kernel status {pe.status.tolist()}")
    say(f"phase 7 done: {time.time() - t0:.1f} s")
    if not (share >= 0.99 and rng_eq and rel["flux"] <= 1e-3
            and rel["mrw_path"] <= 1e-3
            and all(r <= 1e-4 for _, r in bins.values())):
        raise Fail("phase 7: K3 disagrees with its plain version")
    if not edge_ok:
        raise Fail("phase 7: an edge lane neither left its cell nor ended")
    return dict(model=model, pk=pk_k, zeros=zeros, err=err,
                ms=(k_a + k_b) / 2, device_ms=(q_a + q_b) / 2,
                host_ms=(h_a + h_b) / 2, plain_ms=(p_a + p_b) / 2,
                bound_ms=bound_ms)


MC_TIER = 4096            # phase 8: a compaction tier of the pass


def fold_tier(pk):
    """MC_TIER of phase 7's lanes as a compaction tier holds them: the
    last quarter ST_PADDING."""
    from rac2d_torch.ops import mcrt
    sub = pk.take(slice(0, MC_TIER)).clone()
    sub.status[3 * MC_TIER // 4:] = mcrt.ST_PADDING
    return sub


def fold_bytes(pk, tl):
    """K4's bytes on two bases: (what the fold needs: the status of every
    lane, the eight fields of escaped lanes, cell and en of water-destroyed
    ones, the fate counter and the bins it touched, read and written
    once; the earlier basis, kept for its series: the ten lane fields of
    every lane and the touched bins)."""
    from rac2d_torch.ops import kernels, mcrt
    B = pk.x.shape[0]
    n_esc = int((pk.status == mcrt.ST_ESCAPED).sum())
    n_wat = int((pk.status == mcrt.ST_DESTR_WATER).sum())
    bins = touched_bytes(tl, ("collector", "collector_img", "ab_en_water"))
    need = 4 * B + 32 * n_esc + 8 * n_wat + 2 * 8 * mcrt.N_CODES + bins
    return need, nbytes(*(getattr(pk, f) for f in kernels._FOLD_PK)) + bins


def check_fold(model, pk, zeros, **_):
    """Phase 8: K4 against _fold_terminal_plain on phase 7's lanes and on
    a compaction tier of them; its fate counts; its times and bounds."""
    from rac2d_torch.ops import kernels, mcrt
    t0 = time.time()
    dev = pk.x.device
    out, err = {}, 0.0
    for name, lanes in (("full", pk), ("tier", fold_tier(pk))):
        tk, tp = zeros(), zeros()
        fk = torch.zeros(mcrt.N_CODES, dtype=torch.int64, device=dev)
        fp = torch.zeros_like(fk)
        kernels.fold_terminal(model, lanes, tk, 5, fk)
        mcrt._fold_terminal_plain(model, lanes, tp, 5, fp)
        torch.cuda.synchronize()
        rels = {}
        for f in ("collector", "collector_img", "ab_en_water"):
            d = (getattr(tk, f) - getattr(tp, f)).abs().max()
            err = max(err, float(d))
            rels[f] = float(d / getattr(tp, f).abs().max().clamp_min(1e-30))
        want = mcrt.packet_fates(lanes.status)
        got = mcrt.fates_of_counts(fk.tolist())
        exact = got == want and torch.equal(fk, fp)
        n_esc = int((lanes.status == mcrt.ST_ESCAPED).sum())
        n_wat = int((lanes.status == mcrt.ST_DESTR_WATER).sum())
        n_pad = int((lanes.status == mcrt.ST_PADDING).sum())
        say(f"phase 8 K4 fold ({name}): {lanes.x.shape[0]} lanes, {n_esc} "
            f"escaped, {n_wat} water-destroyed, {n_pad} padding; max |diff| "
            f"/ max |plain|: " + ", ".join(
                f"{k} {v:.2e}" for k, v in rels.items()) + " (tol 1e-5); "
            f"fate counts {fk.tolist()} equal to packet_fates {want} and the "
            f"plain fold's: {exact}")
        if not max(rels.values()) <= 1e-5:
            raise Fail(f"phase 8: K4 disagrees with its plain version "
                       f"({name})")
        if not exact:
            raise Fail(f"phase 8: K4's fate counts are wrong ({name})")
        out[name] = (lanes, tk)

    def timings(lanes):
        """One-call, device and host times of K4 through a launch object
        built once (a new Packets object each call), and of the plain
        fold."""
        tl = zeros()
        fates = torch.zeros(mcrt.N_CODES, dtype=torch.int64, device=dev)
        launch = kernels.FoldLaunch(model, tl, 5)

        def one(e0):
            job = lanes._replace(x=lanes.x)
            torch.cuda.synchronize()
            e0.record()
            launch(job, tl, fates)

        def plain(e0):
            t = zeros()
            torch.cuda.synchronize()
            e0.record()
            mcrt._fold_terminal_plain(model, lanes, t, 5)

        def queued(reps):
            jobs = [lanes._replace(x=lanes.x) for _ in range(reps)]
            return queued_ms([lambda j=j: launch(j, tl, fates)
                              for j in jobs])

        p_a = event_ms(plain, 5)
        k_a = event_ms(one, 20)
        (q_a, h_a), (q_b, h_b) = queued(20), queued(20)
        k_b = event_ms(one, 20)
        p_b = event_ms(plain, 5)
        _, h_one = queued_ms([lambda: kernels.fold_terminal(
            model, lanes._replace(x=lanes.x), tl, 5, fates)] * 20)
        launch.prepare(lanes, fates)
        return dict(ms=(k_a + k_b) / 2, k=(k_a, k_b), q=(q_a, q_b),
                    device_ms=(q_a + q_b) / 2, host_ms=(h_a + h_b) / 2,
                    h=(h_a, h_b), h_one=h_one, plain=(p_a, p_b),
                    plain_ms=(p_a + p_b) / 2, plan=launch.plan())

    res = {}
    for name, (lanes, tk) in out.items():
        t = timings(lanes)
        need, old = fold_bytes(lanes, tk)
        b_ms, b_old = need / HBM_BPS * 1e3, old / HBM_BPS * 1e3
        say(f"phase 8 times ({name}, B={lanes.x.shape[0]}): kernel "
            f"{t['k'][0]:.4f}/{t['k'][1]:.4f} ms (events around one call), "
            f"{t['q'][0]:.4f}/{t['q'][1]:.4f} ms on the device (queued; host "
            f"enqueue {t['h'][0]:.4f}/{t['h'][1]:.4f} ms a call through the "
            f"launch object, {t['h_one']:.4f} ms through "
            f"kernels.fold_terminal), plain {t['plain'][0]:.3f}/"
            f"{t['plain'][1]:.3f} ms; bound by bytes {b_ms:.5f} ms ({need} B "
            f"the fold needs; kernel at {b_ms / t['ms']:.2%} of it by the "
            f"one-call time, {b_ms / t['device_ms']:.2%} by the device time)"
            f", {b_old:.5f} ms ({old} B, all ten lane fields, the earlier "
            f"basis; {b_old / t['ms']:.2%} and {b_old / t['device_ms']:.2%}); "
            f"library call: none")
        say(f"phase 8 K4 launch ({name}): {t['plan']}")
        res[name] = dict(t, bound_ms=b_ms, bound_all_fields_ms=b_old)
    say(f"phase 8 done: {time.time() - t0:.1f} s")
    full = res["full"]
    return dict(err=err, ms=full["ms"], device_ms=full["device_ms"],
                host_ms=full["host_ms"], plain_ms=full["plain_ms"],
                bound_ms=full["bound_ms"],
                bound_all_fields_ms=full["bound_all_fields_ms"])


def run_mc_slice(m):
    """Phase 9: two Lucy passes through DiskModel.run_mc."""
    from rac2d_torch.ops import kernels, mcrt
    t0 = time.time()
    kernels.reset_launches()
    m.run_mc(n_passes=2, nph=MC_NPH)
    torch.cuda.synchronize()
    launches = (kernels.mc_walk.launches, kernels.fold_terminal.launches)
    wall = time.time() - t0
    for ip, st in enumerate(m.mc_stats):
        f = st["fates"]
        say(f"phase 9 pass {ip + 1}: {st['packets']} packets in "
            f"{st['wall_s']:.2f} s = {st['packets'] / st['wall_s']:.0f} "
            f"packets/s; {st['chunks']} walk chunks ({st['steps']} steps), "
            f"{st['refills']} refills, {st['compactions']} compactions; K3 "
            f"{st['k3_launches']}, K4 {st['k4_launches']} launches; tail of "
            f"<= {mcrt.TAIL_LANES} live lanes {st['tail_chunks']} chunks in "
            f"{st['tail_s']:.3f} s, {st['tail_s'] / st['wall_s']:.1%} of the "
            f"pass; fates {f}; Tdust over active cells "
            f"{st['tdust_active'][0]:.2f}..{st['tdust_active'][1]:.2f} K")
        say(f"phase 9 pass {ip + 1} host: K3's launch object "
            f"{st['k3_host_s'] * 1e3:.3f} ms over {st['k3_launches']} calls, "
            f"K4's {st['k4_host_s'] * 1e3:.3f} ms over {st['k4_launches']} "
            f"calls, together {(st['k3_host_s'] + st['k4_host_s']) * 1e3:.3f}"
            f" ms; reads back to the host by the pass loop: "
            f"{st['host_reads']} (a live count a chunk, the fate counts "
            f"once)")
        if sum(f.values()) != st["packets"]:
            raise Fail(f"phase 9: pass {ip + 1} did not count every packet")
        # a packet still walking at the pass's step cap (100000) stays
        # "active", as in the JAX package: none may be left
        if f["active"] or st["steps"] >= MC_STEP_CAP:
            pk, c = st.get("live_lanes"), st["cells"]
            for k in range(0 if pk is None else pk.x.shape[0]):
                ci = int(pk.cell[k])
                say(f"phase 9 pass {ip + 1} live lane {k}: x y z "
                    f"{float(pk.x[k])!r} {float(pk.y[k])!r} "
                    f"{float(pk.z[k])!r}, v {float(pk.vx[k])!r} "
                    f"{float(pk.vy[k])!r} {float(pk.vz[k])!r}, lam "
                    f"{float(pk.lam[k]):.6g}, tau {float(pk.tau[k]):.6g}, "
                    f"e_count {int(pk.e_count[k])}, cell {ci}: r "
                    f"[{float(c.rmin[ci])!r}, {float(c.rmax[ci])!r}], z "
                    f"[{float(c.zmin[ci])!r}, {float(c.zmax[ci])!r}]")
            raise Fail(f"phase 9: pass {ip + 1} walked to the step cap with "
                       f"{f['active']} lanes still active")
        if f["premature"] + f["active"] > 1e-3 * st["packets"]:
            raise Fail(f"phase 9: pass {ip + 1}: too many premature packets")
    say(f"phase 9 launches: K3 {launches[0]}, K4 {launches[1]}; "
        f"{wall:.1f} s")
    use = m.grid.using
    T = m.Tdust[use]
    cfg = m.mc_cfg
    flux = m.tallies.flux
    if not (np.isfinite(T).all() and T.min() >= cfg.TdustMin
            and T.max() <= cfg.TdustMax):
        raise Fail("phase 9: Tdust outside [TdustMin, TdustMax]")
    if not (bool(torch.isfinite(flux).all()) and float(flux.min()) >= 0.0):
        raise Fail("phase 9: flux not finite or negative")
    if min(launches) <= 0:
        raise Fail("phase 9: the pass did not go through both kernels")
    return launches


def recheck_plain(m):
    """Phase 10: the second pass again, kernels against the plain walk
    and fold, at MC_NPH_CHECK packets and MC_STEPS_CHECK steps."""
    t0 = time.time()
    cells = m.mc_stats[1]["cells"]
    out = {}
    for walk in ("kernel", "plain"):
        tall, fates, st = m.mc_pass(1, MC_NPH_CHECK, cells, walk=walk,
                                    max_steps=MC_STEPS_CHECK)
        out[walk] = (m.reduce(tall, cells), tall, st)
        say(f"phase 10 {walk}: {st['packets']} packets in "
            f"{st['wall_s']:.2f} s, {st['steps']} steps in {st['chunks']} "
            f"chunks, "
            f"{st['refills']} refills, fates {fates}")
        if st["refills"]:
            raise Fail("phase 10: the check pass refilled")
    use = torch.as_tensor(m.grid.using, device=cells.rmin.device)
    Tk = out["kernel"][0].Tdust[use]
    Tp = out["plain"][0].Tdust[use]
    rel = ((Tk - Tp).abs() / Tp).cpu().numpy()
    ek = float(out["kernel"][1].en_gain[:, use].sum())
    ep = float(out["plain"][1].en_gain[:, use].sum())
    de = abs(ek - ep) / ep
    # cells outside the disk hold no dust: their en_gain is 0, not the NaN
    # of the JAX package's f32 blanketing factor at d2h = 0
    n_bad = [int((~torch.isfinite(out[w][1].en_gain)).any(0).sum())
             for w in ("kernel", "plain")]
    say(f"phase 10 non-finite en_gain: kernel {n_bad[0]}, plain {n_bad[1]} "
        f"cells (tol 0); {int((~use).sum())} cells inactive")
    if max(n_bad):
        raise Fail("phase 10: en_gain is not finite in every cell")
    say(f"phase 10 |dTdust|/Tdust over {int(use.sum())} active cells: "
        f"median {np.median(rel):.4f}, p90 {np.percentile(rel, 90):.4f} "
        f"(tol median 0.03); absorbed energy kernel {ek:.6e} plain "
        f"{ep:.6e} erg/s, rel {de:.4f} (tol 0.02); {time.time() - t0:.1f} s")
    if not (np.median(rel) < 0.03 and de < 0.02):
        raise Fail("phase 10: kernel and plain passes disagree")


# --------------------------------------------------------------------
# the main path: DiskModel.run on the bench disk (phase 11)

RUN_T_MAX = 1e-4          # yr; production 1e6
RUN_CHUNK = 1024          # the pool window (chem_chunk); production 256
RUN_BUDGET_S = 360.0      # the sweep's wall budget: chunk_wall_s x chunks
#                           x nlocal_iter (DiskModel._pool_sweep)
RUN_MAX_S = 300.0         # what phase 11 aims to take


def rel_diff(a, b):
    """(max |a - b| / max(|a|, |b|) over the entries where that scale is
    a normal float64, count of entries below it, where both are 0 or
    subnormal and their difference is held to the smallest normal)."""
    a, b = a.double().cpu(), b.double().cpu()
    scale = torch.maximum(a.abs(), b.abs())
    tiny = torch.finfo(torch.float64).tiny
    d = (a - b).abs()
    big = scale >= tiny
    rel = float((d[big] / scale[big]).max()) if bool(big.any()) else 0.0
    if bool((d[~big] > tiny).any()):
        rel = float("inf")
    return rel, int((~big).sum())


def shielding_card_vs_cpu(m):
    """prepare_sweep_fields on the card and on a CPU copy of the model
    (path matrices and Visser table on the CPU, the same X, Tgas and
    fields): the largest relative difference of each column, shielding
    factor and Av_toISM."""
    import copy
    from rac2d_torch.io import tables
    from rac2d_torch.ops import columns
    m.prepare_sweep_fields()
    h = copy.copy(m)
    h.device = torch.device("cpu")
    h.W_star, h.W_ism = (columns.PathMatrix(W.rows.cpu(), W.cols.cpu(),
                                            W.w.cpu(), W.n_cells)
                         for W in (m.W_star, m.W_ism))
    h._visser = tables.VisserCOShielding("cpu")
    h.prepare_sweep_fields()
    pairs = {"Av_toISM": (m._Av_ism, h._Av_ism)}
    for f in ("toISM", "toStar", "Ncol_toISM", "Ncol_toStar"):
        pairs[f] = (getattr(m._shield, f), getattr(h._shield, f))
    for d in ("colden_toISM", "colden_toStar"):
        for k in getattr(m._shield, d):
            pairs[f"{d}[{k}]"] = (getattr(m._shield, d)[k],
                                  getattr(h._shield, d)[k])
    if m._zetaX_ncol is not None:
        pairs["zetaX_ncol"] = (m._zetaX_ncol, h._zetaX_ncol)
    return {k: rel_diff(a, b) for k, (a, b) in pairs.items()}


def run_model(dev):
    """Phase 11: DiskModel(cfg).prepare() then run(n_iter=1) on the bench
    disk: the initial run_mc (K3, K4), reduce_fields, columns and
    shielding through the path matrices, env assembly, the pool sweep over
    every active cell (K1, K2), the convergence bookkeeping."""
    from rac2d_torch.models import driver
    from rac2d_torch.ops import kernels
    t_ph = time.time()
    m = bench_disk(dev, n_iter=1, evolT=True, chem_stream=True,
                   t_max=RUN_T_MAX, chem_chunk=RUN_CHUNK)
    t_prep = time.time() - t_ph
    use = m.grid.using
    n_act = int(use.sum())
    W = min(RUN_CHUNK, n_act)
    n_chunks = -(-n_act // W)
    m.cfg.chunk_wall_s = RUN_BUDGET_S / (n_chunks * m.cfg.nlocal_iter)
    say(f"phase 11 setup: DiskModel.prepare {t_prep:.2f} s (path trace "
        f"{m.t_trace:.3f} s); {m.grid.n_cells} cells, {n_act} active, NEQ "
        f"{m.ode.neq}; path matrices nnz: star {len(m.W_star.w)}, ISM "
        f"{len(m.W_ism.w)}")
    say(f"phase 11 depth cuts: {MC_NPH} packets x {m.cfg.n_mc_passes} MC "
        f"passes (production 4e6 x 3), t_max {RUN_T_MAX:g} yr (production "
        f"{1e6:g}), chem_chunk {W} (production 256), n_iter 1; "
        f"chunk_wall_s {m.cfg.chunk_wall_s:.3f} s, a sweep budget of "
        f"{RUN_BUDGET_S:g} s over {n_chunks} windows x "
        f"{m.cfg.nlocal_iter} levels; the window refilled every "
        f"{driver.POOL_ROUNDS_PER_CALL} BDF rounds")
    kernels.reset_launches()
    t0 = time.time()
    m.run(n_iter=1)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {"K1": kernels.block_lu_factor.launches,
                "K2": kernels.block_lu_solve.launches,
                "K3": kernels.mc_walk.launches,
                "K4": kernels.fold_terminal.launches}
    st = m.stage_times[0]
    res = m.pool_result
    say(f"phase 11 run: {wall:.2f} s; stage timing: initial mc "
        f"{m.t_mc_initial:.2f} s, " + ", ".join(
            f"{k} {v:.2f} s" for k, v in st.items())
        + f"; pool sweep {int(res.n_steps.sum())} steps, {res.n_rounds} "
        f"BDF rounds, {int(res.n_lu.sum())} lane-LUs")
    for ip, ms in enumerate(m.mc_stats):
        say(f"phase 11 MC pass {ip + 1}: {ms['packets']} packets in "
            f"{ms['wall_s']:.2f} s, {ms['chunks']} chunks, fates "
            f"{ms['fates']}")
    say("phase 11 launches during run: " + ", ".join(
        f"{k} {v}" for k, v in launches.items()))
    q512 = int(((m.quality & 512) > 0)[use].sum())
    say(f"phase 11 chemistry: converged {int(m.converged_cells.sum())}/"
        f"{n_act} ({m.converged_cells.mean():.1%}); cells at quality 512: "
        f"{q512} (tol {0.05 * n_act:.0f}, 5%)")
    if min(launches.values()) <= 0:
        raise Fail("phase 11: run did not launch every kernel "
                   f"({launches})")
    if q512 > 0.05 * n_act:
        raise Fail("phase 11: more than 5% of active cells at quality 512")
    X, Tg = m.X, m.Tgas
    if not (np.isfinite(X).all() and np.isfinite(Tg).all()):
        raise Fail("phase 11: non-finite X or Tgas")
    clean = use & (m.quality == 0)
    drift = element_drift(m.net, m.y0, X[:, clean].T)
    h2 = float(X[m.net.idx["H2"], use].max())
    td = m.Tdust[use]
    say(f"phase 11 checks over {int(clean.sum())} clean cells: max "
        f"abundance {X[:, clean].max():.4g} (tol < 1.5), Tgas in "
        f"[{Tg[clean].min():.4g}, {Tg[clean].max():.4g}] K (tol (2, 3e4)), "
        f"max element drift {drift.max():.2e} (tol 1e-2); max H2 over "
        f"active cells {h2:.4g} (tol > 0.1); Tdust in [{td.min():.4g}, "
        f"{td.max():.4g}] K")
    if (X[:, clean] >= 1.5).any() \
            or not ((Tg[clean] > 2.0) & (Tg[clean] < 3e4)).all():
        raise Fail("phase 11: unphysical state in clean cells")
    if not drift.max() < 0.01:
        raise Fail("phase 11: elements drift by 1% or more")
    if not h2 > 0.1:
        raise Fail("phase 11: no H2 above 0.1")
    if not (np.isfinite(td).all() and td.min() >= m.mc_cfg.TdustMin
            and td.max() <= m.mc_cfg.TdustMax):
        raise Fail("phase 11: Tdust outside [TdustMin, TdustMax]")
    t0 = time.time()
    rel = shielding_card_vs_cpu(m)
    worst = max(r for r, _ in rel.values())
    say("phase 11 columns and shielding, card vs CPU from the final X "
        "(max rel; entries both below the smallest normal float64): "
        + ", ".join(f"{k} {r:.2e} ({n})" for k, (r, n) in rel.items())
        + f" (tol 1e-12); {time.time() - t0:.1f} s")
    if not worst <= 1e-12:
        raise Fail("phase 11: columns on the card differ from the CPU's")
    t_all = time.time() - t_ph
    say(f"phase 11 done: {t_all:.1f} s (aim <= {RUN_MAX_S:g} s)")
    return launches


def main():
    t_all = time.time()
    # ---- 1. the card ----
    if not torch.cuda.is_available():
        say("FAIL phase 1: torch.cuda.is_available() is False")
        return 1
    smi = nvidia_smi()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    say(f"phase 1 card: {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | devices {torch.cuda.device_count()}")

    from rac2d_torch.ops import kernels
    if torch.backends.cuda.matmul.allow_tf32 \
            or torch.backends.cudnn.allow_tf32:
        say("FAIL phase 1: TF32 is on")
        return 1
    rows = []
    try:
        # ---- 2. build ----
        t0 = time.time()
        kernels.load()
        say(f"phase 2 build: {time.time() - t0:.1f} s")
        for line in kernels.build_log.splitlines():
            if ("ptxas info" in line and ("Used" in line
                                          or "Compiling" in line)) \
                    or "spill" in line:
                say("  " + line.strip())
        # ---- 3, 4. K1/K2 vs plain, times; 5, 6. the chemistry slice ----
        # at phase 5's window W and at phase 11's, RUN_CHUNK
        chk = check_kernels(dev)
        tm = time_kernels(**chk)
        del chk["A"], chk["b"], chk["fac"], chk["ref"]
        chk_run = check_shape(dev, RUN_CHUNK)
        tm_run = time_kernels(**chk_run)
        del chk_run["A"], chk_run["b"], chk_run["fac"], chk_run["ref"]
        torch.cuda.empty_cache()
        launches, _ = run_slice(dev)
        for name, key, replaces, err, nl in (
                ("blocklu_factor", "K1", K1_REPLACES, "err_fac",
                 launches[0]),
                ("blocklu_solve", "K2", K2_REPLACES, "err_x",
                 launches[1])):
            rows.append({"name": name, "route": "cuda", "source": SOURCE,
                         "replaces": replaces, "B": RUN_CHUNK,
                         "max_abs_err": chk_run[err], **tm_run[key],
                         "launches_slice": nl,
                         "slice": {"B": W, "max_abs_err": chk[err],
                                   **tm[key]}})
        # ---- 7-10. the Monte Carlo dust pass ----
        t0 = time.time()
        m = bench_disk(dev)
        say(f"phase 7 setup: bench disk prepared in {time.time() - t0:.1f} s")
        k3 = check_walk(m, dev)
        k4 = check_fold(**k3)
        del k3["pk"], k3["model"]
        mc_launches = run_mc_slice(m)
        recheck_plain(m)
        del m
        torch.cuda.empty_cache()
        # ---- 11. the main path: DiskModel.run ----
        run_launches = run_model(dev)
        for row, key in zip(rows, ("K1", "K2")):
            row["launches"] = run_launches[key]
        res = {"mc_walk": (k3, mc_launches[0], run_launches["K3"]),
               "fold_terminal": (k4, mc_launches[1], run_launches["K4"])}
        for row, replaces, name in PROBES:
            r, n, n_run = res[name]
            rows.append({"name": f"{name} ({row})", "route": "cuda",
                         "source": MC_SOURCE, "replaces": replaces,
                         "launches": n_run, "launches_slice": n,
                         "max_abs_err": r["err"],
                         "ms": r["ms"], "device_ms": r["device_ms"],
                         "host_ms": r["host_ms"], "plain_ms": r["plain_ms"],
                         "bound_ms": r["bound_ms"], "bound_by": "bytes",
                         "library_ms": None,
                         **({"bound_all_fields_ms": r["bound_all_fields_ms"]}
                            if "bound_all_fields_ms" in r else {})})
    except Fail as e:
        say(f"FAIL {e}")
        return 1

    say(f"total {time.time() - t_all:.1f} s")
    say(json.dumps({"kernels": rows}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
