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
     1e-8 -> T_MAX = 1e-4 yr; the kernels' launch counts over this run must
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
     MAIN_T_MAX in windows of RUN_CHUNK, with a sweep wall budget of
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
     the same X;
 12. the command line and imaging at full width, on phase 11's model:
     (a) checkpoint.save_state, then load_state into a newly prepared
     model (X, Tgas, Tdust, Tdusts, quality bit-equal, iiter back); the
     iteration table through save_iter_npz/load_iter_npz with every
     PHYS_COLUMNS key the JAX package writes; the SED finite and > 0 in
     the UV, optical, near-IR and far-IR bands; a 201x201 continuum cube
     at 1.3 mm and 45 deg, finite, its peak within 3 px of the centre;
     CO NLTE excitation over every active cell (41 levels; cells
     converged, Newton steps, populations >= 0 summing to 1 within
     1e-12; run twice, the first call also loading the card's
     linear-algebra library); a CO J=2-1 cube 201x201x100 at 45 deg,
     finite, its spectrum double-peaked and symmetric about the line
     centre (peak channels mirror images within one channel, heights
     within 10%, the centre below both); (b) NLTE on 64 of those cells
     solved again on the CPU (within 1e-6 relative on levels above
     1e-10, the same cells converged), and 9x9 rays of each cube traced
     again on the CPU (within 1e-9 of the cube's maximum); (c)
     `python -m rac2d_torch` (no --device: the card) on the tables of
     examples/verify_model.toml with t_max 1e-5 yr in one window of 256,
     per-iteration tables, one analysis point and NLTE lines, --iters 1,
     then resumed from its checkpoint with --iters 0: both exit 0 and
     write every output file (iter_0001.npz in the first), every FITS
     cube parses with the port's reader and is finite, the line cubes
     are those each log says it wrote, the same in both runs, and the
     first run's log shows K1-K4 launched; (d) K1-K4 against their plain
     versions at the shapes that run gave them, on its own model and
     state (its checkpoint): K1/K2 at its pool window (read from its
     log), K3/K4 at its pass width, with their times; then one MC pass on
     that state and one each with the initial Tdust and the initial
     atomic hydrogen, their walk chunks printed.  The line and continuum
     cubes print their peak card memory.  Phase 12 aims at <= 180 s.
     The JAX reader's DiskConfig on the same TOML is compared in the CPU
     tests only (tests/test_torch_cli.py): this machine need not have
     JAX;
 13. the JAX package's end-to-end configuration (the switches of
     tests/test_e2e_driver.py's fixture, with merging):
     DiskModel(cfg, "cuda").prepare() then run(n_iter=2) on the bench disk
     with phase 11's shapes (RUN_CHUNK window, RUN_T_MAX, 2 MC passes of
     1e6 packets) and evolT=False, do_vertical_with_Tdust with
     n_vert_iter_tdust=2, do_vertical_every=1, do_refine and do_merge: the
     hydrostatic bootstrap (MC and balance, twice), the initial MC,
     fixed-T chemistry (K1/K2) then the equilibrium T by bisection in each
     iteration, the re-balance and AMR after the first, the second's MC
     (K3/K4) on the refined grid.  It prints each vertical pass's gas mass,
     rescale range and time, the stage timing lines, the cells and active
     cells before and after AMR with the refined cells and merged pairs,
     the cells bracketed and not by the equilibrium T, K1-K4 launches over
     the run (each must be > 0), each MC pass's walk chunks and fates and
     the cells at quality 512.  It fails on any of phase 11's checks on
     the final grid; on a pass on the refined grid that does not count
     every packet or leaves more than 1e-3 of them premature or walking
     at the step cap, or whose lanes at the cap (diffusing through the
     dense midplane cells the bootstrap makes) do not end when walked on
     through K3 for nmax_encounter more steps; on no refined cell; on the
     equilibrium T of 64 cells solved again on the CPU from the same
     environments differing in a bracket flag or by more than 1e-5 T +
     0.1 K; on K3/K4 disagreeing with their plain versions on the refined
     grid's cells and state (as in phase 12d); unless save_state of the
     refined model, load_state into a newly prepared model, gives back the
     grid hash, every grid array and X, Tgas, Tdust, Tdusts, quality and
     rho_dust bit-equal, and a run_mc there counts every packet; and,
     last, on a column surface density (over the cells active before the
     call) that a fixed-grid re-balance of the refined model changes by
     more than 1e-12 relative.  Each sweep's wall budget is RUN_BUDGET_S
     a window of RUN_CHUNK cells; the pool sweep's log line gives it.
     Then merging on the card: amr_step with refinement off at the
     smallest merge_tol of MERGE_TOLS that gives disjoint uniform pairs
     (the pair counts of each printed), one MC pass on the merged grid,
     K3/K4 against their plain versions there and its columns card vs CPU
     within 1e-12; it fails if nothing merged.  Phase 13 aims at <= 360 s;
 14. the rest of the chemistry solver: (a) `python -m rac2d_torch` (no
     --device) on phase 12c's TOML with t_max 1e-4 yr, chem_stream =
     false (183 cells in one chunk of 256 lanes) and [heating_cooling]
     with allow_gas_dust_en_exch, tdust_iter_tandem and
     dust_gas_linear_couple, --iters 1: exit 0, every output file, the
     chunk lines and K1-K4 in its log, phase 11's physical bars on its
     checkpoint's state; (b) on phase 11's model after phase 12, 512 of
     its active cells (seed 0) from one snapshot of X and Tgas, evolT, to
     phase 11's MAIN_T_MAX, exchange off, CUDA's scatter sums in a fixed
     order (since phase 15; see Deterministic): the pool sweep at width
     256 and the chunked sweep in chunks of 256, each with its BDF rounds,
     wall time,
     ms/round, failed cells and K1/K2 launches and held to phase 11's
     physical bars, then the worst and median key-species difference
     between the two over the cells clean in both (no bar: it measures how
     far a lane's solution depends on its window mates); (c) 256 of those
     cells in one window of the pool sweep (in a fixed summation order, as
     (b)) with the ThermalBalance rebuilt
     with the Tdust LUT and all three exchange modes: ms/round and K1/K2
     launches a round against (b)'s pool, the CUDA kernels one eager RHS
     and one eager Jacobian evaluation launch with the modes off and on
     (torch.profiler; the solvers replay both as CUDA graphs),
     phase 11's physical bars, and every heating/cooling rate of 64 cells,
     card vs CPU from the same inputs, within 1e-9 relative (absolute
     floor 1e-40); (d) ChemicalODE.solve on the dark-cloud cell of
     tests/test_single_cell.py to 1e2 yr on the card and on the CPU (key
     species within 1%), and solve_batched(continuous=True, retry_tols=...)
     on phase 5's 3 COUPLED_CELLS to T_MAX, within 5% of phase 5's final
     states; (e) one coupled Jacobian refresh at W lanes (jac_probe),
     eager (make_jac) against its CUDA graph (_batch_fns's jac_b): the
     host's time to enqueue a call and the device's time of a call, the
     graph's capture, and the graphed J within 1e-12 of the eager one.
     Phase 14 aims at <= 300 s;
 15. the last modules of the port: (a) the inv backend at phase 4's
     shapes (B 1024 and 256, n 485): K1 then blocklu.block_invert, its
     time and bound (getri's 4/3 n^3 flop), one inverse apply beside K2
     (times and bytes bounds), _bsolve on "inv" against "kernel" within
     1e-8 max|x| + 1e-10 (2 refinements, tests/test_blocklu.py's case at
     n 485), and pool sweeps of 64 of phase 14b's cells in one window
     from its snapshot to 1e-6 yr with RAC2D_LU_BACKEND "kernel", "inv",
     "kernel" in turns (the same failed cells, key species within 5%,
     Tgas 2%; ms/round);
     (b) the sharded path on phase 11's model, through its entry points:
     (i) in a process group of one rank (NCCL, cuda:0) with the model's
     sharded branches on and shard_chemistry set, chemistry_step on
     phase 14b's 512 cells alone from its snapshot (the chunked sweep,
     its chunks through sharded_chemistry_solve, X, Tgas and the failed
     cells broadcast), held within rtol 1e-8 (atol 1e-25, the same failed
     cells) of phase 14b's chunked sweep in one process, both with CUDA's
     scatter sums in a fixed order (torch's deterministic mode: its
     atomic f64 sums otherwise change a step decision now and then, and
     two runs of one sweep differ up to the 1e-4 rtol); then
     run_mc(n_passes=1), the pass sharded and its fields broadcast, held
     to this rank's own pass within 1e-5 of each channel's largest entry,
     the fates equal; K1-K4 counted over both (launches_sharded); (ii)
     run_mc(n_passes=1) in 2 processes on the one card joined with gloo
     (NCCL refuses two ranks on one device; the collectives run on host
     copies), each rebuilding phase 11's model from its configuration and
     state: the tallies against the sum of the ranks' own passes (1e-5,
     fates summed exactly), the same tallies and Tdust on both ranks; (c)
     save_state_dist / load_state_dist of phase 11's model in the
     one-rank group, bit-equal; (d) rac2d_torch.postprocess on phase 12c's
     iteration tables and FITS cubes (profiles, CO columns, scale heights,
     moment maps, pv_cut, SpecLine, a beam-convolved continuum image):
     finite and shaped as their inputs.  Phase 15 aims at <= 150 s.
Phases 7 and 8 also print the bounds of K3 and K4 (bytes: for K3 the
packet state read and written once, the tables read once, the tally bins
the run touched read and written once; for K4 the two bases above); no
single PyTorch call computes either.
Depth cuts for the time limit: phases 5-6 run to T_MAX = 1e-4 yr (1 yr
until phase 14 was added, 1e2 yr until phase 11 was), phase 11 to
MAIN_T_MAX = 1e-5 yr (and phases 14b-c and 15b, which solve from its
state) and phase 12c to 1e-5 yr (1e-4 until phase 14).  With phase 14
and the earlier depths the script took 1405 s on an H100 80GB HBM3 (700
W), past its 1200 s limit.  Phase 15 keeps one sharded chemistry sweep
(15b (i)); its 2 processes (15b (ii)) run the MC pass only.
The second-to-last lines are the kernels' JSON record (K1, K2 and one line
for each TPU probe kernel that K3 or K4 replaces, each with its time,
bound, plain and library times and launches: `launches` over phase 11's
run, `launches_slice` over phase 5 (K1/K2) or phase 9 (K3/K4),
`launches_cli` over phase 12c's command-line run (read from its log; the
imaging of phases 12a-b launches none), `launches_e2e` over phase 13's
run, `launches_cli_chunked` over phase 14a's command-line run (from its
log), and for K1/K2 `launches_chunked` over phase 14b's chunked sweep and
`launches_exchange` over phase 14c's sweep, and `launches_sharded` over
phase 15b (i)'s chemistry_step and run_mc and, for K3/K4,
`launches_sharded_2proc` for each process of 15b (ii); the K1/K2 rows
carry phase 15a's `inv_invert` (block_invert after K1) and `inv_apply`
(the apply beside K2) times and bounds by B; the K1/K2 rows hold their check and times at phase 11's window B=RUN_CHUNK and,
under "slice", at phase 5's B=W; K3/K4
rows add device_ms, the queued device time; every row holds, under
"cli", its check and times at phase 12c's shape, and K3/K4 rows under
"e2e" and "e2e_merged" their check and times on phase 13's refined and
merged grids) and the card's
nvidia-smi
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
T_MAX = 1e-4              # yr; 1 until phase 14 was added, 1e2 before PR 8
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
    # the COUPLED_CELLS' final states, for phase 14d
    return launches, rounds, yf[N - 3:], fail[N - 3:]


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


def edge_lanes(ws, zeros, kw, tag):
    """The hand-built lanes that the JAX walk never ends (ROADMAP.md §3),
    8 steps through K3 and through the plain walk: whether each left its
    cell or ended, the same way in both."""
    from rac2d_torch.ops import kernels, mcrt
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
    say(f"{tag} edge lanes ({kinds.count('grazing')} grazing on a bottom "
        f"face, {kinds.count('corner')} aimed at a corner): left their cell "
        f"or ended within 8 steps: kernel {int(ge.sum())}, plain "
        f"{int(gp.sum())} of {len(kinds)}; status, cell and e_count equal: "
        f"{edge_same}; kernel status {pe.status.tolist()}")
    return edge_ok


def check_walk(m, dev, tag="phase 7", nph=MC_NPH, batch=MC_BATCH, warm=True,
               edges=True):
    """Phase 7: K3 against _walk_plain on one 64-step chunk of `batch`
    lanes drawn from a pass of `nph` packets, in a warm Tdust(r) (or, with
    warm=False, the model's own); with `edges`, the hand-built edge lanes
    too."""
    from rac2d_torch.ops import kernels, mcrt
    t0 = time.time()
    cells = m.mc_cells()
    if warm:
        # so that re-emission and MRW run: 150 K (r/AU)^-1/2
        tdust = np.clip(150.0 * m.r_cells ** -0.5, 10.0, 1500.0)[None, :]
        cells = cells._replace(Tdust=torch.as_tensor(tdust, device=dev))
    model = mcrt.McModel(m.tab, m.gi, cells, m.cfg.star_mass)
    ws = mcrt.WalkSetup(model, m.mc_cfg.n_quantile)
    lam, en, _ = m.packet_pool(nph)
    pick = np.linspace(0, len(lam) - 1, batch).astype(np.int64)
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
    say(f"{tag} K3 walk: B={batch}, {MC_STEPS} steps, {m.grid.n_cells} "
        f"cells ({int(m.grid.using.sum())} active), nlam {nlam}; active "
        f"after: kernel {na_k}, plain {na_p}; kernel fates {fates}")
    say(f"{tag} agreement: status+cell+e_count on {share:.6f} of lanes "
        f"(tol 0.99); RNG words equal on {int(live.sum())} live agreeing "
        f"lanes: {rng_eq}; max rel diff on agreeing lanes (|ref| floored "
        f"at 1e-3) " + ", ".join(f"{k} {v:.2e}" for k, v in diffs.items()))
    say(f"{tag} tallies: flux total kernel {tot['flux'][0]:.6e} plain "
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
    say(f"{tag} per-bin tallies on {int(agree.sum())} agreeing lanes: max "
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
    say(f"{tag} times, one {MC_STEPS}-step chunk at B={batch}: kernel "
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
    say(f"{tag} K3 launch: {plan['regs']} registers and "
        f"{plan['local_bytes']} B of local memory a thread, "
        f"{plan['threads']} threads a CTA, {plan['blocks_per_sm']} CTAs per "
        f"SM, grid {plan['grid']} on {plan['sms']} SMs; {plan['smem']} B of "
        f"shared memory a CTA, tables staged in it: none (all {tab_bytes} B "
        f"through __ldg: staging the locate and optics tables measured no "
        f"faster, PERF.md)")
    edge_ok = edge_lanes(ws, zeros, kw, tag) if edges else True
    say(f"{tag} done: {time.time() - t0:.1f} s")
    if not (share >= 0.99 and rng_eq and rel["flux"] <= 1e-3
            and rel["mrw_path"] <= 1e-3
            and all(r <= 1e-4 for _, r in bins.values())):
        raise Fail(f"{tag}: K3 disagrees with its plain version")
    if not edge_ok:
        raise Fail(f"{tag}: an edge lane neither left its cell nor ended")
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


def check_fold(model, pk, zeros, tag="phase 8", **_):
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
        say(f"{tag} K4 fold ({name}): {lanes.x.shape[0]} lanes, {n_esc} "
            f"escaped, {n_wat} water-destroyed, {n_pad} padding; max |diff| "
            f"/ max |plain|: " + ", ".join(
                f"{k} {v:.2e}" for k, v in rels.items()) + " (tol 1e-5); "
            f"fate counts {fk.tolist()} equal to packet_fates {want} and the "
            f"plain fold's: {exact}")
        if not max(rels.values()) <= 1e-5:
            raise Fail(f"{tag}: K4 disagrees with its plain version "
                       f"({name})")
        if not exact:
            raise Fail(f"{tag}: K4's fate counts are wrong ({name})")
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
        say(f"{tag} times ({name}, B={lanes.x.shape[0]}): kernel "
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
        say(f"{tag} K4 launch ({name}): {t['plan']}")
        res[name] = dict(t, bound_ms=b_ms, bound_all_fields_ms=b_old)
    say(f"{tag} done: {time.time() - t0:.1f} s")
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

RUN_T_MAX = 1e-4          # yr; production 1e6 (phase 13)
MAIN_T_MAX = 1e-5         # yr, phases 11, 14b-c and 15 (RUN_T_MAX until
#                           phase 14)
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


def check_bars(m, cells, failed, clean, tag):
    """Phase 11's physical bars over `cells`: at most 5% of them failed
    (failed: bool over cells); finite X and Tgas, and in the clean ones
    (bool over cells) abundances < 1.5, Tgas in (2, 3e4) K and their
    elements within 1% of the initial ones; max H2 over the cells > 0.1."""
    n = len(cells)
    n_fail = int(failed.sum())
    X, Tg = m.X[:, cells], m.Tgas[cells]
    say(f"{tag}: {n_fail} of {n} cells failed (tol {0.05 * n:.0f}, 5%)")
    if n_fail > 0.05 * n:
        raise Fail(f"{tag}: more than 5% of the cells failed")
    if not (np.isfinite(X).all() and np.isfinite(Tg).all()):
        raise Fail(f"{tag}: non-finite X or Tgas")
    drift = element_drift(m.net, m.y0, X[:, clean].T)
    h2 = float(X[m.net.idx["H2"]].max())
    say(f"{tag} checks over {int(clean.sum())} clean cells: max "
        f"abundance {X[:, clean].max():.4g} (tol < 1.5), Tgas in "
        f"[{Tg[clean].min():.4g}, {Tg[clean].max():.4g}] K (tol (2, 3e4)), "
        f"max element drift {drift.max():.2e} (tol 1e-2); max H2 over the "
        f"cells {h2:.4g} (tol > 0.1)")
    if (X[:, clean] >= 1.5).any() \
            or not ((Tg[clean] > 2.0) & (Tg[clean] < 3e4)).all():
        raise Fail(f"{tag}: unphysical state in clean cells")
    if not drift.max() < 0.01:
        raise Fail(f"{tag}: elements drift by 1% or more")
    if not h2 > 0.1:
        raise Fail(f"{tag}: no H2 above 0.1")


def check_physical(m, tag):
    """check_bars over the model's active cells (failed: quality 512;
    clean: quality 0), and Tdust in [TdustMin, TdustMax]."""
    use = m.grid.using
    cells = np.nonzero(use)[0]
    check_bars(m, cells, (m.quality[cells] & 512) > 0,
               m.quality[cells] == 0, tag)
    td = m.Tdust[use]
    say(f"{tag}: Tdust in [{td.min():.4g}, {td.max():.4g}] K")
    if not (np.isfinite(td).all() and td.min() >= m.mc_cfg.TdustMin
            and td.max() <= m.mc_cfg.TdustMax):
        raise Fail(f"{tag}: Tdust outside [TdustMin, TdustMax]")


def check_columns(m, tag):
    """Every column, shielding factor and Av_toISM on the card within
    1e-12 of the CPU's."""
    t0 = time.time()
    rel = shielding_card_vs_cpu(m)
    worst = max(r for r, _ in rel.values())
    say(f"{tag} columns and shielding, card vs CPU from the final X "
        "(max rel; entries both below the smallest normal float64): "
        + ", ".join(f"{k} {r:.2e} ({n})" for k, (r, n) in rel.items())
        + f" (tol 1e-12); {time.time() - t0:.1f} s")
    if not worst <= 1e-12:
        raise Fail(f"{tag}: columns on the card differ from the CPU's")


def check_sane(m, tag):
    """The run's state on its final grid: the converged fraction, then
    check_physical and check_columns."""
    say(f"{tag} chemistry: converged {int(m.converged_cells.sum())}/"
        f"{len(m.converged_cells)} ({m.converged_cells.mean():.1%})")
    check_physical(m, tag)
    check_columns(m, tag)


def run_model(dev):
    """Phase 11: DiskModel(cfg).prepare() then run(n_iter=1) on the bench
    disk: the initial run_mc (K3, K4), reduce_fields, columns and
    shielding through the path matrices, env assembly, the pool sweep over
    every active cell (K1, K2), the convergence bookkeeping."""
    from rac2d_torch.models import driver
    from rac2d_torch.ops import kernels
    t_ph = time.time()
    m = bench_disk(dev, n_iter=1, evolT=True, chem_stream=True,
                   t_max=MAIN_T_MAX, chem_chunk=RUN_CHUNK)
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
        f"passes (production 4e6 x 3), t_max {MAIN_T_MAX:g} yr (production "
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
    launches = kernels.launch_counts()
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
    if min(launches.values()) <= 0:
        raise Fail("phase 11: run did not launch every kernel "
                   f"({launches})")
    check_sane(m, "phase 11")
    t_all = time.time() - t_ph
    say(f"phase 11 done: {t_all:.1f} s (aim <= {RUN_MAX_S:g} s)")
    return launches, m


# --------------------------------------------------------------------
# the command line and imaging at full width (phase 12)

IMG_NX = 201              # the cubes' pixels a side
IMG_NF = 100              # the line cube's channels
IMG_THETA = 45.0          # inclination (deg): a double-peaked line
CONT_LAM_A = 1.3e7        # the continuum cube's wavelength (1.3 mm)
SUB = 9                   # phase 12b: SUB x SUB rays traced on the CPU
SUB_CELLS = 64            # phase 12b: NLTE cells solved on the CPU
CLI_TIMEOUT_S = 300       # each command-line run
PHASE12_AIM_S = 180.0
# the command line's output files besides the FITS cubes
CLI_FILES = ["config_used.toml", "log.txt", "iter_final.npz",
             "checkpoint.npz", "sed.json", "ana/ana_r10_z1.txt"]
# the keys of PHYS_COLUMNS that the JAX package's save_iter_npz writes
ITER_PHYS_KEYS = ["rmin", "rmax", "zmin", "zmax", "Tgas", "Tdust", "n_gas",
                  "Ncol_toISM", "Ncol_toStar", "Av_toStar", "G0_UV_toStar",
                  "G0_UV_H2phd", "zeta_X", "flux_UV", "flux_Lya",
                  "flux_Vis", "flux_NIR", "flux_MIR", "flux_FIR",
                  "phflux_Lya", "vol"]
# SED bands (Angstrom): UV, optical, near-IR, far-IR
SED_BANDS = {"UV": (1e3, 3e3), "optical": (4e3, 7e3), "near-IR": (1e4, 5e4),
             "far-IR": (5e5, 5e6)}


def synced(fn):
    """(fn(), its wall seconds, the card synchronized after it)."""
    t0 = time.time()
    out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, time.time() - t0


def peak_gib(fn):
    """(fn()'s result, its wall seconds, the card memory it held at its
    peak above what was allocated before it, GiB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out, wall = synced(fn)
    return out, wall, (torch.cuda.max_memory_allocated() - base) / 2 ** 30


def pop_diff(f, g, err_f, err_g, tol=1e-10):
    """Populations [cells, levels] of two NLTE solves: (cells converged in
    both, the same set?, max relative difference over levels above tol,
    max absolute difference below)."""
    cf, cg = err_f <= tol, err_g <= tol
    both = cf & cg
    a, b = f[both], g[both]
    big = b > tol
    rel = np.abs(a - b)[big] / b[big]
    return (int(both.sum()), bool((cf == cg).all()),
            float(rel.max()) if rel.size else 0.0,
            float(np.abs(a - b)[~big].max()) if (~big).any() else 0.0)


def cube_subset_cpu(model, theta, xs, ys, freqs, is_line, I, tau, Nu, Nl):
    """SUB x SUB of a cube's rays traced again on the CPU: the largest
    difference of I, tau, N_up and N_low from the card's cube, each over
    its array's largest value."""
    from rac2d_torch.ops import geometry, raytrace

    def cpu(t):
        return t.cpu() if isinstance(t, torch.Tensor) else t
    cpu_model = model._replace(
        gi=geometry.GridIndex(*(cpu(t) for t in model.gi)),
        cells=raytrace.RtCells(*(cpu(t) for t in model.cells)),
        kext_dust=cpu(model.kext_dust))
    (px, py, pz), v = raytrace.cube_rays(model, theta, xs, ys)
    pick = np.linspace(0, len(xs) - 1, SUB).astype(int)
    ray = (pick[:, None] * len(ys) + pick[None, :]).ravel()
    fr = torch.as_tensor(np.asarray(freqs, dtype=np.float64))
    out = raytrace.integrate_rays(cpu_model, px[ray], py[ray], pz[ray], *v,
                                  fr, raytrace.cmb(fr), is_line=is_line)
    card = (I.reshape(-1, I.shape[-1]), tau.ravel(), Nu.ravel(), Nl.ravel())
    errs = {}
    for name, a, full in zip(("I", "tau", "N_up", "N_low"), out, card):
        scale = float(np.abs(full).max()) or 1.0
        errs[name] = float(np.abs(a.numpy() - full[ray]).max()) / scale
    return errs


def check_imaging(m, dev):
    """Phases 12a-b on phase 11's model: checkpoint and iteration-table
    round trips, the SED, a continuum cube, CO NLTE excitation over every
    active cell and a CO J=2-1 line cube, then parts of them again on the
    CPU."""
    import tempfile
    from rac2d_torch import checkpoint, defaults
    from rac2d_torch.models import imaging, output
    from rac2d_torch.ops import stateq
    times = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        checkpoint.save_state(f"{tmp}/ck.npz", m, 1)
        m2 = type(m)(m.cfg, dev)
        m2.prepare()
        it = checkpoint.load_state(f"{tmp}/ck.npz", m2)
        bad = [k for k in ("X", "Tgas", "Tdust", "Tdusts", "quality")
               if not np.array_equal(getattr(m2, k), getattr(m, k))
               or getattr(m2, k).dtype != getattr(m, k).dtype]
        times["checkpoint"] = time.time() - t0
        say(f"phase 12a checkpoint: save, prepare a new model, load: "
            f"iiter {it}, arrays not bit-equal: {bad or 'none'}; "
            f"{times['checkpoint']:.2f} s")
        if bad or it != 1:
            raise Fail("phase 12a: the checkpoint does not round-trip")
        del m2
        t0 = time.time()
        output.save_iter_npz(f"{tmp}/iter.npz", m, 1)
        d = output.load_iter_npz(f"{tmp}/iter.npz")
        missing = [k for k in ITER_PHYS_KEYS if k not in d]
        differ = [k for k in ("Tgas", "Tdust", "abundances", "quality")
                  if not np.array_equal(d[k], output.iter_table(m)[k])]
        times["iter_npz"] = time.time() - t0
        say(f"phase 12a iteration table: {len(d)} keys, PHYS_COLUMNS keys "
            f"missing {missing or 'none'}, state arrays differing "
            f"{differ or 'none'}; {times['iter_npz']:.2f} s")
        if missing or differ:
            raise Fail("phase 12a: the iteration table does not round-trip")
    lam, F = m.sed()
    band = {k: float(F[:, (lam >= lo) & (lam <= hi)].sum())
            for k, (lo, hi) in SED_BANDS.items()}
    say("phase 12a SED (erg/s/cm2/A summed over the band's bins and the mu "
        "bins): " + ", ".join(f"{k} {v:.4g}" for k, v in band.items())
        + f"; finite {bool(np.isfinite(F).all())}")
    if not np.isfinite(F).all() or min(band.values()) <= 0:
        raise Fail("phase 12a: the SED is not finite and > 0 in every band")

    # the continuum cube
    (I, tau, spec), times["continuum"], mem = peak_gib(
        lambda: imaging.make_continuum_cube(m, CONT_LAM_A, IMG_THETA,
                                            nx=IMG_NX, ny=IMG_NX))
    pk = np.unravel_index(np.argmax(I[:, :, 0]), I.shape[:2])
    off = float(np.hypot(pk[0] - IMG_NX // 2, pk[1] - IMG_NX // 2))
    say(f"phase 12a continuum cube {IMG_NX}x{IMG_NX} at {CONT_LAM_A:g} A, "
        f"{IMG_THETA:g} deg: {times['continuum']:.2f} s, peak card memory "
        f"{mem:.3f} GiB above the model's; finite "
        f"{bool(np.isfinite(I).all())}, peak {I.max():.4g} at {pk}, "
        f"{off:.1f} px from the centre (tol 3), flux {spec[0]:.4g} Jy")
    if not np.isfinite(I).all() or off > 3.0:
        raise Fail("phase 12a: the continuum cube")
    from rac2d_torch import constants as c
    half = m.grid.rmax.max() * 1.05             # as make_continuum_cube
    xs = np.linspace(-half, half, IMG_NX)
    cont = (imaging.continuum_model(m, CONT_LAM_A), IMG_THETA, xs, xs,
            np.atleast_1d(c.SpeedOfLight_CGS / (CONT_LAM_A * c.Angstrom2cm)),
            False, I, tau, np.zeros_like(tau), np.zeros_like(tau))

    # CO NLTE excitation over every active cell, then the J=2-1 cube
    li = imaging.LineImaging(m, imaging.LineConfig(
        mol_file=defaults.CO_LAMDA, mole_name="CO", useLTE=False,
        nx=IMG_NX, ny=IMG_NX, nf=IMG_NF, view_thetas=(IMG_THETA,)))
    st = {}
    # twice: the first call also loads the card's linear-algebra library
    _, times["nlte_first"] = synced(lambda: li.excitation(stats=st))
    fpop, times["nlte"] = synced(lambda: li.excitation(stats=st))
    act = np.nonzero(m.grid.using)[0]
    f = fpop[:, act]
    conv = st["err"] <= 1e-10
    say(f"phase 12a CO NLTE excitation: {st['cells']} active cells, "
        f"{li.mol.n_level} levels, {int(conv.sum())} converged "
        f"({conv.mean():.1%}), {st['steps']} batched Newton steps, steps "
        f"per cell {np.bincount(st['iters']).tolist()}; min population "
        f"{f.min():.3g}, max |sum - 1| {np.abs(f.sum(0) - 1).max():.2e} "
        f"(tol 1e-12); {times['nlte']:.2f} s (the first call "
        f"{times['nlte_first']:.2f} s)")
    if f.min() < 0 or np.abs(f.sum(0) - 1).max() > 1e-12 \
            or conv.mean() < 0.95:
        raise Fail("phase 12a: the NLTE populations")
    itr = int(np.argmin(np.abs(li.mol.freq - 230.538e9)))
    (I, tau, Nu, Nl, spec), times["line"], mem = peak_gib(
        lambda: li.make_cube(itr, IMG_THETA))
    from rac2d_torch.ops import raytrace
    chunk = raytrace.CHUNK_ELEMS // ((raytrace.NSUB + 1) * IMG_NF)
    c0 = IMG_NF // 2          # the channel at the rest frequency
    kl = int(np.argmax(spec[:c0]))
    kr = c0 + 1 + int(np.argmax(spec[c0 + 1:]))
    hl, hr = float(spec[kl]), float(spec[kr])
    say(f"phase 12a CO J=2-1 cube {IMG_NX}x{IMG_NX}x{IMG_NF} at "
        f"{IMG_THETA:g} deg: {times['line']:.2f} s in "
        f"{-(-IMG_NX * IMG_NX // chunk)} chunks of {chunk} rays, peak card "
        f"memory {mem:.3f} GiB above the model's; finite "
        f"{bool(np.isfinite(I).all())}; spectrum peaks at channels {kl} "
        f"and {kr} (mirror of {kl}: {2 * c0 - kl}, tol 1), {hl:.4g} and "
        f"{hr:.4g} Jy (tol 10%), {float(spec[c0]):.4g} Jy at the centre; "
        f"max tau {tau.max():.3g}")
    if not np.isfinite(I).all() or abs(kl + kr - 2 * c0) > 1 \
            or abs(hl - hr) > 0.1 * max(hl, hr) \
            or not spec[c0] < min(hl, hr):
        raise Fail("phase 12a: the line spectrum is not double-peaked and "
                   "symmetric")

    # 12b: parts of the same work on the CPU
    t0 = time.time()
    act_e, envs = li.exc_envs()
    sel = np.linspace(0, len(act_e) - 1, SUB_CELLS).astype(int)
    sub = stateq.CellExcEnv(*(a[sel].cpu() for a in envs))
    fc, ec = stateq.solve_stateq_batch(
        stateq.build_mol_tables(li.mol, "cpu"), sub)
    n_both, same, rel, ab = pop_diff(fc.numpy(), fpop[:, act_e[sel]].T,
                                     ec.numpy(), st["err"][sel])
    say(f"phase 12b NLTE on {SUB_CELLS} cells on the CPU vs the card: "
        f"{n_both} converged in both, same set {same}, max rel diff "
        f"{rel:.2e} on levels above 1e-10 (tol 1e-6), max abs diff "
        f"{ab:.2e} below (tol 1e-12); {time.time() - t0:.2f} s")
    if not same or rel > 1e-6 or ab > 1e-12:
        raise Fail("phase 12b: NLTE populations on the CPU and the card "
                   "differ")
    freqs, _, xs, ys = li.cube_axes(itr)
    for name, args in (("line", (li.rt_model(itr, freqs), IMG_THETA, xs,
                                 ys, freqs, True, I, tau, Nu, Nl)),
                       ("continuum", cont)):
        t0 = time.time()
        errs = cube_subset_cpu(*args)
        say(f"phase 12b {name} cube, {SUB}x{SUB} rays on the CPU vs the "
            "card (max diff / the array's max): " + ", ".join(
                f"{k} {v:.2e}" for k, v in errs.items())
            + f" (tol 1e-9); {time.time() - t0:.2f} s")
        if max(errs.values()) > 1e-9:
            raise Fail(f"phase 12b: the {name} cube on the CPU and the "
                       "card differ")
    return times


# phase 12c's changes to examples/verify_model.toml: (text, replacement),
# each found once, and the tables added at its end
CLI_EDITS = [("t_max = 1.0", "t_max = 1e-5"),
             ("chem_chunk = 32", "chem_chunk = 256"),
             ("useLTE = true", "useLTE = false")]
CLI_TABLES = """
[output]
per_iteration = true

[analysis]
points = [[10.0, 1.0]]
"""


def cli_toml(path):
    """examples/verify_model.toml with phase 12c's changes, written to
    path: t_max 1e-5 yr in one window, NLTE lines, per-iteration tables
    and one analysis point."""
    import pathlib
    root = pathlib.Path(__file__).resolve().parent
    text = (root / "examples" / "verify_model.toml").read_text()
    for old, new in CLI_EDITS:
        if text.count(old) != 1:
            raise Fail(f"phase 12c: '{old}' is not in the verify model once")
        text = text.replace(old, new)
    path.write_text(text + CLI_TABLES)


def run_cli(outdir, toml, *extra, timeout=CLI_TIMEOUT_S, tag="phase 12c"):
    """python -m rac2d_torch toml --out outdir extra..., with no --device
    (the card); (wall seconds, its log)."""
    import pathlib
    root = pathlib.Path(__file__).resolve().parent
    cmd = [sys.executable, "-m", "rac2d_torch", str(toml), "--out",
           str(outdir), *extra]
    t0 = time.time()
    try:
        r = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                           timeout=timeout)
    except subprocess.TimeoutExpired:
        raise Fail(f"{tag}: {' '.join(cmd[1:])} ran past {timeout} s")
    wall = time.time() - t0
    if r.returncode != 0:
        say(r.stdout[-4000:] + r.stderr[-4000:])
        raise Fail(f"{tag}: {' '.join(cmd[1:])} exited {r.returncode}")
    log = (pathlib.Path(outdir) / "log.txt").read_text()
    for ln in log.splitlines():
        if any(k in ln for k in ("prepare done", "MC pass", "pool sweep",
                                 "stage timing", "finished in", " in ",
                                 "(level ", "retry level")):
            say(f"  log: {ln.strip()}")
    return wall, log


def log_launches(log):
    """The kernel launch counts of a command-line log, {"K1": n, ...}."""
    counts = {}
    for ln in log.splitlines():
        if ln.startswith("kernel launches:"):
            for part in ln.split(":", 1)[1].split(","):
                k, v = part.split()
                counts[k] = int(v)
    return counts


def check_cli_outputs(outdir, log, per_iteration, lines_want=None):
    """Every output file there, and the line cubes its log says it wrote
    (at least one; with lines_want, those names); each FITS cube parses
    with the port's reader and holds finite values.  (ok, what, the line
    cubes' names)."""
    import pathlib
    from rac2d_torch.io import fits
    out = pathlib.Path(outdir)
    missing = [f for f in CLI_FILES if not (out / f).exists()]
    if per_iteration and not (out / "iter_0001.npz").exists():
        missing.append("iter_0001.npz")
    cubes = sorted(out.glob("*.fits"))
    lines = [c.name for c in cubes if c.name.startswith("line_")]
    conts = [c for c in cubes if c.name.startswith("cont_")]
    logged = sorted(pathlib.Path(ln.split()[1]).name
                    for ln in log.splitlines()
                    if ln.startswith("wrote ") and "/line_" in ln)
    bad = []
    for c in cubes:
        data, _ = fits.read_fits_image(str(c))
        if not np.isfinite(data).all():
            bad.append(c.name)
    ok = (not missing and not bad and conts and lines and lines == logged
          and (lines_want is None or lines == lines_want))
    return ok, (f"missing {missing or 'none'}, {len(lines)} line cubes "
                f"({len(logged)} in the log"
                + ("" if lines_want is None else
                   f", {len(lines_want)} in the first run")
                + f"), {len(conts)} continuum cubes, non-finite "
                f"{bad or 'none'}"), lines


def check_cli(dev, keep):
    """Phases 12c-d: python -m rac2d_torch on the verify model (its tables,
    with t_max 1e-5 yr in one window, per-iteration tables, one analysis
    point and NLTE lines), --iters 1, then resumed from its checkpoint
    with --iters 0; then the kernels at the shapes the first run gave
    them.  The first run's output files are copied into `keep` (for
    phase 15d)."""
    import pathlib
    import re
    import shutil
    import tempfile
    walls = {}
    with tempfile.TemporaryDirectory() as tmp:
        toml = pathlib.Path(tmp) / "model.toml"
        cli_toml(toml)
        out1, out2 = pathlib.Path(tmp) / "run", pathlib.Path(tmp) / "resume"
        walls["run"], log = run_cli(out1, toml, "--iters", "1")
        counts = log_launches(log)
        ok, what, lines = check_cli_outputs(out1, log, True)
        say(f"phase 12c python -m rac2d_torch --iters 1: {walls['run']:.1f} "
            f"s, exit 0; {what}; kernel launches in its log: {counts}")
        if not ok or len(counts) != 4 or min(counts.values()) <= 0:
            raise Fail("phase 12c: the command line's outputs or launches")
        shutil.copytree(out1, keep, dirs_exist_ok=True)
        walls["resume"], log2 = run_cli(
            out2, toml, "--resume", str(out1 / "checkpoint.npz"),
            "--iters", "0")
        ok, what, _ = check_cli_outputs(out2, log2, False, lines)
        resumed = "resumed from" in log2
        say(f"phase 12c resumed, --iters 0: {walls['resume']:.1f} s, exit "
            f"0; {what}; resumed {resumed}; launches {log_launches(log2)}")
        if not ok or not resumed:
            raise Fail("phase 12c: the resumed run's outputs")
        width = [int(w) for w in re.findall(r"pool sweep: \d+ cells, "
                                            r"width (\d+)", log)]
        if len(set(width)) != 1:
            raise Fail("phase 12c: no single pool width in the log")
        kern = check_cli_kernels(dev, toml, out1 / "checkpoint.npz",
                                 width[0])
    return walls, counts, kern


def check_cli_kernels(dev, toml, ckpt, width):
    """Phase 12d: K1-K4 against their plain versions at the shapes the
    command line's --iters 1 run gave them: K1/K2 at its pool window of
    `width` lanes, K3/K4 at its pass width on its own model and state
    (from its checkpoint).  Then one pass on that state, and again with
    the initial Tdust and with the initial atomic hydrogen, to show why
    the resumed run's passes walk longer than the first run's.  {kernel:
    its row's "cli" entry}."""
    from rac2d_torch import checkpoint, config
    from rac2d_torch.models import driver
    t0 = time.time()
    m = driver.DiskModel(config.load_config(str(toml)), dev)
    m.prepare()
    X0, Td0 = m.X.copy(), m.Tdusts.copy()
    checkpoint.load_state(str(ckpt), m)
    n = m.net.n_species + 1
    chk = check_shape(dev, width, n)
    tm = time_kernels(**chk)
    out = {key: {"B": width, "n": n, "max_abs_err": chk[err], **tm[key]}
           for key, err in (("K1", "err_fac"), ("K2", "err_x"))}
    del chk
    lam, _, _ = m.packet_pool()
    lanes = min(m.mc_cfg.max_batch, len(lam))
    k3 = check_walk(m, dev, tag="phase 12d", nph=None, batch=lanes,
                    warm=False, edges=False)
    k4 = check_fold(**k3, tag="phase 12d")
    for key, r in (("K3", k3), ("K4", k4)):
        out[key] = {"B": lanes, "max_abs_err": r["err"], **{k: r[k] for k in (
            "ms", "device_ms", "host_ms", "plain_ms", "bound_ms")}}
    # the first run's passes started from the initial Tdust and
    # abundances, the resumed run's from the checkpoint's: one pass on
    # the checkpoint's state, and again with each of the two put back
    cells = m.mc_cells()
    n_HI0 = m._t(m.grid.n0 * X0[m.net.idx["H"]])
    walks = {}
    for name, cl in (("checkpoint", cells),
                     ("initial Tdust", cells._replace(Tdust=m._t(Td0))),
                     ("initial n_HI", cells._replace(n_HI=n_HI0))):
        _, fates, st = m.mc_pass(0, cells=cl)
        walks[name] = (st["chunks"], st["tail_chunks"], fates["escaped"])
    say(f"phase 12d one pass of {len(lam)} packets: " + "; ".join(
        f"{k}: {c} walk chunks ({t} with at most 64 live lanes), {e} "
        f"escaped" for k, (c, t, e) in walks.items()))
    say(f"phase 12d done: {time.time() - t0:.1f} s")
    return out


# --------------------------------------------------------------------
# the JAX package's end-to-end configuration at full width (phase 13)

# the switches of tests/test_e2e_driver.py's fixture, with merging and the
# hydrostatic bootstrap on (n_vert_iter_tdust: 2 MC + balance passes)
E2E_SWITCHES = dict(evolT=False, do_vertical_with_Tdust=True,
                    n_vert_iter_tdust=2, do_vertical_every=1,
                    do_refine=True, do_merge=True)
E2E_ITERS = 2
E2E_AIM_S = 360.0
# phase 13's merge step: the merge_tol ladder, smallest first
MERGE_TOLS = (1.5, 2.0, 3.0, 10.0, 100.0, 1e4)
EQ_CELLS = 64             # cells whose equilibrium T is solved on the CPU


def column_sigma(g, n0, use):
    """Per column, the sum of dz x n0 over the cells `use` marks (the
    column surface density over the mean particle mass)."""
    dz = g.zmax - g.zmin
    return np.array([
        float((dz * n0 * use)[g.col_cells[g.col_ptr[i]:g.col_ptr[i + 1]]]
              .sum()) for i in range(g.n_columns)])


def eq_T_card_vs_cpu(m):
    """The equilibrium T of EQ_CELLS active cells, on the card and again on
    the CPU from the same environments, y = [X, Tgas] and T0 = max(Tgas,
    2): (cells, bracketed on each, flags equal, max |dT| over the allowed
    1e-5 T + 0.1 K)."""
    from rac2d_torch.ops.thermal import ThermalBalance
    from rac2d_torch.utils.tree import tree_map
    act = np.nonzero(m.grid.using)[0]
    idx = act[np.linspace(0, len(act) - 1, EQ_CELLS).astype(int)]
    env, tenv = m.assemble_envs(idx)
    y = m._t(np.concatenate([m.X[:, idx].T, m.Tgas[idx][:, None]], axis=1))
    T0 = m._t(np.maximum(m.Tgas[idx], 2.0))
    Tc, bc = m.thermal.solve_equilibrium_T(y, env, tenv, T0, m.ode.tab)

    def cpu(a):
        return a.cpu()
    th = ThermalBalance(m.net, config=m.cfg.hc, device="cpu")
    Th, bh = th.solve_equilibrium_T(cpu(y), tree_map(cpu, env),
                                    tree_map(cpu, tenv), cpu(T0),
                                    tree_map(cpu, m.ode.tab))
    Tc, bc = Tc.cpu().numpy(), bc.cpu().numpy()
    Th, bh = Th.numpy(), bh.numpy()
    worst = float((np.abs(Tc - Th) / (1e-5 * Th + 0.1)).max())
    return len(idx), int(bc.sum()), int(bh.sum()), \
        bool((bc == bh).all()), worst


def finish_live_lanes(m, st, tag):
    """A pass's lanes still walking at its step cap (MC_STEP_CAP), walked
    on through K3 from where they stopped, on the pass's cells and the
    model's grid: each must end within nmax_encounter more steps, which a
    lane that diffuses (an encounter nearly every step, in cells made
    optically thick by the hydrostatic compression) does and a lane stuck
    in place (as the lanes of mcrt.edge_lanes once were, with few
    encounters) does not."""
    from rac2d_torch.ops import kernels, mcrt
    pk = st.get("live_lanes")
    if pk is None:
        say(f"{tag} MC: no lane at the step cap")
        return
    pk = pk.clone()
    dev = pk.x.device
    cells = st["cells"]
    e0 = pk.e_count.cpu().numpy()
    c0 = pk.cell.cpu().numpy()
    ws = mcrt.WalkSetup(mcrt.McModel(m.tab, m.gi, cells, m.cfg.star_mass),
                        m.mc_cfg.n_quantile)
    tl = mcrt.McTallies.zeros(m.grid.n_cells, len(m.tab.lam), m.n_dust, 5,
                              device=dev)
    steps, chunk = 0, 8192
    while steps < m.mc_cfg.nmax_encounter \
            and bool((pk.status == mcrt.ST_ACTIVE).any()):
        kernels.mc_walk(ws, pk, tl, chunk, **walk_kw(m))
        steps += chunk
    fates = mcrt.packet_fates(pk.status)
    n_gas = cells.n_gas.cpu().numpy()
    say(f"{tag} MC: {len(e0)} lanes walking at the {MC_STEP_CAP}-step cap, "
        f"encounters {int(e0.min())}..{int(e0.max())} each, in cells "
        f"{sorted(set(c0.tolist()))} (n_gas {n_gas[c0].min():.3g}.."
        f"{n_gas[c0].max():.3g} cm^-3); walked on through K3 for {steps} "
        f"more steps: fates {fates}")
    if fates["active"]:
        raise Fail(f"{tag}: {fates['active']} lanes still walk "
                   f"{steps} steps past the cap")


def run_e2e(dev):
    """Phase 13: the JAX package's end-to-end configuration through
    DiskModel(cfg, "cuda").prepare() then run(n_iter=2) on the bench disk:
    the hydrostatic bootstrap (MC, balance, twice), the initial MC,
    fixed-T chemistry (K1/K2) and the equilibrium T in each iteration, the
    re-balance and AMR after the first, and the MC pass (K3/K4) of the
    second on the refined grid; then the checks of its docstring entry."""
    import tempfile
    from rac2d_torch import checkpoint
    from rac2d_torch.ops import kernels, mcrt
    t_ph = time.time()
    m = bench_disk(dev, n_iter=E2E_ITERS, chem_stream=True, t_max=RUN_T_MAX,
                   chem_chunk=RUN_CHUNK, **E2E_SWITCHES)
    t_prep = time.time() - t_ph
    n_act = int(m.grid.using.sum())
    # the pool sweep's wall budget is chunk_wall_s x windows x nlocal_iter
    # over the cells active when it starts (the bootstrap deactivates
    # most of them): RUN_BUDGET_S for each window of RUN_CHUNK cells
    m.cfg.chunk_wall_s = RUN_BUDGET_S / m.cfg.nlocal_iter
    say(f"phase 13 setup: DiskModel.prepare {t_prep:.2f} s; {m.grid.n_cells} "
        f"cells, {n_act} active; switches {E2E_SWITCHES}, refine_threshold "
        f"{m.cfg.refine_threshold:g}, merge_tol {m.cfg.merge_tol:g}; "
        f"{MC_NPH} packets x {m.cfg.n_mc_passes} MC passes, t_max "
        f"{RUN_T_MAX:g} yr, chem_chunk {RUN_CHUNK}, n_iter {E2E_ITERS}, a "
        f"sweep budget of {RUN_BUDGET_S:g} s a window")
    kernels.reset_launches()
    t0 = time.time()
    m.run(n_iter=E2E_ITERS)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = kernels.launch_counts()
    for ln in m.log:
        if "vertical balance" in ln or "stage timing" in ln \
                or "AMR:" in ln or "equilibrium T:" in ln \
                or "pool sweep:" in ln:
            say(f"phase 13 log: {ln.strip()}")
    say(f"phase 13 run: {wall:.2f} s; stage times " + "; ".join(
        ", ".join(f"{k} {v:.2f} s" for k, v in st.items())
        for st in m.stage_times))
    n_vert = sum("vertical balance:" in ln for ln in m.log)
    if n_vert != m.cfg.n_vert_iter_tdust + E2E_ITERS - 1:
        raise Fail(f"phase 13: {n_vert} vertical passes")
    refined = sum(int(ln.split()[2]) for ln in m.log
                  if "AMR: refining" in ln)
    if not refined:
        raise Fail("phase 13: AMR refined no cell")
    for ip, st in enumerate(m.mc_stats):
        say(f"phase 13 MC pass {ip + 1} ({st['cells'].rmin.shape[0]} "
            f"cells): {st['packets']} packets in {st['wall_s']:.2f} s, "
            f"{st['chunks']} walk chunks ({st['tail_chunks']} with at most "
            f"{mcrt.TAIL_LANES} live lanes), fates {st['fates']}")
    last = m.mc_stats[-1]
    f = last["fates"]
    if last["cells"].rmin.shape[0] != m.grid.n_cells \
            or sum(f.values()) != last["packets"] \
            or f["premature"] + f["active"] > 1e-3 * last["packets"]:
        raise Fail("phase 13: the MC pass on the refined grid")
    finish_live_lanes(m, last, "phase 13")
    say("phase 13 launches during run: " + ", ".join(
        f"{k} {v}" for k, v in launches.items()))
    if min(launches.values()) <= 0:
        raise Fail(f"phase 13: run did not launch every kernel ({launches})")
    check_sane(m, "phase 13")
    t1 = time.time()
    n, bc, bh, same, dT = eq_T_card_vs_cpu(m)
    say(f"phase 13 equilibrium T of {n} cells, card vs CPU: bracketed "
        f"{bc} and {bh}, flags equal {same}; max |dT| / (1e-5 T + 0.1 K) "
        f"{dT:.3e} (tol 1); {time.time() - t1:.1f} s")
    if not same or not dT <= 1.0:
        raise Fail("phase 13: the equilibrium T on the card and the CPU "
                   "differ")
    # K3 and K4 against their plain versions on the refined grid's state
    lam, _, _ = m.packet_pool()
    lanes = min(m.mc_cfg.max_batch, len(lam))
    k3 = check_walk(m, dev, tag="phase 13", nph=None, batch=lanes,
                    warm=False, edges=False)
    k4 = check_fold(**k3, tag="phase 13")
    kern = {key: {"B": lanes, "max_abs_err": r["err"], **{k: r[k] for k in (
        "ms", "device_ms", "host_ms", "plain_ms", "bound_ms")}}
        for key, r in (("K3", k3), ("K4", k4))}
    del k3
    # the refined model's checkpoint in a newly prepared model
    t1 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        checkpoint.save_state(f"{tmp}/ck.npz", m, E2E_ITERS)
        m2 = type(m)(m.cfg, dev)
        m2.prepare()
        it = checkpoint.load_state(f"{tmp}/ck.npz", m2)
    same_hash = checkpoint._grid_hash(m2.grid) == checkpoint._grid_hash(
        m.grid)
    bad = [k for k in checkpoint._GRID_FIELDS
           if not np.array_equal(getattr(m2.grid, k), getattr(m.grid, k))]
    bad += [k for k in ("X", "Tgas", "Tdust", "Tdusts", "quality",
                        "rho_dust")
            if not np.array_equal(getattr(m2, k), getattr(m, k))
            or getattr(m2, k).dtype != getattr(m, k).dtype]
    m2.run_mc(n_passes=1)
    st2 = m2.mc_stats[-1]
    counted = sum(st2["fates"].values()) == st2["packets"]
    say(f"phase 13 checkpoint of the refined model into a new model: iiter "
        f"{it}, grid hash equal {same_hash}, arrays not bit-equal: "
        f"{bad or 'none'}; its run_mc: {st2['packets']} packets, fates "
        f"{st2['fates']}, every packet counted {counted}; "
        f"{time.time() - t1:.1f} s")
    if it != E2E_ITERS or not same_hash or bad or not counted:
        raise Fail("phase 13: the refined model's checkpoint")
    del m2
    # a fixed-grid re-balance of the refined model keeps every column's
    # surface density over the cells active before it (the cell bounds do
    # not move); it changes the model, so it comes last
    g = m.grid
    n0, use = g.n0.copy(), g.using.copy()
    t1 = time.time()
    m.vertical_adjust()
    s0 = column_sigma(g, n0, use)
    s1 = column_sigma(g, g.n0, use)
    ok = s0 > 0
    rel = float((np.abs(s1 - s0)[ok] / s0[ok]).max())
    say(f"phase 13 fixed-grid re-balance of the refined model: "
        f"{time.time() - t1:.3f} s, active cells {int(use.sum())} -> "
        f"{int(g.using.sum())}; max column surface density change "
        f"{rel:.2e} over {int(ok.sum())} columns (tol 1e-12)")
    if not rel <= 1e-12:
        raise Fail("phase 13: a vertical pass changed a column's surface "
                   "density")
    kern["merged"] = merge_step(m, dev)
    t_all = time.time() - t_ph
    say(f"phase 13 done: {t_all:.1f} s (aim <= {E2E_AIM_S:g} s)")
    return launches, kern


def merge_step(m, dev):
    """Phase 13's last step, merging on the card: amr_step on the refined,
    re-balanced model at the smallest merge_tol of MERGE_TOLS that makes
    disjoint uniform pairs (no packed pair is uniform within the default
    1.5), with refinement off (an infinite refine_threshold, so that no
    refine mark keeps a pair from merging), then one MC pass on the merged
    grid (every packet counted, lanes at the step cap walked on), K3/K4
    against their plain versions on it, and its columns, card against CPU,
    within 1e-12.  Fails if nothing merged.  {kernel: its check and times
    on the merged grid}."""
    from rac2d_torch.models import amr
    t0 = time.time()
    av = m.fields.Av_toStar.cpu().numpy()
    counts = {tol: len(amr.disjoint_pairs(amr.need_merge(
        m.grid, m.grid.n0, m.Tdust, av, tol=tol))) for tol in MERGE_TOLS}
    tol = next((t for t in MERGE_TOLS if counts[t]), None)
    say("phase 13 merge: disjoint uniform pairs by merge_tol " + ", ".join(
        f"{t:g}: {n}" for t, n in counts.items()))
    if tol is None:
        raise Fail("phase 13: no merge_tol of MERGE_TOLS merges a pair")
    m.cfg.merge_tol, m.cfg.refine_threshold = tol, np.inf
    n_was, log0 = m.grid.n_cells, len(m.log)
    m.amr_step()
    amr_ln = [ln for ln in m.log[log0:] if "AMR: refining" in ln]
    merged = int(amr_ln[0].split()[5]) if amr_ln else 0
    what = amr_ln[0].strip() if amr_ln else "no change"
    say(f"phase 13 merge: amr_step at merge_tol {tol:g}: {what}; cells "
        f"{n_was} -> {m.grid.n_cells}, {int(m.grid.using.sum())} active; "
        f"{time.time() - t0:.2f} s")
    if not merged:
        raise Fail("phase 13: amr_step merged no pair")
    m.run_mc(n_passes=1, seed=99)
    st = m.mc_stats[-1]
    f = st["fates"]
    say(f"phase 13 merge: MC pass on the merged grid: {st['packets']} "
        f"packets in {st['wall_s']:.2f} s, {st['chunks']} walk chunks, "
        f"fates {f}")
    if st["cells"].rmin.shape[0] != m.grid.n_cells \
            or sum(f.values()) != st["packets"] \
            or f["premature"] + f["active"] > 1e-3 * st["packets"]:
        raise Fail("phase 13: the MC pass on the merged grid")
    finish_live_lanes(m, st, "phase 13 merged")
    lam, _, _ = m.packet_pool()
    lanes = min(m.mc_cfg.max_batch, len(lam))
    k3 = check_walk(m, dev, tag="phase 13 merged", nph=None, batch=lanes,
                    warm=False, edges=False)
    k4 = check_fold(**k3, tag="phase 13 merged")
    check_columns(m, "phase 13 merged")
    say(f"phase 13 merge done: {merged} pairs merged, {time.time() - t0:.1f}"
        " s")
    return {key: {"B": lanes, "pairs": merged, "max_abs_err": r["err"],
                  **{k: r[k] for k in ("ms", "device_ms", "plain_ms",
                                       "bound_ms")}}
            for key, r in (("K3", k3), ("K4", k4))}


# --------------------------------------------------------------------
# the rest of the chemistry solver at full width (phase 14)

# phase 14a: the command line on phase 12c's tables through the chunked
# sweep with every gas-dust exchange mode
CHUNKED_EDITS = [("t_max = 1e-5", "t_max = 1e-4"),
                 ("n_iter = 1", "n_iter = 1\nchem_stream = false")]
EXCHANGE_TABLE = """
[heating_cooling]
allow_gas_dust_en_exch = true
tdust_iter_tandem = true
dust_gas_linear_couple = true
"""
CLI14_TIMEOUT_S = 600
SWEEP_CELLS = 512         # phase 14b: cells of phase 11's model
SWEEP_W = 256             # the pool's width and the chunk (chem_chunk)
SWEEP_CHUNK_WALL_S = 150.0  # chunk_wall_s of both sweeps
RATE_CELLS = 64           # phase 14c: cells whose rates are held card vs CPU
JAC_REPS = 5              # phase 14e: calls timed a side
# phase 14d: the dark-cloud cell of tests/test_single_cell.py
DARK_CLOUD = dict(Tgas=10.0, Tdust=10.0, n_gas=2e4, Av_toISM=10.0,
                  Av_toStar=10.0, G0_UV_toISM=1.0, GrainRadius_CGS=1e-5,
                  sigdust_ave=np.pi * 1e-10, ndust_tot=D2G * 2e4,
                  ratioDust2HnucNum=D2G,
                  SitesPerGrain=4 * np.pi * 1e-10 * 1e15)
DARK_T_MAX = 1e2
PHASE14_AIM_S = 300.0


def check_cli_chunked(dev):
    """Phase 14a: python -m rac2d_torch (no --device) on phase 12c's TOML
    with chem_stream = false (one chunk of 256 lanes: 183 cells padded)
    and [heating_cooling] with the three exchange flags, --iters 1: exit
    0, every output file, the chunk lines and K1-K4 in its log, then the
    saved state (its checkpoint, in a newly prepared model) held to phase
    11's physical bars.  (wall seconds, {kernel: launches})."""
    import pathlib
    import re
    import tempfile
    from rac2d_torch import checkpoint, config
    from rac2d_torch.models import driver
    with tempfile.TemporaryDirectory() as tmp:
        toml = pathlib.Path(tmp) / "model.toml"
        cli_toml(toml)
        text = toml.read_text()
        for old, new in CHUNKED_EDITS:
            if text.count(old) != 1:
                raise Fail(f"phase 14a: '{old}' is not in the TOML once")
            text = text.replace(old, new)
        toml.write_text(text + EXCHANGE_TABLE)
        out = pathlib.Path(tmp) / "run"
        wall, log = run_cli(out, toml, "--iters", "1",
                            timeout=CLI14_TIMEOUT_S, tag="phase 14a")
        counts = log_launches(log)
        ok, what, _ = check_cli_outputs(out, log, True)
        chunks = [ln for ln in log.splitlines()
                  if re.match(r"\s*chunk \d+ \(level \d+\)", ln)]
        pools = [ln for ln in log.splitlines() if "pool sweep:" in ln]
        say(f"phase 14a python -m rac2d_torch --iters 1, chunked sweep with "
            f"the exchange modes: {wall:.1f} s, exit 0; {what}; "
            f"{len(chunks)} chunk lines, {len(pools)} pool lines; kernel "
            f"launches in its log: {counts}")
        if not ok or not chunks or pools or len(counts) != 4 \
                or min(counts.values()) <= 0:
            raise Fail("phase 14a: the command line's outputs, chunk lines "
                       "or launches")
        m = driver.DiskModel(config.load_config(str(toml)), dev)
        m.prepare()
        checkpoint.load_state(str(out / "checkpoint.npz"), m)
        if m.thermal.tdust_lut is None or m.cfg.chem_stream:
            raise Fail("phase 14a: the model did not take the TOML's modes")
        check_physical(m, "phase 14a")
    return wall, counts


def pick_cells(m, n, seed):
    """n of the model's active cells (numpy seed), ordered by density as
    chemistry_step orders a sweep's cells (its expression, on the same
    sorted indices: phase 15b's chemistry_step on these cells alone
    takes them in this order)."""
    act = np.nonzero(m.grid.using)[0]
    sel = np.sort(np.random.default_rng(seed).choice(act, n, replace=False))
    return sel[np.argsort(m.grid.n0[sel])]


class Deterministic:
    """A block in which CUDA's scatter sums run in a fixed order
    (torch.use_deterministic_algorithms, warn-only; index_add_ in the
    right-hand side and the Jacobian, and in the column products, is
    otherwise an atomic f64 sum whose order changes from run to run, and
    with it a step decision now and then: two runs of the same chunked
    sweep then differ by about the 1e-4 rtol, 5.0e-4 once on an H100
    80GB HBM3).  Uninitialized memory is not filled.  Records the
    distinct warn-only notices (ops that have no fixed-order variant) in
    .notices."""

    def __enter__(self):
        import warnings
        import torch.utils.deterministic as tud
        self.prev = (torch.are_deterministic_algorithms_enabled(),
                     torch.is_deterministic_algorithms_warn_only_enabled(),
                     tud.fill_uninitialized_memory)
        torch.use_deterministic_algorithms(True, warn_only=True)
        tud.fill_uninitialized_memory = False
        self.rec = warnings.catch_warnings(record=True)
        self.caught = self.rec.__enter__()
        warnings.simplefilter("always")
        return self

    def __exit__(self, *exc):
        import torch.utils.deterministic as tud
        self.rec.__exit__(*exc)
        self.notices = sorted({str(w.message).splitlines()[0][:120]
                               for w in self.caught})
        torch.use_deterministic_algorithms(self.prev[0],
                                           warn_only=self.prev[1])
        tud.fill_uninitialized_memory = self.prev[2]
        return False


def run_sweep(m, name, cells, touts, fixed_order=False):
    """One sweep of `cells` on the model from its present X and Tgas,
    with fixed_order in a Deterministic block: {the cells' X and Tgas
    after it, failed mask, wall s, BDF rounds, K1/K2 launches}."""
    import contextlib
    from rac2d_torch.ops import kernels
    sweep = m._pool_sweep if name == "pool" else m._chunked_sweep
    kernels.reset_launches()
    t0 = time.time()
    with Deterministic() if fixed_order else contextlib.nullcontext():
        pending = sweep(cells, touts)
        torch.cuda.synchronize()
    wall = time.time() - t0
    lc = kernels.launch_counts()
    rounds = m.pool_result.n_rounds if name == "pool" else m.chunk_rounds
    return dict(X=m.X[:, cells].copy(), Tgas=m.Tgas[cells].copy(),
                failed=np.isin(cells, pending), wall=wall, rounds=rounds,
                K1=lc["K1"], K2=lc["K2"])


def say_sweep(tag, r, n):
    say(f"{tag}: {n} cells, {r['rounds']} BDF rounds, {r['wall']:.2f} s, "
        f"{1e3 * r['wall'] / max(r['rounds'], 1):.1f} ms/round, "
        f"{int(r['failed'].sum())} failed; launches K1 {r['K1']}, K2 "
        f"{r['K2']} ({r['K1'] / max(r['rounds'], 1):.3f} and "
        f"{r['K2'] / max(r['rounds'], 1):.3f} a round)")


def compare_sweeps(m):
    """Phase 14b on phase 11's model after its run: SWEEP_CELLS active
    cells (seed 0) solved twice from one snapshot of X and Tgas, evolT,
    to phase 11's t_max (MAIN_T_MAX), exchange off, both in a fixed
    summation order (so that their difference is the window structure's
    alone, not CUDA's atomic sums): (i) the pool sweep at width SWEEP_W,
    (ii) the chunked sweep in chunks of SWEEP_W.  Each held to phase 11's
    physical bars; then the worst and median key-species difference
    between them over the cells clean in both (no bar: a measurement).
    Returns
    (the pool's result, the chunked one's, the cells, the snapshot)."""
    from rac2d_torch.ops import bdf
    t_ph = time.time()
    cfg = m.cfg
    cells = pick_cells(m, SWEEP_CELLS, 0)
    X0, T0 = m.X.copy(), m.Tgas.copy()
    cfg.chem_chunk, cfg.chunk_wall_s = SWEEP_W, SWEEP_CHUNK_WALL_S
    touts = bdf.log_output_times(cfg.dt_first, cfg.t_max, cfg.ratio_tstep)
    # in a fixed order too: phase 15b's chemistry_step computes them again
    with Deterministic():
        m.prepare_sweep_fields()
    say(f"phase 14b setup: {len(cells)} of {int(m.grid.using.sum())} active "
        f"cells (seed 0), {len(touts)} output times to {cfg.t_max:g} yr, "
        f"width/chunk {SWEEP_W}, chunk_wall_s {SWEEP_CHUNK_WALL_S:g} s")
    out = {}
    for name in ("pool", "chunked"):
        m.X, m.Tgas = X0.copy(), T0.copy()
        r = out[name] = run_sweep(m, name, cells, touts, fixed_order=True)
        say_sweep(f"phase 14b ({'i' if name == 'pool' else 'ii'}) {name} "
                  "sweep", r, len(cells))
        if min(r["K1"], r["K2"]) <= 0:
            raise Fail(f"phase 14b: the {name} sweep launched no K1/K2")
        check_bars(m, cells, r["failed"], ~r["failed"], f"phase 14b {name}")
    a, b = out["pool"], out["chunked"]
    clean = ~a["failed"] & ~b["failed"]
    ki = m.net.key_species_idx
    xa, xb = a["X"][ki][:, clean], b["X"][ki][:, clean]
    big = np.maximum(np.abs(xa), np.abs(xb)) > 1e-12
    rel = np.where(big, np.abs(xa - xb)
                   / np.maximum(np.maximum(np.abs(xa), np.abs(xb)), 1e-300),
                   0.0).max(axis=0)
    dT = np.abs(a["Tgas"][clean] / b["Tgas"][clean] - 1)
    say(f"phase 14b pool vs chunked over {int(clean.sum())} cells clean in "
        f"both: key-species rel diff (entries above 1e-12) worst "
        f"{rel.max():.3e}, median {np.median(rel):.3e}, cells above 1% "
        f"{int((rel > 0.01).sum())}, above 5% {int((rel > 0.05).sum())}; "
        f"Tgas rel diff worst {dT.max():.3e}, median {np.median(dT):.3e}; "
        f"chunked/pool rounds {b['rounds'] / max(a['rounds'], 1):.2f}, "
        f"wall {b['wall'] / a['wall']:.2f}")
    say(f"phase 14b done: {time.time() - t_ph:.1f} s")
    return a, b, cells, (X0, T0)


def kernel_launches(fn):
    """CUDA kernel launches of one fn() call, counted by torch.profiler
    (None if the profiler records none)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages()
            if e.key.startswith("cudaLaunchKernel"))
    return n or None


def exchange_window(m, dev, pool, cells, snap):
    """Phase 14c: SWEEP_W of phase 14b's cells (seed 1) in one window of
    the pool sweep, from the same snapshot, with the model's
    ThermalBalance rebuilt with the Tdust LUT and all three exchange modes
    on, as prepare does: ms/round and K1/K2 launches a round against
    14b (i), and the CUDA kernels one RHS and one Jacobian evaluation
    launch on that window with the modes off and on; phase 11's physical
    bars; every HeatingCoolingRates field of RATE_CELLS of the cells, card
    against CPU from the same inputs, within 1e-9 relative (absolute floor
    1e-40).  Returns the K1/K2 launches."""
    from rac2d_torch.ops import bdf, odesys, rates, thermal
    from rac2d_torch.utils.tree import tree_map
    t_ph = time.time()
    cfg = m.cfg
    sub = np.random.default_rng(1).choice(len(cells), SWEEP_W,
                                          replace=False)
    win = cells[np.sort(sub)]
    X0, T0 = snap
    touts = bdf.log_output_times(cfg.dt_first, cfg.t_max, cfg.ratio_tstep)
    off = m.ode
    cfg.hc = thermal.HcConfig(allow_gas_dust_en_exch=True,
                              tdust_iter_tandem=True,
                              dust_gas_linear_couple=True)
    lut = (m.tab.lut_Tds, m.tab.lut_vals)
    m.thermal = thermal.ThermalBalance(m.net, cfg.hc, device=dev,
                                       tdust_lut=lut)
    m.ode = odesys.ChemicalODE(m.net, thermal=m.thermal, device=dev)
    m.X, m.Tgas = X0.copy(), T0.copy()
    r = run_sweep(m, "pool", win, touts, fixed_order=True)
    say_sweep("phase 14c pool sweep with the exchange modes", r, len(win))
    say(f"phase 14c against 14b (i), the same width: ms/round "
        f"{1e3 * r['wall'] / r['rounds']:.1f} vs "
        f"{1e3 * pool['wall'] / pool['rounds']:.1f} "
        f"({r['wall'] / r['rounds'] / (pool['wall'] / pool['rounds']):.2f}"
        f"x); K1+K2 launches a round "
        f"{(r['K1'] + r['K2']) / r['rounds']:.3f} vs "
        f"{(pool['K1'] + pool['K2']) / pool['rounds']:.3f}")
    if min(r["K1"], r["K2"]) <= 0:
        raise Fail("phase 14c: the sweep launched no K1/K2")
    # the kernels an RHS and a Jacobian evaluation launch, modes off / on
    env, tenv = m.assemble_envs(win)
    y = m._t(np.concatenate([m.X[:, win].T, m.Tgas[win][:, None]], axis=1))
    counts = {}
    for name, ode in (("off", off), ("on", m.ode)):
        # the eager closures: the solvers' f_b and jac_b replay them as
        # CUDA graphs
        f = ode.make_f(env, True, tenv)
        jac = ode.make_jac(env, True, tenv)
        try:
            counts[name] = (kernel_launches(lambda: f(y)),
                            kernel_launches(lambda: jac(y)))
        except Exception as e:          # noqa: BLE001 (reported, no check)
            counts[name] = (f"not measured ({type(e).__name__})",) * 2
    say(f"phase 14c CUDA kernels launched by one RHS / one Jacobian "
        f"evaluation at {len(win)} lanes (torch.profiler): modes off "
        f"{counts['off'][0]} / {counts['off'][1]}, on {counts['on'][0]} / "
        f"{counts['on'][1]}")
    check_bars(m, win, r["failed"], ~r["failed"], "phase 14c")
    # every rate of RATE_CELLS cells, card against CPU, from the same
    # inputs (the state after the sweep)
    t0 = time.time()
    few = win[:RATE_CELLS]
    env, tenv = m.assemble_envs(few)
    y = m._t(np.concatenate([m.X[:, few].T, m.Tgas[few][:, None]], axis=1))
    nS = m.net.n_species
    T = y[:, nS]
    r_card = m.thermal.rates(y, T, env, tenv,
                             rates.compute_rates(m.ode.tab, env, T))

    def cpu(a):
        return a.cpu()
    th_cpu = thermal.ThermalBalance(m.net, cfg.hc, device="cpu",
                                    tdust_lut=lut)
    env_c, tenv_c = tree_map(cpu, env), tree_map(cpu, tenv)
    tab_c = rates.build_rate_tables(m.net, "cpu")
    r_cpu = th_cpu.rates(y.cpu(), T.cpu(), env_c, tenv_c,
                         rates.compute_rates(tab_c, env_c, T.cpu()))
    worst = {}
    for name in r_card._fields:
        a = getattr(r_card, name).cpu()
        b = getattr(r_cpu, name)
        worst[name] = float(((a - b).abs() / (1e-9 * b.abs() + 1e-40)).max())
    bad = {k: v for k, v in worst.items() if not v <= 1.0}
    say(f"phase 14c rates of {len(few)} cells with the exchange modes, card "
        f"vs CPU: max |d| / (1e-9 |cpu| + 1e-40) over {len(worst)} fields "
        f"{max(worst.values()):.3e} (tol 1; worst field "
        f"{max(worst, key=worst.get)}); {time.time() - t0:.1f} s")
    if bad:
        raise Fail(f"phase 14c: rates on the card differ from the CPU's: "
                   f"{bad}")
    m.ode, m.thermal, cfg.hc = off, off.thermal, thermal.HcConfig()
    say(f"phase 14c done: {time.time() - t_ph:.1f} s")
    return r["K1"], r["K2"]


def jac_probe(dev, width=W, reps=JAC_REPS):
    """Phase 14e: one Jacobian refresh of the coupled system (evolT) at
    `width` lanes of bench_cells' recipe in their initial abundances,
    eager (ChemicalODE.make_jac's closure) against its CUDA graph
    (_batch_fns's jac_b, captured at its first call): the mean host ms to
    enqueue a call and the mean ms of a call by CUDA events.  The graph's
    calls are queued behind a spin that outlasts the host (queued_ms), so
    their event time is the device's alone; the eager closure's 4600
    launches a call overfill CUDA's launch queue behind any spin, so its
    event time is taken without one (cuda_ms) and is the host's pace
    wherever that is the slower.  Also the capture's seconds, and the
    graphed J's species block and key-species T row within 1e-12 relative
    of the eager one over their non-zero entries; of the FD T column,
    which CUDA's atomic sums keep an eager call from reproducing itself,
    the largest gap over its lane's largest entry is printed.
    Returns {"eager": (device ms, host ms), "graph": (...), "capture_s"}.
    Runs alone as
    python3 -c 'import chip_smoke as c, torch; c.jac_probe(torch.device("cuda"))'."""
    from rac2d_torch import defaults
    from rac2d_torch.io import umist
    from rac2d_torch.ops import odesys
    from rac2d_torch.ops.thermal import ThermalBalance
    net = umist.load_network(defaults.NETWORK,
                             enthalpy_path=defaults.ENTHALPIES)
    y0 = umist.load_initial_abundances(net, defaults.INIT_ABUNDANCES)
    envs, tenvs, Tg = bench_cells(width, 0, dev)
    y = torch.as_tensor(np.concatenate(
        [np.tile(y0, (width, 1)), Tg[:, None]], axis=1), device=dev)
    ode = odesys.ChemicalODE(net, thermal=ThermalBalance(net, device=dev),
                             device=dev)
    jac = ode.make_jac(envs, True, tenvs)
    _, jac_b, _ = ode._batch_fns(True)
    args = (envs, tenvs, None)
    ref = jac(y)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = jac_b(y, args)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    nS, ki = ode.n_species, ode.key_idx
    err = max(rel_nonzero(out[:, :nS, :nS], ref[:, :nS, :nS]),
              rel_nonzero(out[:, nS, ki], ref[:, nS, ki]))
    if not err <= 1e-12:
        raise Fail(f"phase 14e: the graphed Jacobian differs from the "
                   f"eager one by {err:.3e} relative")
    col = float(((out[:, :, nS] - ref[:, :, nS]).abs().amax(1)
                 / ref[:, :, nS].abs().amax(1)).max())
    del out, ref

    def eager_call():
        jac(y)
    res = {"capture_s": capture_s,
           "eager": (cuda_ms(eager_call, reps), host_ms(eager_call, reps)),
           "graph": queued_ms([lambda: jac_b(y, args)] * reps)}
    say(f"phase 14e one coupled Jacobian refresh at {width} lanes, mean of "
        f"{reps}: eager host {res['eager'][1]:.3f} ms, events "
        f"{res['eager'][0]:.3f} ms; graph host {res['graph'][1]:.3f} ms, "
        f"device {res['graph'][0]:.3f} ms; capture {capture_s:.2f} s; "
        f"graph vs eager {err:.3e} relative (species block, T row), T "
        f"column {col:.3e} of its lane's largest")
    return res


def rel_nonzero(a, b):
    """The largest |a - b| / |b| over the entries where b is not 0 (inf
    where the two differ in which entries are 0)."""
    nz = b != 0.0
    if not torch.equal(a != 0.0, nz):
        return float("inf")
    return float(((a - b).abs()[nz] / b.abs()[nz]).max())


def other_drivers(dev, phase5_states):
    """Phase 14d: ChemicalODE.solve (the single-system solver) on the
    dark-cloud cell of tests/test_single_cell.py to DARK_T_MAX yr, on the
    card and on the CPU (both complete, key species within 1% above
    1e-12: cuSOLVER's f32 factor is not LAPACK's); then
    solve_batched(continuous=True, retry_tols=...) on phase 5's three
    COUPLED_CELLS to T_MAX, within phase 6's 5% of phase 5's final states
    of the same cells.  Returns the K1/K2 launches of the second."""
    from rac2d_torch import defaults
    from rac2d_torch.io import umist
    from rac2d_torch.ops import bdf, kernels, odesys
    from rac2d_torch.ops.rates import CellEnv
    from rac2d_torch.ops.thermal import ThermalBalance
    t_ph = time.time()
    net = umist.load_network(defaults.NETWORK,
                             enthalpy_path=defaults.ENTHALPIES)
    y0 = umist.load_initial_abundances(net, defaults.INIT_ABUNDANCES)
    ki = net.key_species_idx
    touts = bdf.log_output_times(1e-8, DARK_T_MAX, 1.3)
    res = []
    for d in (dev, torch.device("cpu")):
        ode = odesys.ChemicalODE(net, device=d)
        rtol, atol = odesys.tolerance_ladder(net, 1, RTOL0, ATOL0, D2G, d)
        t0 = time.time()
        r = ode.solve(CellEnv.default(d, **DARK_CLOUD), y0, 10.0, touts,
                      rtol, atol, first_step=1e-8)
        res.append(r)
        say(f"phase 14d ChemicalODE.solve, dark cloud to {DARK_T_MAX:g} yr "
            f"on the {d.type}: {time.time() - t0:.2f} s, fail "
            f"{bool(r.fail)}, t_final {float(r.t_final):g}, "
            f"{int(r.n_steps)} steps, {int(r.n_lu)} LUs, "
            f"{int(r.n_jeval)} Jacobians")
    rc, rh = res
    a, b = rc.ys[-1].cpu().numpy()[ki], rh.ys[-1].numpy()[ki]
    big = np.abs(b) > 1e-12
    rel = float((np.abs(a - b)[big] / np.abs(b[big])).max())
    say(f"phase 14d dark cloud card vs CPU: key species rel diff {rel:.3e} "
        f"(tol 1e-2, entries above 1e-12)")
    if bool(rc.fail) or bool(rh.fail) \
            or float(rc.t_final) < DARK_T_MAX * (1 - 1e-12) or not rel < 0.01:
        raise Fail("phase 14d: the single-cell solve")
    # the continuous driver with the ladder on the COUPLED_CELLS
    ode = odesys.ChemicalODE(net, thermal=ThermalBalance(net, device=dev),
                             device=dev)
    envs, tenvs, T0 = coupled_cells(dev)
    rtol, atol = odesys.tolerance_ladder(net, 1, RTOL0, ATOL0, D2G, dev)
    touts = bdf.log_output_times(1e-8, T_MAX, 1.5)
    kernels.reset_launches()
    t0 = time.time()
    r = ode.solve_batched(
        envs, torch.as_tensor(np.tile(y0, (3, 1)), device=dev),
        torch.as_tensor(T0, device=dev), touts, rtol, atol,
        first_step=1e-8, evolT=True, tenvs=tenvs,
        max_steps_per_interval=500, continuous=True,
        retry_tols=ode.retry_ladder(3, RTOL0, ATOL0, D2G))
    torch.cuda.synchronize()
    wall = time.time() - t0
    lc = kernels.launch_counts()
    yf, fail5 = phase5_states
    yc = r.ys[:, -1].numpy()
    worst = 0.0
    for i in range(3):
        big = np.abs(yf[i, ki]) > 1e-12
        worst = max(worst, float((np.abs(yc[i, ki] - yf[i, ki])[big]
                                  / np.abs(yf[i, ki])[big]).max()))
    say(f"phase 14d solve_batched(continuous=True, retry_tols) on the 3 "
        f"COUPLED_CELLS to {T_MAX:g} yr: {wall:.1f} s, {r.n_rounds} BDF "
        f"rounds, failed {r.fail.numpy().tolist()}, ladder levels "
        f"{r.retry_level.numpy().tolist()}, launches K1 {lc['K1']}, K2 "
        f"{lc['K2']}; key species vs phase 5's final states: worst rel diff "
        f"{worst:.3e} (tol 5e-2)")
    if bool(r.fail.any()) or fail5.any() or not worst < 0.05 \
            or min(lc["K1"], lc["K2"]) <= 0:
        raise Fail("phase 14d: the continuous driver")
    say(f"phase 14d done: {time.time() - t_ph:.1f} s")
    return lc["K1"], lc["K2"]


# --------------------------------------------------------------------
# the last modules of the port (phase 15): the inv backend, the sharded
# path, distributed checkpoints and postprocess

PHASE15_AIM_S = 150.0
INV_N = 485               # phase 15a: Newton systems of the main path
SHARD_SEED = 15           # phase 15b: run_mc's seed (its pass key 15000)
SHARD_RANKS = 2           # phase 15b: processes on the one card (gloo)
SHARD_TIMEOUT_S = 300     # phase 15b: the processes' join deadline


def free_port():
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def invert_work(B, n, N):
    """(flop, bytes) of inverting an n x n matrix from its LU: LAPACK
    getri's 4/3 n^3 flop; lu, linv and uinv read once, the [N, N] inverse
    written once."""
    return B * 4 * n ** 3 // 3, B * 4 * (2 * N * N + 2 * N * 64)


def apply_work(B, n, N):
    """(flop, bytes) of one inverse apply: the [B, N, N] f32 inverse read
    once (one FMA an entry), b read and x written."""
    return B * 2 * N * N, B * 4 * (N * N + 2 * n)


def newton_systems(B, n, seed, device):
    """f64 Newton systems (I - c J) x = b of tests/test_blocklu.py's
    inv-backend case at [B, n]: J ~ N(0, 1/n), c = 0.02 n / 70 (the JAX
    test's c J spread at n = 70), error weights 1 + U(0, 1)."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)
    J = t(rng.standard_normal((B, n, n)) / np.sqrt(n))
    c = t(np.full(B, 0.02 * np.sqrt(n / 70.0)))
    scale = t(1.0 + rng.uniform(0, 1, (B, n)))
    b = t(rng.standard_normal((B, n)))
    return J, c, scale, b


def check_inv(dev):
    """Phase 15a at both main-path shapes: K1 then block_invert, A @ inv(A)
    against I in f64, the inverse apply against K2, _bsolve on "inv"
    against "kernel" and against a f64 direct solve (2 refinements, as
    tests/test_blocklu.py), and the times of block_invert, of one apply
    beside K2's, with their bounds.  Returns {B: numbers}."""
    from rac2d_torch.ops import bdf, blocklu, kernels
    out = {}
    for B in (RUN_CHUNK, W):
        n = INV_N
        A, b = newton_matrices(B, n, 0, dev)
        fac = kernels.block_lu_factor(A)
        Ainv = blocklu.block_invert(fac)
        N = Ainv.shape[-1]
        eye = torch.eye(n, dtype=torch.float64, device=dev)
        err_I = float((torch.matmul(A.double(), Ainv[:, :n, :n].double())
                       - eye).abs().amax())
        x_inv = blocklu.inverse_apply(Ainv, b)
        x_k2 = kernels.block_lu_solve(fac, b)
        d_x = rel_per_lane(x_inv, x_k2)
        del A
        t_inv = [cuda_ms(lambda: blocklu.block_invert(fac), 3)
                 for _ in range(2)]
        t_app, t_k2 = [], []
        for _ in range(2):
            t_app.append(cuda_ms(lambda: blocklu.inverse_apply(Ainv, b), 50))
            t_k2.append(cuda_ms(lambda: kernels.block_lu_solve(fac, b), 50))
        del fac, Ainv
        torch.cuda.empty_cache()
        J, c, scale, rhs = newton_systems(B, n, 10, dev)
        xs = {}
        for backend in ("kernel", "inv"):
            f = bdf._bfac(J, c, scale, backend)
            xs[backend] = bdf._bsolve(J, c, f, rhs, 2, backend)
            del f
        eye = torch.eye(n, dtype=torch.float64, device=dev)
        ref = torch.linalg.solve(eye[None] - c[:, None, None] * J, rhs)
        del J
        torch.cuda.empty_cache()
        bar = 1e-8 * float(xs["kernel"].abs().max()) + 1e-10
        d_b = float((xs["inv"] - xs["kernel"]).abs().max())
        d_ref = {k: float((v - ref).abs().max()) for k, v in xs.items()}
        bar_ref = 1e-8 * float(ref.abs().max()) + 1e-10
        bi, bi_by = bound(*invert_work(B, n, N))
        ba, ba_by = bound(*apply_work(B, n, N))
        bk2, _ = bound(*k2_work(B, n, N))
        r = dict(err_I=err_I, d_x=d_x, invert_ms=float(np.mean(t_inv)),
                 invert_bound_ms=bi, invert_bound_by=bi_by,
                 apply_ms=float(np.mean(t_app)), apply_bound_ms=ba,
                 apply_bound_by=ba_by, k2_ms=float(np.mean(t_k2)),
                 bsolve_diff=d_b)
        out[B] = r
        say(f"phase 15a B={B} n={n} N={N}: K1 then block_invert "
            + "/".join(f"{v:.3f}" for v in t_inv) + f" ms (bound {bi:.3f} "
            f"ms by {bi_by}: getri's 4/3 n^3 flop); max |A inv(A) - I| "
            f"{err_I:.3e} (f32 factor, no bar); inverse apply "
            + "/".join(f"{v:.4f}" for v in t_app) + " ms against K2 "
            + "/".join(f"{v:.4f}" for v in t_k2) + f" ms (bounds by bytes: "
            f"the apply {ba:.4f} ms, the [B, N, N] inverse read once, at "
            f"{ba / r['apply_ms']:.1%}; K2 {bk2:.4f} ms at "
            f"{bk2 / r['k2_ms']:.1%}); apply vs K2 max rel per lane "
            f"{d_x:.2e}")
        say(f"phase 15a B={B}: _bsolve (2 refinements) inv vs kernel max "
            f"|d| {d_b:.3e} (tol {bar:.3e} = 1e-8 max|x| + 1e-10); vs a "
            f"f64 direct solve: kernel {d_ref['kernel']:.3e}, inv "
            f"{d_ref['inv']:.3e} (tol {bar_ref:.3e})")
        if not (d_b <= bar and max(d_ref.values()) <= bar_ref):
            raise Fail(f"phase 15a: the inv backend's solve at B={B}")
    return out


INV_CELLS = 64            # phase 15a: cells of the inv-backend pool sweeps
INV_T_MAX = 1e-6          # yr, their t_max (a short sweep)


def inv_sweep(m, cells, snap, touts):
    """Phase 15a's short pool sweeps: INV_CELLS of phase 14b's cells in
    one window from its snapshot to the output times touts (INV_T_MAX),
    with RAC2D_LU_BACKEND (the user's switch) "kernel", "inv", "kernel" in
    turns: rounds, ms/round (kernel's the mean of its two), K1/K2
    launches; the same failed cells and key species within phase 6's 5%
    (Tgas 2%)."""
    import os
    win = cells[::len(cells) // INV_CELLS][:INV_CELLS]
    X0, T0 = snap
    out = {}
    old = os.environ.get("RAC2D_LU_BACKEND")
    try:
        for i, backend in enumerate(("kernel", "inv", "kernel")):
            os.environ["RAC2D_LU_BACKEND"] = backend
            m.X, m.Tgas = X0.copy(), T0.copy()
            r = run_sweep(m, "pool", win, touts)
            say_sweep(f"phase 15a pool sweep on {backend!r} ({i + 1}/3)", r,
                      len(win))
            if backend in out:
                r["wall"] = 0.5 * (r["wall"] + out[backend]["wall"])
            out[backend] = r
    finally:
        if old is None:
            os.environ.pop("RAC2D_LU_BACKEND", None)
        else:
            os.environ["RAC2D_LU_BACKEND"] = old
    a, b = out["inv"], out["kernel"]
    ki = m.net.key_species_idx
    clean = ~a["failed"] & ~b["failed"]
    xa, xb = a["X"][ki][:, clean], b["X"][ki][:, clean]
    big = np.abs(xb) > 1e-12
    rel = float((np.abs(xa - xb)[big] / np.abs(xb[big])).max())
    dT = float(np.abs(a["Tgas"][clean] / b["Tgas"][clean] - 1).max())
    ms = {k: 1e3 * v["wall"] / max(v["rounds"], 1) for k, v in out.items()}
    say(f"phase 15a inv against kernel: {ms['inv']:.1f} vs "
        f"{ms['kernel']:.1f} ms/round ({ms['inv'] / ms['kernel']:.2f}x); "
        f"failed {int(a['failed'].sum())} vs {int(b['failed'].sum())}; "
        f"key species worst rel diff {rel:.3e} (tol 5e-2), Tgas "
        f"{dT:.3e} (tol 2e-2)")
    if (a["failed"] != b["failed"]).any() or not (rel < 0.05 and dT < 0.02) \
            or a["K1"] <= 0:
        raise Fail("phase 15a: the pool sweep on inv")
    return out


def tallies_host(tall):
    return {f: getattr(tall, f).double().cpu().numpy() for f in tall._fields}


def own_pass(m, key, rank, n_ranks, cells, nph):
    """This rank's block of the pass's pool of nph packets walked alone
    through `cells` with its own generator (no collective), in the units
    of DiskModel.mc_pass."""
    from rac2d_torch.models import driver
    from rac2d_torch.ops import mcrt
    from rac2d_torch.parallel import mesh
    lam, en, scale = m.packet_pool(nph)
    pad = -len(lam) % n_ranks
    lam = np.concatenate([lam, np.full(pad, lam[-1])])
    en = np.concatenate([en, np.zeros(pad)])
    per = len(lam) // n_ranks
    model = mcrt.McModel(tab=m.tab, gi=m.gi, cells=cells,
                         star_mass=m.cfg.star_mass)
    gen = torch.Generator(device=m.device).manual_seed(
        mesh.rank_seed(key, rank, n_ranks))
    tall = mcrt.McTallies.zeros(m.grid.n_cells, len(m.tab.lam), m.n_dust, 5,
                                device=m.device)
    _, tall, fates = mcrt.mc_pass_streamed(
        model, gen, lam[rank * per:(rank + 1) * per],
        en[rank * per:(rank + 1) * per], 0.0, m.cfg.maxw, tall,
        **m.pass_kw())
    out = tallies_host(tall)
    for f in driver.ENERGY_TALLIES:
        out[f] = out[f] * scale
    return out, fates


def sum_check(total, parts, tag):
    """The sharded pass's tallies against the sum of the ranks' own
    passes: the largest |d| over a channel's largest entry."""
    worst = {}
    for f, v in total.items():
        want = sum(p[f] for p in parts)
        worst[f] = float(np.abs(v - want).max()
                         / max(np.abs(want).max(), 1e-300))
    w = max(worst.values())
    say(f"{tag}: sharded tallies vs the sum of the ranks' own passes, max "
        f"|d| / channel max {w:.2e} (tol 1e-5; worst "
        f"{max(worst, key=worst.get)})")
    return w


def sweep_diff(X, Tg, ref, tag):
    """The sweep's X and Tgas of the cells against phase 14b's chunked
    sweep `ref` (both in a fixed summation order): entries beyond rtol
    1e-8 (atol 1e-25), worst relative difference."""
    a = np.concatenate([X.ravel(), Tg])
    b = np.concatenate([ref["X"].ravel(), ref["Tgas"]])
    over = np.abs(a - b) > 1e-8 * np.abs(b) + 1e-25
    big = np.abs(b) > 1e-25
    rel = float((np.abs(a - b)[big] / np.abs(b[big])).max())
    say(f"{tag} against phase 14b's: worst rel diff {rel:.3e}, "
        f"{int(over.sum())} of {len(a)} entries beyond rtol 1e-8 (atol "
        f"1e-25)")
    return int(over.sum()), rel


def shard_one_rank(m, cells, snap, ref, tmp):
    """Phase 15b (i) and 15c in a process group of one rank (NCCL,
    cuda:0) with the model's sharded branches switched on (m.group) and
    shard_chemistry set, through the model's entry points: chemistry_step
    on phase 14b's cells alone (the grid's other cells inactive for it)
    from its snapshot, in a Deterministic block: the chunked sweep with
    its chunks through sharded_chemistry_solve, X, Tgas and the failed
    cells broadcast after it; then run_mc(n_passes=1): the pass sharded,
    its fields broadcast.  K1-K4 counted over both.  The sweep is held to
    phase 14b's chunked sweep `ref` at 1e-8 with the same failed cells,
    the pass to this rank's own pass within 1e-5 of each channel's
    largest entry with the fates equal; then save_state_dist /
    load_state_dist of the model, bit-equal (15c)."""
    import torch.distributed as dist
    from rac2d_torch import checkpoint
    from rac2d_torch.ops import kernels
    from rac2d_torch.parallel import mesh
    mesh.init_distributed(f"127.0.0.1:{free_port()}", 1, 0)
    cfg, grid = m.cfg, m.grid
    using, shard = grid.using, cfg.shard_chemistry
    try:
        say(f"phase 15b (i) one rank: backend {dist.get_backend()}, "
            f"device {mesh.collective_device()}")
        m.group = dist.group.WORLD
        cfg.shard_chemistry = True
        X0, T0 = snap
        m.X, m.Tgas = X0.copy(), T0.copy()
        q0 = m.quality.copy()
        grid.using = np.zeros_like(using)
        grid.using[cells] = True
        kernels.reset_launches()
        t0 = time.time()
        with Deterministic():
            m.chemistry_step(iiter=2)
            torch.cuda.synchronize()
        t_sw = time.time() - t0
        grid.using = using
        failed = m.quality[cells] - q0[cells] >= 512
        cells_mc = m.mc_cells()
        t0 = time.time()
        m.run_mc(n_passes=1, seed=SHARD_SEED)
        t_mc = time.time() - t0
        launches = kernels.launch_counts()
        st = m.mc_stats[-1]
        say(f"phase 15b (i) chemistry_step of {len(cells)} cells (the "
            f"sharded chunked sweep): {t_sw:.2f} s, {m.chunk_rounds} BDF "
            f"rounds, {int(failed.sum())} failed; run_mc(n_passes=1): "
            f"{st['packets']} packets in {t_mc:.2f} s, {st['chunks']} "
            f"chunks, fates {m.mc_counts}; launches over both {launches}")
        if min(launches.values()) <= 0:
            raise Fail(f"phase 15b: the sharded path launched {launches}")
        n_over, rel = sweep_diff(m.X[:, cells], m.Tgas[cells], ref,
                                 "phase 15b (i) sharded chunked sweep")
        if n_over or not np.array_equal(failed, ref["failed"]):
            raise Fail("phase 15b: the one-rank sharded sweep differs from "
                       "the one-process sweep")
        own, own_fates = own_pass(m, SHARD_SEED * 1000, 0, 1, cells_mc,
                                  MC_NPH)
        w = sum_check(tallies_host(m.tallies), [own], "phase 15b (i)")
        if not (w <= 1e-5 and own_fates == m.mc_counts):
            raise Fail("phase 15b: the one-rank pass is not its own pass")
        # 15c: the distributed checkpoint of the model, in this group
        t0 = time.time()
        keys = ("X", "Tgas", "Tdust", "Tdusts", "quality")
        saved = {k: np.copy(getattr(m, k)) for k in keys}
        saved.update(n0=m.grid.n0.copy(), using=m.grid.using.copy(),
                     rho_dust=m.rho_dust.copy())
        path = str(tmp / "dcp")
        checkpoint.save_state_dist(path, m, iiter=1)
        for k in keys:
            setattr(m, k, np.zeros_like(saved[k]))
        it = checkpoint.load_state_dist(path, m)
        back = {k: getattr(m, k) for k in keys}
        back.update(n0=m.grid.n0, using=m.grid.using, rho_dust=m.rho_dust)
        same = all(np.array_equal(back[k], v) and back[k].dtype == v.dtype
                   for k, v in saved.items())
        say(f"phase 15c save_state_dist / load_state_dist of phase 11's "
            f"model ({len(saved)} arrays): bit-equal {same}, iiter {it}; "
            f"{time.time() - t0:.2f} s")
        if not same or it != 1:
            raise Fail("phase 15c: the distributed checkpoint round trip")
        return launches, dict(mc_s=t_mc, sweep_s=t_sw,
                              rounds=m.chunk_rounds, mc_sum_err=w,
                              sweep_rel=rel)
    finally:
        grid.using, cfg.shard_chemistry = using, shard
        m.group = None
        dist.destroy_process_group()


def shard_worker(rank, n_ranks, port, tmp):
    """A process of phase 15b (ii): a gloo group of n_ranks on the one
    card (the collectives on host copies: NCCL refuses two ranks on one
    device), phase 11's model rebuilt from its configuration and the
    state phase 15 saved, its run_mc(n_passes=1) (the pass sharded over
    the ranks, the fields broadcast), then this rank's own pass of its
    block."""
    import pickle
    import torch.distributed as dist
    from rac2d_torch.ops import kernels
    from rac2d_torch.parallel import mesh
    t_start = time.time()
    mesh.init_distributed(f"127.0.0.1:{port}", n_ranks, rank, device="cpu",
                          timeout_s=SHARD_TIMEOUT_S)
    try:
        state = torch.load(tmp / "state.pt", weights_only=False)
        m = bench_disk(torch.device(state["device"]), **state["chem"])
        t_prep = time.time() - t_start
        for k in ("X", "Tgas", "Tdust", "Tdusts", "quality"):
            setattr(m, k, state[k])
        cells_mc = m.mc_cells()
        kernels.reset_launches()
        t0 = time.time()
        m.run_mc(n_passes=1, seed=SHARD_SEED)
        torch.cuda.synchronize()
        t_mc = time.time() - t0
        launches = kernels.launch_counts()
        own, own_fates = own_pass(m, SHARD_SEED * 1000, rank, n_ranks,
                                  cells_mc, MC_NPH)
        res = dict(rank=rank, world=m.world, prep_s=t_prep, mc_s=t_mc,
                   launches=launches, fates=m.mc_counts, own=own,
                   own_fates=own_fates, chunks=m.mc_stats[-1]["chunks"],
                   tallies=tallies_host(m.tallies), Tdust=m.Tdust)
        with open(tmp / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def shard_processes(m, tmp):
    """Phase 15b (ii): SHARD_RANKS processes on the one card
    (shard_worker), joined with a deadline: their summed tallies held to
    the sum of their own passes (1e-5, fates summed exactly), the same
    tallies and Tdust on every rank, K3/K4 launched on each."""
    import pickle
    import torch.multiprocessing as mp
    torch.save(dict(
        chem={k: getattr(m.cfg, k) for k in (
            "n_iter", "evolT", "chem_stream", "t_max", "chem_chunk",
            "chunk_wall_s")},
        X=m.X, Tgas=m.Tgas, Tdust=m.Tdust, Tdusts=m.Tdusts,
        quality=m.quality, device=str(m.device)), tmp / "state.pt")
    t0 = time.time()
    ctx = mp.spawn(shard_worker, args=(SHARD_RANKS, free_port(), tmp),
                   nprocs=SHARD_RANKS, join=False)
    try:
        while not ctx.join(timeout=1.0):
            if time.time() - t0 > SHARD_TIMEOUT_S:
                raise Fail(f"phase 15b: {SHARD_RANKS} processes still "
                           f"running after {SHARD_TIMEOUT_S} s")
    except mp.ProcessRaisedException as e:
        raise Fail(f"phase 15b: a process failed: {e}") from None
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    wall = time.time() - t0
    rs = []
    for r in range(SHARD_RANKS):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            rs.append(pickle.load(f))
    r0 = rs[0]
    say(f"phase 15b (ii) {SHARD_RANKS} processes on the card (gloo, "
        f"collectives on host copies): {wall:.1f} s in all; per rank "
        + "; ".join(f"{r['rank']}: prepare {r['prep_s']:.1f} s, run_mc "
                    f"{r['mc_s']:.2f} s ({r['chunks']} chunks), launches "
                    f"{r['launches']}" for r in rs))
    fates = {k: sum(r["own_fates"][k] for r in rs) for k in r0["fates"]}
    w = sum_check(r0["tallies"], [r["own"] for r in rs], "phase 15b (ii)")
    same = all(np.array_equal(r["tallies"][f], r0["tallies"][f])
               for r in rs for f in r0["tallies"]) \
        and all(np.array_equal(r["Tdust"], r0["Tdust"]) for r in rs)
    say(f"phase 15b (ii) fates: sharded {r0['fates']}, sum of the own "
        f"passes {fates}; every rank the same tallies and Tdust {same}")
    if not (w <= 1e-5 and fates == r0["fates"] and same
            and all(r["fates"] == r0["fates"] for r in rs)):
        raise Fail("phase 15b: the sharded pass is not the sum of the "
                   "ranks' own passes on every rank")
    if any(min(r["launches"]["K3"], r["launches"]["K4"]) <= 0 for r in rs):
        raise Fail("phase 15b: a process launched no K3/K4")
    return [r["launches"] for r in rs], dict(
        wall_s=wall, mc_s=[r["mc_s"] for r in rs], mc_sum_err=w)


def check_postprocess(keep):
    """Phase 15d: rac2d_torch.postprocess on phase 12c's iteration tables
    and FITS cubes: radial_profile and column_density of each table,
    moment maps, pv_cut and SpecLine of each line cube, the continuum
    cube's moment 0: all finite and shaped as their inputs."""
    from rac2d_torch import postprocess as pp
    tabs = sorted(keep.glob("iter_*.npz"))
    lines = sorted(keep.glob("line_*.fits"))
    conts = sorted(keep.glob("cont_*.fits"))
    if not (tabs and lines and conts):
        raise Fail(f"phase 15d: phase 12c's outputs missing in {keep}")
    ok = True
    for p in tabs:
        t = pp.load_iter(p)
        r, v = pp.radial_profile(t, t["n_gas"], z_over_r_max=1e3)
        rs, N = pp.column_density(t, "CO")
        rc, H = pp.scale_height(t)
        good = (len(r) > 0 and np.isfinite(v).all() and len(rs) > 0
                and np.isfinite(N).all() and (N > 0).all()
                and np.isfinite(H).all())
        ok &= good
        say(f"phase 15d {p.name}: radial profile {len(r)} cells, CO columns "
            f"{len(rs)} ({N.min():.3e}..{N.max():.3e} cm^-2), scale "
            f"heights {len(rc)}; finite {good}")
    for p in lines:
        cube, freqs, hdr = pp.load_cube(p)
        nf, ny, nx = cube.shape
        mom0, mom1 = pp.moment_maps(cube, freqs,
                                    restfreq=float(hdr.get("F0", 0)) or None)
        pv = pp.pv_cut(cube)
        sl = pp.SpecLine(p)
        good = (mom0.shape == (ny, nx) and mom1.shape == (ny, nx)
                and pv.shape == (nf, nx) and np.isfinite(mom0).all()
                and np.isfinite(mom1).all() and np.isfinite(pv).all()
                and sl.spec is not None and len(sl.spec) == nf
                and np.isfinite(sl.spec).all()
                and np.isfinite(sl.integrated_flux()))
        ok &= good
        say(f"phase 15d {p.name}: cube {cube.shape}, mom0/mom1 "
            f"{mom0.shape}, pv {pv.shape}, SpecLine {sl.molname} "
            f"{sl.qnum}, {len(sl.spec)} channels, integrated flux "
            f"{sl.integrated_flux():.3e} W/m^2; finite and shaped {good}")
    for p in conts:
        img, freqs, hdr = pp.load_cube(p)
        sm = pp.convolve_beam(img.reshape(-1, *img.shape[-2:])[0], 2.0)
        good = np.isfinite(sm).all() and sm.shape == img.shape[-2:]
        ok &= bool(good)
        say(f"phase 15d {p.name}: image {img.shape}, beam-convolved "
            f"{sm.shape}; finite and shaped {good}")
    if not ok:
        raise Fail("phase 15d: postprocess on phase 12c's outputs")


def last_modules(dev, m, cells, snap, chunked, keep):
    """Phase 15: (a) the inv backend, (b) the sharded path on one rank
    and on SHARD_RANKS processes, (c) the distributed checkpoint, (d)
    postprocess.  Returns (the inv numbers, the launches of (b) (i), its
    numbers, the launches of (b) (ii)'s ranks, their numbers)."""
    import pathlib
    import shutil
    import tempfile
    from rac2d_torch.ops import bdf
    t_ph = time.time()
    walls = {}
    torch.cuda.empty_cache()
    # phase 14b's sweep fields (columns and shielding from its snapshot)
    # stay in place for 15a's sweeps
    cfg = m.cfg
    t0 = time.time()
    inv_sweep(m, cells, snap, bdf.log_output_times(
        cfg.dt_first, INV_T_MAX, cfg.ratio_tstep))
    walls["15a sweeps"] = time.time() - t0
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="rac2d_phase15_"))
    try:
        t0 = time.time()
        l1, n1 = shard_one_rank(m, cells, snap, chunked, tmp)
        walls["15b (i) + 15c"] = time.time() - t0
        t0 = time.time()
        l2, n2 = shard_processes(m, tmp)
        walls["15b (ii)"] = time.time() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # last: the inverse at full width (its f64 Newton systems take 4 GB)
    t0 = time.time()
    inv = check_inv(dev)
    torch.cuda.empty_cache()
    walls["15a inverse"] = time.time() - t0
    t0 = time.time()
    check_postprocess(keep)
    walls["15d"] = time.time() - t0
    say(f"phase 15 done: {time.time() - t_ph:.1f} s (aim <= "
        f"{PHASE15_AIM_S:g} s); " + ", ".join(
            f"{k} {v:.1f} s" for k, v in walls.items()))
    return inv, l1, n1, l2, n2


def main():
    import pathlib
    import shutil
    import tempfile
    keep = pathlib.Path(tempfile.mkdtemp(prefix="rac2d_phase12c_"))
    try:
        return _main(keep)
    finally:
        shutil.rmtree(keep, ignore_errors=True)


def _main(keep):
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
        launches, _, *phase5_states = run_slice(dev)
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
        run_launches, m = run_model(dev)
        # ---- 12. the command line and imaging ----
        t12 = time.time()
        kernels.reset_launches()
        times = check_imaging(m, dev)
        img_launches = kernels.launch_counts()
        torch.cuda.empty_cache()
        walls, cli_launches, cli_kern = check_cli(dev, keep)
        t12 = time.time() - t12
        img = ", ".join(f"{k} {v:.2f} s" for k, v in times.items())
        cli = ", ".join(f"{k} {v:.1f} s" for k, v in walls.items())
        say(f"phase 12 done: {t12:.1f} s (aim <= {PHASE12_AIM_S:g} s); "
            f"imaging {img}; command line {cli}; kernel launches in phases "
            f"12a-b {img_launches}, in the command line's run "
            f"{cli_launches}")
        torch.cuda.empty_cache()
        # ---- 13. the end-to-end configuration ----
        e2e_launches, e2e_kern = run_e2e(dev)
        torch.cuda.empty_cache()
        # ---- 14. the rest of the chemistry solver ----
        t14 = time.time()
        walls14 = {}
        t0 = time.time()
        _, cli14_launches = check_cli_chunked(dev)
        walls14["14a"] = time.time() - t0
        t0 = time.time()
        pool, chunked, cells, snap = compare_sweeps(m)
        walls14["14b"] = time.time() - t0
        t0 = time.time()
        exch_launches = exchange_window(m, dev, pool, cells, snap)
        walls14["14c"] = time.time() - t0
        torch.cuda.empty_cache()
        t0 = time.time()
        other_drivers(dev, phase5_states)
        walls14["14d"] = time.time() - t0
        t0 = time.time()
        jac_probe(dev)
        walls14["14e"] = time.time() - t0
        torch.cuda.empty_cache()
        say(f"phase 14 done: {time.time() - t14:.1f} s (aim <= "
            f"{PHASE14_AIM_S:g} s); " + ", ".join(
                f"{k} {v:.1f} s" for k, v in walls14.items()))
        # ---- 15. the last modules: inv, sharding, DCP, postprocess ----
        inv, sh1, sh1_n, sh2, sh2_n = last_modules(dev, m, cells, snap,
                                                   chunked, keep)
        del m
        torch.cuda.empty_cache()
        sharded = {"launches_sharded": sh1, "sharded": sh1_n,
                   "sharded_2proc": sh2_n}
        for row, key, nx in zip(rows, ("K1", "K2"), exch_launches):
            row["launches"] = run_launches[key]
            row["launches_cli"] = cli_launches[key]
            row["launches_e2e"] = e2e_launches[key]
            row["launches_chunked"] = chunked[key]
            row["launches_exchange"] = nx
            row["launches_cli_chunked"] = cli14_launches[key]
            row["cli"] = cli_kern[key]
            row["launches_sharded"] = sh1[key]
        res = {"mc_walk": (k3, mc_launches[0], run_launches["K3"],
                           cli_launches["K3"], cli_kern["K3"], "K3"),
               "fold_terminal": (k4, mc_launches[1], run_launches["K4"],
                                 cli_launches["K4"], cli_kern["K4"], "K4")}
        for row, replaces, name in PROBES:
            r, n, n_run, n_cli, cli, key = res[name]
            rows.append({"name": f"{name} ({row})", "route": "cuda",
                         "source": MC_SOURCE, "replaces": replaces,
                         "launches": n_run, "launches_slice": n,
                         "launches_cli": n_cli,
                         "launches_e2e": e2e_launches[key],
                         "launches_cli_chunked": cli14_launches[key],
                         "max_abs_err": r["err"],
                         "ms": r["ms"], "device_ms": r["device_ms"],
                         "host_ms": r["host_ms"], "plain_ms": r["plain_ms"],
                         "bound_ms": r["bound_ms"], "bound_by": "bytes",
                         "library_ms": None,
                         **({"bound_all_fields_ms": r["bound_all_fields_ms"]}
                            if "bound_all_fields_ms" in r else {}),
                         "cli": cli, "e2e": e2e_kern[key],
                         "e2e_merged": e2e_kern["merged"][key],
                         "launches_sharded": sh1[key],
                         "launches_sharded_2proc": [r[key] for r in sh2]})
        # the inv backend beside K1 (block_invert of its factor) and K2
        # (the apply that takes K2's place): torch matmuls, not kernels
        for row, what in zip(rows[:2], ("invert", "apply")):
            row["inv_" + what] = {
                str(B): {k.replace(what + "_", ""): v for k, v in r.items()
                         if k.startswith(what + "_")}
                for B, r in inv.items()}
        say("phase 15 sharded path: " + json.dumps(sharded))
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
