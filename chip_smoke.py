#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (rac2d_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its result and seconds; any failure exits non-zero):
  1. the card: nvidia-smi name and power limit; CUDA must be available;
  2. build the hand-written CUDA kernels from rac2d_torch/csrc/ (nvcc,
     sm_90a) and print the compiler's register/shared-memory report;
  3. kernels K1 (blocked LU factor) and K2 (block substitution) against
     their plain PyTorch versions on the card, at the shapes of the main
     path: B=256 lanes, n=485 (padded to N=512), on row/column-equilibrated
     I - cJ matrices made from a numpy seed;
  4. time K1/K2 and their plain versions (CUDA events, in turns
     plain, kernel, kernel, plain);
  5. the slice: the coupled chemistry+temperature pool sweep through
     ChemicalODE(net, thermal=ThermalBalance(net)).solve_pool on the
     shipped network (NEQ=485), window W=256, per-lane retry ladder of 3
     levels, over a pool of 512 random disk cells (the bench.py recipe,
     seed 0) plus the 3 production cells of tests/test_chem_production.py,
     1e-8 -> 1e3 yr; the kernels' launch counts over this run must be > 0,
     and the final states must be finite, physical and conserve elements;
  6. 8 of those lanes re-solved with the plain LU on the card: key species
     within 5%.
The second-to-last lines are the kernels' JSON record and the card's
nvidia-smi line; the last line is {"ok": true, "device": {...}}.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

D2G = 2.8e-12
W = 256
T_MAX = 1e3
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


def check_kernels(dev, B=W, n=485):
    """Phase 3: K1/K2 vs their plain versions on the card."""
    from rac2d_torch.ops import blocklu, kernels
    t0 = time.time()
    A, b = newton_matrices(B, n, 0, dev)
    fac = kernels.block_lu_factor(A)
    x = kernels.block_lu_solve(fac, b)
    torch.cuda.synchronize()
    ref = blocklu.block_lu(A)
    xr = blocklu.block_lu_solve(ref, b)
    torch.cuda.synchronize()
    err_fac = 0.0
    for name in ("lu", "linv", "uinv"):
        k_, p_ = getattr(fac, name), getattr(ref, name)
        err = float((k_ - p_).abs().amax())
        err_fac = max(err_fac, err)
        rel = float(((k_ - p_).abs().amax(dim=(-2, -1))
                     / p_.abs().amax(dim=(-2, -1)).clamp_min(1.0)).max())
        say(f"phase 3 K1 {name}: max abs diff {err:.3e}, max rel {rel:.3e} "
            f"(tol 1e-4)")
        if not rel <= 1e-4:
            raise Fail(f"phase 3: K1 {name} disagrees with block_lu")
    err_x = float((x - xr).abs().amax())
    rel_x = float(((x - xr).abs().amax(1)
                   / xr.abs().amax(1).clamp_min(1.0)).max())
    res = float(((A.double() @ x.double()[..., None])[..., 0]
                 - b.double()).abs().amax())
    say(f"phase 3 K2: max abs diff {err_x:.3e}, max rel {rel_x:.3e} "
        f"(tol 1e-4); max |A x - b| {res:.3e}")
    if not rel_x <= 1e-4 or not np.isfinite(res):
        raise Fail("phase 3: K2 disagrees with block_lu_solve")
    say(f"phase 3 done: B={B} n={n}, {time.time() - t0:.1f} s")
    return dict(A=A, b=b, fac=fac, ref=ref, err_fac=err_fac, err_x=err_x)


def time_kernels(A, b, fac, ref, **_):
    """Phase 4: mean ms of K1/K2 and their plain versions, in turns
    plain, kernel, kernel, plain."""
    from rac2d_torch.ops import blocklu, kernels
    t0 = time.time()
    k1_pa = cuda_ms(lambda: blocklu.block_lu(A), 3)
    k1_a = cuda_ms(lambda: kernels.block_lu_factor(A), 10)
    k1_b = cuda_ms(lambda: kernels.block_lu_factor(A), 10)
    k1_pb = cuda_ms(lambda: blocklu.block_lu(A), 3)
    k2_pa = cuda_ms(lambda: blocklu.block_lu_solve(ref, b), 10)
    k2_a = cuda_ms(lambda: kernels.block_lu_solve(fac, b), 50)
    k2_b = cuda_ms(lambda: kernels.block_lu_solve(fac, b), 50)
    k2_pb = cuda_ms(lambda: blocklu.block_lu_solve(ref, b), 10)
    B, n = b.shape
    say(f"phase 4 K1 factor B={B} n={n}: kernel {k1_a:.3f}/{k1_b:.3f} ms, "
        f"plain {k1_pa:.3f}/{k1_pb:.3f} ms")
    say(f"phase 4 K2 solve  B={B} n={n}: kernel {k2_a:.4f}/{k2_b:.4f} ms, "
        f"plain {k2_pa:.4f}/{k2_pb:.4f} ms")
    say(f"phase 4 done: {time.time() - t0:.1f} s")
    return dict(k1_ms=(k1_a + k1_b) / 2, k1_plain=(k1_pa + k1_pb) / 2,
                k2_ms=(k2_a + k2_b) / 2, k2_plain=(k2_pa + k2_pb) / 2)


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
    say(f"phase 5 launches: K1 {launches[0]}, K2 {launches[1]}")
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

    t0 = time.time()
    pick = np.concatenate([np.arange(N - 3, N),
                           np.nonzero(ok[:N - 3])[0][:5]])
    sel = torch.as_tensor(pick, device=dev)
    out_b = ode.solve_pool(tree_map(lambda a: a[sel], envs), y0b[sel],
                           T0t[sel], touts, rtol, atol, width=len(pick),
                           tenvs=tree_map(lambda a: a[sel], tenvs),
                           lu_backend="block", **kw)
    yb = out_b.ys[:, -1].numpy()
    ki = net.key_species_idx
    worst = 0.0
    for j, i in enumerate(pick):
        if fail[i] or bool(out_b.fail[j]):
            raise Fail(f"phase 6: lane {i} failed (kernel {fail[i]}, "
                       f"plain {bool(out_b.fail[j])})")
        big = np.abs(yb[j, ki]) > 1e-12
        rel = np.abs(yf[i, ki] - yb[j, ki])[big] / np.abs(yb[j, ki])[big]
        worst = max(worst, float(rel.max()))
    say(f"phase 6 plain LU re-solve of {len(pick)} lanes: worst key-species "
        f"rel diff {worst:.3e} (tol 5e-2), {time.time() - t0:.1f} s")
    if not worst < 0.05:
        raise Fail("phase 6: kernel and plain LU runs disagree")
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
    try:
        # ---- 2. build ----
        t0 = time.time()
        kernels.load()
        say(f"phase 2 build: {time.time() - t0:.1f} s")
        for line in kernels.build_log.splitlines():
            if "ptxas info" in line and ("Used" in line
                                         or "Compiling" in line):
                say("  " + line.strip())
        # ---- 3, 4. kernels vs plain, times ----
        chk = check_kernels(dev)
        tm = time_kernels(**chk)
        del chk["A"], chk["b"], chk["fac"], chk["ref"]
        # ---- 5, 6. the slice ----
        launches = run_slice(dev)
    except Fail as e:
        say(f"FAIL {e}")
        return 1

    say(f"total {time.time() - t_all:.1f} s")
    say(json.dumps({"kernels": [
        {"name": "blocklu_factor", "route": "cuda", "source": SOURCE,
         "replaces": K1_REPLACES, "launches": launches[0],
         "max_abs_err": chk["err_fac"], "ms": tm["k1_ms"],
         "plain_ms": tm["k1_plain"]},
        {"name": "blocklu_solve", "route": "cuda", "source": SOURCE,
         "replaces": K2_REPLACES, "launches": launches[1],
         "max_abs_err": chk["err_x"], "ms": tm["k2_ms"],
         "plain_ms": tm["k2_plain"]}]}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
