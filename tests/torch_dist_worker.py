"""The multi-rank CPU tests' launcher and the work of each rank
(tests/test_torch_parallel.py).

``run_ranks(fn, *args)`` starts n processes with
``torch.multiprocessing.spawn``; each joins a gloo group on a free
localhost port (``parallel.mesh.init_distributed``, a collective timeout
of GROUP_TIMEOUT_S), runs ``fn(rank, n, *args)`` on one torch thread and
pickles what it returns.  The parent waits at most JOIN_TIMEOUT_S for all
of them: a rank that raises fails the test with its traceback, and ranks
still running at the deadline (a deadlock) are killed and fail it too.
This module imports no JAX; the rank functions build their inputs from
seeds, as the tests' single-process references do.
"""

import os
import pickle
import socket
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

JOIN_TIMEOUT_S = 120.0
GROUP_TIMEOUT_S = 60.0


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _entry(rank, n, port, out, fn, args):
    from rac2d_torch.parallel import mesh
    torch.set_num_threads(1)
    mesh.init_distributed(f"127.0.0.1:{port}", n, rank, device="cpu",
                          timeout_s=GROUP_TIMEOUT_S)
    try:
        res = fn(rank, n, *args)
        with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, *args, n=2, timeout_s=JOIN_TIMEOUT_S):
    """[fn(rank, n, *args) of each rank] from n spawned gloo ranks."""
    out = tempfile.mkdtemp(prefix="rac2d_ranks_")
    ctx = mp.spawn(_entry, args=(n, free_port(), out, fn, args), nprocs=n,
                   join=False)
    deadline = time.monotonic() + timeout_s
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            raise TimeoutError(f"{n} ranks of {fn.__name__} still running "
                               f"after {timeout_s:.0f} s")
    res = []
    for r in range(n):
        with open(os.path.join(out, f"rank{r}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    return res


# --------------------------------------------------------------------
# the mesh

def mesh_placement(rank, n):
    from rac2d_torch.parallel import mesh
    arr = np.arange(64.0).reshape(8, 8)
    m = mesh.make_mesh()
    m2 = mesh.make_mesh(n_cells_shards=n)
    return dict(
        shape=tuple(m.shape), names=m.mesh_dim_names,
        shape2=tuple(m2.shape),
        pkt=mesh.shard_batch(m, arr, axis="pkt").numpy(),
        cells=mesh.shard_batch(m2, arr, axis="cells").numpy(),
        cells_one=mesh.shard_batch(m, arr, axis="cells").numpy(),
        rep=mesh.replicate(m, arr).numpy(),
        put=mesh.put_global(m, arr, axis="pkt").numpy(),
        local=mesh.host_local_batch(arr),
        any=(mesh.any_rank(rank == 1), mesh.any_rank(False),
             mesh.any_rank(torch.tensor(rank == 0))),
        each=mesh.any_rank_each(torch.tensor([rank == 1, False, True])),
        min=mesh.min_rank(10.0 - rank),
        gather=mesh.all_gather_rows(torch.full((2, 3), float(rank))).numpy(),
        device=str(mesh.rank_device("cpu")))


# --------------------------------------------------------------------
# the chemistry solve: dark-cloud lanes on the shipped network

def dark_cloud_case(B, t_max, seed=1):
    """(ode, envs, y0b, T0b, touts, rtol_b, atol_b) of B dark-cloud lanes
    (tests/test_parallel.py's, on the shipped network) on the CPU."""
    from rac2d_torch import defaults
    from rac2d_torch.io import umist
    from rac2d_torch.ops import bdf, odesys
    from rac2d_torch.ops.rates import CellEnv
    from rac2d_torch.utils.tree import stack
    net = umist.load_network(defaults.NETWORK,
                             enthalpy_path=defaults.ENTHALPIES)
    y0 = umist.load_initial_abundances(net, defaults.INIT_ABUNDANCES)
    ode = odesys.ChemicalODE(net, device="cpu")
    rng = np.random.default_rng(seed)
    n_gas = 10 ** rng.uniform(4, 6, B)
    d2g = 2.8e-12
    envs = stack([CellEnv.default(
        "cpu", Tgas=15.0, Tdust=15.0, n_gas=n_gas[i], ratioDust2HnucNum=d2g,
        ndust_tot=d2g * n_gas[i], GrainRadius_CGS=1e-5,
        sigdust_ave=np.pi * 1e-10, SitesPerGrain=4 * np.pi * 1e-10 * 1e15)
        for i in range(B)])
    rtol, atol = odesys.tolerance_ladder(net, 1, 1e-4, 1e-30, d2g, "cpu")
    touts = bdf.log_output_times(1e-8, t_max, 1.5)
    return (ode, envs, torch.as_tensor(np.tile(y0, (B, 1))),
            torch.full((B,), 15.0, dtype=torch.float64), touts,
            rtol.expand(B, -1), atol.expand(B, -1))


def chem_solve(rank, n, B, t_max, max_wall_s):
    """The sharded solve of dark_cloud_case(B, t_max); max_wall_s may
    differ between the ranks (a list, one per rank)."""
    from rac2d_torch.parallel import mesh
    ode, envs, y0b, T0b, touts, rtol_b, atol_b = dark_cloud_case(B, t_max)
    wall = max_wall_s[rank] if max_wall_s is not None else None
    t0 = time.time()
    res = mesh.sharded_chemistry_solve(
        ode, envs, None, y0b, T0b, touts, rtol_b, atol_b, 1e-8, False,
        max_steps_per_interval=400, max_wall_s=wall)
    return dict(ys=res.ys.numpy(), fail=res.fail.numpy(),
                t_final=res.t_final.numpy(), n_steps=res.n_steps.numpy(),
                n_rounds=res.n_rounds, wall=time.time() - t0)


# --------------------------------------------------------------------
# the MC pass and the model

def mc_model(nph):
    """The small MC disk of tests/torch_mc_fixtures.py, prepared on the
    CPU (cold dust: a pass ends in a few walk chunks; on warm dust the
    plain walk's tail takes minutes on the CPU)."""
    from torch_mc_fixtures import disk_cfg
    driver, cfg = disk_cfg("torch", nph=nph)
    m = driver.DiskModel(cfg, device="cpu")
    m.prepare()
    return m


def tallies_np(tall):
    return {f: getattr(tall, f).numpy() for f in tall._fields}


def mc_pass(rank, n, nph, key):
    """One sharded pass through DiskModel.mc_pass (several ranks)."""
    m = mc_model(nph)
    tall, fates, stats = m.mc_pass(key, nph)
    return dict(tallies=tallies_np(tall), fates=fates,
                packets=stats["packets"], ranks=stats["ranks"])


def tiny_model(grid="one", chem_chunk=2, **kw):
    """tests/test_torch_run.py's smallest disk on the CPU (kw: DiskConfig
    fields to set)."""
    from test_torch_run import tiny_cfg
    driver, cfg = tiny_cfg("torch", 1e-2, grid, chem_chunk)
    for k, v in kw.items():
        setattr(cfg, k, v)
    m = driver.DiskModel(cfg, device="cpu")
    m.prepare()
    return m


STATE = ("X", "Tgas", "Tdust", "Tdusts", "quality")


def seeded_state(m, seed):
    rng = np.random.default_rng(seed)
    n = m.grid.n_cells
    m.X = m.X * 10 ** rng.uniform(-1, 1, m.X.shape)
    m.Tgas = rng.uniform(10, 300, n)
    m.Tdust = rng.uniform(10, 300, n)
    m.Tdusts = rng.uniform(10, 300, m.Tdusts.shape)
    m.quality = rng.integers(0, 1024, n)
    m.grid.n0 = m.grid.n0 * rng.uniform(0.5, 2.0, n)
    m.rho_dust = m.rho_dust * rng.uniform(0.5, 2.0, m.rho_dust.shape)
    m._derive_cell_state()


def checkpoint_round_trip(rank, n, path):
    """save_state_dist on every rank, then load_state_dist into a fresh
    model of the same grid and into one of another grid."""
    from rac2d_torch import checkpoint
    m = tiny_model()
    seeded_state(m, 7)
    checkpoint.save_state_dist(path, m, iiter=3)
    saved = {k: getattr(m, k).copy() for k in STATE}
    saved.update(n0=m.grid.n0.copy(), rho_dust=m.rho_dust.copy())
    fresh = tiny_model()
    it = checkpoint.load_state_dist(path, fresh)
    back = {k: getattr(fresh, k) for k in STATE}
    back.update(n0=fresh.grid.n0, rho_dust=fresh.rho_dust,
                d2h=fresh.d2h, d2h_want=m.d2h)
    other = tiny_model(grid="cut")
    try:
        checkpoint.load_state_dist(path, other)
        refused = None
    except ValueError as e:
        refused = str(e)
    return dict(saved=saved, back=back, iiter=it, refused=refused)


def model_run(rank, n, nph, t_max):
    """DiskModel(cfg).run(n_iter=1) on the smallest disk (one chunk of 4
    cells) to t_max yr, with the state just before its chemistry step
    (after the MC) kept."""
    m = tiny_model(chem_chunk=4, nph_per_pass=nph, t_max=t_max)
    snap = {}
    step = m.chemistry_step

    def chemistry_step(iiter=1):
        snap.update({k: np.copy(getattr(m, k)) for k in STATE})
        snap["fields"] = {f: getattr(m.fields, f).clone()
                          for f in m.fields._fields
                          if isinstance(getattr(m.fields, f), torch.Tensor)}
        snap["tallies"] = m.tallies
        snap["mc_counts"] = dict(m.mc_counts)
        return step(iiter)
    m.chemistry_step = chemistry_step
    m.run(n_iter=1)
    return dict(snap=snap, final={k: getattr(m, k) for k in STATE},
                converged=m.converged_cells, log=m.log, rank=m.rank,
                world=m.world, chunk_rounds=m.chunk_rounds)


def cli_run(rank, n, toml, out):
    """python -m rac2d_torch as torchrun starts it, on the CPU."""
    from rac2d_torch import __main__ as tmain
    os.environ["WORLD_SIZE"] = str(n)
    return tmain.main([toml, "--device", "cpu", "--out", out,
                       "--iters", "0"])
