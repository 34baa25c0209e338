"""Traffic driver: back-to-back chemistry sweeps of the disk model.

Set-up: the configuration's disk through DiskModel.prepare() and its MC
passes (run_mc, seeded from the traffic's setup_mc_seed, the same for
every run), the snapshot of the evolving state, and a warm-up of the
window's own shapes: the window's chemistry_step cut short after two
pool calls of the traffic's warmup_rounds_per_call rounds each.

Window: sweeps through DiskModel.chemistry_step, each on cells_per_sweep
active cells: the middle cell of each of as many strata of the active
cells sorted by density.  Every sweep of every seed holds the same
cells from the same MC fields, so that the seed does not change the
work (it draws the cells the check compares).  Before each sweep X, Tgas
and quality are restored from the snapshot and grid.using is set to the
sweep's cells (the sweep's pool then holds exactly them).  Sweeps start
until the window's seconds have passed; the window ends with the last
sweep.  A sweep that outlasts sweep_deadline_s ends at its wall budget
(its unfinished lanes fail) and makes the run not correct.

The check compares what the sweeps produced with the plain reference in
benchmark/chemref (see chemref/compare.py).
"""

import time

import numpy as np
import torch
from torch.profiler import record_function

from harness import spec, trace as tracemod

from rac2d_torch.models import density, driver
from rac2d_torch.models.grid import GridConfig
from rac2d_torch.ops import kernels, optics


def disk_config(cfg):
    """The driver's DiskConfig from the configuration file."""
    def path(key):
        return str(spec.ROOT / cfg[key])
    return driver.DiskConfig(
        star_mass=cfg["star_mass"], star_radius=cfg["star_radius"],
        star_T=cfg["star_T"], lumi_Xray=cfg["lumi_Xray"],
        andrews=density.AndrewsDisk(
            Md=cfg["andrews_Md"], rin=cfg["andrews_rin"],
            rout=cfg["andrews_rout"], rc=cfg["andrews_rc"],
            hc=cfg["andrews_hc"]),
        grid=GridConfig(rmin=cfg["grid_rmin"], rmax=cfg["grid_rmax"],
                        zmax=cfg["grid_zmax"], ncol=cfg["grid_ncol"],
                        max_num_of_cells=cfg["grid_max_num_of_cells"]),
        dust=[driver.DustComponent(
            opti_files=[path("dust_opti_file")], weights=[1.0],
            rho_material=cfg["dust_rho_material"],
            mrn_rmin=cfg["dust_mrn_rmin"], mrn_rmax=cfg["dust_mrn_rmax"],
            mrn_n=cfg["dust_mrn_n"], d2g_mass=cfg["dust_d2g_mass"])],
        network_file=path("network_file"),
        enthalpy_file=path("enthalpy_file"),
        init_abundances_file=path("init_abundances_file"),
        h2o_cross_file=path("h2o_cross_file"),
        mc=optics.McConfig(nph=cfg["nph_per_pass"],
                           nlen_lut=cfg["mc_nlen_lut"],
                           n_quantile=cfg["mc_n_quantile"],
                           max_batch=cfg["mc_max_batch"]),
        nph_per_pass=cfg["nph_per_pass"], n_mc_passes=cfg["n_mc_passes"],
        evolT=cfg["evolT"], chem_stream=cfg["chem_stream"],
        chem_chunk=cfg["chem_chunk"], rtol_chem=cfg["rtol_chem"],
        atol_chem=cfg["atol_chem"], dt_first=cfg["dt_first"],
        ratio_tstep=cfg["ratio_tstep"], nlocal_iter=cfg["nlocal_iter"],
        t_max=cfg["t_max"])


def sweep_order(grid, cells):
    """The cells in the order chemistry_step gives its pool (its
    expression on the same sorted indices)."""
    act = np.sort(cells)
    return act[np.argsort(grid.n0[act])]


def strata_middles(by_density, n):
    """The middle cell of each of n strata of the density-sorted cells."""
    return np.array([s[len(s) // 2] for s in np.array_split(by_density, n)])


# a wall budget that ends a sweep after its first two pool calls (the
# pool's clock starts after the first)
WALL_ONLY = 1e-3


class State:
    pass


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def setup(cfg, traffic, seed, dev):
    st = State()
    st.cfg, st.traffic, st.seed = cfg, traffic, seed
    m = st.model = driver.DiskModel(disk_config(cfg), dev)
    m.prepare()
    # the MC fields decide how many rounds a sweep takes, so they are
    # the same for every seed
    m.run_mc(seed=traffic["setup_mc_seed"])
    st.n_per_sweep = cfg["cells_per_sweep"]
    st.width = min(cfg["chem_chunk"], st.n_per_sweep)
    st.using = m.grid.using.copy()
    act = np.nonzero(st.using)[0]
    st.by_density = act[np.argsort(m.grid.n0[act], kind="stable")]
    st.snap = (m.X.copy(), m.Tgas.copy(), m.quality.copy())
    st.cells = strata_middles(st.by_density, st.n_per_sweep)
    # warm-up: the window's sweep, ended by its wall budget after its
    # second pool call (the pool's clock starts after the first), with
    # warmup_rounds_per_call rounds a call in place of the driver's
    rounds = driver.POOL_ROUNDS_PER_CALL
    driver.POOL_ROUNDS_PER_CALL = traffic["warmup_rounds_per_call"]
    try:
        run_sweep(st, st.cells, WALL_ONLY)
    finally:
        driver.POOL_ROUNDS_PER_CALL = rounds
    restore(st)
    return st


def set_wall(st, seconds):
    """The pool's wall budget, chunk_wall_s x chunks x nlocal_iter, to
    `seconds`."""
    m = st.model
    n_chunks = -(-st.n_per_sweep // st.width)
    m.cfg.chunk_wall_s = seconds / (n_chunks * m.cfg.nlocal_iter)


def restore(st):
    m = st.model
    m.X, m.Tgas, m.quality = (a.copy() for a in st.snap)
    m.grid.using = st.using.copy()


def run_sweep(st, cells, wall_s):
    """One chemistry_step on `cells` from the snapshot, with a wall
    budget of wall_s; its record."""
    m = st.model
    restore(st)
    set_wall(st, wall_s)
    use = np.zeros_like(st.using)
    use[cells] = True
    m.grid.using = use
    m._t_envs = 0.0
    kernels.reset_launches()
    t0 = time.perf_counter()
    with record_function("bench.chemistry_step"):
        m.chemistry_step(iiter=1)
        sync(m.device)
    wall = time.perf_counter() - t0
    res = m.pool_result
    order = sweep_order(m.grid, cells)
    return dict(
        cells=order, wall_s=wall, fields_s=m._t_shield + m._t_envs,
        rounds=int(res.n_rounds), steps=int(res.n_steps.sum()),
        n_steps=res.n_steps.numpy().copy(),
        failed=res.fail.numpy().copy(),
        retry_level=res.retry_level.numpy().copy(),
        X=m.X[:, order].copy(), Tgas=m.Tgas[order].copy(),
        Tgas0=np.maximum(m.Tdust[order] * 1.1 + 10.0, 0.0),
        launches=kernels.launch_counts(),
        deadline_hit=wall > wall_s)


def window(st, seconds, traced):
    """Sweeps until `seconds` have passed; (record, trace summary).  A
    traced run then traces one more sweep, cut short by its wall budget
    after its first two pool calls (tracing a whole sweep would take
    minutes to read)."""
    sweeps = []
    t0 = time.perf_counter()
    while not sweeps or time.perf_counter() - t0 < seconds:
        sweeps.append(run_sweep(st, st.cells, st.traffic["sweep_deadline_s"]))
    window_s = time.perf_counter() - t0
    tr = tracemod.Trace(traced, st.model.device)
    if traced:
        with tr:
            run_sweep(st, st.cells, WALL_ONLY)
    restore(st)
    n_fail = int(sum(s["failed"].sum() for s in sweeps))
    n_all = sum(len(s["cells"]) for s in sweeps)
    record = dict(
        sweeps=sweeps, seed=st.seed, window_s=window_s, attempted=n_all,
        failed=n_fail, cells_done=n_all - n_fail, width=st.width,
        neq=st.model.ode.neq,
        timed=dict(wall_s=sum(s["wall_s"] for s in sweeps),
                   fields_s=sum(s["fields_s"] for s in sweeps),
                   rounds=sum(s["rounds"] for s in sweeps),
                   steps=sum(s["steps"] for s in sweeps),
                   cells=n_all, sweeps=len(sweeps)))
    return record, tr.summary()


def reference_inputs(st, record):
    """Host copies of what the reference follows from the program's
    set-up (the MC stage's fields; see chemref/compare.py), taken before
    the model is freed."""
    from chemref import compare
    return compare.program_state(st.model, st.cfg)


def check(ref_in, record, traffic):
    from chemref import compare
    return compare.check(ref_in, record, traffic)
