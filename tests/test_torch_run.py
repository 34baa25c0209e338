"""Port parity: the chemistry hand-off and DiskModel.run, on the CPU.

(a) Hand-off: the tiny model of tests/test_e2e_driver.py with evolT=True
    and neither vertical structure nor AMR.  The JAX package runs run_mc;
    its state (X, Tgas, Tdust, Tdusts, quality, tallies, fields) is carried
    into the port (convert.model_state), and both run chemistry_step(1).
    The same failed cells, quality and converged mask; key species within
    5% where |X| > 1e-12 and Tgas within 2% (the bars of
    tests/test_torch_pool_sweep.py::test_coupled_pool_sweep_matches_jax);
    some abundance above 1e-12 moved by more than 10% in the port.  The
    MC noise stays out of the comparison.  The default run cuts the grid
    to one column (4 active cells), runs to 1e-2 yr, and streams the cells
    through a window of 2 (chem_chunk): the JAX package refills the window
    every 256 BDF rounds, the port every 32 (driver.POOL_ROUNDS_PER_CALL),
    so the two start the same lanes at different rounds.  Two columns (10
    cells) at windows 4 and 16, 1e1 yr, and the fixture's own grid (117
    active cells) are marked slow.
check_hand_off serves the other hand-off files too: the evolT=False
sweep (tests/test_torch_eq_hand_off.py), the gas-dust exchange modes
(tests/test_torch_exchange_hand_off.py, test_torch_linear_hand_off.py)
and the chunked sweep (tests/test_torch_chunked_hand_off.py,
test_torch_chunked_eq_hand_off.py); `hc` there is a dict of HcConfig
fields, made into each package's HcConfig.

A full port run is in tests/test_torch_run_loop.py (a file of its own, so
that the two long runs go to two workers).
"""

import numpy as np
import pytest

from rac2d_torch import convert

from torch_mc_fixtures import one_torch_thread  # noqa: F401 (autouse)

# grid cuts of the tiny model: (ncol, density_log_range); "e2e" is the
# fixture's own grid; "vert" keeps 9 active cells of 2 columns through the
# hydrostatic passes of tests/test_torch_e2e_loop.py
GRIDS = {"e2e": (5, 5.0), "cut": (2, 0.3), "one": (1, 0.3),
         "loop": (2, 0.5), "vert": (2, 1.0)}


def tiny_cfg(pkg, t_max, grid="cut", chem_chunk=16, evolT=True, **kw):
    """The tiny model of tests/test_e2e_driver.py (CI size), by default
    with evolT=True and neither vertical structure nor AMR (kw: other
    DiskConfig fields; hc as a dict of HcConfig fields), as `pkg`'s
    (driver module, DiskConfig)."""
    if pkg == "jax":
        from rac2d_tpu import defaults
        from rac2d_tpu.models import density, driver
        from rac2d_tpu.models.grid import GridConfig
        from rac2d_tpu.ops import optics, thermal
        kw = {**dict(do_vertical_every=0, do_refine=False, do_merge=False,
                     shard_chemistry=False), **kw}
    else:
        from rac2d_torch import defaults
        from rac2d_torch.models import density, driver
        from rac2d_torch.models.grid import GridConfig
        from rac2d_torch.ops import optics, thermal
    if "hc" in kw:
        kw["hc"] = thermal.HcConfig(**kw["hc"])
    ncol, dlr = GRIDS[grid]
    return driver, driver.DiskConfig(
        star_mass=0.6, star_radius=1.0, star_T=4000.0, lumi_Xray=1e29,
        andrews=density.AndrewsDisk(Md=0.01, rin=1.0, rout=40.0, rc=40.0,
                                    hc=10.0),
        grid=GridConfig(rmin=1.0, rmax=40.0, zmax=40.0, ncol=ncol,
                        max_num_of_cells=64, density_log_range=dlr),
        dust=[driver.DustComponent(opti_files=[defaults.SILICATE_OPTI],
                                   weights=[1.0], d2g_mass=0.01)],
        network_file=defaults.NETWORK, enthalpy_file=defaults.ENTHALPIES,
        init_abundances_file=defaults.INIT_ABUNDANCES,
        h2o_cross_file=defaults.H2O_PHOTOXS,
        n_iter=2, evolT=evolT, t_max=t_max, ratio_tstep=2.5,
        chem_chunk=chem_chunk,
        max_steps_per_interval=400, nlocal_iter=2,
        mc=optics.McConfig(nph=1000, nlen_lut=128, n_quantile=64),
        n_mc_passes=1, nph_per_pass=1000, converged_fraction=2.0, **kw)


@pytest.mark.parametrize("grid,chem_chunk,t_max", [
    ("one", 2, 1e-2),
    pytest.param("cut", 4, 1e-2, marks=pytest.mark.slow),
    pytest.param("cut", 16, 1e1, marks=pytest.mark.slow),
    pytest.param("e2e", 16, 1e-2, marks=pytest.mark.slow)])
def test_chemistry_hand_off_matches_jax(grid, chem_chunk, t_max):
    check_hand_off(grid, chem_chunk, t_max)


def check_hand_off(grid, chem_chunk, t_max, **kw):
    """The JAX package's run_mc state carried into the port, then
    chemistry_step(1) in both (kw: other DiskConfig fields of both), held
    to the bars of the module docstring."""
    jdriver, jcfg = tiny_cfg("jax", t_max, grid, chem_chunk, **kw)
    tdriver, tcfg = tiny_cfg("torch", t_max, grid, chem_chunk, **kw)
    jm = jdriver.DiskModel(jcfg)
    jm.prepare()
    jm.run_mc()
    tm = tdriver.DiskModel(tcfg, device="cpu")
    tm.prepare()
    convert.model_state(jm, tm)
    np.testing.assert_array_equal(tm.grid.using, jm.grid.using)
    X0 = tm.X.copy()
    jfrac = jm.chemistry_step(1)
    tfrac = tm.chemistry_step(1)

    act = jm.grid.using
    # more cells than window slots: the window is refilled, at other
    # rounds in the port than in the JAX package
    assert act.sum() > chem_chunk
    assert tdriver.POOL_ROUNDS_PER_CALL != 256
    np.testing.assert_array_equal(tm.quality, jm.quality)
    np.testing.assert_array_equal(tm.converged_cells, jm.converged_cells)
    assert tfrac == jfrac
    assert np.isfinite(tm.X).all() and np.isfinite(tm.Tgas).all()
    ki = jm.net.key_species_idx
    xt, xj = tm.X[ki][:, act], jm.X[ki][:, act]
    big = np.abs(xj) > 1e-12
    rel = np.abs(xt - xj)[big] / np.abs(xj)[big]
    print(f"worst key-species rel diff {rel.max():.3e} over {big.sum()} "
          f"entries above 1e-12; max Tgas rel diff "
          f"{np.abs(tm.Tgas[act] / jm.Tgas[act] - 1).max():.3e}")
    assert rel.max() < 0.05, rel.max()
    # the sweep moved the chemistry: some abundance above 1e-12 by > 10%
    x0 = X0[:, act]
    big0 = np.abs(x0) > 1e-12
    assert (np.abs(tm.X[:, act] - x0)[big0] / np.abs(x0[big0])).max() > 0.1
    Tt, Tj = tm.Tgas[act], jm.Tgas[act]
    assert (np.abs(Tt - Tj) < 0.02 * Tj).all(), np.abs(Tt / Tj - 1).max()
    # the sweep evolved the gas away from its first guess
    assert (np.abs(Tt / (jm.Tdust[act] * 1.1 + 10.0) - 1) > 1e-3).any()
