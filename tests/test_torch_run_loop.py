"""Port: a full DiskModel.run on the CPU.

run(n_iter=2) (MC, chemistry, MC, chemistry) on the tiny model of
tests/test_e2e_driver.py (evolT=True, no vertical structure or AMR) with
its grid cut to two columns (11 active cells) and t_max 1e-6 yr.  It
passes the checks of
tests/test_e2e_driver.py::test_run_completes_with_sane_state, and each
sweep must move the state off where it started: some abundance above
1e-12 by more than 10% and Tgas by more than 1e-5 relative in some cell
(the first sweep moves them by 30% and 2.4e-4, the second by a factor
of 3e2 and 7.4e-5).  A sweep from 1e-8 yr costs 170-330 pool rounds of
about 0.4 s on one CPU thread whatever t_max (169 rounds to 2e-8 yr, 221
to 1e-6, 354 to 1e-4), so the file takes about four minutes; a sweep to
2e-8 yr moves no abundance by 1%.
"""

import numpy as np

from test_torch_run import tiny_cfg
from torch_mc_fixtures import one_torch_thread  # noqa: F401 (autouse)

T_MAX = 1e-6


def test_run_completes_with_sane_state():
    """A full port run, n_iter=2 (MC, chemistry, MC, chemistry), with the
    checks of tests/test_e2e_driver.py::test_run_completes_with_sane_state
    and of each sweep's movement."""
    driver, cfg = tiny_cfg("torch", T_MAX, "loop")
    m = driver.DiskModel(cfg, device="cpu")
    m.prepare()
    moved = []
    sweep = m.chemistry_step

    def chemistry_step(iiter=1):
        """The sweep, recording how far it moved X and Tgas."""
        X0, T0 = m.X.copy(), m.Tgas.copy()
        if iiter == 1:              # the first guess chemistry_step makes
            T0 = np.maximum(m.Tdust * 1.1 + 10.0, T0)
        frac = sweep(iiter)
        act = m.grid.using
        x0 = X0[:, act]
        big = np.abs(x0) > 1e-12
        moved.append((
            float((np.abs(m.X[:, act] - x0)[big] / np.abs(x0[big])).max()),
            float(np.abs(m.Tgas[act] / T0[act] - 1.0).max())))
        return frac

    m.chemistry_step = chemistry_step
    m.run(n_iter=2)
    assert len(m.stage_times) == len(moved) == 2
    assert set(m.stage_times[0]) == {"mc", "chemistry", "shielding",
                                     "env-assembly"}
    assert m.W_star.w.device.type == m._shield.toISM.device.type == "cpu"
    for dx, dT in moved:
        assert dx > 0.1 and dT > 1e-5, moved
    act = m.grid.using
    assert act.sum() > 10
    # Tdust from MC: finite, ordered with radius roughly
    assert np.isfinite(m.Tdust[act]).all()
    assert m.Tdust[act].max() > 20.0
    # chemistry ran: H2 formed somewhere, abundances within [-eps, 1]
    iH2 = m.net.idx["H2"]
    assert m.X[iH2][act].max() > 0.1
    # cleanly-solved cells must be physical; cells the solver flagged
    # carry their quality bits instead
    clean = act & (m.quality == 0)
    ibad = np.nonzero((m.X[:, clean] >= 1.5).any(axis=1))[0]
    assert len(ibad) == 0, (
        f"unphysical abundances in clean cells for "
        f"{[m.net.species[i] for i in ibad]}")
    assert (m.Tgas[clean] > 1.0).all() and (m.Tgas[clean] < 3e4).all()
    frac_bad = (m.quality[act] > 0).mean()
    assert frac_bad < 0.5, frac_bad
    # after a sweep the MC reads the port's own Tgas, not Tdust
    np.testing.assert_array_equal(m.mc_cells().Tgas.numpy(),
                                  np.maximum(m.Tgas, 1.0))
