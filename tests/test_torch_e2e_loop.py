"""Port: a full DiskModel.run on the CPU with every switch of the JAX
package's end-to-end configuration (tests/test_e2e_driver.py).

run(n_iter=2) on tests/test_torch_run.py's tiny model cut to two columns
("vert" grid, 13 cells, 12 active) with evolT=False (fixed-T chemistry,
then the equilibrium T by bisection), the hydrostatic bootstrap
(do_vertical_with_Tdust, n_vert_iter_tdust=2: MC, balance, MC, balance),
the re-balance after the first iteration (do_vertical_every=1) and AMR
with merging (do_refine, do_merge), to t_max 1e-6 yr.  The default
refine_threshold (10) already refines here: after the first sweep the
watched abundances jump tenfold between vertical neighbours on the
columns' fronts, so the threshold is left as it is.  The run passes the
checks of tests/test_e2e_driver.py::test_run_completes_with_sane_state,
and the log shows both bootstrap passes, the re-balance and a refinement.
About 40 s on one CPU thread.
"""

import numpy as np

from test_torch_run import tiny_cfg
from torch_mc_fixtures import one_torch_thread  # noqa: F401 (autouse)

T_MAX = 1e-6


def test_run_completes_with_sane_state():
    driver, cfg = tiny_cfg(
        "torch", T_MAX, "vert", evolT=False, do_vertical_with_Tdust=True,
        n_vert_iter_tdust=2, do_vertical_every=1, do_refine=True,
        do_merge=True)
    m = driver.DiskModel(cfg, device="cpu")
    m.prepare()
    n_cells = m.grid.n_cells
    m.run(n_iter=2)
    log = "\n".join(m.log)
    assert log.count("vertical-structure pass") == 2
    assert log.count("vertical balance:") == 3
    assert "AMR: refining" in log
    refined = [ln for ln in m.log if "AMR: refining" in ln][0]
    assert int(refined.split()[2]) > 0
    assert m.grid.n_cells > n_cells
    # the equilibrium T of both sweeps bracketed some cells
    eq = [ln for ln in m.log if "equilibrium T:" in ln]
    assert len(eq) == 2 and all(int(ln.split()[2]) > 0 for ln in eq), eq
    assert len(m.stage_times) == 2
    assert set(m.stage_times[0]) == {"mc", "chemistry", "shielding",
                                     "env-assembly", "vertical", "amr"}
    # the last MC pass walked the refined grid
    assert m.tallies.en_gain.shape[-1] == m.grid.n_cells
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
