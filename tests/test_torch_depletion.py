"""Port parity: the O/C depletion of the initial abundances
(rac2d_torch.models.depletion against rac2d_tpu.models.depletion), on the
CPU.

`apply_depletion` on the small bench disk (torch_mc_fixtures.disk_cfg,
ncol=10) with each method, both modes and the nitrogen switch, from the
same abundances, Tgas and densities.  Both modules are plain numpy doing
the same float64 operations in the same order, so X must agree within
1e-12 relative; every case must change X, so that the comparison is not
between two copies of the input.
"""

import numpy as np
import pytest

from rac2d_torch import defaults
from rac2d_torch.io import umist

from torch_mc_fixtures import disk_cfg
from torch_mc_fixtures import one_torch_thread  # noqa: F401 (autouse)

RTOL = 1e-12

# (DepletionConfig fields, ElementDepletion fields of O, of C, star_mass,
# t_evol)
CASES = {
    "radial": (dict(method="radial"),
               dict(r0=10.0, a=0.1, b=1.0, gam=2.0, rin=3.0, fin=0.5),
               dict(r0=5.0, a=0.3, b=0.9, gam=1.5, rout=60.0, fout=0.2)),
    "vscale-power": (dict(method="vscale"),
                     dict(r0=20.0, vfac=0.5, p=2.0, k=0.1, gval=0.01),
                     dict(r0=8.0, vfac=0.3, p=1.0, k=0.2, gval=0.02,
                          enhance_max=0.8)),
    "vscale-tanh": (dict(method="vscale", vscale_profile="tanh"),
                    dict(tanh_r=10.0, tanh_scale=5.0, tanh_minval=0.1,
                         tanh_maxval=1.0),
                    dict(tanh_r=30.0, tanh_scale=10.0, tanh_minval=0.2,
                         tanh_maxval=0.9)),
    "vertical": (dict(method="vertical"),
                 dict(r0=10.0, k=1.0, p=1.0, gval=0.05),
                 dict(r0=20.0, k=0.5, p=2.0, gval=0.1, tads=10.0,
                      tsed=1e4)),
    "C/O-ratio": (dict(method="C/O-ratio", C_to_O_ratio=1.5),
                  dict(r0=20.0, vfac=0.5, p=2.0, k=0.1, gval=0.01), {}),
    "C/O-ratio-zscale": (dict(method="C/O-ratio", dep_zscale=5.0),
                         dict(r0=20.0, vfac=0.5, p=2.0, k=0.1, gval=0.01),
                         {}),
    "uniform": (dict(method="uniform", f_depl_O=0.1, f_depl_C=0.5,
                     deplete_nitrogen=True,
                     deplete_nitrogen_as_carbon=True), {}, {}),
}


def _depletion(pkg, name, mode):
    if pkg == "jax":
        from rac2d_tpu.models import depletion
    else:
        from rac2d_torch.models import depletion
    kw, o, c = CASES[name]
    return depletion, depletion.DepletionConfig(
        o=depletion.ElementDepletion(**o), c=depletion.ElementDepletion(**c),
        mode=mode, **kw)


@pytest.fixture(scope="module")
def disk():
    """(network, JAX grid, port grid, X, Tgas): the small bench disk and
    initial abundances scaled per cell, so that every carrier differs."""
    from rac2d_tpu.models.grid import make_grid as jmake
    from rac2d_torch.models.grid import make_grid as tmake
    net = umist.load_network(defaults.NETWORK,
                             enthalpy_path=defaults.ENTHALPIES)
    grids = []
    for pkg, make in (("jax", jmake), ("torch", tmake)):
        _, cfg = disk_cfg(pkg)
        grids.append(make(cfg.grid, cfg.andrews))
    jg, tg = grids
    for f in ("rmin", "rmax", "zmin", "zmax", "n0", "using", "col_ptr",
              "col_cells"):
        np.testing.assert_array_equal(getattr(tg, f), getattr(jg, f), f)
    y0 = umist.load_initial_abundances(net, defaults.INIT_ABUNDANCES)
    rng = np.random.default_rng(0)
    X = y0[:, None] * 10 ** rng.uniform(-0.5, 0.5, (len(y0), tg.n_cells))
    Tg = 10 ** rng.uniform(1.0, 3.0, tg.n_cells)
    return net, jg, tg, X, Tg


@pytest.mark.parametrize("mode", ["redistribute", "scale"])
@pytest.mark.parametrize("name", list(CASES))
def test_apply_depletion_matches_jax(disk, name, mode):
    net, jg, tg, X, Tg = disk
    out = {}
    for pkg, g in (("jax", jg), ("torch", tg)):
        mod, cfg = _depletion(pkg, name, mode)
        Xp = X.copy()
        ret = mod.apply_depletion(net, Xp, g, g.n0, Tg.copy(), cfg,
                                  star_mass=0.6, t_evol=1e5)
        assert ret is Xp                      # in place, as in JAX
        out[pkg] = Xp
    assert np.isfinite(out["torch"]).all()
    assert not np.array_equal(out["torch"], X), "depletion changed nothing"
    np.testing.assert_allclose(out["torch"], out["jax"], rtol=RTOL, atol=0)
