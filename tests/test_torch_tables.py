"""Parity of the port's table lookups (rac2d_torch.utils.interp,
rac2d_torch.io.tables) with the JAX package's, on the CPU.

Both packages evaluate the same f64 formulas on the same shipped tables,
so the bar is 1e-12 relative (last-bit differences of log/exp/pow), on
points drawn from a numpy seed that cover the tables and their edges.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from rac2d_torch.utils import interp as ti
from rac2d_tpu.utils import interp as ji

from torch_mc_fixtures import one_torch_thread  # noqa: F401 (autouse)

RTOL = 1e-12


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL,
                               atol=1e-300)


def test_interp_matches_jax():
    rng = np.random.default_rng(0)
    xp = np.sort(rng.uniform(0.0, 10.0, 17))
    fp = rng.uniform(0.1, 5.0, 17)
    x = rng.uniform(-2.0, 12.0, 200)        # below, inside and above xp
    t = torch.as_tensor
    _close(ti.interp1(t(x), t(xp), t(fp)), ji.interp1(x, xp, fp))
    _close(ti.loglog_interp1(t(x + 3.0), t(xp + 1.0), t(fp)),
           ji.loglog_interp1(x + 3.0, xp + 1.0, fp))
    xg, yg, zg = np.linspace(0, 1, 5), np.linspace(-1, 2, 7), \
        np.linspace(3, 4, 4)
    T2 = rng.standard_normal((5, 7))
    T3 = rng.standard_normal((5, 7, 4))
    x, y, z = (rng.uniform(a - 0.3, b + 0.3, 100)
               for a, b in ((0, 1), (-1, 2), (3, 4)))
    _close(ti.bilinear(t(x), t(y), t(xg), t(yg), t(T2)),
           ji.bilinear(x, y, xg, yg, T2))
    _close(ti.trilinear(t(x), t(y), t(z), t(xg), t(yg), t(zg), t(T3)),
           ji.trilinear(x, y, z, xg, yg, zg, T3))
    _close(ti.logspace(-3, 2, 11, "cpu"), ji.logspace(-3, 2, 11))


@pytest.mark.parametrize("name", ["NeufeldH2O", "NeufeldCO"])
def test_neufeld_tables_match_jax(name):
    from rac2d_torch.io import tables as tt
    from rac2d_tpu.io import tables as jt
    rng = np.random.default_rng(1)
    T = 10 ** rng.uniform(0.5, 3.8, 300)     # both sides of the 100 K split
    logN = rng.uniform(8.0, 22.0, 300)
    a, b = getattr(tt, name)("cpu"), getattr(jt, name)()
    for pa, pb in zip(a.params(torch.as_tensor(T), torch.as_tensor(logN)),
                      b.params(jnp.asarray(T), jnp.asarray(logN))):
        _close(pa, pb)
    for pa, pb in zip(a.vib_params(torch.as_tensor(T), torch.as_tensor(logN)),
                      b.vib_params(jnp.asarray(T), jnp.asarray(logN))):
        _close(pa, pb)


def test_neufeld_h2_visser_and_ion_luts_match_jax():
    from rac2d_torch import defaults
    from rac2d_torch.io import tables as tt
    from rac2d_tpu.io import tables as jt
    rng = np.random.default_rng(2)
    T = 10 ** rng.uniform(0.5, 4.0, 300)
    for pa, pb in zip(tt.NeufeldH2("cpu").params(torch.as_tensor(T)),
                      jt.NeufeldH2().params(jnp.asarray(T))):
        _close(pa, pb)
    N_H2 = 10 ** rng.uniform(-2.0, 24.0, 300)
    N_CO = 10 ** rng.uniform(-2.0, 20.0, 300)
    _close(tt.VisserCOShielding("cpu").shielding(torch.as_tensor(N_H2),
                                            torch.as_tensor(N_CO)),
           jt.VisserCOShielding().shielding(jnp.asarray(N_H2),
                                            jnp.asarray(N_CO)))
    ne = 10 ** rng.uniform(-6.0, 8.0, 300)
    for ion in ("N+", "Si+", "Fe+"):
        path = defaults.DATA / f"{ion}_LUT.bin"
        _close(tt.IonCoolingLUT(path, "cpu").cooling_per_ion(torch.as_tensor(ne),
                                                      torch.as_tensor(T)),
               jt.IonCoolingLUT(path).cooling_per_ion(jnp.asarray(ne),
                                                      jnp.asarray(T)))
