"""Port parity: one cell through ChemicalODE.solve (the single-system BDF
solver), on the CPU.

The dark-cloud cell of tests/test_single_cell.py (10 K, n = 2e4 cm^-3,
Av = 10, no thermal balance), built on the shipped network and initial
abundances (that test takes the absent reference's network), from 1e-8
yr with record times a factor 1.3 apart, rtol 1e-4 and atol 1e-30 (the
first level of the tolerance ladder).  The port's solve and the JAX
package's jitted solve: both complete with the same accepted steps, every
abundance above 1e-12 agrees within 1e-9 relative (measured: 7e-15 at
1e2 yr, 7e-13 at 1e6 yr; both factor the Newton matrix with LAPACK's
pivoted f32 LU), and the elements are conserved as the JAX test holds
them.  Tier-1 runs to 1e2 yr; to 1e6 yr, with that test's dark-cloud
chemistry, is marked slow.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from torch_mc_fixtures import one_torch_thread  # noqa: F401 (autouse)

D2G_NUM = 2.8e-12
ENV = dict(Tgas=10.0, Tdust=10.0, n_gas=2e4, Av_toISM=10.0, Av_toStar=10.0,
           G0_UV_toISM=1.0, GrainRadius_CGS=1e-5, sigdust_ave=np.pi * 1e-10,
           ndust_tot=D2G_NUM * 2e4, ratioDust2HnucNum=D2G_NUM,
           SitesPerGrain=4 * np.pi * 1e-10 * 1e15)


def dark_cloud(t_max):
    """(network, y0, JAX result, port result) to t_max yr."""
    from rac2d_tpu import defaults
    from rac2d_tpu.io import umist
    from rac2d_tpu.ops import bdf as jbdf, odesys, rates
    from rac2d_torch import convert
    from rac2d_torch.ops import odesys as t_odesys, rates as t_rates
    net = umist.load_network(defaults.NETWORK,
                             enthalpy_path=defaults.ENTHALPIES)
    y0 = umist.load_initial_abundances(net, defaults.INIT_ABUNDANCES)
    rtol, atol = odesys.tolerance_ladder(net, 1, 1e-4, 1e-30, D2G_NUM)
    touts = jbdf.log_output_times(1e-8, t_max, 1.3)
    ode = odesys.ChemicalODE(net)
    env = rates.CellEnv.default(**ENV)
    rj = jax.jit(lambda y, T: ode.solve(env, y, T, jnp.asarray(touts), rtol,
                                        atol, first_step=1e-8))(
        jnp.asarray(y0), jnp.asarray(10.0))
    t_ode = t_odesys.ChemicalODE(convert.chem_net(net), device="cpu")
    rt = t_ode.solve(t_rates.CellEnv.default("cpu", **ENV), y0, 10.0, touts,
                     np.array(rtol), np.array(atol), first_step=1e-8)
    return net, y0, rj, rt


@pytest.mark.parametrize("t_max", [
    1e2, pytest.param(1e6, marks=pytest.mark.slow)])
def test_dark_cloud_matches_jax(t_max):
    from rac2d_tpu.io import umist
    net, y0, rj, rt = dark_cloud(t_max)
    nS = net.n_species
    assert not bool(rt.fail) and not bool(rj.fail)
    assert float(rt.t_final) == pytest.approx(t_max)
    assert int(rt.n_steps) == int(rj.n_steps) > 50
    assert rt.ys.shape == rj.ys.shape
    a = rt.ys[-1].numpy()[:nS]
    b = np.asarray(rj.ys[-1])[:nS]
    big = np.abs(b) > 1e-12
    rel = np.abs(a - b)[big] / np.abs(b[big])
    assert rel.max() < 1e-9, rel.max()
    # element conservation, as tests/test_single_cell.py holds it: charge
    # and every real element (the electron count, index 1, changes with
    # the ionization state)
    drift = np.abs(umist.elemental_abundances(net, a)
                   - umist.elemental_abundances(net, y0))
    assert drift[0] < 1e-12
    assert drift[2:].max() < 1e-10
    if t_max >= 1e6:
        # tests/test_single_cell.py::test_dark_cloud_chemistry
        def x(name):
            return a[net.species.index(name)]
        assert 0.49 < x("H2") < 0.501
        assert 1e-6 < x("CO") < 2e-4
        assert x("gH2O") > 1e-5
        assert x("gCO") > 1e-6
        assert 1e-9 < x("E-") < 1e-6
        assert np.isfinite(a).all() and a.min() > -1e-12
