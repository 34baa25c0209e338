"""The port's coupled pool sweep against the JAX package, on the CPU.

The coupled chemistry+temperature pool sweep — ChemicalODE(net,
thermal=ThermalBalance(net)).solve_pool on the shipped network (NEQ =
485), evolT=True, per-lane retry ladder of 3 levels — through both
packages on the same cells (tests/test_chem_production.py
COUPLED_CELLS + a repeat of the dark-cloud cell, width 2 so lanes
stream through the window): the same fail pattern and ladder level per
lane, key species within 5% where the abundance is > 1e-12 (as
tests/test_chem_production.py:226-230) and final Tgas within 2%.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_chem_production import COUPLED_CELLS
from test_parity_oracle import _env_pairs
from test_torch_chem import D2G, _tenv_of
from torch_mc_fixtures import one_torch_thread  # noqa: F401 (autouse)


# 1 yr is the full check (243 s alone on an 8-core CPU); 1e-2 yr runs the
# same path in the default test run (195 s alone, about 75 s of it JAX's)
@pytest.mark.parametrize("t_end", [1e-2, pytest.param(1.0,
                                                      marks=pytest.mark.slow)])
def test_coupled_pool_sweep_matches_jax(t_end):
    from rac2d_tpu import defaults
    from rac2d_tpu.io import umist
    from rac2d_tpu.ops import bdf as jbdf, odesys, thermal

    from rac2d_torch import convert
    from rac2d_torch.ops import odesys as t_odesys

    cells = COUPLED_CELLS + [COUPLED_CELLS[0]]
    N = len(cells)
    net = umist.load_network(defaults.NETWORK,
                             enthalpy_path=defaults.ENTHALPIES)
    y0 = umist.load_initial_abundances(net, defaults.INIT_ABUNDANCES)
    tb = thermal.ThermalBalance(net)
    ode = odesys.ChemicalODE(net, thermal=tb)
    envs = jax.tree.map(lambda *a: jnp.stack(a),
                        *[_env_pairs(p)[1] for p in cells])
    tenvs = jax.tree.map(lambda *a: jnp.stack(a),
                         *[_tenv_of(thermal.ThermalEnv, p) for p in cells])
    touts = jbdf.log_output_times(1e-8, t_end, 2.0)
    T0 = np.array([p["T"] for p in cells])
    y0b = np.tile(y0, (N, 1))
    kw = dict(width=2, first_step=1e-8, evolT=True,
              max_steps_per_interval=500)

    rtol, atol = odesys.tolerance_ladder(net, 1, 1e-4, 1e-30, D2G)
    jres = ode.solve_pool(envs, jnp.asarray(y0b), jnp.asarray(T0),
                          jnp.asarray(touts), rtol, atol, tenvs=tenvs,
                          retry_tols=ode.retry_ladder(3, 1e-4, 1e-30, D2G),
                          **kw)

    tnet = convert.chem_net(net)
    t_ode = t_odesys.ChemicalODE(
        tnet, thermal=convert.thermal_balance(tb, "cpu"), device="cpu")
    trtol, tatol = t_odesys.tolerance_ladder(tnet, 1, 1e-4, 1e-30, D2G,
                                             "cpu")
    tres = t_ode.solve_pool(
        convert.cell_env(envs, "cpu"), torch.as_tensor(y0b), torch.as_tensor(T0),
        touts, trtol, tatol, tenvs=convert.thermal_env(tenvs, "cpu"),
        retry_tols=t_ode.retry_ladder(3, 1e-4, 1e-30, D2G), **kw)

    np.testing.assert_array_equal(tres.fail.numpy(), np.asarray(jres.fail))
    np.testing.assert_array_equal(tres.retry_level.numpy(),
                                  np.asarray(jres.retry_level))
    nS = net.n_species
    yt = tres.ys[:, -1].numpy()
    yj = np.asarray(jres.ys[:, -1])
    assert np.isfinite(yt).all()
    ki = net.key_species_idx
    for b in range(N):
        big = np.abs(yj[b, ki]) > 1e-12
        rel = np.abs(yt[b, ki] - yj[b, ki])[big] / np.abs(yj[b, ki])[big]
        assert rel.max() < 0.05, (b, rel.max())
        assert abs(yt[b, nS] - yj[b, nS]) < 0.02 * yj[b, nS], b
