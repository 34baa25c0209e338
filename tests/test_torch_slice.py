"""The port's main-path slice against the JAX package, on the CPU.

(d) The pool driver (rac2d_torch.ops.bdf) on the stiff Robertson problem
    against scipy's BDF, as tests/test_bdf.py:26-45 holds the JAX solver,
    and against the JAX pool driver on the same inputs.
(e) The coupled chemistry+temperature pool sweep — ChemicalODE(net,
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


def _robertson_torch():
    def f_b(y, args):
        return torch.stack([
            -0.04 * y[:, 0] + 1e4 * y[:, 1] * y[:, 2],
            0.04 * y[:, 0] - 1e4 * y[:, 1] * y[:, 2] - 3e7 * y[:, 1] ** 2,
            3e7 * y[:, 1] ** 2], dim=1)

    def jac_b(y, args):
        z = torch.zeros_like(y[:, 0])
        return torch.stack([
            torch.stack([z - 0.04, 1e4 * y[:, 2], 1e4 * y[:, 1]], 1),
            torch.stack([z + 0.04, -1e4 * y[:, 2] - 6e7 * y[:, 1],
                         -1e4 * y[:, 1]], 1),
            torch.stack([z, 6e7 * y[:, 1], z], 1)], dim=1)

    return f_b, jac_b


def _robertson_jax():
    def f(y):
        return jnp.array([
            -0.04 * y[0] + 1e4 * y[1] * y[2],
            0.04 * y[0] - 1e4 * y[1] * y[2] - 3e7 * y[1] ** 2,
            3e7 * y[1] ** 2])

    def jac(y):
        return jnp.array([
            [-0.04, 1e4 * y[2], 1e4 * y[1]],
            [0.04, -1e4 * y[2] - 6e7 * y[1], -1e4 * y[1]],
            [0.0, 6e7 * y[1], 0.0]])

    return (lambda y, a: jax.vmap(f)(y)), (lambda y, a: jax.vmap(jac)(y))


Y0_ROB = np.array([[1.0, 0.0, 0.0], [0.7, 0.2, 0.1], [0.5, 0.0, 0.5],
                   [0.9, 0.05, 0.05], [1.0, 0.0, 0.0]])


def _scipy_robertson(y0, touts):
    from scipy.integrate import solve_ivp
    f_b, jac_b = _robertson_torch()
    sol = solve_ivp(
        lambda t, y: f_b(torch.as_tensor(y)[None], None)[0].numpy(),
        (0, touts[-1]), y0, method="BDF", rtol=1e-10, atol=1e-14,
        t_eval=touts,
        jac=lambda t, y: jac_b(torch.as_tensor(y)[None], None)[0].numpy())
    return sol.y.T


def test_advance_robertson_against_scipy():
    """Every recorded state of the continuous-recording advance loop."""
    from rac2d_torch.ops import bdf
    f_b, jac_b = _robertson_torch()
    touts = np.logspace(-5, 5, 20)
    B = 2
    y0 = torch.as_tensor(Y0_ROB[:B])
    rtol = torch.full((B, 3), 1e-6, dtype=torch.float64)
    atol = torch.full((B, 3), 1e-10, dtype=torch.float64)
    cst = bdf.ContState(
        st=bdf._batch_init(f_b, y0, 0.0, 1e-6, None),
        irec=torch.zeros(B, dtype=torch.int64),
        since=torch.zeros(B, dtype=torch.int64),
        ts=torch.zeros(B, 20, dtype=torch.float64),
        ys=torch.zeros(B, 20, 3, dtype=torch.float64))
    adv = bdf.make_advance(f_b, jac_b, 2000, None, 1)
    cst = adv(cst, torch.as_tensor(touts), float(touts[-1]), rtol, atol,
              None, 100000)
    assert not bool(cst.st.fail.any())
    assert (cst.irec == 20).all()
    np.testing.assert_array_equal(cst.ts.numpy(), np.tile(touts, (B, 1)))
    for b in range(B):
        ref = _scipy_robertson(Y0_ROB[b], touts)
        bound = 10.0 * (1e-6 * np.abs(ref) + 1e-10)
        assert (np.abs(cst.ys[b].numpy() - ref) < bound).all(), b


def test_pool_robertson_matches_scipy_and_jax():
    """5 lanes through a window of 2 (refills), final states vs scipy and
    vs the JAX pool driver on the same inputs."""
    from rac2d_tpu.ops import bdf as jbdf
    from rac2d_torch.ops import bdf
    touts = np.logspace(-3, 3, 8)
    N = len(Y0_ROB)
    rtol = np.full((N, 3), 1e-6)
    atol = np.full((N, 3), 1e-10)
    f_b, jac_b = _robertson_torch()
    tt = torch.as_tensor
    res = bdf.bdf_solve_batch_pool(f_b, jac_b, tt(Y0_ROB), 0.0, touts,
                                   tt(rtol), tt(atol), 1e-6, width=2,
                                   rounds_per_call=64)
    jf, jj = _robertson_jax()
    jres = jbdf.bdf_solve_batch_pool(jf, jj, jnp.asarray(Y0_ROB), 0.0,
                                     jnp.asarray(touts), jnp.asarray(rtol),
                                     jnp.asarray(atol), 1e-6, width=2,
                                     rounds_per_call=64)
    assert not bool(res.fail.any())
    np.testing.assert_array_equal(res.fail.numpy(), np.asarray(jres.fail))
    np.testing.assert_array_equal(res.t_final.numpy(),
                                  np.asarray(jres.t_final))
    y = res.ys[:, -1].numpy()
    yj = np.asarray(jres.ys[:, -1])
    for b in range(N):
        ref = _scipy_robertson(Y0_ROB[b], touts)[-1]
        bound = 10.0 * (1e-6 * np.abs(ref) + 1e-10)
        assert (np.abs(y[b] - ref) < bound).all(), b
        assert (np.abs(y[b] - yj[b]) < 0.1 * bound).all(), b


def test_pool_step_budget_and_ladder():
    """A lane that cannot reach its next tout within the round budget
    fails; with a retry ladder it is rolled back and retried at each
    level before it counts as failed."""
    from rac2d_torch.ops import bdf
    f_b, jac_b = _robertson_torch()
    touts = np.logspace(-3, 3, 6)
    tt = torch.as_tensor
    y0 = tt(Y0_ROB[:2])
    rtol = torch.full((2, 3), 1e-6, dtype=torch.float64)
    atol = torch.full((2, 3), 1e-10, dtype=torch.float64)
    ladder = [(torch.full((3,), 1e-5, dtype=torch.float64),
               torch.full((3,), 1e-9, dtype=torch.float64))] * 2
    res = bdf.bdf_solve_batch_pool(f_b, jac_b, y0, 0.0, touts, rtol, atol,
                                   1e-6, width=2, max_steps_per_interval=3,
                                   rounds_per_call=32, retry_tols=ladder)
    assert bool(res.fail.all())
    assert res.retry_level.tolist() == [2, 2]


def test_pool_wall_budget_marks_unfinished_lanes_failed():
    """When max_wall_s runs out (timed from the end of the first advance
    call), the lanes in the window are flushed as failed at their last
    state and the pool entries never started stay failed with y0."""
    from rac2d_torch.ops import bdf
    f_b, jac_b = _robertson_torch()
    touts = np.logspace(-3, 3, 6)
    tt = torch.as_tensor
    N = len(Y0_ROB)
    rtol = torch.full((N, 3), 1e-6, dtype=torch.float64)
    atol = torch.full((N, 3), 1e-10, dtype=torch.float64)
    res = bdf.bdf_solve_batch_pool(f_b, jac_b, tt(Y0_ROB), 0.0, touts, rtol,
                                   atol, 1e-6, width=2, rounds_per_call=1,
                                   max_wall_s=0.0)
    assert bool(res.fail.all())
    assert int(res.n_steps[:2].sum()) > 0
    assert (res.n_steps[2:] == 0).all() and (res.t_final[2:] == 0).all()
    np.testing.assert_array_equal(res.ys[2:, -1].numpy(), Y0_ROB[2:])


# 1 yr is the full check (~165 s on an 8-core CPU, JAX's share ~85 s of it,
# mostly compile); 1e-2 yr runs the same path in the default test run
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
    t_ode = t_odesys.ChemicalODE(tnet, thermal=convert.thermal_balance(tb))
    trtol, tatol = t_odesys.tolerance_ladder(tnet, 1, 1e-4, 1e-30, D2G)
    tres = t_ode.solve_pool(
        convert.cell_env(envs), torch.as_tensor(y0b), torch.as_tensor(T0),
        touts, trtol, tatol, tenvs=convert.thermal_env(tenvs),
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
