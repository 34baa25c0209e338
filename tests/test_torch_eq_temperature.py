"""Port parity: the equilibrium gas temperature (thermal.solve_equilibrium_T)
against the JAX package on the CPU.  The evolT=False chemistry hand-off,
which runs it inside the sweep, is in tests/test_torch_eq_hand_off.py (a
file of its own: the JAX sweep's compile alone takes about a minute).

Tolerances and why:
- solve_equilibrium_T on the cells of tests/test_torch_chem.py (POINTS +
  COUPLED_CELLS) with abundances drawn from a numpy seed, T0 at 10, 100
  and 1000 K, against the JAX function under jax.vmap: the bracket flags
  equal and |dT| <= 1e-5 T + 0.1 K, the bisection's own stopping width
  (the net rates agree to 1e-10, tests/test_torch_chem.py, so a sign may
  differ only within the last bracket).  The max relative dT is printed;
  it is about 1e-12 (the same bisection steps);
- a case that cannot bracket (n_expand = 1, T0 far from equilibrium):
  the same flags, and T0 itself where no bracket was found, on both sides.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_torch_chem import CELLS, _tenv_of
from test_parity_oracle import _env_pairs
from torch_mc_fixtures import one_torch_thread  # noqa: F401 (autouse)

RTOL_T, ATOL_T = 1e-5, 0.1


@pytest.fixture(scope="module")
def both():
    """The JAX ThermalBalance and rate tables and the port's copies, the
    cells' environments in both packages, and seeded abundances [B, nS+1]
    (the last column a placeholder T, replaced by each trial T)."""
    from rac2d_tpu import defaults
    from rac2d_tpu.io import umist
    from rac2d_tpu.ops import odesys, thermal

    from rac2d_torch import convert

    net = umist.load_network(defaults.NETWORK,
                             enthalpy_path=defaults.ENTHALPIES)
    y0 = umist.load_initial_abundances(net, defaults.INIT_ABUNDANCES)
    tb = thermal.ThermalBalance(net)
    ode = odesys.ChemicalODE(net, thermal=tb)
    envs = jax.tree.map(lambda *a: jnp.stack(a),
                        *[_env_pairs(p)[1] for p in CELLS])
    tenvs = jax.tree.map(lambda *a: jnp.stack(a),
                         *[_tenv_of(thermal.ThermalEnv, p) for p in CELLS])
    rng = np.random.default_rng(3)
    y = y0[None, :] * 10 ** rng.uniform(-1, 1, (len(CELLS), len(y0)))
    y = np.concatenate([y, np.full((len(CELLS), 1), 50.0)], axis=1)
    return dict(tb=tb, tab=ode.tab, envs=envs, tenvs=tenvs, y=y,
                t_tb=convert.thermal_balance(tb, "cpu"),
                t_tab=convert.rate_tables(ode.tab, "cpu"),
                t_envs=convert.cell_env(envs, "cpu"),
                t_tenvs=convert.thermal_env(tenvs, "cpu"))


@pytest.fixture(scope="module")
def jax_solve(both):
    """The JAX function under vmap, compiled once: n_expand is an argument
    (its loop bound may be traced)."""
    tb, tab = both["tb"], both["tab"]
    return jax.jit(jax.vmap(
        lambda y, e, te, t0, n_expand: tb.solve_equilibrium_T(
            y, e, te, t0, tab, n_expand=n_expand),
        in_axes=(0, 0, 0, 0, None)))


def _solve_both(both, jax_solve, T0, n_expand=60):
    """(T, bracketed) of the JAX function and of the port's, as numpy
    arrays."""
    jT, jb = jax_solve(jnp.asarray(both["y"]), both["envs"], both["tenvs"],
                       jnp.asarray(T0), n_expand)
    tT, tb_ = both["t_tb"].solve_equilibrium_T(
        torch.as_tensor(both["y"]), both["t_envs"], both["t_tenvs"],
        torch.as_tensor(T0), both["t_tab"], n_expand=n_expand)
    return np.asarray(jT), np.asarray(jb), tT.numpy(), tb_.numpy()


@pytest.mark.parametrize("T0", [10.0, 100.0, 1000.0])
def test_solve_equilibrium_T_matches_jax(both, jax_solve, T0):
    T0s = np.full(len(CELLS), T0)
    jT, jb, tT, tb = _solve_both(both, jax_solve, T0s)
    np.testing.assert_array_equal(tb, jb)
    assert jb.any()
    dT = np.abs(tT - jT)
    rel = float((dT / jT).max())
    print(f"T0 {T0:g} K: {int(jb.sum())}/{len(jb)} bracketed, max rel dT "
          f"{rel:.3e}")
    assert (dT <= RTOL_T * jT + ATOL_T).all(), rel
    np.testing.assert_array_equal(tT[~tb], T0s[~tb])


def test_no_bracket_returns_T0(both, jax_solve):
    """One expansion step from T0 = 3e4 K, far above every cell's
    equilibrium: no lane brackets, and both return T0."""
    T0s = np.full(len(CELLS), 3e4)
    jT, jb, tT, tb = _solve_both(both, jax_solve, T0s, n_expand=1)
    np.testing.assert_array_equal(tb, jb)
    assert not jb.any()
    np.testing.assert_array_equal(jT, T0s)
    np.testing.assert_array_equal(tT, T0s)

