"""Parity of the PyTorch chemistry stack (rac2d_torch) with the JAX package.

The same inputs — the shipped network, the cell environments of
tests/test_parity_oracle.py (POINTS) and tests/test_chem_production.py
(COUPLED_CELLS), abundance vectors drawn from a numpy seed — go through
both packages on the CPU:

  - rates, RHS and species Jacobian at 5e-12 relative (atol 1e-250), the
    bar of tests/test_parity_oracle.py:67 (both sides run the same f64
    formulas; the differences are last-bit differences of exp/pow);
  - every heating/cooling term and dT/dt at 1e-10 relative;
  - the coupled (evolT) RHS and dense Jacobian with its FD temperature
    row/column at 1e-10 relative to each row's scale.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_chem_production import COUPLED_CELLS
from test_parity_oracle import POINTS, _env_pairs

CELLS = POINTS + COUPLED_CELLS
D2G = 2.8e-12


@pytest.fixture(scope="module")
def both():
    from rac2d_tpu import defaults
    from rac2d_tpu.io import umist
    from rac2d_tpu.ops import odesys, thermal

    from rac2d_torch import convert
    from rac2d_torch.ops import odesys as t_odesys

    net = umist.load_network(defaults.NETWORK,
                             enthalpy_path=defaults.ENTHALPIES)
    y0 = umist.load_initial_abundances(net, defaults.INIT_ABUNDANCES)
    tb = thermal.ThermalBalance(net)
    ode = odesys.ChemicalODE(net, thermal=tb)
    t_tb = convert.thermal_balance(tb, "cpu")
    t_ode = t_odesys.ChemicalODE(convert.chem_net(net), thermal=t_tb,
                                 device="cpu")

    envs = jax.tree.map(lambda *a: jnp.stack(a),
                        *[_env_pairs(p)[1] for p in CELLS])
    tenvs = jax.tree.map(lambda *a: jnp.stack(a),
                         *[_tenv_of(thermal.ThermalEnv, p) for p in CELLS])
    T = np.array([p["T"] for p in CELLS])
    return dict(net=net, y0=y0, tb=tb, ode=ode, t_tb=t_tb, t_ode=t_ode,
                envs=envs, tenvs=tenvs, T=T,
                t_envs=convert.cell_env(envs, "cpu"),
                t_tenvs=convert.thermal_env(tenvs, "cpu"))


def _tenv_of(cls, p):
    """The realistic dust population of the production cells
    (tests/test_chem_production.py:65-74)."""
    return cls.default(
        omega_Kepler=2e-9, velo_width_turb=3e4, coherent_length=1e13,
        n_dusts=np.array([D2G * p["n"], 0, 0, 0]),
        sig_dusts=np.array([np.pi * 1e-10, 0, 0, 0]),
        Tdusts=np.array([p["Tdust"], 0, 0, 0]))


def _states(y0, n, seed):
    """n abundance vectors: initial, randomized positive, with negative
    excursions (as tests/test_parity_oracle.py:84-92)."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n):
        y = y0 * 10 ** rng.uniform(-2, 2, y0.shape) + 1e-30 if b % 3 \
            else y0.copy()
        if b % 3 == 2:
            y[rng.integers(0, len(y0), 40)] *= -1.0
        out.append(y)
    return np.stack(out)


def _rates_both(both):
    from rac2d_tpu.ops import rates as jr
    from rac2d_torch.ops import rates as tr
    kj = np.asarray(jax.jit(jax.vmap(
        lambda e, T: jr.compute_rates(both["ode"].tab, e, T)))(
        both["envs"], jnp.asarray(both["T"])))
    kt = tr.compute_rates(both["t_ode"].tab, both["t_envs"],
                          torch.as_tensor(both["T"])).numpy()
    return kj, kt


def test_network_parse_equals_jax(both):
    """The port's UMIST parser reads the shipped network, enthalpies and
    initial abundances into exactly the JAX package's arrays."""
    import dataclasses
    from rac2d_torch import defaults
    from rac2d_torch.io import umist
    net = umist.load_network(defaults.NETWORK,
                             enthalpy_path=defaults.ENTHALPIES)
    ref = both["net"]
    for f in dataclasses.fields(umist.ChemNet):
        a, b = getattr(net, f.name), getattr(ref, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(
                a, b, equal_nan=a.dtype.kind == "f"), f.name
        else:
            assert a == b, f.name
    y0 = umist.load_initial_abundances(net, defaults.INIT_ABUNDANCES)
    assert np.array_equal(y0, both["y0"])
    from rac2d_tpu.io import umist as jumist
    assert np.array_equal(umist.elemental_abundances(net, y0),
                          jumist.elemental_abundances(ref, both["y0"]))


def test_rate_tables_convert_equal_built(both):
    """Tables built by the port from the network equal the JAX tables
    carried across by rac2d_torch.convert."""
    from rac2d_torch import convert
    from rac2d_torch.ops import network as tn, rates as tr
    for built, conv in (
            (both["t_ode"].tab, convert.rate_tables(both["ode"].tab, "cpu")),
            (both["t_ode"].inc, convert.incidence(both["ode"].inc, "cpu"))):
        for f in type(built)._fields:
            a, b = getattr(built, f), getattr(conv, f)
            if isinstance(a, int):
                assert a == b, f
            else:
                assert a.dtype == b.dtype and torch.equal(a, b), f
    assert isinstance(both["t_ode"].tab, tr.RateTables)
    assert isinstance(both["t_ode"].inc, tn.Incidence)


@pytest.mark.parametrize("ic", range(len(CELLS)))
def test_rates_match_jax(both, ic):
    kj, kt = _rates_both(both)
    np.testing.assert_allclose(kt[ic], kj[ic], rtol=5e-12, atol=1e-250)


def test_rhs_jac_species_match_jax(both):
    from rac2d_tpu.ops import network as jn
    from rac2d_torch.ops import network as tn
    kj, kt = _rates_both(both)
    nS = both["net"].n_species
    ys = _states(both["y0"], len(CELLS), 7)
    d2h = np.asarray(both["envs"].ratioDust2HnucNum)
    spg = np.asarray(both["envs"].SitesPerGrain)
    inc = both["ode"].inc
    fj = np.asarray(jax.vmap(lambda k, y, a, s: jn.rhs_species(
        inc, k, y, a, s))(kj, ys, d2h, spg))
    Jj = np.asarray(jax.vmap(lambda k, y, a, s: jn.jac_species(
        inc, k, y, a, s))(kj, ys, d2h, spg))
    tinc = both["t_ode"].inc
    tt = torch.as_tensor
    ft = tn.rhs_species(tinc, tt(kt), tt(ys), tt(d2h), tt(spg)).numpy()
    Jt = tn.jac_species(tinc, tt(kt), tt(ys), tt(d2h), tt(spg)).numpy()
    assert ft.shape == (len(CELLS), nS) and Jt.shape == (len(CELLS), nS, nS)
    np.testing.assert_allclose(ft, fj, rtol=5e-12, atol=1e-250)
    np.testing.assert_allclose(Jt, Jj, rtol=5e-12, atol=1e-250)


def test_thermal_terms_and_dTdt_match_jax(both):
    """Every heating/cooling term and dT/dt, on the initial and on
    randomized states, with the rate vector passed in (chemical heating,
    H2 formation)."""
    from rac2d_torch.ops import thermal as tt_mod
    kj, kt = _rates_both(both)
    ys = _states(both["y0"], len(CELLS), 11)
    T = both["T"]
    yT = np.concatenate([ys, T[:, None]], axis=1)
    tb = both["tb"]
    rj = jax.vmap(lambda y, T, e, te, k: tb.rates(y, T, e, te, k))(
        yT, T, both["envs"], both["tenvs"], kj)
    tt = torch.as_tensor
    rt = both["t_tb"].rates(tt(yT), tt(T), both["t_envs"], both["t_tenvs"],
                            tt(kt))
    assert isinstance(rt, tt_mod.HeatingCoolingRates)
    for name in rt._fields:
        a = getattr(rt, name).numpy()
        b = np.asarray(getattr(rj, name))
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-300,
                                   err_msg=name)
    dj = np.asarray(jax.vmap(lambda y, T, e, te, k: tb.dTdt(y, T, e, te, k))(
        yT, T, both["envs"], both["tenvs"], kj))
    dt = both["t_tb"].dTdt(tt(yT), tt(T), both["t_envs"], both["t_tenvs"],
                           tt(kt)).numpy()
    np.testing.assert_allclose(dt, dj, rtol=1e-10, atol=0)


def test_thermal_rejects_unported_modes(both):
    from rac2d_torch.ops.thermal import HcConfig, ThermalBalance
    for kw in ("tdust_iter_tandem", "dust_gas_linear_couple",
               "allow_gas_dust_en_exch"):
        with pytest.raises(NotImplementedError):
            ThermalBalance(both["t_tb"].net, HcConfig(**{kw: True}),
                           device="cpu")


def test_coupled_f_and_jac_match_jax(both):
    """The evolT system: f and the dense Jacobian with its FD temperature
    column and key-species row (odesys.py:152-184 in both packages)."""
    ode, t_ode = both["ode"], both["t_ode"]
    nS = both["net"].n_species
    ys = _states(both["y0"], len(CELLS), 3)
    ys = np.abs(ys)       # the coupled solver's states are positive
    yT = np.concatenate([ys, both["T"][:, None]], axis=1)
    fj = np.asarray(jax.vmap(lambda y, e, te: ode.make_f(e, True, te)(y))(
        yT, both["envs"], both["tenvs"]))
    Jj = np.asarray(jax.vmap(lambda y, e, te: ode.make_jac(e, True, te)(y))(
        yT, both["envs"], both["tenvs"]))
    y = torch.as_tensor(yT)
    ft = t_ode.make_f(both["t_envs"], True, both["t_tenvs"])(y).numpy()
    Jt = t_ode.make_jac(both["t_envs"], True, both["t_tenvs"])(y).numpy()
    np.testing.assert_allclose(ft[:, :nS], fj[:, :nS], rtol=5e-12,
                               atol=1e-250)
    np.testing.assert_allclose(ft[:, nS], fj[:, nS], rtol=1e-10)
    np.testing.assert_allclose(Jt[:, :nS, :nS], Jj[:, :nS, :nS],
                               rtol=5e-12, atol=1e-250)
    # T column (FD over dT = 0.01 T + 1): at 1e-10 of the column's scale
    a, b = Jt[:, :, nS], Jj[:, :, nS]
    scale = np.abs(b).max(axis=1, keepdims=True)
    assert (np.abs(a - b) <= 1e-10 * scale).all()
    # T row (FD of dT/dt over dy_i = 0.01 y_i + 1e-6 d2h): the numerator
    # is a difference of two sums of heating/cooling terms that nearly
    # cancel, so its roundoff scales with sum|terms|, not with dT/dt; the
    # bar is 1e-10 of sum|terms| (in K/yr) divided by dy_i
    from rac2d_tpu import constants as c
    kj, _ = _rates_both(both)
    rj = jax.vmap(lambda y, T, e, te, k: both["tb"].rates(y, T, e, te, k))(
        yT, both["T"], both["envs"], both["tenvs"], kj)
    S = sum(np.abs(np.asarray(v)) for v in rj) * c.SecondsPerYear \
        / (np.asarray(both["envs"].n_gas) * c.kBoltzmann_CGS)
    key = both["net"].key_species_idx
    dy = yT[:, key] * 1e-2 + D2G * 1e-6
    diff = np.abs(Jt[:, nS, key] - Jj[:, nS, key])
    assert (diff <= 1e-10 * S[:, None] / dy).all()
    other = np.setdiff1d(np.arange(nS), key)
    assert (Jt[:, nS, other] == 0).all() and (Jj[:, nS, other] == 0).all()
