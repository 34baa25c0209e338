"""Port parity: the gas-dust energy-exchange modes (rac2d_torch.ops.thermal),
on the CPU.

The same inputs, made from numpy seeds, go through the JAX package's
ThermalBalance and the port's (carried across by convert.thermal_balance,
LUT included):

  - the LUT helpers _lut_Td and _lut_val at 1e-12, on the port's bench
    optics LUT (silicate and graphite, 256 temperatures) and on the
    synthetic T^4 LUT of tests/test_tables_thermal.py, with values below,
    at and inside the table and above it;
  - _tandem_tdusts and _demit_dtd at 1e-10 on six cells of two dust
    components (two of four slots padded, which must come back as they
    were), with exchange coefficients from weak to saturating;
  - every heating/cooling rate at 1e-10 under the flag sets {allow},
    {tandem}, {allow, tandem}, {linear} and {allow, tandem, linear}; the
    first two change nothing in either package, so the port's rates under
    them are bit-equal to its rates with no flag;
  - the physical-direction assertions of
    tests/test_tables_thermal.py::test_thermal_tandem_and_dynamic_alpha
    on the shipped network, in both packages;
  - the coupled f, dense Jacobian and dT/dt with every mode on, at the
    bars of tests/test_torch_chem.py::test_coupled_f_and_jac_match_jax.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_chem_production import COUPLED_CELLS
from test_parity_oracle import POINTS, _env_pairs
from test_torch_chem import _states

from torch_mc_fixtures import one_torch_thread  # noqa: F401 (autouse)

CELLS = POINTS + COUPLED_CELLS
D2G = 2.8e-12
VOL_CM3 = 1e40
PMASS = np.array([1.26e-14, 1.0e-13])
FLAG_SETS = {
    "allow": dict(allow_gas_dust_en_exch=True),
    "tandem": dict(tdust_iter_tandem=True),
    "allow+tandem": dict(allow_gas_dust_en_exch=True,
                         tdust_iter_tandem=True),
    "linear": dict(dust_gas_linear_couple=True),
    "all": dict(allow_gas_dust_en_exch=True, tdust_iter_tandem=True,
                dust_gas_linear_couple=True),
}


def bench_lut():
    """The port's optics LUT for the bench dust: silicate and graphite,
    MRN 0.01-1 um, 256 temperatures from TdustMin to TdustMax."""
    from rac2d_torch import defaults
    from rac2d_torch.io import draine
    from rac2d_torch.ops import optics
    mixes = [draine.mrn_average(draine.load_opti(f), 0.01, 1.0, 3.5, 2.0)
             for f in (defaults.SILICATE_OPTI, defaults.GRAPHITE_OPTI)]
    tab = optics.build_tables(mixes, optics.McConfig(nlen_lut=256,
                                                     n_quantile=16))
    return tab.lut_Tds, tab.lut_vals


def synthetic_lut():
    """tests/test_tables_thermal.py's gray-body LUT: val ~ T^4."""
    Tds = np.linspace(1.0, 2000.0, 256)
    return Tds, ((5.67e-5 / np.pi) * Tds ** 4)[None, :]


@pytest.fixture(scope="module")
def net():
    from rac2d_tpu import defaults
    from rac2d_tpu.io import umist
    return umist.load_network(defaults.NETWORK,
                              enthalpy_path=defaults.ENTHALPIES)


@pytest.fixture(scope="module")
def lut():
    return bench_lut()


def balances(net, lut, flags):
    """(JAX ThermalBalance, the port's) with `flags` and the LUT."""
    from rac2d_tpu.ops import thermal
    from rac2d_torch import convert
    tb = thermal.ThermalBalance(net, config=thermal.HcConfig(**flags),
                                tdust_lut=lut)
    return tb, convert.thermal_balance(tb, "cpu")


def tenv_fields(lut, seed):
    """ThermalEnv fields of the CELLS with two dust components: their
    absorbed power en_gains put each component at a radiative-equilibrium
    Tdust of 0.5-2 x the cell's (inf in the padded slots and in one real
    one, the sentinel of an unlimited budget)."""
    Tds, vals = lut
    rng = np.random.default_rng(seed)
    out = []
    for ic, p in enumerate(CELLS):
        n_d = np.array([D2G, 0.3 * D2G]) * p["n"]
        m = n_d * VOL_CM3 * PMASS
        Trad = p["Tdust"] * 10 ** rng.uniform(-0.3, 0.3, 2)
        gains = 4 * np.pi * m * np.array(
            [np.interp(Trad[j], Tds, vals[j % len(vals)]) for j in range(2)])
        if ic == 2:
            gains[1] = np.inf
        out.append(dict(
            omega_Kepler=2e-9, velo_width_turb=3e4, coherent_length=1e13,
            n_dusts=np.r_[n_d, 0, 0],
            sig_dusts=np.array([np.pi * 1e-10, np.pi * 4e-10, 0, 0]),
            Tdusts=np.array([p["Tdust"], 0.8 * p["Tdust"], 0, 0]),
            en_gains=np.r_[gains, np.inf, np.inf], mdusts_cell=np.r_[m, 0, 0],
            volume=VOL_CM3 / 1.49597871e13 ** 3))
    return out


def envs_both(lut, seed):
    """(JAX envs, JAX tenvs, port envs, port tenvs) of the CELLS."""
    from rac2d_tpu.ops import thermal
    from rac2d_torch import convert

    def stack(xs):
        return jax.tree.map(lambda *a: jnp.stack(a), *xs)

    envs = stack([_env_pairs(p)[1] for p in CELLS])
    tenvs = stack([thermal.ThermalEnv.default(**kw)
                   for kw in tenv_fields(lut, seed)])
    return (envs, tenvs, convert.cell_env(envs, "cpu"),
            convert.thermal_env(tenvs, "cpu"))


def lut_queries(lut, seed):
    """[M, nd] energies per dust mass for _lut_Td (below the table, at
    its first node, inside, at a node, at its top, above) and [M, nd]
    temperatures for _lut_val (below, inside, at nodes, above)."""
    Tds, vals = lut
    rng = np.random.default_rng(seed)
    lo, hi = vals[:, 0], vals[:, -1]
    inside = np.exp(rng.uniform(np.log(np.maximum(lo, 1e-300)), np.log(hi),
                                (40, len(vals))))
    q = np.concatenate([0.1 * lo[None], 0.5 * lo[None], lo[None], inside,
                        vals[:, 100][None], hi[None], 2.0 * hi[None]])
    T = np.concatenate([
        np.full((1, len(vals)), 0.5 * Tds[0]),
        10 ** rng.uniform(np.log10(Tds[0]), np.log10(Tds[-1]),
                          (40, len(vals))),
        np.tile(Tds[[0, 7, -1]][:, None], (1, len(vals))),
        np.full((1, len(vals)), 2.0 * Tds[-1])])
    return q, T


@pytest.mark.parametrize("which", ["bench", "synthetic"])
def test_lut_helpers_match_jax(net, which):
    lut = bench_lut() if which == "bench" else synthetic_lut()
    tb, tt = balances(net, lut, FLAG_SETS["all"])
    q, T = lut_queries(lut, 5)
    vals = jnp.asarray(lut[1])
    per = dict(in_axes=(0, 1), out_axes=1)
    Td_j = np.asarray(jax.vmap(jax.vmap(tb._lut_Td, in_axes=(None, 0)),
                               **per)(vals, jnp.asarray(q)))
    v_j = np.asarray(jax.vmap(jax.vmap(tb._lut_val, in_axes=(None, 0)),
                              **per)(vals, jnp.asarray(T)))
    Td_t = tt._lut_Td(torch.as_tensor(q)).numpy()
    v_t = tt._lut_val(torch.as_tensor(T)).numpy()
    np.testing.assert_allclose(Td_t, Td_j, rtol=1e-12, atol=0)
    np.testing.assert_allclose(v_t, v_j, rtol=1e-12, atol=0)
    # the table's edges were reached: its top temperature above it, the
    # linear ramp from 0 below it
    assert (Td_t[-1] == lut[0][-1]).all() and (Td_t[0] < lut[0][0]).all()


def test_tandem_and_demit_match_jax(net, lut):
    tb, tt = balances(net, lut, FLAG_SETS["all"])
    envs, tenvs, t_envs, t_tenvs = envs_both(lut, 1)
    rng = np.random.default_rng(2)
    B = len(CELLS)
    Tg = 10 ** rng.uniform(1.0, 3.5, B)
    gains = np.where(np.isfinite(np.asarray(tenvs.en_gains)),
                     np.asarray(tenvs.en_gains), 1e20)
    # exchange at a 100 K gap from 1e-3 to 10 x the absorbed power: from
    # a small correction to the energy floor and the LUT's top
    coeff = gains * 10 ** rng.uniform(-3, 1, (B, 4)) / (100.0 * VOL_CM3)
    Tj = np.asarray(jax.vmap(tb._tandem_tdusts)(
        jnp.asarray(Tg), jnp.asarray(coeff), tenvs))
    Tt = tt._tandem_tdusts(torch.as_tensor(Tg), torch.as_tensor(coeff),
                           t_tenvs).numpy()
    np.testing.assert_allclose(Tt, Tj, rtol=1e-10, atol=0)
    # the padded components come back as they were; the real ones moved
    np.testing.assert_array_equal(Tt[:, 2:], np.asarray(tenvs.Tdusts)[:, 2:])
    assert (np.abs(Tt[:, :2] / np.asarray(tenvs.Tdusts)[:, :2] - 1)
            > 1e-3).any()
    dj = np.asarray(jax.vmap(tb._demit_dtd)(jnp.asarray(Tj), tenvs))
    dt = tt._demit_dtd(torch.as_tensor(Tt), t_tenvs).numpy()
    np.testing.assert_allclose(dt, dj, rtol=1e-10, atol=0)
    assert (dt[:, 2:] == 0).all() and (dt[:, :2] > 0).all()


def _rates_both(net, lut, flags, seed=11):
    """Every rate of the CELLS at positive states drawn from `seed`, in
    both packages under `flags`: (JAX rates, port rates, (the port's
    balance, y, T, envs, tenvs, rate vectors))."""
    from rac2d_tpu import defaults
    from rac2d_tpu.io import umist
    from rac2d_tpu.ops import rates as jr
    from rac2d_torch.ops import rates as tr
    tb, tt = balances(net, lut, flags)
    envs, tenvs, t_envs, t_tenvs = envs_both(lut, 1)
    y0 = umist.load_initial_abundances(net, defaults.INIT_ABUNDANCES)
    ys = np.abs(_states(y0, len(CELLS), seed))
    T = np.array([p["T"] for p in CELLS])
    yT = np.concatenate([ys, T[:, None]], axis=1)
    tab = jr.build_rate_tables(net)
    kj = jax.vmap(lambda e, T_: jr.compute_rates(tab, e, T_))(
        envs, jnp.asarray(T))
    kt = tr.compute_rates(tr.build_rate_tables(tt.net, "cpu"), t_envs,
                          torch.as_tensor(T))
    rj = jax.vmap(lambda y, T_, e, te, k: tb.rates(y, T_, e, te, k))(
        yT, T, envs, tenvs, kj)
    tt_ = torch.as_tensor
    rt = tt.rates(tt_(yT), tt_(T), t_envs, t_tenvs, kt)
    return rj, rt, (tt, yT, T, t_envs, t_tenvs, kt)


@pytest.mark.parametrize("flags", list(FLAG_SETS))
def test_rates_match_jax_under_each_flag_set(net, lut, flags):
    rj, rt, (tt, yT, T, t_envs, t_tenvs, kt) = _rates_both(
        net, lut, FLAG_SETS[flags])
    for name in rt._fields:
        np.testing.assert_allclose(getattr(rt, name).numpy(),
                                   np.asarray(getattr(rj, name)),
                                   rtol=1e-10, atol=1e-300, err_msg=name)
    # the exchange moved the gas-grain term where a mode is on (JAX's
    # conditions: the tandem needs allow and tandem, the couple only its
    # own flag), and nowhere else
    from rac2d_torch.ops.thermal import HcConfig, ThermalBalance
    base = ThermalBalance(tt.net, HcConfig(), device="cpu")
    r0 = base.rates(torch.as_tensor(yT), torch.as_tensor(T), t_envs,
                    t_tenvs, kt)
    on = flags in ("allow+tandem", "linear", "all")
    same = torch.equal(r0.cooling_gas_grain, rt.cooling_gas_grain)
    assert same != on
    if not on:
        # the repair of the port's refusal: {allow} or {tandem} alone
        # gives exactly the rates with no flag
        for name in rt._fields:
            assert torch.equal(getattr(rt, name), getattr(r0, name)), name


def test_tandem_physical_direction(net):
    """tests/test_tables_thermal.py::test_thermal_tandem_and_dynamic_alpha
    on the shipped network, in both packages: the dust thermalizes toward
    hot gas, so the residual gas-grain cooling is far below the
    frozen-Tdust value and above the energy floor; dynamic alpha heats no
    more than the base alpha.  The two packages agree at 1e-10."""
    from rac2d_tpu import constants as c
    from rac2d_tpu.ops import thermal
    from rac2d_tpu.ops.rates import CellEnv, build_rate_tables, \
        compute_rates
    from rac2d_torch import convert
    lut = synthetic_lut()
    cfg = thermal.HcConfig(allow_gas_dust_en_exch=True,
                           tdust_iter_tandem=True,
                           use_fixed_alpha_visc=False)
    tb = thermal.ThermalBalance(net, config=cfg, tdust_lut=lut)
    tb0 = thermal.ThermalBalance(net)
    d2g, n_gas = 2.8e-12, 1e10
    env = CellEnv.default(Tgas=300.0, Tdust=50.0, n_gas=n_gas,
                          ratioDust2HnucNum=d2g, ndust_tot=d2g * n_gas)
    tenv = thermal.ThermalEnv.default(
        n_dusts=jnp.array([d2g * n_gas, 0, 0, 0]),
        sig_dusts=jnp.array([np.pi * 1e-10, 0, 0, 0]),
        Tdusts=jnp.array([50.0, 0, 0, 0]),
        en_gains=jnp.array([1e-8, jnp.inf, jnp.inf, jnp.inf]),
        mdusts_cell=jnp.array([1e10, 0, 0, 0]),
        volume=1e40 / c.AU2cm ** 3, omega_Kepler=1e-8, alpha_viscosity=0.01)
    rng = np.random.default_rng(3)
    y = np.concatenate([rng.uniform(1e-12, 1e-4, net.n_species), [300.0]])
    k = compute_rates(build_rate_tables(net), env, env.Tgas)
    rj = tb.rates(jnp.asarray(y), 300.0, env, tenv, k)
    rj0 = tb0.rates(jnp.asarray(y), 300.0, env, tenv, k)

    def one(a):
        return torch.as_tensor(np.array(a))[None]
    tt, tt0 = convert.thermal_balance(tb, "cpu"), \
        convert.thermal_balance(tb0, "cpu")
    te = convert.thermal_env(jax.tree.map(lambda a: a[None], tenv), "cpu")
    ee = convert.cell_env(jax.tree.map(lambda a: a[None], env), "cpu")
    args = (one(y), one(300.0), ee, te, one(k))
    rt, rt0 = tt.rates(*args), tt0.rates(*args)
    floor = -0.8 * 1e-8 / 1e40
    for r, r0 in ((rj, rj0), (rt, rt0)):
        for f in r._fields:
            assert np.isfinite(float(getattr(r, f))), f
        assert floor * 1.01 <= float(r.cooling_gas_grain) \
            < 0.01 * float(r0.cooling_gas_grain)
        assert 0.0 <= float(r.heating_viscosity) \
            <= float(r0.heating_viscosity)
    for f in rt._fields:
        np.testing.assert_allclose(float(getattr(rt, f)),
                                   float(getattr(rj, f)), rtol=1e-10,
                                   atol=1e-300, err_msg=f)


def test_coupled_f_jac_dTdt_with_exchange_match_jax(net, lut):
    """The evolT system with every exchange mode on: f, the dense
    Jacobian (FD temperature column and key-species row) and dT/dt, held
    as tests/test_torch_chem.py::test_coupled_f_and_jac_match_jax holds
    them without the modes."""
    from rac2d_tpu import constants as c
    from rac2d_tpu.ops import odesys
    from rac2d_torch.ops import odesys as t_odesys
    rj, rt, (tt, yT, T, t_envs, t_tenvs, kt) = _rates_both(
        net, lut, FLAG_SETS["all"], seed=3)
    tb = balances(net, lut, FLAG_SETS["all"])[0]
    envs, tenvs, _, _ = envs_both(lut, 1)
    ode = odesys.ChemicalODE(net, thermal=tb)
    t_ode = t_odesys.ChemicalODE(tt.net, thermal=tt, device="cpu")
    nS = net.n_species
    fj = np.asarray(jax.vmap(lambda y, e, te: ode.make_f(e, True, te)(y))(
        yT, envs, tenvs))
    Jj = np.asarray(jax.vmap(lambda y, e, te: ode.make_jac(e, True, te)(y))(
        yT, envs, tenvs))
    y = torch.as_tensor(yT)
    ft = t_ode.make_f(t_envs, True, t_tenvs)(y).numpy()
    Jt = t_ode.make_jac(t_envs, True, t_tenvs)(y).numpy()
    np.testing.assert_allclose(ft[:, :nS], fj[:, :nS], rtol=5e-12,
                               atol=1e-250)
    np.testing.assert_allclose(ft[:, nS], fj[:, nS], rtol=1e-10)
    np.testing.assert_allclose(Jt[:, :nS, :nS], Jj[:, :nS, :nS],
                               rtol=5e-12, atol=1e-250)
    a, b = Jt[:, :, nS], Jj[:, :, nS]
    scale = np.abs(b).max(axis=1, keepdims=True)
    assert (np.abs(a - b) <= 1e-10 * scale).all()
    S = sum(np.abs(np.asarray(v)) for v in rj) * c.SecondsPerYear \
        / (np.asarray(envs.n_gas) * c.kBoltzmann_CGS)
    key = net.key_species_idx
    dy = yT[:, key] * 1e-2 + D2G * 1e-6
    diff = np.abs(Jt[:, nS, key] - Jj[:, nS, key])
    assert (diff <= 1e-10 * S[:, None] / dy).all()
    # dT/dt at the rate vector of the cells' temperatures
    dj = np.asarray(jax.vmap(lambda y_, T_, e, te, k: tb.dTdt(
        y_, T_, e, te, k))(yT, T, envs, tenvs, jnp.asarray(kt.numpy())))
    dt = tt.dTdt(y, torch.as_tensor(T), t_envs, t_tenvs, kt).numpy()
    np.testing.assert_allclose(dt, dj, rtol=1e-10, atol=0)
