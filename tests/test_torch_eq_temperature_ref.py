"""The port's equilibrium gas temperature (ThermalBalance.solve_equilibrium_T,
the evolT=False sweep's last stage) against the benchmark's plain
reference (benchmark/chemref/thermal.py's solve_equilibrium_T, with the
rate coefficients of its oracle, benchmark/chemref/oracle.py), on the CPU.
Nothing of the JAX package is imported here.

Tolerances and why:
- on four cells (dark cloud, stall cell, warm layer, inner disk) with
  abundances drawn from a numpy seed, T0 at 10, 100 and 1000 K: the
  bracket flags equal and |dT| <= 1e-5 T + 0.1 K, the bisection's own
  stopping width (the two sides' rates agree to 1e-12,
  benchmark/tests/test_bench_oracle.py, so a sign of the net rate may
  differ only within the last bracket);
- a case that cannot bracket (n_expand = 1, T0 = 3e4 K, far above every
  cell's equilibrium): no lane brackets, and T0 itself on both sides.
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

BENCH = pathlib.Path(__file__).resolve().parents[1] / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.append(str(BENCH))

from chemref import constants, oracle, umist as ref_umist  # noqa: E402
from chemref import thermal as ref_thermal  # noqa: E402

from torch_mc_fixtures import one_torch_thread  # noqa: F401,E402 (autouse)

RTOL_T, ATOL_T = 1e-5, 0.1
D2G = 2.8e-12
GRAIN_A = 1e-5
FSS_ISM = [1.0, 0.3, 0.6, 1.0, 1.0]
FSS_STAR = [1.0, 0.2, 0.5, 1.0, 1.0]
# (Tdust, n_gas, Av, G0 to the star, Ly-alpha flux, X-ray ionization)
CELLS = [(10.0, 1e5, 10.0, 0.0, 0.0, 0.0),          # dark cloud
         (20.0, 1e6, 5.0, 0.0, 0.0, 0.0),           # stall cell
         (30.0, 1e7, 2.0, 1e2, 1e6, 1e-16),         # warm layer
         (80.0, 1e9, 0.5, 1e4, 0.0, 0.0)]           # inner disk


def env_dicts(Tdust, n, Av, G0, lya, zx):
    """The cell's environment as the oracle reads it (floats, shielding
    by species name) and its fields in the order of CellEnv."""
    base = dict(
        Tdust=Tdust, n_gas=n, zeta_cosmicray_H2=1.36e-17, zeta_Xray_H2=zx,
        Ncol_toISM=n * 1e17, Av_toISM=Av, Av_toStar=Av, G0_UV_toISM=1.0,
        G0_UV_toStar=G0, G0_UV_H2phd=0.5 * G0, G0_UV_toStar_photoDesorb=G0,
        phflux_Lya=lya, omega_albedo=0.5, GrainRadius_CGS=GRAIN_A,
        sigdust_ave=np.pi * GRAIN_A ** 2, ndust_tot=D2G * n,
        ratioDust2HnucNum=D2G,
        SitesPerGrain=4.0 * np.pi * GRAIN_A ** 2 * 1e15)
    mine = dict(base, fss_ism=dict(zip(oracle.SHIELDED, FSS_ISM[1:])),
                fss_star=dict(zip(oracle.SHIELDED, FSS_STAR[1:])))
    return mine, dict(base, f_selfshielding_toISM=FSS_ISM,
                      f_selfshielding_toStar=FSS_STAR)


def stacked(cls, rows):
    """A batch of the named tuple cls from one dict of fields a lane."""
    return cls(**{k: torch.tensor(np.array([r[k] for r in rows],
                                           np.float64))
                  for k in cls._fields})


def tenv_row(Tdust, n):
    """The realistic dust population of tests/test_chem_production.py."""
    return dict(
        PAH_abundance=constants.PAH_abundance_0, MeanMolWeight=1.4,
        alpha_viscosity=0.0, omega_Kepler=2e-9, velo_width_turb=3e4,
        coherent_length=1e13, Ncol_toStar=0.0, Neufeld_G=1.0,
        Neufeld_dv_dz=1e-9, n_dusts=[D2G * n, 0.0, 0.0, 0.0],
        sig_dusts=[np.pi * 1e-10, 0.0, 0.0, 0.0],
        Tdusts=[Tdust, 0.0, 0.0, 0.0], en_gains=[np.inf] * 4,
        mdusts_cell=[0.0] * 4, volume=1.0)


def port_inputs(cells=CELLS, seed=3):
    """The port's ThermalBalance and rate tables, its environments of
    `cells` at Tgas 50 K, and abundances [B, nS+1] drawn from the seed
    (the last column a placeholder T, replaced by each trial T)."""
    from rac2d_torch import defaults
    from rac2d_torch.io import umist
    from rac2d_torch.ops import rates, thermal

    net = umist.load_network(defaults.NETWORK,
                             enthalpy_path=defaults.ENTHALPIES)
    y0 = umist.load_initial_abundances(net, defaults.INIT_ABUNDANCES)
    rng = np.random.default_rng(seed)
    y = y0[None, :] * 10 ** rng.uniform(-1, 1, (len(cells), len(y0)))
    y = np.concatenate([y, np.full((len(cells), 1), 50.0)], axis=1)
    rows = [dict(env_dicts(*p)[1], Tgas=50.0) for p in cells]
    return dict(tb=thermal.ThermalBalance(net, device="cpu"),
                tab=rates.build_rate_tables(net, "cpu"),
                env=stacked(rates.CellEnv, rows),
                tenv=stacked(thermal.ThermalEnv,
                             [tenv_row(p[0], p[1]) for p in cells]),
                y=torch.tensor(y))


@pytest.fixture(scope="module")
def both():
    """The port's inputs, and the reference's ThermalBalance, its
    environments and its rates_of(T) from the oracle, lane by lane."""
    from rac2d_torch import defaults
    port = port_inputs()
    net = ref_umist.load_network(defaults.NETWORK, defaults.ENTHALPIES)
    orc = oracle.Oracle(net)
    mine = [env_dicts(*p)[0] for p in CELLS]

    def rates_of(T):
        return torch.tensor(np.stack([orc.rates(e, float(t))
                                      for e, t in zip(mine, T)]))

    rows = [dict(env_dicts(*p)[1], Tgas=50.0) for p in CELLS]
    ref = dict(tb=ref_thermal.ThermalBalance(net, device="cpu"),
               env=stacked(ref_thermal.CellEnv, rows),
               tenv=stacked(ref_thermal.ThermalEnv,
                            [tenv_row(p[0], p[1]) for p in CELLS]),
               rates_of=rates_of)
    return port, ref


def solve_both(both, T0, n_expand=60):
    """(T, bracketed) of the port and of the reference, as numpy arrays."""
    port, ref = both
    T0 = torch.full((len(CELLS),), T0, dtype=torch.float64)
    pT, pb = port["tb"].solve_equilibrium_T(
        port["y"], port["env"], port["tenv"], T0, port["tab"],
        n_expand=n_expand)
    rT, rb = ref["tb"].solve_equilibrium_T(
        port["y"], ref["env"], ref["tenv"], T0, ref["rates_of"],
        n_expand=n_expand)
    return pT.numpy(), pb.numpy(), rT.numpy(), rb.numpy()


@pytest.mark.parametrize("T0", [10.0, 100.0, 1000.0])
def test_equilibrium_T_matches_the_reference(both, T0):
    pT, pb, rT, rb = solve_both(both, T0)
    np.testing.assert_array_equal(pb, rb)
    assert rb.any()
    dT = np.abs(pT - rT)
    print(f"T0 {T0:g} K: {int(rb.sum())}/{len(rb)} bracketed, T {rT}, "
          f"max rel dT {float((dT / rT).max()):.3e}")
    assert (dT <= RTOL_T * rT + ATOL_T).all(), (pT, rT)
    np.testing.assert_array_equal(pT[~pb], T0)


def test_no_bracket_returns_T0(both):
    pT, pb, rT, rb = solve_both(both, 3e4, n_expand=1)
    assert not pb.any() and not rb.any()
    np.testing.assert_array_equal(pT, np.full(len(CELLS), 3e4))
    np.testing.assert_array_equal(rT, np.full(len(CELLS), 3e4))
