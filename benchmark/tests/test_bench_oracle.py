"""The reference's own pieces against the port they judge, on the CPU:
the oracle's rates, right-hand side and Jacobian at three environments
of the shipped network, and the reference's grid.  Agreement here is what
lets a ref_gap reading stand for the program's integration alone."""

import json

import numpy as np
import pytest
import torch

from chemref import grid as refgrid, oracle, umist
from chemref.data import DATA
from harness import spec

NET = str(DATA / "chem" / "rate06_withgrain.dat")
ENTHALPY = str(DATA / "chem" / "Species_enthalpy.dat")
INIT = str(DATA / "chem" / "initial_condition_Garrod08_mod.dat")
A = 1e-5
D2G = 2.8e-12
FSS_ISM = [1.0, 0.3, 0.6, 0.7, 0.8]
FSS_STAR = [1.0, 0.2, 0.5, 0.4, 0.9]
# (Tgas, Tdust, n_gas, Av): dark cloud, warm layer, inner disk
POINTS = [(10.0, 10.0, 1e5, 10.0), (50.0, 30.0, 1e7, 2.0),
          (300.0, 80.0, 1e9, 0.5)]


@pytest.fixture(scope="module")
def nets():
    from rac2d_torch.io import umist as port_umist
    return (umist.load_network(NET, ENTHALPY),
            port_umist.load_network(NET, ENTHALPY))


def envs(T, Td, n, Av):
    base = dict(
        Tdust=Td, n_gas=n, zeta_cosmicray_H2=1.36e-17, zeta_Xray_H2=1e-16,
        Ncol_toISM=n * 1e17, Av_toISM=Av, Av_toStar=1.3 * Av,
        G0_UV_toISM=1.0, G0_UV_toStar=1e2, G0_UV_H2phd=50.0,
        G0_UV_toStar_photoDesorb=1e2, phflux_Lya=1e6, omega_albedo=0.5,
        GrainRadius_CGS=A, sigdust_ave=np.pi * A * A, ndust_tot=D2G * n,
        ratioDust2HnucNum=D2G, SitesPerGrain=4.0 * np.pi * A * A * 1e15)
    mine = dict(base, fss_ism=dict(zip(oracle.SHIELDED, FSS_ISM[1:])),
                fss_star=dict(zip(oracle.SHIELDED, FSS_STAR[1:])))
    from rac2d_torch.ops.rates import CellEnv
    t = {k: torch.tensor([v], dtype=torch.float64)
         for k, v in dict(base, Tgas=T, f_selfshielding_toISM=FSS_ISM,
                          f_selfshielding_toStar=FSS_STAR).items()}
    port = CellEnv(**t)
    return mine, port


def port_rates(pnet, env, T):
    from rac2d_torch.ops import rates
    tab = rates.build_rate_tables(pnet, "cpu")
    return rates.compute_rates(tab, env,
                               torch.tensor([T], dtype=torch.float64))


@pytest.mark.parametrize("point", POINTS)
def test_rates_match_the_port(nets, point):
    net, pnet = nets
    mine, port = envs(*point)
    k = oracle.Oracle(net).rates(mine, point[0])
    kp = port_rates(pnet, port, point[0])[0].numpy()
    np.testing.assert_allclose(k, kp, rtol=1e-12, atol=1e-250)


def test_rhs_and_jacobian_match_the_port(nets):
    from rac2d_torch.ops import network
    net, pnet = nets
    mine, port = envs(*POINTS[1])
    o = oracle.Oracle(net)
    k = o.rates(mine, POINTS[1][0])
    inc = network.build_incidence(pnet, False, "cpu")
    spg = mine["SitesPerGrain"]
    y0 = umist.load_initial_abundances(net, INIT)
    rng = np.random.default_rng(7)
    y = y0 * 10 ** rng.uniform(-2, 2, y0.shape) + 1e-30
    y[rng.integers(0, len(y), 40)] *= -1.0
    for yy in (y0, y):
        args = (torch.tensor(k)[None], torch.tensor(yy)[None],
                torch.tensor([D2G]), torch.tensor([spg]))
        f = network.rhs_species(inc, *args)[0].numpy()
        np.testing.assert_allclose(o.rhs(k, yy, D2G, spg), f, rtol=1e-9,
                                   atol=1e-12 * np.abs(f).max())
        J = network.jac_species(inc, *args)[0].numpy()
        # the oracle differentiates the top-layer desorption's linear
        # branch (x <= 1e-4) as k / Nlayer, the port as its exponential
        # form: 5e-9 of the largest entry; the fluxes agree
        np.testing.assert_allclose(o.jac(k, yy, D2G, spg), J, rtol=1e-7,
                                   atol=1e-12 * np.abs(J).max())


def test_float32_rates_are_float32(nets):
    net, _ = nets
    mine, _ = envs(*POINTS[1])
    assert oracle.Oracle(net).rates(mine, 50.0, dtype=np.float32).dtype \
        == np.float32


def test_grid_is_the_programs():
    from rac2d_torch.models import density
    from rac2d_torch.models.grid import GridConfig, make_grid
    cfg = json.loads((spec.BENCH / "tests" / "tiny.json").read_text())
    g = refgrid.make_grid(cfg)
    p = make_grid(
        GridConfig(rmin=cfg["grid_rmin"], rmax=cfg["grid_rmax"],
                   zmax=cfg["grid_zmax"], ncol=cfg["grid_ncol"],
                   max_num_of_cells=cfg["grid_max_num_of_cells"]),
        density.AndrewsDisk(Md=cfg["andrews_Md"], rin=cfg["andrews_rin"],
                            rout=cfg["andrews_rout"], rc=cfg["andrews_rc"],
                            hc=cfg["andrews_hc"]))
    for k in ("rmin", "rmax", "zmin", "zmax", "n0", "using"):
        assert np.array_equal(g[k], getattr(p, k)), k
