"""Port parity: the Monte Carlo dust pass as a slice — DiskModel.prepare,
the field reduction, the analytic thin-shell Tdust, and run_mc — against
the JAX package.

Tolerances and why:
- prepare state (grid, optics tables, per-cell MC state): the same
  float64 numpy code in both packages, so equal (1e-12 for the tables);
- reduce_fields from identical float64 tallies: 1e-10 (float64 sums over
  the wavelength axis in another order);
- the thin-shell Tdust: the analytic bounds of tests/test_parity_tdust.py
  (5% in fully lit cells), since the port's launch draws another stream;
- run_mc: every packet counted, Tdust finite inside [TdustMin, TdustMax].
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rac2d_tpu.ops import fields as jfields
from rac2d_tpu.ops import mcrt as jmcrt
from rac2d_torch import convert
from rac2d_torch.io.draine import DustMixture
from rac2d_torch.models import star as tstar
from rac2d_torch.ops import fields as tfields
from rac2d_torch.ops import geometry as tgeo
from rac2d_torch.ops import mcrt as tmcrt
from rac2d_torch.ops import optics as toptics

from test_parity_tdust import _inv_d2_eff
from torch_mc_fixtures import disk_cfg
from torch_mc_fixtures import one_torch_thread  # noqa: F401 (autouse)

import rac2d_tpu.constants as c


@pytest.fixture(scope="module")
def disks():
    """The small bench disk prepared by both packages."""
    out = []
    for pkg in ("jax", "torch"):
        driver, cfg = disk_cfg(pkg)
        m = driver.DiskModel(cfg) if pkg == "jax" \
            else driver.DiskModel(cfg, device="cpu")
        m.prepare()
        out.append(m)
    return out


def test_prepare_state_equals_jax(disks):
    jm, tm = disks
    for f in ("rmin", "rmax", "zmin", "zmax", "using", "n0", "col_ptr",
              "col_cells"):
        np.testing.assert_array_equal(getattr(tm.grid, f),
                                      getattr(jm.grid, f), f)
    for f in ("r_edges", "z_edges", "cell_of", "n_z", "r_lut", "r_lut_pack",
              "zc_pack"):
        np.testing.assert_array_equal(getattr(tm.gi, f).numpy(),
                                      np.asarray(getattr(jm.gi, f)), f)
    for f in toptics.McTables._fields[:-1]:
        np.testing.assert_allclose(getattr(tm.tab, f), getattr(jm.tab, f),
                                   rtol=1e-12, atol=0, err_msg=f)
    jc, tc = jm.mc_cells(), tm.mc_cells()
    for f in tmcrt.McCells._fields:
        np.testing.assert_allclose(getattr(tc, f).numpy(),
                                   np.asarray(getattr(jc, f)), rtol=1e-12,
                                   atol=0, err_msg=f)
    for f in ("vol", "d2h", "grain_a", "abso_wei", "r_cells", "z_cells",
              "lumi_UV0", "lumi_Lya", "lumi_H2phd"):
        np.testing.assert_allclose(getattr(tm, f), getattr(jm, f),
                                   rtol=1e-12, err_msg=f)


def test_reduce_fields_equals_jax(disks):
    """Identical float64 tallies (numpy-seeded, with empty cells and
    empty bins) through both reductions."""
    jm, tm = disks
    n, nlam = jm.grid.n_cells, len(jm.tab.lam)
    rng = np.random.default_rng(3)
    flux = 10 ** rng.uniform(-3, 3, (n, nlam)) \
        * (rng.uniform(size=(n, nlam)) > 0.2)
    flux[::7] = 0.0
    en_gain = 10 ** rng.uniform(20, 30, (1, n)) * (np.arange(n) % 5 > 0)
    dir_flux = rng.standard_normal((n, 3))
    jt = jmcrt.McTallies.zeros(n, nlam, 1, 5)._replace(
        flux=jnp.asarray(flux), en_gain=jnp.asarray(en_gain),
        dir_flux=jnp.asarray(dir_flux))
    tt = convert.mc_tallies(jt, "cpu")
    jc = jm.mc_cells()
    jf = jfields.reduce_fields(
        jm.tab, jc, jt, jm.vol, jm.r2av, jm.lumi_UV0, jm.lumi_Lya,
        jm.lumi_H2phd, jnp.asarray(jm.r_cells), jnp.asarray(jm.z_cells))
    tf = tfields.reduce_fields(
        tm.tab, convert.mc_cells(jc, "cpu"), tt, tm.vol, tm.r2av,
        tm.lumi_UV0, tm.lumi_Lya, tm.lumi_H2phd, torch.as_tensor(tm.r_cells),
        torch.as_tensor(tm.z_cells))
    for f in tfields.RadiationFields._fields:
        a = np.asarray(getattr(jf, f), np.float64)
        b = getattr(tf, f).double().numpy()
        np.testing.assert_allclose(b, a, rtol=1e-10, atol=1e-300,
                                   err_msg=f)
    assert (np.asarray(jf.Tdust) > 1.0).any()


def test_thin_shell_tdust_on_the_port():
    """tests/test_parity_tdust.py::test_tdust_matches_analytic_optically_thin
    through the port's launch_packets -> mc_pass -> update_tdust."""
    lam = np.logspace(2.5, 7.5, 400)
    k = np.full(len(lam), 10.0)
    mix = DustMixture(lam=lam, kab=k, ksc=0 * k, g=0 * k, pmass=1e-14,
                      rav=0.1, r2av=0.01, r3av=1e-3, rho_material=3.0)
    tab = toptics.build_tables([mix], toptics.McConfig(nlen_lut=256))
    r_edges = np.array([1.0, 2.0, 4.0, 8.0, 16.0, 32.0])
    z_edges = np.array([0.0, 8.0, 32.0])
    nr, nz = len(r_edges) - 1, len(z_edges) - 1
    ir, iz = np.meshgrid(np.arange(nr), np.arange(nz), indexing="ij")
    rmin, rmax = r_edges[ir.ravel()], r_edges[ir.ravel() + 1]
    zmin, zmax = z_edges[iz.ravel()], z_edges[iz.ravel() + 1]
    n = nr * nz
    gi = tgeo.GridIndex(
        r_edges=torch.as_tensor(r_edges),
        z_edges=torch.as_tensor(np.tile(z_edges, (nr, 1))),
        cell_of=torch.arange(n, dtype=torch.int32).reshape(nr, nz),
        n_z=torch.full((nr,), nz, dtype=torch.int32),
        zmax_dom=float(z_edges[-1]), rmin_dom=float(r_edges[0]),
        rmax_dom=float(r_edges[-1]))
    rho = 1e-4 / (10.0 * 31.0 * c.AU2cm)
    vol = np.pi * (rmax ** 2 - rmin ** 2) * (zmax - zmin) * c.AU2cm ** 3

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64))
    cells = tmcrt.McCells(
        rmin=t(rmin), rmax=t(rmax), zmin=t(zmin), zmax=t(zmax),
        using=torch.ones(n, dtype=torch.bool), n_gas=t(np.zeros(n)),
        n_HI=t(np.zeros(n)), n_H2O=t(np.zeros(n)), Tgas=t(np.full(n, 100.0)),
        rho_dust=t(np.full((1, n), rho)), dust_depletion=t(np.ones(n)),
        d2h=t(np.full(n, 1e-12)), grain_a=t(np.full(n, 1e-5)),
        Tdust=t(np.full((1, n), 20.0)), mdust_cell=t((rho * vol)[None, :]),
        abso_wei=t(np.ones((1, n))))
    model = tmcrt.McModel(tab=tab, gi=gi, cells=cells, star_mass=1.0)

    star = tstar.blackbody_star(4000.0, 1.0, mass=1.0)
    maxw = 0.95
    lam_pk, en_pk = tstar.packet_ladder(star, 40_000, 1.0, 1.0, 1.0)
    en_pk = en_pk * (maxw / 2.0)
    en_scale = float(np.max(en_pk))
    gen = torch.Generator().manual_seed(3)
    pk = tmcrt.launch_packets(model, gen, torch.as_tensor(lam_pk),
                              torch.as_tensor(en_pk / en_scale), 0.0, maxw)
    tall = tmcrt.McTallies.zeros(n, len(tab.lam), 1, 5, device="cpu")
    pk, tall = tmcrt.mc_pass(model, pk, tall, use_mrw=False)
    assert (pk.status != tmcrt.ST_ACTIVE).all()
    tall = tall._replace(en_gain=tall.en_gain.double() * en_scale)
    Td_mc = tmcrt.update_tdust(tab, cells, tall)[0].numpy()

    Rsun_AU = c.Rsun_CGS / c.AU2cm
    Td_ana, frac_in = np.zeros(n), np.zeros(n)
    for i in range(n):
        inv_d2, frac_in[i] = _inv_d2_eff(rmin[i], rmax[i], zmin[i], zmax[i],
                                         maxw)
        Td_ana[i] = 4000.0 * np.sqrt(
            Rsun_AU * np.sqrt(max(inv_d2, 1e-300)) / 2.0)
    rel = np.abs(Td_mc - Td_ana) / np.maximum(Td_ana, 1e-300)
    lit = frac_in > 0.9
    part = (frac_in > 0.1) & ~lit
    dark = frac_in <= 0.1
    assert lit.sum() >= 5
    assert rel[lit].max() < 0.05, list(zip(Td_mc[lit], Td_ana[lit]))
    if part.any():
        assert rel[part].max() < 0.20, list(zip(Td_mc[part], Td_ana[part]))
    if dark.any():
        gain = tall.en_gain[0].numpy()
        assert (gain[dark] < 0.1 * gain[lit].min()).all()


def test_run_mc_on_the_port(disks):
    """One streamed Lucy pass through the port's DiskModel.run_mc on the
    small disk (plain walk and fold on the CPU)."""
    _, tm = disks
    tm.run_mc(n_passes=1)
    st = tm.mc_stats[-1]
    f = st["fates"]
    assert sum(f.values()) == st["packets"]
    assert f["escaped"] > 0 and f["destructed"] > 0
    assert f["premature"] + f["active"] <= 1e-3 * st["packets"]
    assert st["k3_launches"] == 0 and st["k4_launches"] == 0
    use = tm.grid.using
    mc = tm.mc_cfg
    T = tm.Tdust[use]
    assert np.isfinite(T).all()
    assert T.min() >= mc.TdustMin and T.max() <= mc.TdustMax
    assert T.max() > 20.0
    assert bool(torch.isfinite(tm.tallies.flux).all())
    assert float(tm.tallies.flux.min()) >= 0.0
