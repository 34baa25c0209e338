"""Port parity: ``rac2d_torch.postprocess`` and ``rac2d_torch.io.radmc``
against the JAX package's modules, on the CPU.

The eight cases of tests/test_postprocess.py run on the port's copy and
on the JAX module with the same numpy inputs (seeded); every output must
be bit-equal (the same numpy on the same inputs), and the port must pass
the JAX test's own assertions.  The
FITS cubes are written by the port's ``io/fits.py`` and read by both
packages.  Then the RADMC table loader of
tests/test_grid_amr.py::test_radmc_loader on both ``RadmcData``s, and
``make_grid(..., dens_fn=radmc.density)`` on both packages: the same
leaves.
"""

import numpy as np
import pytest

import rac2d_tpu.constants as jc
from rac2d_tpu import postprocess as jpp
from rac2d_torch import constants as tc
from rac2d_torch import postprocess as tpp
from rac2d_torch.io import fits as tfits

PKGS = ((jpp, jc), (tpp, tc))


def _fake_table(n=24):
    rng = np.random.default_rng(0)
    rmin = np.repeat(np.array([1.0, 2.0, 4.0, 8.0]), 6)
    rmax = rmin * 1.5
    zmin = np.tile(np.arange(6) * 0.5, 4)
    zmax = zmin + 0.5
    return dict(
        rmin=rmin, rmax=rmax, zmin=zmin, zmax=zmax,
        using=np.ones(n, bool), n_gas=np.full(n, 1e6),
        species=np.array(["H2", "CO"]),
        abundances=np.stack([np.full(n, 0.5),
                             10 ** rng.uniform(-6, -4, n)]))


def _equal(a, b):
    """Nested outputs of the two packages, equal leaf by leaf."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, (str, type(None))):
        assert a == b
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_profiles_and_columns():
    t = _fake_table()
    out = []
    for pp, c in PKGS:
        r, v = pp.radial_profile(t, t["n_gas"], z_over_r_max=1e3)
        assert len(r) > 0 and (np.diff(r) >= 0).all()
        z, v2 = pp.vertical_cut(t, pp.abundance(t, "CO"), r0=3.0)
        assert len(z) == 6 and (np.diff(z) > 0).all()
        rs, N = pp.column_density(t, "H2")
        assert len(rs) == 4
        np.testing.assert_allclose(N, 1e6 * 0.5 * 3.0 * c.AU2cm,
                                   rtol=1e-10)
        d = pp.iter_diff(t, t, "CO")
        assert (d == 0).all()
        out.append((r, v, z, v2, rs, N, d))
    _equal(*out)


def _blue_red_cube():
    nf, ny, nx = 21, 5, 5
    f0 = 2.3e11
    freqs = f0 * (1 + np.linspace(-1e-5, 1e-5, nf))
    cube = np.zeros((nf, ny, nx))
    # left half emits blue-shifted, right half red-shifted
    cube[4, :, :2] = 1.0
    cube[16, :, 3:] = 1.0
    return cube, freqs, f0


def test_moment_maps_and_pv():
    cube, freqs, f0 = _blue_red_cube()
    out = []
    for pp, _ in PKGS:
        mom0, mom1 = pp.moment_maps(cube, freqs, restfreq=f0)
        assert mom0.shape == cube.shape[1:]
        assert mom1[2, 0] * mom1[2, 4] < 0      # opposite signs
        pv = pp.pv_cut(cube)
        assert pv.shape == (cube.shape[0], cube.shape[2])
        sm = pp.convolve_beam(cube[4], 2.0)
        np.testing.assert_allclose(sm.sum(), cube[4].sum(), rtol=1e-8)
        assert sm.max() < cube[4].max()
        out.append((mom0, mom1, pv, sm))
    _equal(*out)


def test_parse_contributions(tmp_path):
    p = tmp_path / "ana_r10_z2.txt"
    p.write_text(
        "# point (10, 2) AU -> cell 5 [1,2]x[0,1]\n"
        "n_gas = 1.0e+06 cm^-3\n"
        "Tgas  = 35.20 K\n\n"
        "== CO  X = 1.2e-04 ==\n"
        "  production:\n"
        "     1.0e-10   60.0%  C + OH -> CO + H\n"
        "     5.0e-11   40.0%  HCO+ + E- -> CO + H\n"
        "  destruction:\n"
        "     9.0e-11   90.0%  CO + PHOTON -> C + O\n")
    out = [pp.parse_contributions(str(p)) for pp, _ in PKGS]
    d = out[1]
    assert d["header"]["Tgas"] == pytest.approx(35.2)
    assert len(d["CO"]["produce"]) == 2
    assert d["CO"]["produce"][0][1] == pytest.approx(0.6)
    assert "PHOTON" in d["CO"]["destroy"][0][2]
    assert out[0] == out[1]


SPEC_ATTRS = ("molname", "qnum", "f0", "E_up", "dist", "f", "v", "spec",
              "cube", "df", "fmin", "intflux", "intfluxl")


def _spec_lines(p):
    sls = [pp.SpecLine(p) for pp, _ in PKGS]
    for a in SPEC_ATTRS:
        _equal(getattr(sls[0], a), getattr(sls[1], a))
    assert sls[0].header == sls[1].header
    return sls[1]


def test_specline_roundtrip(tmp_path):
    nf, ny, nx = 16, 4, 4
    f0 = 345.796e9
    df = 1e5
    freqs = f0 + (np.arange(nf) - nf / 2) * df
    cube = np.random.default_rng(1).random((nx, ny, nf))
    spec = cube.sum(axis=(0, 1))
    base = np.linspace(spec[0], spec[-1], nf)
    hdr = {"EXTNAME": "LineCube", "F0": f0, "LAM0": 8669.9,
           "EUP": 33.2, "ELOW": 16.6, "AUL": 2.5e-6,
           "BUL": 1.1e4, "BLU": 3.3e4, "QNUM": "3->2",
           "MOL-DB": "CO", "MAXFLUX": float(spec.max()),
           "MAXTAU": 7.5,
           "INTFLUX": float(spec.sum() * 1e-26 * df),
           "INTFLUXL": float((spec - base).sum() * 1e-26 * df),
           "THETA": 7.0, "DIST": 54.0}
    p = tmp_path / "line.fits"
    tfits.write_cube_fits(p, cube, freqs=freqs, spectrum=spec, header=hdr)
    sl = _spec_lines(p)
    assert sl.molname == "CO" and sl.qnum == "3->2"
    np.testing.assert_allclose(sl.f0, f0)
    np.testing.assert_allclose(sl.E_up, 33.2)
    np.testing.assert_allclose(sl.dist, 54.0)
    np.testing.assert_allclose(sl.spec, spec, rtol=1e-12)
    iv0 = np.argmin(np.abs(sl.v))
    assert abs(sl.f[iv0] - f0) <= df
    for base_off in (False, True):
        a, b = (pp.SpecLine(p).integrated_flux(base_off) for pp, _ in PKGS)
        assert a == b
    np.testing.assert_allclose(sl.integrated_flux(False), sl.intflux,
                               rtol=1e-10)
    np.testing.assert_allclose(sl.integrated_flux(True), sl.intfluxl,
                               rtol=1e-8)
    # load_cube on the same file
    _equal(*[pp.load_cube(p) for pp, _ in PKGS])


def test_scale_height_and_tau_surface():
    H_in = 1.0      # AU
    nz, dz = 120, 0.05
    zmin = np.arange(nz) * dz
    t = dict(rmin=np.full(nz, 1.0), rmax=np.full(nz, 1.5),
             zmin=zmin, zmax=zmin + dz,
             n_gas=1e8 * np.exp(-0.5 * ((zmin + dz / 2) / H_in) ** 2),
             Tgas=np.full(nz, 50.0), using=np.ones(nz, bool))
    N_target = 1e8 * H_in * tc.AU2cm * np.sqrt(2 * np.pi) * 0.2
    kappa = 1.0 / N_target
    out = []
    for pp, _ in PKGS:
        rc, H = pp.scale_height(t)
        assert len(rc) == 1
        np.testing.assert_allclose(H[0], H_in, rtol=0.05)
        rc1, z1 = pp.tau_surface(t, kappa)
        st = pp.stokes_number(t, 2e33, 1e-5)
        assert (st > 0).all() and np.isfinite(st).all()
        fac = pp.settling_factor(st)
        assert (fac > 0).all()
        out.append((rc, H, rc1, z1, st, fac))
    _equal(*out)
    from math import erf
    col = lambda z: (1e8 * H_in * tc.AU2cm * np.sqrt(2 * np.pi)
                     * 0.5 * (1 - erf(z / H_in / np.sqrt(2))))
    zs = np.linspace(0, 6, 4000)
    z_expect = zs[np.argmin(np.abs([col(z) - N_target for z in zs]))]
    np.testing.assert_allclose(out[1][3][0], z_expect, atol=0.08)


def test_to_spherical_and_groups(tmp_path):
    n = 8
    t = dict(rmin=np.array([1., 1., 1., 1., 3., 3., 3., 3.]),
             rmax=np.array([3., 3., 3., 3., 9., 9., 9., 9.]),
             zmin=np.tile([0., 2.], 4)[:n],
             zmax=np.tile([2., 8.], 4)[:n],
             using=np.ones(n, bool))
    vals = np.arange(n, dtype=float) + 1
    r_grid = np.array([1.0, 3.0, 9.0])
    theta_grid = np.array([0.0, np.pi / 4, np.pi / 2])
    names = ["H2", "C2H2", "CH4", "HCN", "NH3", "Na", "CO", "gC3H2+"]
    out = []
    for i, (pp, _) in enumerate(PKGS):
        v = pp.to_spherical(t, {"v": vals}, r_grid, theta_grid)["v"]
        assert v.shape == (1, 2, 2)
        assert v[0, 1, 0] == 1.0   # near midplane, inner radius: cell 0
        p = tmp_path / f"v{i}.inp"
        pp.write_radmc_inp(p, v)
        hc = pp.hydrocarbons(names)
        assert set(hc) == {"C2H2", "CH4", "gC3H2+"}
        nb = pp.nitrogen_bearing(names)
        assert "HCN" in nb and "NH3" in nb and "Na" not in nb
        out.append((v, p.read_bytes(), hc, nb))
    assert len(np.loadtxt(tmp_path / "v1.inp")) == out[1][0].size
    _equal(*out)


def test_specline_rebuild_without_fluxspec(tmp_path):
    nf, ny, nx = 8, 3, 3
    f0 = 345.796e9
    df = 1e5
    freqs = f0 + (np.arange(nf) - nf / 2) * df
    cube = np.random.default_rng(2).random((nx, ny, nf))
    pix_sr = 2.5e-13
    hdr = {"EXTNAME": "LineCube", "F0": f0, "QNUM": "F=1/2-3/2",
           "MOL-DB": "OH", "THETA": 45.0, "DIST": 100.0,
           "PIXSR": pix_sr}
    p = tmp_path / "line_nospec.fits"
    tfits.write_cube_fits(p, cube, freqs=freqs, header=hdr)
    sl = _spec_lines(p)
    assert sl.qnum == "F=1/2-3/2"          # '/' inside quotes preserved
    np.testing.assert_allclose(sl.spec, cube.sum(axis=(0, 1)) * pix_sr
                               / 1e-23, rtol=1e-10)


def test_element_tokenizer_groups():
    names = ["HNe+", "Ne", "NH3", "N2H+", "NaH", "CN", "HCN", "CO"]
    for pp, _ in PKGS:
        assert pp._counts("HNe+") == {"H": 1, "Ne": 1}
        assert pp._counts("HC3N") == {"H": 1, "C": 3, "N": 1}
        assert pp._counts("He") == {"He": 1}
        assert pp._counts("Cl2") == {"Cl": 2}
        assert pp._counts("NaCl") == {"Na": 1, "Cl": 1}
        assert set(pp.nitrogen_bearing(names)) == {"NH3", "N2H+", "CN",
                                                   "HCN"}
    for name in names + ["C2H2", "gC3H2+", "H2O"]:
        assert jpp._counts(name) == tpp._counts(name)


def test_iteration_table_round_trip(tmp_path):
    """load_iter on a table written by the port's models/output.py, and
    the profiles of both packages on it."""
    from rac2d_torch.models import output as tout
    t = _fake_table()
    p = tmp_path / "iter_0001.npz"
    np.savez_compressed(p, **t)
    tabs = [pp.load_iter(p) for pp, _ in PKGS]
    _equal(*tabs)
    _equal(dict(tout.load_iter_npz(p)), tabs[1])
    _equal(*[pp.radial_profile(tab, pp.abundance(tab, "CO"))
             for (pp, _), tab in zip(PKGS, tabs)])


def test_plot_mesh():
    pytest.importorskip("matplotlib")
    t = _fake_table()
    vals = tpp.abundance(t, "CO")
    ax_t = tpp.plot_mesh(t, vals, mirror=True)
    ax_j = jpp.plot_mesh(t, vals, mirror=True)
    # the cells and their mirror images below the midplane
    assert len(ax_t.collections) == len(ax_j.collections) == 2
    for pt, pj in zip(ax_t.collections, ax_j.collections):
        np.testing.assert_array_equal(pt.get_array(), pj.get_array())
        assert len(pt.get_paths()) == len(vals)
        for a, b in zip(pt.get_paths(), pj.get_paths()):
            np.testing.assert_array_equal(a.vertices, b.vertices)
    assert ax_t.get_ylim() == ax_j.get_ylim()
    np.testing.assert_array_equal(tpp.cell_quads(t), jpp.cell_quads(t))


def test_radmc_loader():
    from rac2d_torch import defaults
    from rac2d_torch.io.radmc import RadmcData as TRadmc
    from rac2d_tpu.io.radmc import RadmcData as JRadmc
    path = str(defaults.DATA / "radmc_example.dat")
    dt, dj = TRadmc.load(path), JRadmc.load(path)
    assert dt.n.shape == (150, 50)
    for f in ("r_cm", "theta", "n", "T"):
        np.testing.assert_array_equal(getattr(dt, f), getattr(dj, f))
    assert float(dt.density(10.0, 0.0)) > 0
    assert float(dt.density(1e4, 0.0)) == 0.0
    rng = np.random.default_rng(3)
    r = 10 ** rng.uniform(-0.5, 3.5, 500)
    z = r * rng.uniform(0.0, 1.2, 500)
    np.testing.assert_array_equal(dt.density(r, z), dj.density(r, z))
    np.testing.assert_array_equal(dt.temperature(r, z),
                                  dj.temperature(r, z))


def test_make_grid_with_radmc_density():
    from rac2d_torch import defaults
    from rac2d_torch.io.radmc import RadmcData as TRadmc
    from rac2d_torch.models import density as tdens
    from rac2d_torch.models.grid import GridConfig as TGC
    from rac2d_torch.models.grid import make_grid as tmake
    from rac2d_tpu.io.radmc import RadmcData as JRadmc
    from rac2d_tpu.models import density as jdens
    from rac2d_tpu.models.grid import GridConfig as JGC
    from rac2d_tpu.models.grid import make_grid as jmake
    path = str(defaults.DATA / "radmc_example.dat")
    kw = dict(rmin=1.0, rmax=50.0, zmax=50.0, ncol=8)
    akw = dict(Md=0.01, rin=1.0, rout=50.0, rc=20.0, hc=5.0)
    gt = tmake(TGC(**kw), tdens.AndrewsDisk(**akw),
               dens_fn=TRadmc.load(path).density)
    gj = jmake(JGC(**kw), jdens.AndrewsDisk(**akw),
               dens_fn=JRadmc.load(path).density)
    assert gt.n_cells == gj.n_cells and gt.n_cells > 8
    for f in ("rmin", "rmax", "zmin", "zmax", "n0", "using", "col_ptr",
              "col_cells"):
        np.testing.assert_array_equal(getattr(gt, f), getattr(gj, f), f)
    assert (gt.n0[gt.using] > 0).all()
