"""Port parity: the column path matrices, columns, self-shielding and the
chemistry sweep's inputs against the JAX package, on the CPU.

Tolerances and why:
- path matrices: the same ray march in float64 (the native library built
  from the same source with the same flags, or the same Python trace), so
  rows and cols equal and w within 1e-12 relative; the port's native and
  Python traces against each other: equal rows and cols, w within 1e-8
  (two implementations that round differently);
- the analytic overburden of tests/test_tables_thermal.py
  (test_path_matrix_vertical_column): 15%, as there;
- columns, shielding factors and Av to the ISM from identical X and n0:
  1e-10 relative (float64 sums of the same products; index_add_ in place
  of segment_sum);
- the Ncol X-ray rate (xray_ionization_rate_ncol): 1e-8 relative.  The
  dust self-blanketing factor's closed form, f = 1.5/tau (1 - 2/tau^2
  (1 - (1 + tau) e^-tau)), cancels as 1/tau^2 at small grain optical depth
  (tau ~ 1e-3 at 10 keV): one ulp of difference between XLA's exp and
  torch's comes out as up to 5e-10 relative in zeta_X on these inputs;
- the sweep's inputs, every CellEnv/ThermalEnv field of prepare_sweep_fields
  + assemble_envs from state carried over from JAX: 1e-10 relative, the
  Ncol X-ray rate (zeta_Xray_H2 in calc_zetaXray_from_Ncol mode) 1e-8.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rac2d_torch import convert
from rac2d_torch.io import native
from rac2d_torch.ops import columns as tcol
from rac2d_torch.ops import geometry as tgeo

from torch_mc_fixtures import disk_cfg
from torch_mc_fixtures import one_torch_thread  # noqa: F401 (autouse)

RTOL_W = 1e-12
RTOL = 1e-10
RTOL_ZETA_X = 1e-8


def _grids(name):
    """(jax grid, jax grid index, torch grid, torch grid index)."""
    from rac2d_tpu.ops import geometry as jgeo
    out = []
    for pkg in ("jax", "torch"):
        if name == "bench":
            driver, cfg = disk_cfg(pkg)
            a, gcfg = cfg.andrews, cfg.grid
        else:
            # the grid of tests/test_tables_thermal.py
            # (test_path_matrix_vertical_column)
            if pkg == "jax":
                from rac2d_tpu.models.density import AndrewsDisk
                from rac2d_tpu.models.grid import GridConfig
            else:
                from rac2d_torch.models.density import AndrewsDisk
                from rac2d_torch.models.grid import GridConfig
            a = AndrewsDisk(Md=0.01, rin=1.0, rout=50.0, rc=20.0, hc=5.0)
            gcfg = GridConfig(rmin=1.0, rmax=50.0, zmax=50.0, ncol=12)
        if pkg == "jax":
            from rac2d_tpu.models.grid import make_grid
            g = make_grid(gcfg, a)
            out += [g, jgeo.build_grid_index(g)]
        else:
            from rac2d_torch.models.grid import make_grid
            g = make_grid(gcfg, a)
            out += [g, tgeo.build_grid_index(g, "cpu")]
    return out


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("grid", ["bench", "thermal"])
def test_path_matrices_equal_jax(grid, use_native):
    from rac2d_tpu.ops import columns as jcol
    jg, jgi, tg, tgi = _grids(grid)
    for f in ("rmin", "rmax", "zmin", "zmax", "using"):
        np.testing.assert_array_equal(getattr(tg, f), getattr(jg, f), f)
    jW = jcol.build_path_matrices(jg, jgi, use_native=use_native)
    tW = tcol.build_path_matrices(tg, tgi, use_native=use_native,
                                  device="cpu")
    for j, t in zip(jW, tW):
        assert t.n_cells == j.n_cells
        assert t.rows.dtype == t.cols.dtype == torch.int64
        assert t.w.dtype == torch.float64
        np.testing.assert_array_equal(t.rows.numpy(), np.asarray(j.rows))
        np.testing.assert_array_equal(t.cols.numpy(), np.asarray(j.cols))
        np.testing.assert_allclose(t.w.numpy(), np.asarray(j.w),
                                   rtol=RTOL_W, atol=0)
        assert len(t.w) > t.n_cells // 2


def test_native_and_python_traces_agree():
    """The port's two traces cross the same cells; their lengths agree
    within 1e-8 (the C++ and Python marches round differently, up to
    8e-10 relative on this grid)."""
    _, _, tg, tgi = _grids("thermal")
    nat = tcol.build_path_matrices(tg, tgi, device="cpu")
    py = tcol.build_path_matrices(tg, tgi, use_native=False, device="cpu")
    for a, b in zip(nat, py):
        assert torch.equal(a.rows, b.rows) and torch.equal(a.cols, b.cols)
        np.testing.assert_allclose(a.w.numpy(), b.w.numpy(), rtol=1e-8,
                                   atol=0)


def test_path_matrix_vertical_column():
    """ISM matrix of a simple grid: N_col equals the analytic overburden
    (tests/test_tables_thermal.py, on the port)."""
    from rac2d_torch import constants as c
    _, _, g, gi = _grids("thermal")
    W_star, W_ism = tcol.build_path_matrices(g, gi, device="cpu")
    N = W_ism.matvec(torch.as_tensor(g.n0)).numpy()
    icol = 6
    members = g.col_cells[g.col_ptr[icol]:g.col_ptr[icol + 1]]
    members = members[g.using[members]]
    bott = members[np.argmin(g.zmin[members])]
    # the ray starts at the corner closest to the target (top of the
    # cell), so the bottom cell's own thickness contributes ~nothing
    above = members[g.zmin[members] >= g.zmax[bott] - 1e-9]
    expect = ((g.zmax[above] - g.zmin[above]) * g.n0[above]).sum() * c.AU2cm
    assert N[bott] == pytest.approx(expect, rel=0.15)


def test_native_library_builds_outside_the_jax_package():
    lib = native.get_lib()
    path = native.BUILD_DIR.resolve()
    assert str(lib._name).startswith(str(path)), lib._name
    assert path.parts[-2:] == ("build", "rac2d_torch")


def test_failed_native_build_raises(tmp_path, monkeypatch):
    """No silent fallback to the Python trace: a source that does not
    compile raises with the compiler's output."""
    bad = tmp_path / "pathtrace.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    _, _, g, gi = _grids("thermal")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tcol.build_path_matrices(g, gi, device="cpu")


def _close(t, j, name, rtol=RTOL):
    np.testing.assert_allclose(t.cpu().numpy(), np.asarray(j), rtol=rtol,
                               atol=0, err_msg=name)


def test_columns_and_shielding_equal_jax():
    """From identical X and n0 on identical path matrices."""
    from rac2d_tpu.io import tables as jtables
    from rac2d_tpu.io import umist as jumist
    from rac2d_tpu import defaults
    from rac2d_tpu.ops import columns as jcol
    from rac2d_torch.io import tables as ttables
    jg, jgi, _, _ = _grids("bench")
    jW = jcol.build_path_matrices(jg, jgi)
    tW = [convert.path_matrix(W, "cpu") for W in jW]
    net = jumist.load_network(defaults.NETWORK, defaults.ENTHALPIES)
    rng = np.random.default_rng(0)
    n = jg.n_cells
    X = 10 ** rng.uniform(-14, -0.3, (net.n_species, n))
    dv = rng.uniform(1e4, 3e5, n)
    n0 = jg.n0
    js = jcol.compute_shielding(jW[0], jW[1], jnp.asarray(n0),
                                jnp.asarray(X), net.idx, jnp.asarray(dv),
                                jtables.VisserCOShielding())
    ts = tcol.compute_shielding(tW[0], tW[1], torch.as_tensor(n0),
                                torch.as_tensor(X), net.idx,
                                torch.as_tensor(dv),
                                ttables.VisserCOShielding("cpu"))
    for f in ("toISM", "toStar", "Ncol_toISM", "Ncol_toStar"):
        _close(getattr(ts, f), getattr(js, f), f)
    for d in ("colden_toISM", "colden_toStar"):
        for s in ("H2", "CO", "H2O", "OH"):
            _close(getattr(ts, d)[s], getattr(js, d)[s], f"{d}[{s}]")
    # the factors span their range on this disk
    f = ts.toStar.numpy()
    assert (f[1:] < 0.5).any() and (f[1:] > 0.99).any()


def test_xray_ionization_rate_ncol_equals_jax():
    from rac2d_tpu.ops import columns as jcol
    rng = np.random.default_rng(1)
    lam = np.geomspace(1.0, 200.0, 60)
    sv = 10 ** rng.uniform(26, 29, 60)
    is_x = (lam >= 1.0) & (lam <= 100.0)
    n = 16
    args = [rng.uniform(0.5, 1.0, n), 10 ** rng.uniform(-13, -11, n),
            10 ** rng.uniform(-5.5, -4.5, n), 10 ** rng.uniform(18, 25, n),
            rng.uniform(1.0, 50.0, n), rng.uniform(0.0, 20.0, n)]
    jz = jcol.xray_ionization_rate_ncol(
        jnp.asarray(lam), jnp.asarray(sv), jnp.asarray(is_x),
        *(jnp.asarray(a) for a in args))
    tz = tcol.xray_ionization_rate_ncol(
        lam, sv, is_x, *(torch.as_tensor(a) for a in args))
    _close(tz, jz, "zeta_X", RTOL_ZETA_X)
    assert (tz > 0).all()


@pytest.fixture(scope="module")
def mc_done():
    """The small bench disk after one JAX MC pass, and the port's model
    with that state carried over (Tgas and X as the sweep would see
    them: a warm Tgas, abundances perturbed per cell from one seed)."""
    jdriver, jcfg = disk_cfg("jax")
    tdriver, tcfg = disk_cfg("torch")
    jm = jdriver.DiskModel(jcfg)
    jm.prepare()
    jm.run_mc()
    rng = np.random.default_rng(2)
    jm.X = jm.X * 10 ** rng.uniform(-1, 1, jm.X.shape)
    jm.Tgas = np.maximum(jm.Tdust * 1.1 + 10.0, jm.Tgas)
    tm = tdriver.DiskModel(tcfg, device="cpu")
    tm.prepare()
    convert.model_state(jm, tm)
    return jm, tm


@pytest.mark.parametrize("zeta_ncol", [False, True])
def test_sweep_inputs_equal_jax(mc_done, zeta_ncol):
    jm, tm = mc_done
    jm.cfg.calc_zetaXray_from_Ncol = zeta_ncol
    tm.cfg.calc_zetaXray_from_Ncol = zeta_ncol
    for W in ("W_star", "W_ism"):
        j, t = getattr(jm, W), getattr(tm, W)
        np.testing.assert_array_equal(t.rows.numpy(), np.asarray(j.rows))
        np.testing.assert_array_equal(t.cols.numpy(), np.asarray(j.cols))
        _close(t.w, j.w, W, RTOL_W)
    jm.prepare_sweep_fields()
    tm.prepare_sweep_fields()
    _close(tm._Av_ism, jm._Av_ism, "Av_ism")
    for f in ("toISM", "toStar", "Ncol_toISM", "Ncol_toStar"):
        _close(getattr(tm._shield, f), getattr(jm._shield, f), f)
    if zeta_ncol:
        _close(tm._zetaX_ncol, jm._zetaX_ncol, "zetaX_ncol", RTOL_ZETA_X)
        assert float(tm._zetaX_ncol.max()) > 0
    else:
        assert tm._zetaX_ncol is None
    act = np.nonzero(jm.grid.using)[0]
    act = act[np.argsort(jm.grid.n0[act])]
    jenv, jtenv = jm.assemble_envs(act)
    tenv, ttenv = tm.assemble_envs(act)
    for t, j in ((tenv, jenv), (ttenv, jtenv)):
        for f in type(t)._fields:
            a, b = getattr(t, f), np.asarray(getattr(j, f))
            assert a.device.type == "cpu" and a.dtype == torch.float64, f
            assert a.shape == b.shape, f
            _close(a, b, f, RTOL_ZETA_X if zeta_ncol and f == "zeta_Xray_H2"
                   else RTOL)
    assert torch.isinf(ttenv.en_gains[:, tm.n_dust:]).all()
