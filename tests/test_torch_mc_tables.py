"""Port parity: the host-built Monte Carlo inputs — grid, grid index,
packet ladder, optics tables — and the walk's float32 tables, against the
JAX package.

The host builds are the same float64 numpy code in both packages, so
grid, index and ladder must be equal and the optics tables equal to
1e-12.  The walk's f32 tables (``WalkSetup`` vs JAX ``_WalkSetup``) agree
to f32 rounding, 1e-6; values below the smallest normal f32 (2**-126)
may differ, because XLA on the CPU flushes subnormals to zero.  The
Lyman-alpha sigma table is the exception: the port evaluates it in f64
and rounds (1e-6 against the JAX function run in f64), while the JAX
package evaluates it in f32, where nu - nu0 cancels near the line core:
the port's table differs from JAX's only by JAX's own f32 error.
"""

import numpy as np
import pytest
import torch

from rac2d_tpu import defaults as jdefaults
from rac2d_tpu.io import draine as jdraine
from rac2d_tpu.models import star as jstar
from rac2d_tpu.models.density import AndrewsDisk as JAndrews
from rac2d_tpu.models.grid import GridConfig as JGridConfig
from rac2d_tpu.models.grid import make_grid as jmake_grid
from rac2d_tpu.ops import geometry as jgeo
from rac2d_tpu.ops import mcrt as jmcrt
from rac2d_tpu.ops import optics as joptics
from rac2d_torch import defaults as tdefaults
from rac2d_torch.io import draine as tdraine
from rac2d_torch.models import star as tstar
from rac2d_torch.models.density import AndrewsDisk as TAndrews
from rac2d_torch.models.grid import GridConfig as TGridConfig
from rac2d_torch.models.grid import make_grid as tmake_grid
from rac2d_torch.ops import geometry as tgeo
from rac2d_torch.ops import mcrt as tmcrt
from rac2d_torch.ops import optics as toptics

from torch_mc_fixtures import disk_cfg, torch_model, warm_tdust

DISK = dict(Md=0.01, rin=1.0, rout=100.0, rc=50.0, hc=10.0)
GRID = dict(rmin=1.0, rmax=100.0, zmax=100.0, ncol=24,
            max_num_of_cells=400)


def _grids():
    return (jmake_grid(JGridConfig(**GRID), JAndrews(**DISK)),
            tmake_grid(TGridConfig(**GRID), TAndrews(**DISK)))


def test_make_grid_and_grid_index_equal_jax():
    jg, tg = _grids()
    for f in ("rmin", "rmax", "zmin", "zmax", "using", "n0", "col_id",
              "col_ptr", "col_cells", "nb_above_ptr", "nb_above",
              "nb_below", "nb_inner", "nb_outer", "surf_cells",
              "bott_cells"):
        np.testing.assert_array_equal(getattr(tg, f), getattr(jg, f), f)
    jgi, tgi = jgeo.build_grid_index(jg), tgeo.build_grid_index(tg, "cpu")
    for f in jgeo.GridIndex._fields:
        a, b = getattr(jgi, f), getattr(tgi, f)
        if isinstance(a, float):
            assert a == b, f
        else:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), f)


def test_packet_ladder_equals_jax():
    """Blackbody + thermal X-ray star, and the TW Hya file spectrum."""
    for kw in ({}, {"spec": True}):
        if kw:
            js = jstar.load_star_spectrum(jdefaults.TWHYA_SPECTRUM, T=4000.0,
                                          radius=1.0, mass=0.6)
            ts = tstar.load_star_spectrum(tdefaults.TWHYA_SPECTRUM, T=4000.0,
                                          radius=1.0, mass=0.6)
        else:
            js = jstar.blackbody_star(4000.0, 1.0, mass=0.6)
            ts = tstar.blackbody_star(4000.0, 1.0, mass=0.6)
        for s in (js, ts):
            s.lumi_Xray = 1e30
        js, ts = jstar.merge_xray(js), tstar.merge_xray(ts)
        jl, je = jstar.packet_ladder(js, 50_000, 0.2, 0.1, 1e-3)
        tl, te = tstar.packet_ladder(ts, 50_000, 0.2, 0.1, 1e-3)
        np.testing.assert_array_equal(tl, jl)
        np.testing.assert_array_equal(te, je)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_planck_equals_jax(dtype):
    """B_nu and B_lambda on tensors (f64, and the f32 of the MC folds)
    against the JAX functions in the same precision, T = 0 included
    (f32: below the smallest normal, XLA flushes to zero); B_lambda_np
    against its JAX twin, equal."""
    from rac2d_tpu.utils import planck as jplanck
    from rac2d_torch.utils import planck as tplanck
    import jax.numpy as jnp
    rng = np.random.default_rng(4)
    T = np.concatenate([[0.0], 10 ** rng.uniform(0.0, 4.5, 63)])[:, None]
    lam_cm = np.logspace(-6, 0, 50)[None, :]
    nu = 2.99792458e10 / lam_cm
    npd = np.float64 if dtype == torch.float64 else np.float32
    rtol, atol = ((1e-12, 0.0) if dtype == torch.float64
                  else (1e-5, 2.0 ** -126))
    for tf, jf, x in ((tplanck.B_nu, jplanck.B_nu, nu),
                      (tplanck.B_lambda, jplanck.B_lambda, lam_cm)):
        got = tf(torch.as_tensor(T, dtype=dtype),
                 torch.as_tensor(x, dtype=dtype)).double().numpy()
        ref = np.asarray(jf(jnp.asarray(T, npd), jnp.asarray(x, npd)),
                         np.float64)
        np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)
        # (f32 overflows to inf/nan at short wavelengths, as in JAX)
        assert (got[0] == 0.0).all() and (got[1:] > 0).any(1).all()
    np.testing.assert_array_equal(tplanck.B_lambda_np(T, lam_cm),
                                  jplanck.B_lambda_np(T, lam_cm))


def _bench_tables():
    """build_tables on the bench disk's dust (silicate, MRN, water)."""
    out = []
    for draine, optics, d in ((jdraine, joptics, jdefaults),
                              (tdraine, toptics, tdefaults)):
        mix = draine.mrn_average(draine.load_opti(d.SILICATE_OPTI), 0.01,
                                 1.0, 3.5, 2.0)
        h2o = draine.load_h2o_cross_section(d.H2O_PHOTOXS)
        out.append(optics.build_tables(
            [mix], optics.McConfig(nlen_lut=256, n_quantile=128), *h2o))
    return out


def test_build_tables_equal_jax():
    jt, tt = _bench_tables()
    for f in joptics.McTables._fields[:-1]:
        np.testing.assert_allclose(getattr(tt, f), getattr(jt, f),
                                   rtol=1e-12, atol=0, err_msg=f)
    for f in joptics.LamSeg._fields:
        np.testing.assert_array_equal(getattr(tt.lam_seg, f),
                                      getattr(jt.lam_seg, f), f)


@pytest.fixture(scope="module")
def jax_disk():
    driver, cfg = disk_cfg("jax")
    m = driver.DiskModel(cfg)
    m.prepare()
    m.Tdusts = warm_tdust(m.r_cells)
    return m


def test_walk_setup_tables_match_jax(jax_disk):
    m = jax_disk
    jmodel = jmcrt.McModel(m.tab, m.gi, m.mc_cells(), m.cfg.star_mass)
    jws = jmcrt._WalkSetup(jmodel, 128, True)
    tws = tmcrt.WalkSetup(torch_model(jmodel, "cpu"), 128)
    for f, rtol in (("cellmat", 1e-6), ("tabmat", 1e-6),
                    ("reemit_lam", 1e-6), ("mrw_lnx", 1e-6)):
        a = np.asarray(getattr(jws, f)).reshape(-1)
        b = getattr(tws, f).numpy().reshape(-1)
        np.testing.assert_allclose(b, a, rtol=rtol,
                                   atol=np.finfo(np.float32).tiny, err_msg=f)
    assert tws.inv_dlnT == pytest.approx(float(jws._inv_dlnT), rel=1e-6)
    assert tws.lnT0 == pytest.approx(float(jws._lnT0), abs=1e-6)


def test_lya_sigma_table_is_the_f64_profile(jax_disk):
    """The port's Lyman-alpha table equals the JAX lya_sigma evaluated in
    f64 at the same f32 (lambda, T) points, to f32 rounding."""
    import jax.numpy as jnp
    m = jax_disk
    jmodel = jmcrt.McModel(m.tab, m.gi, m.mc_cells(), m.cfg.star_mass)
    tws = tmcrt.WalkSetup(torch_model(jmodel, "cpu"), 128)
    lam32 = np.asarray(m.tab.lam, np.float32).astype(np.float64)
    T = np.exp(np.arange(tmcrt.N_TLYA, dtype=np.float32)
               / np.float32(tws.inv_dlnT_lya)).astype(np.float64)
    ref = np.asarray(joptics.lya_sigma(jnp.asarray(lam32)[:, None],
                                       jnp.asarray(T)[None, :]))
    got = tws.lya_pair.numpy()[:, 0].reshape(ref.shape)
    np.testing.assert_allclose(got, ref, rtol=1e-6,
                               atol=np.finfo(np.float32).tiny)
    jws = jmcrt._WalkSetup(jmodel, 128, True)
    jax32 = np.asarray(jws.lya_pair)[..., 0].astype(np.float64)
    assert (np.abs(got - jax32) <= 1.01 * np.abs(jax32 - ref)
            + 1e-6 * ref + np.finfo(np.float32).tiny).all()
