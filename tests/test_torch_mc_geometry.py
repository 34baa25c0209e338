"""Port parity: ray/cell geometry, point location and the closed-form
binning of the Monte Carlo walk (rac2d_torch.ops.geometry / optics)
against the JAX package on the same numpy-seeded inputs.

Tolerances: exit lengths and nudges to f32 rtol 1e-6, plus 4 f32 ulps of
the position's magnitude for the cylinder roots, where -B + sqrt(D)
cancels and one library may fuse a multiply-add that the other rounds
twice; found/dirtype and every cell index exactly; bin indices exactly
for points inside bins, and within one bin for points exactly ON a grid
edge (the JAX package documents that an edge value may land one bin
over, optics.py:152-155; log() differs by an ulp between the libraries).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rac2d_tpu.models.density import AndrewsDisk
from rac2d_tpu.models.grid import GridConfig, make_grid
from rac2d_tpu.ops import geometry as jgeo
from rac2d_tpu.ops import optics as joptics
from rac2d_tpu.io.draine import DustMixture
from rac2d_torch import convert
from rac2d_torch.ops import geometry as tgeo
from rac2d_torch.ops import optics as toptics


def _grid():
    a = AndrewsDisk(Md=0.01, rin=1.0, rout=50.0, rc=20.0, hc=5.0)
    return make_grid(GridConfig(rmin=1.0, rmax=50.0, zmax=50.0, ncol=16), a)


def _rays(g, n, seed):
    """Points inside random cells (half mirrored below the midplane),
    isotropic directions, as f32."""
    rng = np.random.default_rng(seed)
    ic = rng.integers(0, g.n_cells, n)
    r = g.rmin[ic] + rng.uniform(0.01, 0.99, n) * (g.rmax[ic] - g.rmin[ic])
    z = g.zmin[ic] + rng.uniform(0.01, 0.99, n) * (g.zmax[ic] - g.zmin[ic])
    z = np.where(rng.uniform(size=n) < 0.5, -z, z)
    ph = rng.uniform(0, 2 * np.pi, n)
    w = rng.uniform(-1, 1, n)
    s = np.sqrt(1 - w * w)
    phi_v = rng.uniform(0, 2 * np.pi, n)
    cols = [r * np.cos(ph), r * np.sin(ph), z, s * np.cos(phi_v),
            s * np.sin(phi_v), w, g.rmin[ic], g.rmax[ic], g.zmin[ic],
            g.zmax[ic]]
    return [np.asarray(v, np.float32) for v in cols]


@pytest.mark.parametrize("mirror", [False, True])
def test_ray_cell_exit_matches_jax(mirror):
    g = _grid()
    args = _rays(g, 4000, 1)
    jf = jgeo.ray_cell_exit_mirror if mirror else jgeo.ray_cell_exit
    tf = tgeo.ray_cell_exit_mirror if mirror else tgeo.ray_cell_exit
    jl, je, jd, jfound = map(np.asarray, jf(*map(jnp.asarray, args)))
    tl, te, td, tfound = (t.numpy() for t in tf(*map(torch.as_tensor, args)))
    # the direct solver needs z inside [zmin, zmax]: half the points
    assert jfound.mean() > (0.9 if mirror else 0.45)
    np.testing.assert_array_equal(tfound, jfound)
    np.testing.assert_array_equal(td[jfound], jd[jfound])
    pos = np.abs(args[0]) + np.abs(args[1]) + np.abs(args[2])
    ulp4 = 4 * np.finfo(np.float32).eps * pos
    assert (np.abs(tl - jl) <= 1e-6 * np.abs(jl) + ulp4).all()
    np.testing.assert_allclose(te, je, rtol=1e-6)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_locate_matches_jax_on_both_paths(dtype):
    """f32 points take the packed walk path, f64 points the full one."""
    g = _grid()
    jgi = jgeo.build_grid_index(g)
    tgi = tgeo.build_grid_index(g, "cpu")
    rng = np.random.default_rng(2)
    n = 20000
    r = rng.uniform(0.5, 55.0, n)
    z = np.abs(rng.uniform(-1, 1, n)) ** 3 * 55.0
    rc, zc = g.centers()        # and every cell center exactly
    rsq = np.concatenate([r * r, rc * rc]).astype(dtype)
    za = np.concatenate([z, zc]).astype(dtype)
    jc = np.asarray(jgeo.locate(jgi, jnp.asarray(rsq), jnp.asarray(za)))
    tc = tgeo.locate(tgi, torch.as_tensor(rsq), torch.as_tensor(za)).numpy()
    np.testing.assert_array_equal(tc, jc)
    assert (tc[n:] == np.arange(g.n_cells)).all()
    assert (tc[:n] == -1).any() and (tc[:n] >= 0).mean() > 0.5


def test_locate_searchsorted_fallback_matches_jax():
    """A hand-built index without the radial LUT (the test fixtures')."""
    g = _grid()
    jgi = jgeo.build_grid_index(g)._replace(r_lut=None, r_lut_pack=None)
    tgi = convert.grid_index(jgi, "cpu")
    rng = np.random.default_rng(3)
    rsq = rng.uniform(0.5, 55.0, 5000) ** 2
    za = rng.uniform(0.0, 55.0, 5000)
    for dt in (np.float32, np.float64):
        jc = np.asarray(jgeo.locate(jgi, jnp.asarray(rsq.astype(dt)),
                                    jnp.asarray(za.astype(dt))))
        tc = tgeo.locate(tgi, torch.as_tensor(rsq.astype(dt)),
                         torch.as_tensor(za.astype(dt))).numpy()
        np.testing.assert_array_equal(tc, jc)


def _tables():
    lam = np.logspace(2.5, 7.5, 400)
    n = len(lam)
    mix = DustMixture(lam=lam, kab=np.full(n, 10.0), ksc=np.zeros(n),
                      g=np.zeros(n), pmass=1e-14, rav=0.1, r2av=0.01,
                      r3av=1e-3, rho_material=3.0)
    return joptics.build_tables([mix], joptics.McConfig(nlen_lut=128))


def test_lam_to_bin_matches_jax_in_walk_and_fold_precision():
    """The walk casts the segment constants to f32 first (JAX
    _WalkSetup); the terminal fold reads them in f64."""
    tab = _tables()
    seg = tab.lam_seg
    rng = np.random.default_rng(4)
    inner = np.concatenate([10 ** rng.uniform(0, 7.6, 20000),
                            seg.lam0 + rng.uniform(-3, 3, 5000)])
    lam = np.concatenate([inner, tab.lam]).astype(np.float32)
    n_in = len(inner)
    jseg32 = seg._replace(
        log0=jnp.asarray(seg.log0, jnp.float32),
        inv_d=jnp.asarray(seg.inv_d, jnp.float32),
        b_mid=jnp.asarray(seg.b_mid, jnp.float32),
        b_lya=jnp.asarray(seg.b_lya, jnp.float32),
        b_high=jnp.asarray(seg.b_high, jnp.float32),
        lya_inv_d=jnp.asarray(seg.lya_inv_d, jnp.float32))
    tseg = convert.mc_tables(tab).lam_seg
    for jseg, seg_f32 in ((jseg32, True), (seg, False)):
        jb = np.asarray(joptics.lam_to_bin(jseg, jnp.asarray(lam)))
        tb = toptics.lam_to_bin(tseg, torch.as_tensor(lam), seg_f32).numpy()
        np.testing.assert_array_equal(tb[:n_in], jb[:n_in])
        assert np.abs(tb[n_in:] - jb[n_in:]).max() <= 1


def test_tdust_bin_matches_jax():
    tab = _tables()
    rng = np.random.default_rng(5)
    T = np.concatenate([10 ** rng.uniform(-0.5, 3.5, 20000),
                        tab.lut_Tds]).astype(np.float32)
    n_in = 20000
    lut = tab.lut_Tds.astype(np.float32)
    jb = np.asarray(joptics.tdust_bin(jnp.asarray(lut), jnp.asarray(T)))
    tb = toptics.tdust_bin(torch.as_tensor(lut), torch.as_tensor(T)).numpy()
    np.testing.assert_array_equal(tb[:n_in], jb[:n_in])
    assert np.abs(tb[n_in:] - jb[n_in:]).max() <= 1
