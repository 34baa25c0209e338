"""Port parity: the line-list readers, the mixed-precision solve, NLTE
excitation, the ray-traced continuum and line cubes, the FITS writer and
the point analysis against the JAX package, on the CPU (JAX on the CPU).

States come from tests/torch_cli_fixtures.py: a tiny disk prepared by both
packages with one seeded state; no chemistry sweep and no MC pass run.

Tolerances and why:
- readers: equal fields (the same numpy code on the same file);
- mp_linsolve: 1e-12 of max|x| (the f32 factors may pivot differently in
  LAPACK and XLA; two f64 refinements close the gap on well-conditioned,
  row-scaled systems);
- boltzmann: 1e-13 relative;
- stateq_rhs: 1e-11 of the largest term of each cell's rate equations
  (about 3e-12 measured).  XLA's float64 exp differs from libm's in the
  last bit for many arguments, and the escape probability
  (1 - exp(-3 tau)) / (3 tau) cancels at small tau, so one ulp of exp comes
  out as about 1e-12 of J_ave there, and as up to 1e-10 relative in beta
  itself (held to 1e-9) at tau just above 1e-6;
- the Newton Jacobian (written out in the port, jax.jacfwd in JAX):
  1e-12 of each cell's largest entry;
- NLTE populations, on cells converged in both (the same set): 1e-6
  relative on every level above 1e-10 of the molecules (the Newton
  tolerance on the residual), 1e-12 absolute below (a level at 1e-12 came
  out 1.07e-6 relative apart, 1e-18 absolute: such populations carry few
  digits);
- cubes: I, tau, N_up, N_low within 1e-9 of the cube's maximum (float64
  marches of the same cells; erf and exp differ in the last bit);
- FITS: byte-equal for the same arrays and header;
- analysis files: equal line by line, numbers within 1e-9 relative.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import rac2d_tpu.constants as jc
from rac2d_tpu import defaults as jdefaults

from torch_cli_fixtures import seeded_models
from torch_mc_fixtures import one_torch_thread  # noqa: F401 (autouse)

RTOL_LIN = 1e-12
RTOL_POP = 1e-6
RTOL_CUBE = 1e-9
RTOL_TEXT = 1e-9


@pytest.fixture(scope="module")
def models():
    return seeded_models()


# ---------------------------------------------------------------- readers

def _same_molecule(a, b):
    for f in ("name", "weight", "energy_K", "g", "iup", "ilow", "Aul", "freq",
              "lam_A", "Bul", "Blu", "Eup_K"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    assert len(a.partners) == len(b.partners)
    for p, q in zip(a.partners, b.partners):
        assert p.name == q.name
        for f in ("T_coll", "iup", "ilow", "Cul"):
            np.testing.assert_array_equal(getattr(p, f), getattr(q, f), f)


@pytest.mark.parametrize("path", [jdefaults.CO_LAMDA, jdefaults.H2O_LAMDA])
def test_lamda_reader_equal(path):
    from rac2d_tpu.io import lamda as jl
    from rac2d_torch.io import lamda as tl
    a, b = jl.load_lamda(path), tl.load_lamda(path)
    _same_molecule(a, b)
    assert b.n_level > 10 and len(b.partners) >= 1


def _hitran_record(wavnum, inten, A, Elow, gup, glo):
    """One synthetic 160-char HITRAN-2012 record, as
    tests/test_linelists.py makes them."""
    s = [" "] * 160

    def put(lo, hi, text):
        t = text.rjust(hi - lo)
        s[lo:hi] = list(t[:hi - lo])
    put(0, 2, "5")
    put(2, 3, "1")
    put(3, 15, f"{wavnum:12.6f}")
    put(15, 25, f"{inten:10.3E}")
    put(25, 35, f"{A:10.4E}")
    put(45, 55, f"{Elow:10.4f}")
    put(67, 82, "X1/2".ljust(15))
    put(82, 97, "X1/2".ljust(15))
    put(97, 112, "  2".ljust(15))
    put(112, 127, "  1".ljust(15))
    put(146, 153, f"{gup:7.1f}")
    put(153, 160, f"{glo:7.1f}")
    return "".join(s)


def test_hitran_reader_equal(tmp_path):
    from rac2d_tpu.io import hitran as jh
    from rac2d_torch.io import hitran as th
    rows = [_hitran_record(3.845033, 1e-25, 7.2e-8, 0.0, 5.0, 3.0),
            _hitran_record(7.689919, 2e-25, 6.9e-7, 3.845033, 7.0, 5.0),
            _hitran_record(11.53462, 3e-25, 2.5e-6, 11.535, 9.0, 7.0)]
    p = tmp_path / "fake.par"
    p.write_text("\n".join(rows) + "\n")
    a, b = jh.load_hitran(str(p)), th.load_hitran(str(p))
    _same_molecule(a, b)
    assert len(b.Aul) == 3
    a = jh.load_hitran(str(p), lam_range_um=(1000.0, 3000.0))
    b = th.load_hitran(str(p), lam_range_um=(1000.0, 3000.0))
    _same_molecule(a, b)
    assert len(b.Aul) == 2


def _cdms_row(freq_mhz, lgint, elow, gup, tag, jup):
    """One catalog row of a linear rotor (QNFMT 1202: g = 2J + 1) in the
    fixed columns the reader parses."""
    q = (f"{jup:2d}" + " " * 10) + (f"{jup - 1:2d}" + " " * 10)
    return (f"{freq_mhz:13.4f}{0.005:8.4f}{lgint:8.4f} 3{elow:10.4f}"
            f"{gup:3d}{tag:7d}{1202:4d}{q}")


@pytest.mark.parametrize("partition", [False, True])
def test_cdms_reader_equal(tmp_path, partition):
    from rac2d_tpu.io import cdms as jcd
    from rac2d_torch.io import cdms as tcd
    B = 1.9225                     # cm^-1, a CO-like rotor
    c_mhz = jc.SpeedOfLight_CGS * 1e-6
    rows = [_cdms_row(2.0 * B * J * c_mhz, -5.0 + 0.3 * J,
                      B * (J - 1) * J, 2 * J + 1, 28503, J)
            for J in range(1, 7)]
    cat = tmp_path / "cdms.dat"
    cat.write_text("\n".join(rows) + "\n")
    kw = {}
    if partition:
        part = tmp_path / "partition.dat"
        part.write_text(f"{28503:7d}" + " CO".ljust(31)
                        + " 2.0369 1.9123 1.7367 nan 1.1\n")
        kw["partition_file"] = str(part)
    a = jcd.load_cdms(str(cat), **kw)
    b = tcd.load_cdms(str(cat), **kw)
    _same_molecule(a, b)
    assert b.n_level == 7 and len(b.Aul) == 6 and (b.Aul > 0).all()


# ----------------------------------------------------------- linear algebra

def test_mp_linsolve_equal_jax():
    from rac2d_tpu.ops import linalg as jla
    from rac2d_torch.ops import linalg as tla
    rng = np.random.default_rng(3)
    B, n = 12, 41
    A = np.eye(n) * 4.0 + rng.normal(size=(B, n, n))
    A *= 10 ** rng.uniform(-12, 12, (B, n, 1))       # rows over decades
    b = rng.normal(size=(B, n)) * 10 ** rng.uniform(-12, 12, (B, n))
    xj = np.asarray(jax.vmap(jla.mp_linsolve)(jnp.asarray(A), jnp.asarray(b)))
    xt = tla.mp_linsolve(torch.as_tensor(A), torch.as_tensor(b))
    assert xt.dtype == torch.float64
    xt = xt.numpy()
    scale = np.abs(xj).max(-1, keepdims=True)
    assert (np.abs(xt - xj) <= RTOL_LIN * scale).all(), \
        (np.abs(xt - xj) / scale).max()
    # and it solves the system
    res = np.einsum("bij,bj->bi", A, xt) - b
    assert (np.abs(res) <= 1e-12 * np.abs(A).max(-1) * scale).all()


# ---------------------------------------------------------------- excitation

@pytest.fixture(scope="module")
def co():
    from rac2d_tpu.io import lamda as jl
    from rac2d_tpu.ops import stateq as jsq
    from rac2d_torch.io import lamda as tl
    from rac2d_torch.ops import stateq as tsq
    jmol = jl.load_lamda(jdefaults.CO_LAMDA)
    tmol = tl.load_lamda(jdefaults.CO_LAMDA)
    return (jsq.build_mol_tables(jmol),
            tsq.build_mol_tables(tmol, "cpu"), tmol)


def _exc_envs(mol, seed=0):
    """18 cells: 6 in the LTE limit (n_H2 1e10-1e12), 6 subthermal (1e1-1e3),
    6 optically thick lines (n_mol x L up to 1e20 cm^-2 at n_H2 1e4-1e6),
    with continuum extinction and mean intensity."""
    rng = np.random.default_rng(seed)
    nr, npart = len(mol.Aul), len(mol.partners)
    nH2 = np.concatenate([10 ** rng.uniform(10, 12, 6),
                          10 ** rng.uniform(1, 3, 6),
                          10 ** rng.uniform(4, 6, 6)])
    dmol = np.concatenate([10 ** rng.uniform(-3, 0, 12),
                           10 ** rng.uniform(1, 3, 6)])
    L = np.concatenate([10 ** rng.uniform(12, 14, 12),
                        10 ** rng.uniform(16, 17, 6)])
    B = len(nH2)
    dens = np.stack([0.75 * nH2, 0.25 * nH2], 1)[:, :npart]
    return (rng.uniform(10.0, 300.0, B), rng.uniform(1e4, 1e5, B), L, dmol,
            dens, 10 ** rng.uniform(-24, -20, (B, nr)),
            10 ** rng.uniform(-16, -13, (B, nr)))


def test_boltzmann_and_rhs_equal_jax(co):
    from rac2d_tpu.ops import stateq as jsq
    from rac2d_torch.ops import stateq as tsq
    jt, tt, mol = co
    env = _exc_envs(mol)
    jenv = jsq.CellExcEnv(*(jnp.asarray(a) for a in env))
    tenv = tsq.CellExcEnv(*(torch.as_tensor(a) for a in env))
    fb_j = np.asarray(jax.vmap(lambda T: jsq.boltzmann(jt, T))(jenv.Tkin))
    fb_t = tsq.boltzmann(tt, tenv.Tkin).numpy()
    np.testing.assert_allclose(fb_t, fb_j, rtol=1e-13, atol=0)
    f = np.random.default_rng(1).dirichlet(np.ones(mol.n_level), len(env[0]))
    jy, (jb, jJ) = jax.vmap(lambda e, x: jsq.stateq_rhs(jt, e, x))(
        jenv, jnp.asarray(f))
    ty, (tb, tJ) = tsq.stateq_rhs(tt, tenv, torch.as_tensor(f))
    # the largest term of each cell's equations: radiative and collisional
    ft = torch.as_tensor(f)
    yu, yl = ft[:, tt.iup], ft[:, tt.ilow]
    terms = [tt.Aul * yu, tt.Bul * tJ * yu, tt.Blu * tJ * yl]
    for pi, (Cul, Clu) in enumerate(tsq._collision_rates(tt, tenv.Tkin)):
        dp = tenv.dens_partner[:, pi:pi + 1]
        terms += [Cul * ft[:, tt.p_iup[pi]] * dp,
                  Clu * ft[:, tt.p_ilow[pi]] * dp]
    scale = torch.stack([t.abs().amax(-1) for t in terms]).amax(0).numpy()
    d = np.abs(ty.numpy() - np.asarray(jy)).max(-1)
    assert (d <= 1e-11 * scale).all(), (d / scale).max()
    # beta itself: one ulp of exp over 3 tau, down to tau = 1e-6 (below,
    # beta is 1 exactly)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-9, atol=0)


def test_jacobian_equal_jax(co):
    """The port writes the Newton Jacobian out; JAX takes jax.jacfwd of
    the residual.  Within 1e-12 of each cell's largest entry (1.8e-13
    measured; single entries carry the cancellations of the residual's
    own terms)."""
    from rac2d_tpu.ops import stateq as jsq
    from rac2d_torch.ops import stateq as tsq
    jt, tt, mol = co
    env = _exc_envs(mol)
    f = np.random.default_rng(2).dirichlet(np.ones(mol.n_level),
                                           len(env[0]))
    jenv = jsq.CellExcEnv(*(jnp.asarray(a) for a in env))

    def resid(e, x):
        y, _ = jsq.stateq_rhs(jt, e, x)
        return jnp.concatenate([y[:-1], jnp.array([x.sum() - 1.0])])

    Jj = np.asarray(jax.vmap(lambda e, x: jax.jacfwd(
        lambda z: resid(e, z))(x))(jenv, jnp.asarray(f)))
    Jt = tsq.jacobian(tt, tsq.CellExcEnv(*(torch.as_tensor(a) for a in env)),
                      torch.as_tensor(f)).numpy()
    scale = np.abs(Jj).max((1, 2), keepdims=True)
    assert (np.abs(Jt - Jj) <= 1e-12 * scale).all(), \
        (np.abs(Jt - Jj) / scale).max()


def _compare_populations(ft, et, fj, ej, tol=1e-10):
    conv_t, conv_j = et <= tol, ej <= tol
    np.testing.assert_array_equal(conv_t, conv_j)
    ft, fj = ft[conv_t], fj[conv_t]
    big = fj > 1e-10
    rel = np.abs(ft - fj) / np.where(big, fj, 1.0)
    assert (rel[big] <= RTOL_POP).all(), rel[big].max()
    assert (np.abs(ft - fj)[~big] <= 1e-12).all()
    return int(conv_t.sum())


def test_solve_stateq_batch_equal_jax(co):
    from rac2d_tpu.ops import stateq as jsq
    from rac2d_torch.ops import stateq as tsq
    jt, tt, mol = co
    env = _exc_envs(mol)
    fj, ej = jsq.solve_stateq_batch(
        jt, jsq.CellExcEnv(*(jnp.asarray(a) for a in env)))
    st = {}
    tenv = tsq.CellExcEnv(*(torch.as_tensor(a) for a in env))
    ft, et = tsq.solve_stateq_batch(tt, tenv, stats=st)
    n_conv = _compare_populations(ft.numpy(), et.numpy(), np.asarray(fj),
                                  np.asarray(ej))
    assert n_conv >= 16
    np.testing.assert_allclose(ft.sum(-1).numpy(), 1.0, rtol=0, atol=1e-12)
    # cells that converged took fewer steps than the cap; the LTE-limit
    # cells are at LTE, the subthermal ones below it in J = 3
    assert st["iters"].max() <= 30 and st["steps"] == st["iters"].max()
    fb = tsq.boltzmann(tt, tenv.Tkin).numpy()
    assert np.abs(ft.numpy()[:6] - fb[:6]).max() < 1e-4
    assert (ft.numpy()[6:12, 3] < fb[6:12, 3]).all()
    # one cell through solve_stateq, as in the batch (BLAS may sum in
    # another order at another batch size)
    f1, e1 = tsq.solve_stateq(tt, tsq.CellExcEnv(*(a[3] for a in tenv)))
    np.testing.assert_allclose(f1.numpy(), ft[3].numpy(), rtol=1e-12,
                               atol=1e-20)
    # cooling from the populations
    cj = np.asarray(jax.vmap(lambda e, x: jsq.cooling_rate(jt, e, x))(
        jsq.CellExcEnv(*(jnp.asarray(a) for a in env)), fj))
    ct = tsq.cooling_rate(tt, tenv, torch.as_tensor(np.asarray(fj))).numpy()
    np.testing.assert_allclose(ct, cj, rtol=1e-9, atol=0)


# --------------------------------------------------------------------- cubes

def _line_cfg(useLTE):
    return dict(mol_file=jdefaults.CO_LAMDA, mole_name="CO", useLTE=useLTE,
                freq_min=2e11, freq_max=2.4e11, nx=7, ny=7, nf=16,
                view_thetas=[7.0, 45.0])


def _close_to_max(t, j, name):
    t, j = np.asarray(t), np.asarray(j)
    assert t.shape == j.shape, name
    scale = np.abs(j).max()
    assert np.abs(t - j).max() <= RTOL_CUBE * scale, \
        (name, np.abs(t - j).max() / scale)


@pytest.mark.parametrize("theta", [7.0, 45.0])
@pytest.mark.parametrize("useLTE", [True, False])
def test_line_cube_equal_jax(models, useLTE, theta):
    from rac2d_tpu.models import imaging as jimg
    from rac2d_torch.models import imaging as timg
    jm, tm = models
    jm.prepare_sweep_fields()
    tm.prepare_sweep_fields()
    jli = jimg.LineImaging(jm, jimg.LineConfig(**_line_cfg(useLTE)))
    tli = timg.LineImaging(tm, timg.LineConfig(**_line_cfg(useLTE)))
    np.testing.assert_array_equal(tli.transitions, jli.transitions)
    itr = int(tli.transitions[0])
    jout = jli.make_cube(itr, theta)
    tout = tli.make_cube(itr, theta)
    for t, j, name in zip(tout, jout, ("I", "tau", "N_up", "N_low",
                                       "spectrum")):
        _close_to_max(t, j, name)
    I = tout[0]
    assert np.isfinite(I).all() and I.max() > I.min()
    assert tli.tab.energy_K.device.type == "cpu"


def test_cube_chunks_equal(models, monkeypatch):
    """A cube's rays traced a few pixels at a time give the cube whose
    rays were traced at once (the default chunk holds all 49 here)."""
    from rac2d_torch.models import imaging as timg
    from rac2d_torch.ops import raytrace
    _, tm = models
    tm.prepare_sweep_fields()
    tli = timg.LineImaging(tm, timg.LineConfig(**_line_cfg(False)))
    tli.excitation()
    itr = int(tli.transitions[0])
    freqs, _, xs, ys = tli.cube_axes(itr)
    model = tli.rt_model(itr, freqs)
    whole = raytrace.make_cube(model, 45.0, xs, ys, freqs)
    # 5 rays a chunk at 16 channels
    monkeypatch.setattr(raytrace, "CHUNK_ELEMS", 5 * (raytrace.NSUB + 1) * 16)
    parts = raytrace.make_cube(model, 45.0, xs, ys, freqs)
    for t, w, name in zip(parts, whole, ("I", "tau", "N_up", "N_low")):
        _close_to_max(t, w, name)
    assert whole[0].max() > whole[0].min()


@pytest.mark.parametrize("theta", [7.0, 45.0])
def test_continuum_cube_equal_jax(models, theta):
    from rac2d_tpu.models import imaging as jimg
    from rac2d_torch.models import imaging as timg
    jm, tm = models
    for lam in (1.3e7, [8e5, 1.3e7]):
        jout = jimg.make_continuum_cube(jm, lam, theta, nx=7, ny=7)
        tout = timg.make_continuum_cube(tm, lam, theta, nx=7, ny=7)
        for t, j, name in zip(tout, jout, ("I", "tau", "spectrum")):
            _close_to_max(t, j, name)
        assert tout[0].max() > 0


def test_excitation_without_sweep_fields(models):
    """The JAX package's NLTE excitation raises AttributeError on a model
    whose sweep fields were never computed (a run resumed with zero
    iterations); the port computes them first and gives the populations
    JAX gives after an explicit prepare_sweep_fields."""
    from rac2d_tpu.models import imaging as jimg
    from rac2d_torch.models import imaging as timg
    jm, tm = models
    jm._shield = None
    tm._shield = None
    jli = jimg.LineImaging(jm, jimg.LineConfig(**_line_cfg(False)))
    with pytest.raises(AttributeError):
        jli.excitation()
    tli = timg.LineImaging(tm, timg.LineConfig(**_line_cfg(False)))
    st = {}
    ft = tli.excitation(stats=st)
    assert tm._shield is not None
    jm.prepare_sweep_fields()
    fj = jli.excitation()
    act = np.nonzero(tm.grid.using)[0]
    assert st["cells"] == len(act)
    # the JAX excitation keeps no residuals: compare on the cells the port
    # converged
    conv = st["err"] <= 1e-10
    assert conv.mean() > 0.9
    zero = np.zeros(int(conv.sum()))
    _compare_populations(ft[:, act[conv]].T, zero, fj[:, act[conv]].T, zero)


# ---------------------------------------------------------------------- FITS

def test_fits_bytes_equal_jax(tmp_path):
    from rac2d_tpu.io import fits as jf
    from rac2d_torch.io import fits as tf
    rng = np.random.default_rng(4)
    cube = rng.normal(size=(9, 7, 5))
    kw = dict(freqs=2.3e11 + np.arange(5) * 1e6, tau_map=cube[:, :, 0],
              int_map=cube[:, :, 1], ncol_up=cube[:, :, 2],
              ncol_low=cube[:, :, 3], spectrum=cube[0, 0],
              header={"EXTNAME": "LineCube", "LINE": "CO", "RESTFRQ": 2.3e11,
                      "QNUM": "2->1", "THETA": 45.0, "DIST": 100.0})
    jf.write_cube_fits(str(tmp_path / "j.fits"), cube, **kw)
    tf.write_cube_fits(str(tmp_path / "t.fits"), cube, **kw)
    a = (tmp_path / "j.fits").read_bytes()
    b = (tmp_path / "t.fits").read_bytes()
    assert a == b and len(a) % 2880 == 0
    data, hdr = tf.read_fits_image(str(tmp_path / "t.fits"))
    np.testing.assert_array_equal(np.transpose(data, (2, 1, 0)), cube)
    assert hdr["QNUM"].strip("' ") == "2->1"
    ext = tf.read_fits_extension(str(tmp_path / "t.fits"), "TauMap")
    np.testing.assert_array_equal(
        ext[0], jf.read_fits_extension(str(tmp_path / "j.fits"), "TauMap")[0])


# ------------------------------------------------------------------ analysis

_NUM = re.compile(r"[-+]?\d+\.\d*(?:[eE][-+]?\d+)?%?")


def _same_text(a, b, rtol=RTOL_TEXT):
    la, lb = a.splitlines(), b.splitlines()
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if x == y:
            continue
        assert _NUM.sub("#", x) == _NUM.sub("#", y), (x, y)
        for p, q in zip(_NUM.findall(x), _NUM.findall(y)):
            if p.endswith("%") or q.endswith("%"):
                # a share printed to 0.1%: the last digit may round
                # either way
                assert abs(float(p[:-1]) - float(q[:-1])) <= 0.1, (x, y)
                continue
            fp, fq = float(p), float(q)
            assert abs(fp - fq) <= rtol * max(abs(fp), abs(fq)), (x, y)


def test_analyse_model_points_equal_jax(models, tmp_path):
    from rac2d_tpu.ops import analysis as jan
    from rac2d_torch.ops import analysis as tan
    jm, tm = models
    jm.prepare_sweep_fields()
    tm.prepare_sweep_fields()
    pts = [(10.0, 1.0), (50.0, 20.0)]
    sp = ["CO", "H2O", "not-a-species"]
    jf = jan.analyse_model_points(jm, pts, sp, tmp_path / "j", n_top=10)
    tf = tan.analyse_model_points(tm, pts, sp, tmp_path / "t", n_top=10)
    assert [pathlib.Path(p).name for p in tf] \
        == [pathlib.Path(p).name for p in jf]
    for a, b in zip(jf, tf):
        ta, tb = pathlib.Path(a).read_text(), pathlib.Path(b).read_text()
        assert "heating/cooling" in tb and "elemental residence" in tb
        _same_text(ta, tb)
