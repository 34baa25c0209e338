"""Port parity: the hydrostatic vertical structure, AMR refine/merge and the
checkpoint of a refined grid, against the JAX package on the CPU.

The state is tests/torch_cli_fixtures.py's: the tiny bench disk (5
columns, 116 cells) prepared by both packages, with a warm Tdust(r), a Tgas
above it, abundances perturbed per cell by up to 10^0.5 either way (so
that watched species jump between vertical neighbours) and seeded fields
and tallies, carried from the JAX model into the port's.

Tolerances and why:
- ops/vertical.py and models/amr.py are host numpy, copies of the JAX
  package's modules run on the same inputs: every output bit-equal;
- DiskModel.vertical_adjust (both variants) and amr_step on that state: n0,
  using, rho_dust, the remapped state and the new grid bit-equal, the
  rescale range in the log line equal; the path matrices rebuilt after the
  moving variant and after AMR with tests/test_torch_columns.py's bars
  (rows and cols equal, w within 1e-12 relative: the same ray march in
  float64); every prepare_sweep_fields/assemble_envs field on the refined
  grid within 1e-10 relative (the columns file's bar);
- merging: the JAX package hands chained pairs (a, b), (b, c) to
  adapt_grid, which then leaves c's extent out of the column (a hole); the
  port's amr_step keeps only disjoint pairs (amr.disjoint_pairs, a repair
  in the port only).  The amr_step comparison gives the JAX model the same
  disjoint pairs, and a test of its own shows the hole and its repair;
- a checkpoint of a refined model, written by either package, loads into
  a freshly prepared model of the other, adopting the grid: the hash,
  every grid array and the state bit-equal;
- after a fixed-grid vertical_adjust, a checkpoint loaded into a fresh
  model: the port restores n0, using and rho_dust (a repair, in the port
  only, of the JAX package's load_state, which keeps the initial ones
  while the grid hash, over the cell bounds only, matches; the test also
  holds the JAX package to that, to document the departure).
"""

import numpy as np
import pytest

from rac2d_torch import checkpoint as tck
from rac2d_torch import convert
from rac2d_torch.models import amr as tamr
from rac2d_torch.ops import vertical as tvert

from torch_cli_fixtures import seeded_models
from torch_mc_fixtures import disk_cfg
from torch_mc_fixtures import one_torch_thread  # noqa: F401 (autouse)

RTOL_W = 1e-12
RTOL = 1e-10
WATCH = ("H2", "H2O", "CO", "E-")
# AMR switches of the amr_step and checkpoint tests: on this state a
# threshold of 3 marks 74 cells and a merge tolerance of 3 leaves pairs of
# unmarked cells to merge (the defaults, 10 and 1.5, change nothing here)
AMR = dict(do_refine=True, do_merge=True, refine_threshold=3.0,
           merge_tol=3.0)


@pytest.fixture(scope="module")
def models():
    """One seeded (JAX, port) pair for the tests that change nothing."""
    return seeded_models()


def _watch(m):
    return np.asarray([m.net.idx[s] for s in WATCH if s in m.net.idx])


def _grid_equal(a, b):
    for k in tck._GRID_FIELDS:
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), k)


def _paths_equal(jm, tm):
    for W in ("W_star", "W_ism"):
        j, t = getattr(jm, W), getattr(tm, W)
        np.testing.assert_array_equal(t.rows.numpy(), np.asarray(j.rows))
        np.testing.assert_array_equal(t.cols.numpy(), np.asarray(j.cols))
        np.testing.assert_allclose(t.w.numpy(), np.asarray(j.w),
                                   rtol=RTOL_W, atol=0, err_msg=W)


def _state_equal(jm, tm):
    for k in ("X", "Tgas", "Tdust", "Tdusts", "quality", "rho_dust"):
        a, b = getattr(tm, k), np.asarray(getattr(jm, k))
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, k)


@pytest.mark.parametrize("preset", [None, 0.02])
def test_pressure_gravity_balance_equal_jax(models, preset):
    from rac2d_tpu.ops import vertical as jvert
    jm, tm = models
    args = (np.maximum(jm.Tdust, 1.0), jm.rho_dust, jm.cfg.star_mass)
    kw = dict(use_Tdust=True, pmass=jm.pmass, disk_gas_mass_preset=preset)
    j = jvert.pressure_gravity_balance(jm.grid, jm.grid.n0, *args, **kw)
    t = tvert.pressure_gravity_balance(tm.grid, tm.grid.n0, *args, **kw)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(t[0], tm.grid.n0)
    assert tvert.disk_gas_mass(tm.grid, t[0]) \
        == jvert.disk_gas_mass(jm.grid, j[0])


def test_pressure_gravity_balance_moving_equal_jax(models):
    from rac2d_tpu.ops import vertical as jvert
    jm, tm = models
    args = (np.maximum(jm.Tdust, 1.0), jm.rho_dust, jm.cfg.star_mass)
    kw = dict(use_Tdust=True, zmax_dom=jm.cfg.grid.zmax)
    j = jvert.pressure_gravity_balance_moving(jm.grid, jm.grid.n0, *args,
                                              **kw)
    t = tvert.pressure_gravity_balance_moving(tm.grid, tm.grid.n0, *args,
                                              **kw)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(t[0], tm.grid.zmin)


def test_need_refine_equal_jax(models):
    from rac2d_tpu.models import amr as jamr
    jm, tm = models
    w = _watch(jm)
    mins = np.array([1e-10, 1e-12, 1e-8, 1e-9])
    marked = []
    for thresh, min_abun in ((3.0, 1e-15), (2.0, mins), (10.0, 1e-15)):
        j = jamr.need_refine(jm.grid, jm.X, w, thresh=thresh,
                             min_abun=min_abun,
                             min_dz=jm.cfg.grid.smallest_cell_size)
        t = tamr.need_refine(tm.grid, tm.X, w, thresh=thresh,
                             min_abun=min_abun,
                             min_dz=tm.cfg.grid.smallest_cell_size)
        np.testing.assert_array_equal(t, j)
        marked.append(int(t.sum()))
    assert marked[0] > 0 and marked[1] > 0, marked


def test_need_merge_equal_jax(models):
    from rac2d_tpu.models import amr as jamr
    jm, tm = models
    for tol in (1.5, 2.0, 3.0):
        j = jamr.need_merge(jm.grid, jm.grid.n0, jm.Tdust,
                            np.asarray(jm.fields.Av_toStar), tol=tol)
        t = tamr.need_merge(tm.grid, tm.grid.n0, tm.Tdust,
                            tm.fields.Av_toStar.numpy(), tol=tol)
        assert t == j
    assert len(t)


def test_adapt_grid_and_remap_state_equal_jax(models):
    from rac2d_tpu.models import amr as jamr
    jm, tm = models
    mask = jamr.need_refine(jm.grid, jm.X, _watch(jm), thresh=3.0)
    pairs = [(a, b) for a, b in jamr.need_merge(
        jm.grid, jm.grid.n0, jm.Tdust, np.asarray(jm.fields.Av_toStar),
        tol=3.0) if not (mask[a] or mask[b])]
    assert mask.any() and pairs
    jg, jp = jamr.adapt_grid(jm.grid, mask, pairs)
    tg, tp = tamr.adapt_grid(tm.grid, mask, pairs)
    np.testing.assert_array_equal(tp, jp)
    _grid_equal(tg, jg)
    assert tg.n_cells == jm.grid.n_cells + int(mask.sum()) - len(pairs)
    arrays = (jm.X, jm.Tgas, jm.Tdusts, jm.quality, jm.rho_dust)
    for a, b in zip(tamr.remap_state(tp, *arrays),
                    jamr.remap_state(jp, *arrays)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_load_watch_list_equal_jax(models, tmp_path):
    from rac2d_tpu.models import amr as jamr
    jm, tm = models
    p = tmp_path / "species_check_refine.dat"
    p.write_text("! name  min_abundance\nH2 1e-10\n# a comment\nCO 1e-12\n"
                 "NOT_A_SPECIES 1e-3\nE- 1e-9\nH2O\n\nH2O 1e-8 extra\n")
    j = jamr.load_watch_list(str(p), jm.net)
    t = tamr.load_watch_list(str(p), tm.net)
    for a, b in zip(t, j):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert len(t[0]) == 4


def _holes(g):
    """Gaps between vertically adjacent cells of a column, or below its
    lowest cell, over all columns."""
    n = 0
    for icol in range(g.n_columns):
        mem = g.col_cells[g.col_ptr[icol]:g.col_ptr[icol + 1]]
        o = mem[np.argsort(g.zmin[mem])]
        n += int((g.zmin[o[1:]] != g.zmax[o[:-1]]).sum()) + (g.zmin[o[0]] > 0)
    return n


def test_chained_merges_leave_no_hole(models):
    from rac2d_tpu.models import amr as jamr
    jm, tm = models
    mask = jamr.need_refine(jm.grid, jm.X, _watch(jm), thresh=3.0)
    pairs = [(a, b) for a, b in jamr.need_merge(
        jm.grid, jm.grid.n0, jm.Tdust, np.asarray(jm.fields.Av_toStar),
        tol=3.0) if not (mask[a] or mask[b])]
    kept = tamr.disjoint_pairs(pairs)
    cells = [c for pair in kept for c in pair]
    assert len(cells) == len(set(cells)) and set(kept) <= set(pairs)
    assert len(kept) < len(pairs)           # chains on this state
    assert _holes(jm.grid) == 0
    assert _holes(jamr.adapt_grid(jm.grid, mask, pairs)[0]) > 0
    assert _holes(tamr.adapt_grid(tm.grid, mask, kept)[0]) == 0


def _adjust(moving):
    """A fresh seeded pair after vertical_adjust in both: (JAX model, port
    model, their return values, the port's n0 before)."""
    jm, tm = seeded_models()
    jm.cfg.vertical_moving = tm.cfg.vertical_moving = moving
    n0 = tm.grid.n0.copy()
    return jm, tm, jm.vertical_adjust(), tm.vertical_adjust(), n0


@pytest.fixture(scope="module")
def rebalanced():
    return _adjust(False)


@pytest.mark.parametrize("moving", [False, True], ids=["fixed", "moving"])
def test_vertical_adjust_equal_jax(rebalanced, moving):
    jm, tm, jr, tr, n0 = _adjust(True) if moving else rebalanced
    assert tr == jr
    assert tm.log[-1] == jm.log[-1] and "rescale range" in tm.log[-1]
    for k in ("n0", "using", "zmin", "zmax"):
        np.testing.assert_array_equal(getattr(tm.grid, k),
                                      getattr(jm.grid, k), k)
    np.testing.assert_array_equal(tm.rho_dust, jm.rho_dust)
    assert not np.array_equal(tm.grid.n0, n0)
    for k in ("d2h", "r_cells", "z_cells", "vol", "abso_wei"):
        np.testing.assert_allclose(getattr(tm, k), getattr(jm, k),
                                   rtol=1e-15, atol=0, err_msg=k)
    assert tm._shield is None
    if moving:
        # the grid moved: its index and path matrices were rebuilt
        _paths_equal(jm, tm)
        np.testing.assert_array_equal(tm.gi.cell_of.numpy(),
                                      np.asarray(jm.gi.cell_of))


def _seed_fields(jm, seed):
    """Radiation fields and tallies for the JAX model's current grid, as
    tests/torch_cli_fixtures.py seeds them."""
    from rac2d_tpu.ops import fields as jfields
    from rac2d_tpu.ops import mcrt as jmcrt
    rng = np.random.default_rng(seed)
    n = jm.grid.n_cells
    nlam = len(jm.tab.lam)
    u = rng.uniform
    fl = {f: u(0.5, 2.0, n) for f in jfields.RadiationFields._fields}
    fl.update(flux=10 ** u(-6, 2, (n, nlam)), Tdusts=jm.Tdusts,
              Tdust=jm.Tdust, dir_flux=rng.normal(size=(n, 3)))
    jm.fields = jfields.RadiationFields(**fl)
    jm.tallies = jmcrt.McTallies(
        flux=u(0, 1, (n, nlam)), phc=u(0, 1, (n, nlam)),
        dir_flux=u(0, 1, (n, 3)), en_gain=u(0, 1, (1, n)),
        en_gain_abso=u(0, 1, (1, n)), ab_en_water=u(0, 1, n),
        cr_count=u(0, 1, n), collector=10 ** u(20, 30, (5, nlam)),
        collector_img=u(0, 1, (5, 8, 8, nlam)), mrw_path=u(0, 1, n),
        en_gain_mrw=u(0, 1, (1, n)))


@pytest.fixture(scope="module")
def refined():
    """A fresh seeded pair after amr_step in both, with AMR's switches; the
    JAX model merges the pairs the port merges (its need_merge replaced for
    the call by one that drops, as the port's amr_step does, the pairs
    with a refine-marked cell, then keeps the disjoint ones)."""
    from rac2d_tpu.models import amr as jamr
    jm, tm = seeded_models()
    for m in (jm, tm):
        for k, v in AMR.items():
            setattr(m.cfg, k, v)
    n = jm.grid.n_cells
    mask = jamr.need_refine(jm.grid, jm.X, _watch(jm),
                            thresh=AMR["refine_threshold"],
                            min_dz=jm.cfg.grid.smallest_cell_size)
    need_merge = jamr.need_merge

    def port_pairs(*a, **k):
        return tamr.disjoint_pairs([(i, j) for i, j in need_merge(*a, **k)
                                    if not (mask[i] or mask[j])])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jamr, "need_merge", port_pairs)
        jr = jm.amr_step()
    return jm, tm, jr, tm.amr_step(), n


def test_amr_step_equal_jax(refined):
    jm, tm, jr, tr, n_before = refined
    assert jr and tr
    # both refined and merged
    line = [ln for ln in tm.log if "AMR: refining" in ln][-1]
    assert line == [ln for ln in jm.log if "AMR: refining" in ln][-1]
    n_ref, n_pairs = (int(w) for w in line.split() if w.isdigit())
    assert n_ref > 0 and n_pairs > 0
    assert tm.grid.n_cells == n_before + n_ref - n_pairs
    assert _holes(tm.grid) == 0
    _grid_equal(tm.grid, jm.grid)
    _state_equal(jm, tm)
    assert tm.fields is None and tm._shield is None
    _paths_equal(jm, tm)
    # the sweep's inputs on the refined grid, from the same fields
    _seed_fields(jm, 5)
    convert.model_state(jm, tm)
    jm.prepare_sweep_fields()
    tm.prepare_sweep_fields()
    act = np.nonzero(jm.grid.using)[0]
    jenv, jtenv = jm.assemble_envs(act)
    tenv, ttenv = tm.assemble_envs(act)
    for t, j in ((tenv, jenv), (ttenv, jtenv)):
        for f in type(t)._fields:
            a, b = getattr(t, f), np.asarray(getattr(j, f))
            assert a.shape == b.shape, f
            np.testing.assert_allclose(a.numpy(), b, rtol=RTOL, atol=0,
                                       err_msg=f)


def test_model_grid_carries_a_refined_grid(refined):
    """convert.model_grid puts the JAX model's refined grid and rho_dust
    into a newly prepared port model, with its geometry rebuilt; the state
    follows with convert.model_state."""
    jm = refined[0]
    _seed_fields(jm, 6)
    driver, cfg = disk_cfg("torch", ncol=5, max_cells=64)
    tm = driver.DiskModel(cfg, device="cpu")
    tm.prepare()
    assert tm.grid.n_cells != jm.grid.n_cells
    convert.model_state(jm, convert.model_grid(jm, tm))
    _grid_equal(tm.grid, jm.grid)
    _state_equal(jm, tm)
    _paths_equal(jm, tm)
    np.testing.assert_array_equal(tm.gi.cell_of.numpy(),
                                  np.asarray(jm.gi.cell_of))
    assert tm.fields.Av_toStar.shape == (jm.grid.n_cells,)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_refined_checkpoint_loads_in_the_other_package(refined, writer,
                                                       tmp_path):
    from rac2d_tpu import checkpoint as jck
    jm, tm = refined[:2]
    p = tmp_path / "ck.npz"
    if writer == "jax":
        jck.save_state(p, jm, 2)
        driver, cfg = disk_cfg("torch", ncol=5, max_cells=64)
        other = driver.DiskModel(cfg, device="cpu")
        other.prepare()
        assert tck.load_state(p, other) == 2
        assert tck._grid_hash(other.grid) == jck._grid_hash(jm.grid)
        _grid_equal(other.grid, jm.grid)
        _state_equal(jm, other)
        _paths_equal(jm, other)
    else:
        tck.save_state(p, tm, 2)
        driver, cfg = disk_cfg("jax", ncol=5, max_cells=64)
        other = driver.DiskModel(cfg)
        other.prepare()
        assert jck.load_state(p, other) == 2
        assert jck._grid_hash(other.grid) == tck._grid_hash(tm.grid)
        _grid_equal(other.grid, tm.grid)
        _state_equal(other, tm)
        _paths_equal(other, tm)


def test_load_state_restores_rebalanced_densities(rebalanced, tmp_path):
    from rac2d_tpu import checkpoint as jck
    jm, tm, _, _, n0 = rebalanced
    tck.save_state(tmp_path / "t.npz", tm, 1)
    jck.save_state(tmp_path / "j.npz", jm, 1)
    fresh_j, fresh_t = seeded_models()
    assert tck.load_state(tmp_path / "t.npz", fresh_t) == 1
    for k in ("n0", "using"):
        np.testing.assert_array_equal(getattr(fresh_t.grid, k),
                                      getattr(tm.grid, k), k)
    np.testing.assert_array_equal(fresh_t.rho_dust, tm.rho_dust)
    np.testing.assert_array_equal(fresh_t.d2h, tm.d2h)
    assert fresh_t._shield is None
    # the JAX package keeps the prepared (initial) densities
    assert jck.load_state(tmp_path / "j.npz", fresh_j) == 1
    np.testing.assert_array_equal(fresh_j.grid.n0, n0)
    assert not np.array_equal(fresh_j.grid.n0, jm.grid.n0)


def test_sweep_tolerances_take_the_solved_cells_dust(monkeypatch):
    """A hydrostatic pass that empties cells of gas keeps their dust, so
    their d2h (dust over n0) becomes enormous.  The pool sweep's tolerance
    ladder takes the dust-to-H ratio of its grain atols as the mean over
    the cells it solves, not over every cell (in the port only; the JAX
    package's all-cell mean made the grain species' atols ~1e153 after
    the bootstrap of chip_smoke.py's end-to-end phase, and the sweep
    accepted abundances of +-1.75)."""
    from rac2d_torch.ops import odesys

    class Stop(Exception):
        pass

    _, tm = seeded_models()
    g = tm.grid
    gone = np.nonzero(g.using)[0][-3:]
    g.n0[gone] *= 1e-31              # as run F's bootstrap pass did
    g.using[gone] = False
    tm._derive_cell_state()
    act = g.using
    assert tm.d2h.mean() > 1e20 * tm.d2h[act].mean()
    seen = []
    ladder = odesys.tolerance_ladder

    def spy(net, level, rtol0, atol0, d2g, *a, **k):
        seen.append(d2g)
        return ladder(net, level, rtol0, atol0, d2g, *a, **k)

    def stop(envs, y0, T0, touts, rtol, atol, *a, **k):
        raise Stop(atol)

    monkeypatch.setattr(odesys, "tolerance_ladder", spy)
    monkeypatch.setattr(tm.ode, "solve_pool", stop)
    with pytest.raises(Stop) as got:
        tm.chemistry_step(1)
    assert seen and all(d == tm.d2h[act].mean() for d in seen)
    atol = got.value.args[0]
    gi = tm.net.grain_species_idx
    assert len(gi)
    np.testing.assert_allclose(
        atol[gi].numpy(),
        max(tm.cfg.atol_chem, tm.d2h[act].mean() * 1e-8), rtol=1e-15)
