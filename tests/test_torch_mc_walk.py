"""Port parity: the Monte Carlo packet walk (K3's plain version,
rac2d_torch.ops.mcrt._walk_plain) against the JAX walk (mcrt._mc_walk)
from the same JAX-launched packets, and the pass-level checks of
tests/test_mcrt.py on the port.

Tolerances and why:
- the xorshift128 stream and the RNG words after a walk: bit for bit
  (integer arithmetic; both walks advance every lane every step);
- status, cell and e_count on >= 99.9% of lanes, and on the lanes still
  walking positions, directions, lam and tau to rtol 1e-5 per step
  (with the domain size as the floor for positions and 1 for the
  unit-vector components and tau).  XLA and torch
  evaluate log/sin/cos/division a few ulps apart: those differences add
  up over the steps, and a lane whose event threshold falls inside the
  gap may take the other branch;
- tally totals: rtol 1e-4 (f32 sums in another order) plus what the
  lanes that took another branch carry (4x their fraction for energies,
  one count a step each for the counters);
- pass-level checks: the statistical bounds of tests/test_mcrt.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rac2d_tpu.constants as c
from rac2d_tpu.io import bethell as jbethell
from rac2d_tpu.ops import mcrt as jmcrt
from rac2d_torch import convert
from rac2d_torch.io import bethell as tbethell
from rac2d_torch.ops import mcrt as tmcrt

from test_mcrt import _uniform_sphere_model
from torch_mc_fixtures import disk_cfg, torch_model, warm_tdust
from torch_mc_fixtures import one_torch_thread  # noqa: F401 (autouse)

NQ = 128


def _xorshift_np(st, n):
    """Reference xorshift128 + Knuth scramble on numpy uint32."""
    s0, s1, s2, s3 = (a.copy() for a in st)
    out = []
    with np.errstate(over="ignore"):
        for _ in range(n):
            t = s3 ^ (s3 << np.uint32(11))
            t = t ^ (t >> np.uint32(8))
            t = t ^ s0 ^ (s0 >> np.uint32(19))
            s3, s2, s1, s0 = s2, s1, s0, t
            out.append(((t * np.uint32(2654435761)) >> np.uint32(8))
                       .astype(np.float32) * np.float32(1.0 / (1 << 24)))
    return np.stack(out), (s0, s1, s2, s3)


def test_xorshift_draws_bit_exact():
    rng = np.random.default_rng(0)
    st = tuple(rng.integers(0, 2 ** 32, 5000, dtype=np.uint32)
               for _ in range(4))
    st = (st[0] | np.uint32(1),) + st[1:]
    ref_u, ref_st = _xorshift_np(st, 37)
    tst = tuple(torch.as_tensor(a.astype(np.int64)) for a in st)
    u, new = tmcrt.xorshift_draws(tst, 37)
    np.testing.assert_array_equal(u.numpy(), ref_u)
    for a, b in zip(new, ref_st):
        np.testing.assert_array_equal(a.numpy().astype(np.uint32), b)


def test_dust_blanketing_f32_is_stable():
    """The X-ray dust self-blanketing factor in f32 (the walk's precision)
    against its float64 value: the port within 1e-5; the JAX package's
    f32 closed form cancels (a fault of the reference walk, recorded in
    ROADMAP.md) and is off by more than 10% at grain tau ~ 1e-3."""
    tau = np.logspace(-6, 2, 3000)
    G = np.ones_like(tau)
    a = np.full_like(tau, np.sqrt(1.5 / np.pi))   # tau_grain = sraw
    t = tau
    closed = 1.5 / t * (1 - 2 / t ** 2 * (1 - (1 + t) * np.exp(-t)))
    series = 1 - 3 * t / 8 + t ** 2 / 10 - t ** 3 / 48 + t ** 4 / 280 \
        - t ** 5 / 1920
    ref = np.where(t > 1e-2, closed, series)      # float64
    got = tbethell.dust_blanketing(
        *(torch.as_tensor(v, dtype=torch.float32) for v in (tau, G, a)),
        torch).double().numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    jf = np.asarray(jbethell.dust_blanketing(
        *(jnp.asarray(v, jnp.float32) for v in (tau, G, a)), jnp))
    assert np.abs(jf / ref - 1)[np.abs(tau - 1e-3) < 5e-4].max() > 0.1
    # float64 input keeps the JAX package's closed form
    np.testing.assert_allclose(
        tbethell.dust_blanketing(*(torch.as_tensor(v) for v in (tau, G, a)),
                                 torch).numpy(),
        jbethell.dust_blanketing(tau, G, a), rtol=1e-12)


def _gray():
    # thick enough (inscribed radius x inverse mean free path up to 10)
    # for the Modified Random Walk to take over deep inside the cell
    model, tab, _ = _uniform_sphere_model(tau_half=20.0)
    rng = np.random.default_rng(1)
    lam = 10 ** rng.uniform(3.0, 6.0, 3000)   # across mrw_lam_min
    return model, lam, np.ones_like(lam)


@pytest.fixture(scope="module")
def disk():
    """The small bench disk (JAX), warm Tdust, packets from its ladder."""
    driver, cfg = disk_cfg("jax")
    m = driver.DiskModel(cfg)
    m.prepare()
    m.Tdusts = warm_tdust(m.r_cells)
    model = jmcrt.McModel(m.tab, m.gi, m.mc_cells(), m.cfg.star_mass)
    from rac2d_tpu.models import star as jstar
    lam, en = jstar.packet_ladder(m.star, 20_000, 0.2, 0.1, 1e-3)
    # no X-ray packets: their dust term takes the blanketing factor,
    # which the JAX walk evaluates in f32 where it cancels (see
    # test_dust_blanketing_f32_is_stable); the port's is stable
    keep = np.nonzero(lam > c.lam_range_Xray[1] / c.Angstrom2micron)[0]
    pick = keep[np.linspace(0, len(keep) - 1, 4000).astype(int)]
    return model, lam[pick], en[pick] / en.max()


def _jax_walk(jmodel, lam, en, steps, use_mrw):
    """JAX-launched packets (as the port's, on the CPU: the JAX walk
    donates its own), and the JAX walk of them over `steps` steps:
    (packets, walked JAX packets, step tallies)."""
    pk = jmcrt.launch_packets(jmodel, jax.random.PRNGKey(5),
                              jnp.asarray(lam), jnp.asarray(en), 0.0, 0.95)
    tpk = convert.packets(pk, "cpu")
    n, nlam = jmodel.cells.rmin.shape[0], len(jmodel.tab.lam)
    nd = jmodel.cells.rho_dust.shape[0]
    _, jpk, jtl = jmcrt._mc_walk(
        jmodel, jax.random.PRNGKey(0), pk,
        jmcrt.McTallies.zeros(n, nlam, nd, 5), max_steps=steps,
        n_quantile=NQ, finalize=False, use_mrw=use_mrw, save_counts=True,
        save_dir=True)
    return tpk, jpk, jtl


def _walk_both(jmodel, lam, en, steps, use_mrw):
    tpk, jpk, jtl = _jax_walk(jmodel, lam, en, steps, use_mrw)
    tmodel = torch_model(jmodel, "cpu")
    n, nlam = tmodel.cells.rmin.shape[0], len(jmodel.tab.lam)
    nd = tmodel.cells.rho_dust.shape[0]
    kw = dict(use_mrw=use_mrw, save_counts=True, save_dir=True)
    ws = tmcrt.WalkSetup(tmodel, NQ)
    # both walks read the same Lyman-alpha table (the port builds its
    # own in f64; tests/test_torch_mc_tables.py compares the two)
    jws = jmcrt._WalkSetup(jmodel, NQ, use_mrw)
    ws.lya_pair = torch.as_tensor(np.array(jws.lya_pair).reshape(-1, 2))
    ttl = tmcrt.McTallies.zeros(n, nlam, nd, 5, device="cpu")
    n_active = tmcrt._walk_plain(ws, tpk, ttl, steps, **kw)
    return jpk, jtl, tpk, ttl, int(n_active), float(jmodel.gi.rmax_dom)


@pytest.mark.parametrize("case,steps,use_mrw", [
    ("gray", 1, True), ("gray", 16, True), ("gray", 16, False),
    ("disk", 1, True), ("disk", 16, True), ("disk", 16, False)])
def test_walk_matches_jax(case, steps, use_mrw, request):
    if case == "gray":
        model, lam, en = _gray()
    else:
        model, lam, en = request.getfixturevalue("disk")
    jpk, jtl, tpk, ttl, n_active, L = _walk_both(model, lam, en, steps,
                                                 use_mrw)
    j = {f: np.asarray(getattr(jpk, f)) for f in jmcrt.Packets._fields}
    t = {f: getattr(tpk, f).numpy() for f in jmcrt.Packets._fields}
    # the RNG words: bit for bit on every lane
    for f in ("rs0", "rs1", "rs2", "rs3"):
        np.testing.assert_array_equal(t[f], j[f].view(np.int32))
    same = (t["status"] == j["status"]) & (t["cell"] == j["cell"]) \
        & (t["e_count"] == j["e_count"])
    # the state of the lanes still walking: f32 ulp differences of the
    # two libraries add up step by step, so rtol 1e-5 per step
    rtol = 1e-5 * steps
    ok = same.copy()
    live = same & (j["status"] == jmcrt.ST_ACTIVE)
    for f in ("x", "y", "z"):
        ok &= ~live | (np.abs(t[f] - j[f]) <= rtol * (np.abs(j[f]) + L))
    for f in ("vx", "vy", "vz", "tau"):     # unit vectors, tau ~ 1
        ok &= ~live | (np.abs(t[f] - j[f]) <= rtol * (np.abs(j[f]) + 1.0))
    ok &= ~live | (np.abs(t["lam"] - j["lam"]) <= rtol * np.abs(j["lam"]))
    assert ok.mean() >= 0.999, ok.mean()
    assert live.sum() > 0.1 * len(ok)
    n_diff = 1.0 - same.mean()
    assert abs(n_active - int((j["status"] == jmcrt.ST_ACTIVE).sum())) \
        <= 1e-3 * len(ok)
    # the walk did something: events, and after a few steps deaths
    assert (j["e_count"] > 0).any()
    assert steps == 1 or (j["status"] != 0).any()
    # tally totals: 1e-4, plus what the few diverged lanes carry (up to
    # one count per step each for the counters)
    tol = 1e-4 + 4 * n_diff
    n_div = int((~same).sum())
    for f in ("flux", "mrw_path", "phc", "en_gain_abso", "cr_count"):
        a = float(np.asarray(getattr(jtl, f), np.float64).sum())
        b = float(getattr(ttl, f).double().sum())
        bound = 1e-4 * abs(a) + steps * n_div if f in ("phc", "cr_count") \
            else tol * abs(a)
        assert abs(a - b) <= bound + 1e-30, (f, a, b)
    da = np.abs(np.asarray(jtl.dir_flux, np.float64)).sum(0)
    db = ttl.dir_flux.double().abs().sum(0).numpy()
    np.testing.assert_allclose(db, da, rtol=tol)
    if use_mrw and steps > 1 and case == "gray":
        assert float(np.asarray(jtl.mrw_path).sum()) > 0


@pytest.fixture(scope="module")
def walked16(disk):
    """The packets of a 16-step JAX walk, for the gray and disk cases."""
    return {"gray": (_gray()[0],) + _jax_walk(*_gray(), 16, True)[1:2],
            "disk": (disk[0],) + _jax_walk(*disk, 16, True)[1:2]}


@pytest.mark.parametrize("case,lanes", [
    ("gray", "walked"), ("disk", "walked"), ("disk", "padding"),
    ("disk", "no_escaped")])
def test_fold_terminal_matches_jax(case, lanes, walked16):
    """K4's plain twin (_fold_terminal_plain) against the JAX
    _fold_terminal on the packets of a 16-step JAX walk: as walked, with
    every third lane made compaction padding, and with no escaped lane.
    Tolerance: the collector, collector_img and ab_en_water totals within
    1e-6 relative (f32 adds in another order) on every lane, and every
    bin within 1e-5 of its array's largest on the lanes that both
    packages put in the same wavelength bin.  A lane on a bin edge may
    fall on the other side of it: re-emitted lanes carry a wavelength of
    the grid itself, and XLA's and torch's f32 log differ by an ulp
    there, so a whole group of them can move one bin (16 of 2589 escaped
    lanes at 94239.5 A in the disk case).  Such lanes must be at most 1%
    of the escaped ones and each exactly one bin off.  The twin's fate
    counter equals packet_fates on the same lanes."""
    from rac2d_tpu.ops import optics as joptics
    from rac2d_torch.ops import optics as toptics
    jmodel, jpk = walked16[case]
    tmodel = torch_model(jmodel, "cpu")
    st = np.array(jpk.status)
    if lanes == "padding":
        st[::3] = tmcrt.ST_PADDING
    elif lanes == "no_escaped":
        st[st == tmcrt.ST_ESCAPED] = tmcrt.ST_DESTRUCTED
    esc = st == tmcrt.ST_ESCAPED
    jbin = np.asarray(joptics.lam_to_bin(jmodel.tab.lam_seg, jpk.lam))
    tbin = toptics.lam_to_bin(tmodel.tab.lam_seg,
                              torch.as_tensor(np.array(jpk.lam)),
                              False).numpy()
    edge = esc & (jbin != tbin)
    assert edge.sum() <= 0.01 * max(esc.sum(), 1)
    assert (np.abs(jbin - tbin)[edge] == 1).all()
    n, nlam = jmodel.cells.rmin.shape[0], len(jmodel.tab.lam)
    nd = jmodel.cells.rho_dust.shape[0]

    def both(status, fates=None):
        pk = jpk._replace(status=jnp.asarray(status))
        jtl = jmcrt._fold_terminal(jmodel, pk,
                                   jmcrt.McTallies.zeros(n, nlam, nd, 5), 5)
        tl = tmcrt.McTallies.zeros(n, nlam, nd, 5, device="cpu")
        tmcrt._fold_terminal_plain(tmodel, convert.packets(pk, "cpu"), tl,
                                   5, fates)
        return jtl, tl

    fates = torch.zeros(tmcrt.N_CODES, dtype=torch.int64)
    jtl, tl = both(st, fates)
    # the same lanes without those on a bin edge (made destroyed: not
    # folded)
    jtl_in, tl_in = both(np.where(edge, tmcrt.ST_DESTRUCTED, st))
    assert (int(esc.sum()) == 0) == (lanes == "no_escaped")
    for f in ("collector", "collector_img", "ab_en_water"):
        a = np.asarray(getattr(jtl, f), np.float64)
        b = getattr(tl, f).double().numpy()
        assert abs(a.sum() - b.sum()) <= 1e-6 * abs(a.sum()), f
        a = np.asarray(getattr(jtl_in, f), np.float64)
        b = getattr(tl_in, f).double().numpy()
        assert np.abs(a - b).max() <= 1e-5 * np.abs(a).max(), f
    if esc.any():
        assert float(tl.collector.sum()) > 0
    np.testing.assert_array_equal(
        fates.numpy(), np.bincount(st, minlength=tmcrt.N_CODES))
    assert tmcrt.fates_of_counts(fates.tolist()) == \
        tmcrt.packet_fates(torch.as_tensor(st))


def test_streamed_fates_keep_their_bookkeeping(monkeypatch):
    """The fates of mc_pass_streamed, now counted by the fold into a device
    counter read once, equal the bookkeeping of packet_fates at each fold:
    a retired batch counts its terminal lanes (not "active"), the final
    batch every lane, ST_PADDING never; on a pass with padding in its
    pool, refills, compactions and lanes still walking at its step cap."""
    model, tab, _ = _uniform_sphere_model(tau_half=20.0)
    tmodel = torch_model(model, "cpu")
    seen = []
    plain = tmcrt._fold_terminal_plain

    def fold(model, pk, tallies, n_mu, fates=None):
        seen.append(tmcrt.packet_fates(pk.status))
        return plain(model, pk, tallies, n_mu, fates)
    monkeypatch.setattr(tmcrt, "_fold_terminal_plain", fold)
    N = 2000
    lam, en = np.full(N, 3.0e5), np.ones(N)
    stats = {}
    _, _, fates = tmcrt.mc_pass_streamed(
        tmodel, torch.Generator().manual_seed(3), lam, en, 0.0, 1.0,
        tmcrt.McTallies.zeros(1, len(tab.lam), 1, 5, device="cpu"),
        max_batch=256, steps_per_call=16, max_steps=640, use_mrw=True,
        compact_floor=64, stats=stats)
    want = {k: sum(f[k] for f in seen[:-1]) + seen[-1][k]
            if k != "active" else seen[-1][k] for k in fates}
    assert fates == want
    assert stats["refills"] > 2 and stats["compactions"] >= 1
    assert fates["active"] > 0
    assert sum(fates.values()) == N
    assert stats["host_reads"] == stats["chunks"] + 1


@pytest.mark.parametrize("kind", ["grazing", "corner"])
def test_edge_lanes_leave_their_cell_or_end(kind, disk):
    """The lanes that the JAX walk never ends (ROADMAP.md §3, repaired in
    the port): a grazing descent onto a bottom face must cross into the
    cell below, and a lane aimed at its cell's corner (no exit, a nudge
    that leaves it in place) must end as premature, within 8 steps."""
    model, _, _ = disk
    ws = tmcrt.WalkSetup(torch_model(model, "cpu"), NQ)
    pk, kinds = tmcrt.edge_lanes(ws)
    sel = torch.as_tensor([k == kind for k in kinds])
    assert int(sel.sum()) >= 2
    pk = pk.take(sel)
    c0 = pk.cell.clone()
    n, nlam = ws.n_cells, ws.nlam
    tl = tmcrt.McTallies.zeros(n, nlam, ws.n_dust, 5, device="cpu")
    gone = torch.zeros(len(c0), dtype=torch.bool)
    for _ in range(8):
        tmcrt._walk_plain(ws, pk, tl, 1)
        gone |= (pk.cell != c0) | (pk.status != tmcrt.ST_ACTIVE)
    assert bool(gone.all()), (pk.cell, pk.status)
    if kind == "grazing":
        assert bool((pk.cell != c0).all())
    else:
        assert bool((pk.status == tmcrt.ST_PREMATURE).all())


def test_en_gain_is_zero_in_dust_free_cells(disk):
    """_en_gain_from_flux on a model with dust-free cells (d2h = 0): finite
    everywhere, 0 there, and every other cell bitwise as in the model
    where they hold dust.  The JAX package gives NaN in those cells."""
    model, _, _ = disk
    n, nlam = model.cells.rmin.shape[0], len(model.tab.lam)
    free = np.array([3, 17, n - 1])
    cells = model.cells._replace(
        d2h=np.asarray(model.cells.d2h).copy(),
        rho_dust=np.asarray(model.cells.rho_dust).copy())
    cells.d2h[free] = 0.0
    cells.rho_dust[:, free] = 0.0
    dfree = model._replace(cells=cells)
    rng = np.random.default_rng(4)
    flux = 10 ** rng.uniform(-3, 3, (n, nlam))
    mrw = 10 ** rng.uniform(-3, 3, (1, n))

    def gain(m):
        tl = tmcrt.McTallies.zeros(n, nlam, 1, 5, device="cpu")._replace(
            flux=torch.as_tensor(flux, dtype=torch.float32),
            en_gain_mrw=torch.as_tensor(mrw, dtype=torch.float32))
        return tmcrt._en_gain_from_flux(torch_model(m, "cpu"), tl).en_gain
    got, ref = gain(dfree), gain(model)
    assert bool(torch.isfinite(got).all())
    assert bool((got[:, free] == 0.0).all())
    other = np.setdiff1d(np.arange(n), free)
    assert torch.equal(got[:, other], ref[:, other])
    assert bool(torch.isfinite(ref).all())
    jt = jmcrt.McTallies.zeros(n, nlam, 1, 5)._replace(
        flux=jnp.asarray(flux, jnp.float32))
    jg = np.asarray(jmcrt._en_gain_from_flux(dfree, jt).en_gain)
    assert not np.isfinite(jg[:, free]).any()


def test_thin_absorption_on_the_port():
    """tests/test_mcrt.py::test_mc_optically_thin_absorption through the
    port's launch_packets -> mc_pass, and the same fraction as JAX within
    MC noise (about 1% at 4000 packets; bound 5%)."""
    model, tab, _ = _uniform_sphere_model(tau_half=0.05)
    B = 4000
    lam, en = np.full(B, 5.5e4), np.ones(B)
    tmodel = torch_model(model, "cpu")
    gen = torch.Generator().manual_seed(0)
    pk = tmcrt.launch_packets(tmodel, gen, torch.as_tensor(lam),
                              torch.as_tensor(en), 0.0, 1.0)
    tall = tmcrt.McTallies.zeros(1, len(tab.lam), 1, 5, device="cpu")
    pk, tall = tmcrt.mc_pass(tmodel, pk, tall, use_mrw=False)
    assert (pk.status != tmcrt.ST_ACTIVE).all()
    absorbed = float(tall.en_gain.sum())
    assert 0.02 < absorbed / B < 0.2
    assert bool(torch.isfinite(tall.flux).all())
    jpk = jmcrt.launch_packets(model, jax.random.PRNGKey(0),
                               jnp.asarray(lam), jnp.asarray(en), 0.0, 1.0)
    _, jtl = jmcrt.mc_pass(model, jax.random.PRNGKey(0), jpk,
                           jmcrt.McTallies.zeros(1, len(tab.lam), 1, 5),
                           use_mrw=False)
    ja = float(np.asarray(jtl.en_gain).sum())
    assert abs(absorbed - ja) / ja < 0.05


def test_streamed_refill_on_the_port():
    """tests/test_mcrt.py::test_mc_pass_streamed_refill_conserves_physics
    on the port: every pool packet counted once, the pool drained through
    several top-ups, and the deposited energy statistically equal to the
    full-width pass (MC noise ~ 1/sqrt(N); bound 10%)."""
    model, tab, _ = _uniform_sphere_model(tau_half=20.0)
    tmodel = torch_model(model, "cpu")
    N = 4096
    lam, en = np.full(N, 3.0e5), np.ones(N)
    gen = torch.Generator().manual_seed(7)
    pk0 = tmcrt.launch_packets(tmodel, gen, torch.as_tensor(lam),
                               torch.as_tensor(en), 0.0, 1.0)
    _, tl_a = tmcrt.mc_pass(tmodel, pk0,
                            tmcrt.McTallies.zeros(1, len(tab.lam), 1, 5, device="cpu"),
                            use_mrw=True, max_steps=40_000)
    refills, stats = [], {}
    _, tl_b, fates = tmcrt.mc_pass_streamed(
        tmodel, gen, lam, en, 0.0, 1.0,
        tmcrt.McTallies.zeros(1, len(tab.lam), 1, 5, device="cpu"), max_batch=512,
        steps_per_call=64, max_steps=40_000, use_mrw=True, compact_floor=64,
        progress_cb=lambda done, act, left: refills.append(left),
        stats=stats)
    assert refills[0] > 0 and refills[-1] == 0
    assert stats["refills"] > 2 and stats["compactions"] >= 1
    assert sum(fates.values()) == N
    assert fates["active"] == 0
    en_a = float(tl_a.en_gain.sum())
    en_b = float(tl_b.en_gain.sum())
    assert en_a > 0
    np.testing.assert_allclose(en_b, en_a, rtol=0.1)
    assert bool(torch.isfinite(tl_b.flux).all())
