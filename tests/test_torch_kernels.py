"""The CUDA kernel wrappers (rac2d_torch.ops.kernels): K1/K2 (blocked
LU) and K3/K4 (Monte Carlo walk and terminal fold).

On the CPU: the wrappers run their plain versions, launch nothing, and
refuse devices that have neither.  Tests marked `cuda` need the card and
skip without one; this file imports neither JAX nor the JAX package, so
on the card run it without the repository's conftest (which imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

Tolerances on the card: f32 roundoff of a 512-wide factorization whose
kernel sums in another order (FMA, shuffles) than the plain version,
<= 1e-4 relative to max(|ref|, 1) per lane; the f64-refined Newton solve
at 1e-8, the bar of tests/test_blocklu.py:107-132.  K3 against its
plain version: status and cell agree on >= 99% of lanes (libm ulps and
atomics reorder a few threshold decisions), the RNG words
are equal on live agreeing lanes, the tally totals within 1e-3, and on
the agreeing lanes every tally bin within 1e-4 of its channel's largest;
K4: the collector totals within 1e-5 (f32 atomics in another order).
"""

import numpy as np
import pytest
import torch

from rac2d_torch import defaults
from rac2d_torch.models import density, driver
from rac2d_torch.models.grid import GridConfig
from rac2d_torch.ops import bdf, blocklu, kernels, mcrt, optics

from torch_mc_fixtures import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture
def cuda_device():
    """The card, for tests marked `cuda`; decided when the test runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run `python -m pytest --noconftest "
                    "-m cuda tests/test_torch_kernels.py` on the card")
    return torch.device("cuda")


def _matrices(B, n, seed, device):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, n, n)) / np.sqrt(n) + 2.0 * np.eye(n)
    b = rng.standard_normal((B, n))
    return (torch.as_tensor(A, dtype=torch.float32, device=device),
            torch.as_tensor(b, dtype=torch.float32, device=device))


def _rel(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    dims = tuple(range(1, a.dim()))
    return float(((a - b).abs().amax(dim=dims)
                  / b.abs().amax(dim=dims).clamp_min(1.0)).max())


def test_wrappers_run_plain_version_on_cpu():
    A, b = _matrices(2, 90, 3, "cpu")
    kernels.reset_launches()
    fac = kernels.block_lu_factor(A)
    x = kernels.block_lu_solve(fac, b)
    ref = blocklu.block_lu(A)
    assert torch.equal(fac.lu, ref.lu) and torch.equal(fac.uinv, ref.uinv)
    assert torch.equal(x, blocklu.block_lu_solve(ref, b))
    assert kernels.block_lu_factor.launches == 0
    assert kernels.block_lu_solve.launches == 0


def test_wrappers_refuse_other_devices():
    A = torch.empty(2, 70, 70, device="meta")
    with pytest.raises(ValueError):
        kernels.block_lu_factor(A)
    with pytest.raises(ValueError):
        kernels.block_lu_solve(None, torch.empty(2, 70, device="meta"))


def test_build_dir_is_inside_the_checkout():
    root = kernels.CSRC.parent.parent
    assert kernels.BUILD_DIR == root / "build" / "rac2d_torch"
    assert sorted(p.name for p in kernels.CSRC.glob("*.cu")) == \
        ["blocklu.cu", "mcwalk.cu"]
    assert "arch=compute_90a,code=sm_90a" in kernels.NVCC_FLAGS


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3, 256])
@pytest.mark.parametrize("n", [1, 64, 65, 100, 130, 485, 512, 600])
def test_kernels_match_plain_on_card(cuda_device, n, B):
    A, b = _matrices(B, n, n, cuda_device)
    kernels.reset_launches()
    fac = kernels.block_lu_factor(A)
    x = kernels.block_lu_solve(fac, b)
    torch.cuda.synchronize()
    assert kernels.block_lu_factor.launches == 1
    assert kernels.block_lu_solve.launches == 1
    ref = blocklu.block_lu(A)
    xr = blocklu.block_lu_solve(ref, b)
    for name in ("lu", "linv", "uinv"):
        assert _rel(getattr(fac, name), getattr(ref, name)) <= 1e-4, name
    assert _rel(x, xr) <= 1e-4


@pytest.mark.parametrize("n", [1, 65, 130])
def test_poisoned_entries_are_ones_the_solve_skips(n):
    """blocklu.poison_unneeded hides, besides lu's diagonal blocks (which
    the substitution never reads), only entries that the factor holds as
    exact zeros or exact ones (the padding's identity, linv's unit
    diagonal), so a kernel that skips them computes the same x."""
    A, b = _matrices(2, n, n + 11, "cpu")
    fac = blocklu.block_lu(A)
    pf = blocklu.poison_unneeded(fac, n)
    N = fac.lu.shape[-1]
    diag = torch.zeros(N, N, dtype=torch.bool)
    for kb in range(0, N, blocklu.BK):
        diag[kb:kb + blocklu.BK, kb:kb + blocklu.BK] = True
    for name in ("lu", "linv", "uinv"):
        a, p = getattr(fac, name), getattr(pf, name)
        hid = torch.isnan(p)
        assert hid.any(), name
        assert torch.equal(a[~hid], p[~hid]), name
        if name == "lu":
            hid = hid & ~diag
        assert bool(((a[hid] == 0) | (a[hid] == 1)).all()), name
    # the plain solve does not read lu's diagonal blocks either
    lu = fac.lu.clone()
    lu[:, diag] = float("nan")
    assert torch.equal(blocklu.block_lu_solve(fac._replace(lu=lu), b),
                       blocklu.block_lu_solve(fac, b))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 256])
@pytest.mark.parametrize("n", [65, 485, 600])
def test_solve_reads_only_what_it_needs_on_card(cuda_device, n, B):
    """K2 on a factor whose unneeded entries are NaN gives the same x as
    on the clean factor."""
    A, b = _matrices(B, n, n + B, cuda_device)
    fac = kernels.block_lu_factor(A)
    x = kernels.block_lu_solve(fac, b)
    xp = kernels.block_lu_solve(blocklu.poison_unneeded(fac, n), b)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(xp).all())
    assert torch.equal(x, xp)


def test_pivot_floor_keeps_sign_on_cpu():
    A, want = blocklu.floored_pivot_matrices("cpu")
    fac = kernels.block_lu_factor(A)
    assert len(want) == len(blocklu.FLOOR_CASES)
    for (lane, j), v in want.items():
        assert float(fac.lu[lane, j, j]) == float(np.float32(v))


@pytest.mark.cuda
def test_factor_floors_pivots_like_plain_on_card(cuda_device):
    A, want = blocklu.floored_pivot_matrices(cuda_device)
    b = torch.ones(A.shape[:2], dtype=torch.float32, device=cuda_device)
    fac = kernels.block_lu_factor(A)
    x = kernels.block_lu_solve(fac, b)
    torch.cuda.synchronize()
    ref = blocklu.block_lu(A)
    for (lane, j), v in want.items():
        assert float(fac.lu[lane, j, j]) == float(np.float32(v))
    for name in ("lu", "linv", "uinv"):
        assert _rel(getattr(fac, name), getattr(ref, name)) <= 1e-4, name
    assert _rel(x, blocklu.block_lu_solve(ref, b)) <= 1e-4


@pytest.mark.cuda
def test_kernel_rejects_bad_arguments_on_card(cuda_device):
    A, b = _matrices(2, 70, 1, cuda_device)
    with pytest.raises(TypeError):
        kernels.block_lu_factor(A.double())
    with pytest.raises(ValueError):
        kernels.block_lu_factor(A.transpose(1, 2))
    fac = kernels.block_lu_factor(A)
    with pytest.raises(ValueError):
        kernels.block_lu_solve(fac, b[:, :60])


@pytest.mark.cuda
def test_newton_solve_kernel_matches_block_on_card(cuda_device):
    """bdf._bfac/_bsolve through the kernels vs the plain LU, both with f64
    refinement, against a float64 solve."""
    rng = np.random.default_rng(10)
    B, n = 4, 485
    J = torch.as_tensor(rng.standard_normal((B, n, n)), device=cuda_device)
    c = torch.full((B,), 0.02, dtype=torch.float64, device=cuda_device)
    scale = torch.as_tensor(1.0 + rng.uniform(0, 1, (B, n)),
                            device=cuda_device)
    b = torch.as_tensor(rng.standard_normal((B, n)), device=cuda_device)
    eye = torch.eye(n, dtype=torch.float64, device=cuda_device)
    ref = torch.linalg.solve(eye - c[:, None, None] * J, b)
    for backend in ("kernel", "block"):
        fac = bdf._bfac(J, c, scale, backend)
        x = bdf._bsolve(J, c, fac, b, 2, backend)
        assert float((x - ref).abs().max()) \
            < 1e-8 * float(ref.abs().max()), backend


# --------------------------------------------------------------------
# K3/K4: the Monte Carlo walk and the terminal fold

def _mc_setup(device, n_packets=4096, seed=0, ncol=10, max_cells=100):
    """A small TW Hya-like disk (the bench recipe at ncol=10) with a
    warm Tdust(r) profile, and packets launched from its ladder."""
    cfg = driver.DiskConfig(
        lumi_Xray=1e30,
        andrews=density.AndrewsDisk(Md=0.01, rin=1.0, rout=100.0, rc=50.0,
                                    hc=10.0),
        grid=GridConfig(rmin=1.0, rmax=100.0, zmax=100.0, ncol=ncol,
                        max_num_of_cells=max_cells),
        dust=[driver.DustComponent(opti_files=[defaults.SILICATE_OPTI],
                                   weights=[1.0])],
        network_file=defaults.NETWORK, enthalpy_file=defaults.ENTHALPIES,
        init_abundances_file=defaults.INIT_ABUNDANCES,
        h2o_cross_file=defaults.H2O_PHOTOXS,
        mc=optics.McConfig(nlen_lut=256, n_quantile=128))
    m = driver.DiskModel(cfg, device)
    m.prepare()
    m.Tdusts = np.clip(150.0 * m.r_cells ** -0.5, 10.0, 1500.0)[None, :]
    model = mcrt.McModel(m.tab, m.gi, m.mc_cells(), cfg.star_mass)
    lam, en, _ = m.packet_pool(20_000)
    pick = np.linspace(0, len(lam) - 1, n_packets).astype(int)
    gen = torch.Generator(device=device).manual_seed(seed)
    pk = mcrt.launch_packets(model, gen, torch.as_tensor(lam[pick],
                                                         device=device),
                             torch.as_tensor(en[pick], device=device),
                             0.0, cfg.maxw)
    return m, model, pk


def test_mc_wrappers_run_plain_version_on_cpu():
    m, model, pk = _mc_setup("cpu", n_packets=256)
    ws = mcrt.WalkSetup(model, m.mc_cfg.n_quantile)
    nlam = len(m.tab.lam)
    tk = mcrt.McTallies.zeros(m.grid.n_cells, nlam, 1, 5, device="cpu")
    tp = mcrt.McTallies.zeros(m.grid.n_cells, nlam, 1, 5, device="cpu")
    pk_k, pk_p = pk.clone(), pk.clone()
    kernels.reset_launches()
    na = kernels.mc_walk(ws, pk_k, tk, 8)
    assert int(na) == int(mcrt._walk_plain(ws, pk_p, tp, 8))
    kernels.fold_terminal(model, pk_k, tk, 5)
    mcrt._fold_terminal_plain(model, pk_p, tp, 5)
    for a, b in zip(pk_k + tk, pk_p + tp):
        assert torch.equal(a, b)
    assert kernels.mc_walk.launches == 0
    assert kernels.fold_terminal.launches == 0


def _totals_rel(a, b):
    a, b = float(a.double().sum()), float(b.double().sum())
    return abs(a - b) / max(abs(b), 1e-30)


# (lanes, steps, use_mrw, save_counts): the options at 4096 lanes; the
# persistent grid at one lane, at 127 and 129 lanes (a few warps, one
# ragged) and at the full batch width, at 1 and 64 steps (a lane handed
# on at every step, and lanes dying inside a chunk)
MC_CASES = [(4096, 16, True, True), (4096, 16, True, False),
            (4096, 16, False, True), (4096, 16, False, False),
            (1, 1, True, True), (1, 64, True, True), (127, 64, True, True),
            (129, 1, True, True), (129, 64, True, True),
            (262144, 1, True, True), (262144, 64, True, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,steps,use_mrw,save_counts", MC_CASES)
def test_mc_kernels_match_plain_on_card(cuda_device, B, steps, use_mrw,
                                        save_counts):
    m, model, pk = _mc_setup(cuda_device, n_packets=B)
    ws = mcrt.WalkSetup(model, m.mc_cfg.n_quantile)
    nlam = len(m.tab.lam)
    tk = mcrt.McTallies.zeros(m.grid.n_cells, nlam, 1, 5, device=cuda_device)
    tp = mcrt.McTallies.zeros(m.grid.n_cells, nlam, 1, 5, device=cuda_device)
    pk_k, pk_p = pk.clone(), pk.clone()
    kw = dict(use_mrw=use_mrw, save_counts=save_counts, save_dir=True)
    kernels.reset_launches()
    na_k = int(kernels.mc_walk(ws, pk_k, tk, steps, **kw))
    na_p = int(mcrt._walk_plain(ws, pk_p, tp, steps, **kw))
    torch.cuda.synchronize()
    assert kernels.mc_walk.launches == 1
    agree = (pk_k.status == pk_p.status) & (pk_k.cell == pk_p.cell) \
        & (pk_k.e_count == pk_p.e_count)
    assert float(agree.float().mean()) >= 0.99
    assert abs(na_k - na_p) <= 0.01 * len(agree)
    live = agree & (pk_k.status == mcrt.ST_ACTIVE)
    for f in ("rs0", "rs1", "rs2", "rs3"):
        assert torch.equal(getattr(pk_k, f)[live], getattr(pk_p, f)[live])
    fields = ["flux", "mrw_path", "dir_flux"]
    if save_counts:
        fields += ["phc", "en_gain_abso", "cr_count"]
    for f in fields:
        assert _totals_rel(getattr(tk, f), getattr(tp, f)) <= 1e-3, f
    # every bin, on the agreeing lanes alone (tallies never feed back into
    # a lane's walk, so re-walked alone they add what they added before)
    sk, sp = tk, tp
    if not bool(agree.all()):
        sub = pk.take(agree)
        sk = mcrt.McTallies.zeros(m.grid.n_cells, nlam, 1, 5,
                                  device=cuda_device)
        sp = mcrt.McTallies.zeros(m.grid.n_cells, nlam, 1, 5,
                                  device=cuda_device)
        kernels.mc_walk(ws, sub.clone(), sk, steps, **kw)
        mcrt._walk_plain(ws, sub.clone(), sp, steps, **kw)
        torch.cuda.synchronize()
    for f in fields:
        a, b = getattr(sk, f), getattr(sp, f)
        assert float((a - b).abs().max()) <= \
            1e-4 * float(b.abs().max()), f
    # K4 on the same retired lanes
    kernels.fold_terminal(model, pk_k, tk, 5)
    mcrt._fold_terminal_plain(model, pk_k, tp, 5)
    torch.cuda.synchronize()
    assert kernels.fold_terminal.launches == 1
    for f in ("collector", "collector_img", "ab_en_water"):
        assert _totals_rel(getattr(tk, f), getattr(tp, f)) <= 1e-5, f
        assert float((getattr(tk, f) - getattr(tp, f)).abs().max()) <= \
            1e-5 * float(getattr(tp, f).abs().max()) + 1e-30, f


@pytest.mark.cuda
def test_edge_lanes_end_on_card_as_in_plain_walk(cuda_device):
    """The hand-built lanes that the JAX walk never ends (mcrt.edge_lanes)
    through K3, one step a launch: each leaves its cell or ends within 8
    steps, with the status, cell and e_count of the plain walk."""
    m, model, _ = _mc_setup(cuda_device, n_packets=1)
    ws = mcrt.WalkSetup(model, m.mc_cfg.n_quantile)
    edge, kinds = mcrt.edge_lanes(ws)
    assert "grazing" in kinds and "corner" in kinds
    c0 = edge.cell.clone()
    out = []
    for walk in (kernels.mc_walk, mcrt._walk_plain):
        pk = edge.clone()
        tl = mcrt.McTallies.zeros(m.grid.n_cells, len(m.tab.lam), 1, 5,
                                  device=cuda_device)
        gone = torch.zeros_like(c0, dtype=torch.bool)
        for _ in range(8):
            walk(ws, pk, tl, 1)
            gone |= (pk.cell != c0) | (pk.status != mcrt.ST_ACTIVE)
        assert bool(gone.all()), walk
        out.append(pk)
    for f in ("status", "cell", "e_count"):
        assert torch.equal(getattr(out[0], f), getattr(out[1], f)), f


@pytest.mark.cuda
def test_walk_plan_on_card(cuda_device):
    """K3's launch: a persistent grid of K3_MIN_BLOCKS or more CTAs per
    SM at full width, one CTA for a few lanes, and no local memory beyond
    the 32-byte frame of sincosf's slow-path argument reduction."""
    m, model, pk = _mc_setup(cuda_device, n_packets=262144)
    ws = mcrt.WalkSetup(model, m.mc_cfg.n_quantile)
    tl = mcrt.McTallies.zeros(m.grid.n_cells, len(m.tab.lam), 1, 5,
                              device=cuda_device)
    launch = kernels.WalkLaunch(ws, tl)
    launch.prepare(pk, 64)
    plan = launch.plan()
    assert plan["blocks_per_sm"] >= 2
    assert plan["grid"] == plan["blocks_per_sm"] * plan["sms"]
    assert plan["grid"] * plan["threads"] < 262144
    assert plan["local_bytes"] <= 32
    launch.prepare(pk.take(slice(0, 129)), 64)
    assert launch.plan()["grid"] == 1


@pytest.mark.cuda
def test_mc_kernels_reject_bad_arguments_on_card(cuda_device):
    m, model, pk = _mc_setup(cuda_device, n_packets=64)
    ws = mcrt.WalkSetup(model, m.mc_cfg.n_quantile)
    tl = mcrt.McTallies.zeros(m.grid.n_cells, len(m.tab.lam), 1, 5,
                              device=cuda_device)
    with pytest.raises(TypeError):
        kernels.mc_walk(ws, pk._replace(x=pk.x.double()), tl, 4)
    with pytest.raises(ValueError):
        kernels.mc_walk(ws, pk, tl._replace(flux=tl.flux[:, :-1]), 4)
    with pytest.raises(ValueError):
        kernels.mc_walk(ws, pk, tl, 0)
    ws.gi = ws.gi._replace(r_lut_pack=None)
    with pytest.raises(ValueError):
        kernels.mc_walk(ws, pk, tl, 4)
    with pytest.raises(ValueError):
        kernels.fold_terminal(model, pk, tl, 4)
    with pytest.raises(TypeError):
        kernels.fold_terminal(model, pk, tl, 5,
                              torch.zeros(6, dtype=torch.int32,
                                          device=cuda_device))
    # the launch objects: a packet tensor of the wrong type, or tallies
    # other than those they were built with, raise before any launch
    ws = mcrt.WalkSetup(model, m.mc_cfg.n_quantile)
    walk = kernels.WalkLaunch(ws, tl)
    fold = kernels.FoldLaunch(model, tl, 5)
    other = mcrt.McTallies.zeros(m.grid.n_cells, len(m.tab.lam), 1, 5,
                                 device=cuda_device)
    kernels.reset_launches()
    with pytest.raises(TypeError):
        walk(pk._replace(cell=pk.cell.float()), tl, 4)
    with pytest.raises(ValueError):
        walk(pk, other, 4)
    with pytest.raises(TypeError):
        fold(pk._replace(status=pk.status.long()), tl)
    with pytest.raises(ValueError):
        fold(pk, other)
    assert kernels.mc_walk.launches == 0
    assert kernels.fold_terminal.launches == 0


# --------------------------------------------------------------------
# K3/K4's launch objects: built once per pass, patched per Packets object

def _launch_setup(device, n_packets=256):
    m, model, pk = _mc_setup(device, n_packets=n_packets)
    ws = mcrt.WalkSetup(model, m.mc_cfg.n_quantile)
    tl = mcrt.McTallies.zeros(m.grid.n_cells, len(m.tab.lam), 1, 5,
                              device=device)
    return m, model, ws, pk, tl


def struct_fields(args):
    """A ctypes argument struct as a dict (arrays as lists)."""
    return {n: (list(v) if hasattr(v, "_length_") else v)
            for n, v in ((n, getattr(args, n)) for n, _ in args._fields_)}


def _after_refill_and_compaction(model, pk, m):
    """The Packets objects of a pass after a walk chunk, a refill and a
    compaction (mcrt's own helpers, on the CPU)."""
    ws = mcrt.WalkSetup(model, m.mc_cfg.n_quantile)
    tl = mcrt.McTallies.zeros(m.grid.n_cells, len(m.tab.lam), 1, 5,
                              device="cpu")
    n_active = int(mcrt._walk_plain(ws, pk, tl, 8))
    fresh = pk.take(slice(0, 64)).clone()
    refilled = mcrt._refill_packets(pk, fresh, n_active)
    return refilled, mcrt._compact_packets(refilled, 64)


def test_walk_launch_patched_struct_equals_fresh_one():
    """A WalkLaunch built once and prepared on the packets of a refill and
    then of a compaction holds, field for field, the struct of one built
    fresh for those packets (all but the counters, which each object
    owns)."""
    m, model, ws, pk, tl = _launch_setup("cpu")
    once = kernels.WalkLaunch(ws, tl)
    once.prepare(pk, 64)
    for new in _after_refill_and_compaction(model, pk.clone(), m):
        got = struct_fields(once.prepare(new, 64))
        want = struct_fields(
            kernels.WalkLaunch(ws, tl).prepare(new, 64))
        assert got.pop("counters") == once.counters.data_ptr()
        want.pop("counters")
        assert got == want
        assert got["B"] == new.x.shape[0]
        assert got["x"] == new.x.data_ptr()


def test_fold_launch_patched_struct_equals_fresh_one():
    m, model, _, pk, tl = _launch_setup("cpu")
    fates = torch.zeros(mcrt.N_CODES, dtype=torch.int64)
    once = kernels.FoldLaunch(model, tl, 5)
    once.prepare(pk)
    for new in _after_refill_and_compaction(model, pk.clone(), m):
        got = struct_fields(once.prepare(new, fates))
        want = struct_fields(
            kernels.FoldLaunch(model, tl, 5).prepare(new, fates))
        assert got == want
        assert got["fates"] == fates.data_ptr()
        assert got["status"] == new.status.data_ptr()
    assert struct_fields(once.prepare(pk))["fates"] is None


def test_launch_objects_refuse_other_tallies():
    m, model, ws, pk, tl = _launch_setup("cpu")
    other = mcrt.McTallies.zeros(m.grid.n_cells, len(m.tab.lam), 1, 5,
                                 device="cpu")
    walk = kernels.WalkLaunch(ws, tl)
    fold = kernels.FoldLaunch(model, tl, 5)
    with pytest.raises(ValueError, match="flux"):
        walk(pk, tl._replace(flux=other.flux), 4)
    with pytest.raises(ValueError, match="collector_img"):
        fold(pk, tl._replace(collector_img=other.collector_img))
    # the same tensors in another tuple are the same tallies
    walk(pk, mcrt.McTallies(*tl), 1)
    fold(pk, mcrt.McTallies(*tl))


def test_launch_objects_refuse_wrongly_typed_packets():
    _, model, ws, pk, tl = _launch_setup("cpu")
    walk = kernels.WalkLaunch(ws, tl)
    fold = kernels.FoldLaunch(model, tl, 5)
    with pytest.raises(TypeError, match="packets.x"):
        walk.prepare(pk._replace(x=pk.x.double()), 4)
    with pytest.raises(TypeError, match="packets.status"):
        fold.prepare(pk._replace(status=pk.status.long()))
    with pytest.raises(ValueError, match="packets.vz"):
        fold.prepare(pk._replace(vz=pk.vz[:-1]))
    with pytest.raises(TypeError, match="fates"):
        fold.prepare(pk, torch.zeros(mcrt.N_CODES, dtype=torch.int32))
    with pytest.raises(ValueError, match="max_steps"):
        walk.prepare(pk, 0)


def _fold_batches(pk):
    """K4's edge batches from a walked batch: as it is, all padding, and
    with no terminal lane (escaped and water-destroyed lanes made
    destroyed)."""
    pad = pk._replace(status=torch.full_like(pk.status, mcrt.ST_PADDING))
    st = pk.status.clone()
    st[(st == mcrt.ST_ESCAPED) | (st == mcrt.ST_DESTR_WATER)] = \
        mcrt.ST_DESTRUCTED
    return {"walked": pk, "padding": pad,
            "no_terminal": pk._replace(status=st)}


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 1024, 4096, 262144])
def test_fold_matches_plain_and_counts_fates_on_card(cuda_device, B):
    """K4 against its plain twin at B lanes walked 64 steps, and on the
    same lanes all padding and with no terminal lane: every bin within
    1e-5 of its array's largest (f32 atomics in another order), and the
    fate counts exact."""
    m, model, ws, pk, tl = _launch_setup(cuda_device, n_packets=B)
    kernels.mc_walk(ws, pk, tl, 64)
    for name, lanes in _fold_batches(pk).items():
        tk = mcrt.McTallies.zeros(m.grid.n_cells, len(m.tab.lam), 1, 5,
                                  device=cuda_device)
        tp = mcrt.McTallies.zeros(m.grid.n_cells, len(m.tab.lam), 1, 5,
                                  device=cuda_device)
        fk = torch.zeros(mcrt.N_CODES, dtype=torch.int64,
                         device=cuda_device)
        fp = torch.zeros_like(fk)
        kernels.reset_launches()
        kernels.fold_terminal(model, lanes, tk, 5, fk)
        mcrt._fold_terminal_plain(model, lanes, tp, 5, fp)
        torch.cuda.synchronize()
        assert kernels.fold_terminal.launches == 1
        for f in ("collector", "collector_img", "ab_en_water"):
            a, b = getattr(tk, f), getattr(tp, f)
            assert float((a - b).abs().max()) <= \
                1e-5 * float(b.abs().max()), (name, f)
        assert torch.equal(fk, fp), name
        assert mcrt.fates_of_counts(fk.tolist()) == \
            mcrt.packet_fates(lanes.status), name
        if name != "walked":
            assert float(tk.collector.abs().sum()) == 0.0


@pytest.mark.cuda
def test_fold_plan_on_card(cuda_device):
    """K4's grid comes from the device: at full width as many CTAs as its
    occupancy allows on every SM, at most what the lanes need (FOLD_V
    lanes a thread), one CTA for a few lanes."""
    m, model, ws, pk, tl = _launch_setup(cuda_device, n_packets=262144)
    fold = kernels.FoldLaunch(model, tl, 5)
    fold.prepare(pk)
    plan = fold.plan()
    assert plan["sms"] == torch.cuda.get_device_properties(
        cuda_device).multi_processor_count
    need = -(-262144 // (kernels.FOLD_V * plan["threads"]))
    assert plan["grid"] == min(need, plan["blocks_per_sm"] * plan["sms"])
    fold.prepare(pk.take(slice(0, 129)))
    assert fold.plan()["grid"] == 1


@pytest.mark.cuda
def test_walk_launch_reused_across_packets_on_card(cuda_device):
    """One WalkLaunch over a pass's Packets objects (a walk chunk, a
    refill, a compaction) walks each as kernels.mc_walk does, and zeroes
    its counters before each launch."""
    m, model, ws, pk, tl = _launch_setup(cuda_device, n_packets=4096)
    t1 = mcrt.McTallies.zeros(m.grid.n_cells, len(m.tab.lam), 1, 5,
                              device=cuda_device)
    once = kernels.WalkLaunch(ws, tl)
    a, b = pk.clone(), pk.clone()
    n_once = [int(once(a, tl, 16))]
    n_fresh = [int(kernels.mc_walk(ws, b, t1, 16))]
    fresh = pk.take(slice(0, 1024)).clone()
    a = mcrt._refill_packets(a, fresh, n_once[0])
    b = mcrt._refill_packets(b, fresh.clone(), n_fresh[0])
    for pa, pb in ((a, b), (mcrt._compact_packets(a, 1024),
                            mcrt._compact_packets(b, 1024))):
        n_once.append(int(once(pa, tl, 16)))
        n_fresh.append(int(kernels.mc_walk(ws, pb, t1, 16)))
        agree = (pa.status == pb.status) & (pa.cell == pb.cell)
        assert float(agree.float().mean()) >= 0.99
    assert all(abs(x - y) <= 0.01 * 4096 for x, y in zip(n_once, n_fresh))
    assert _totals_rel(tl.flux, t1.flux) <= 1e-3
