"""Port parity: multi-rank sharding over torch.distributed
(``rac2d_torch.parallel.mesh``, the sharded branches of ``DiskModel``,
``checkpoint.save_state_dist``/``load_state_dist`` and the command line
under torchrun), on the CPU.

Every multi-rank case runs 2 gloo ranks through
``torch.multiprocessing.spawn`` on a free localhost port
(tests/torch_dist_worker.py), with a join timeout of 120 s and a
collective timeout of 60 s, so that a deadlock fails the test rather than
hanging it.  The references are single-process runs of the same port
code in this process.  Bars:
- the mesh and placement: the shapes and rows of the JAX package's
  tests/test_parallel.py::test_mesh_and_placement, for 2 ranks;
- the sharded chemistry solve (4 dark-cloud lanes to 1e-2 yr on the
  shipped network) against ``ChemicalODE.solve_batched`` of the same
  lanes in one process: rtol 1e-8, atol 1e-25 (tests/test_parallel.py:69);
  and the same 2-rank result against the JAX package's
  ``sharded_chemistry_solve`` on 2 of the CPU devices that
  tests/conftest.py provides, at the same bar and with the same
  accepted steps (measured against the one-process solve: 6.7e-9
  relative at worst);
- the wall-clock guard firing on one rank first: both ranks stop after
  the same interval, with the same results, well inside the timeout;
- the sharded MC pass (nph 20000, the small disk of
  tests/torch_mc_fixtures.py): every tally channel equal to the sum of
  each rank's own single-process pass (its block, its generator) within
  1e-5 relative to the channel's largest entry (f32 sums in another
  order), the fates summed exactly; against the unsharded pass of the
  same pool (other random numbers, so a statistical bar, not the 1e-4 of
  tests/test_parallel.py, which runs the same random numbers in both):
  chip_smoke.py phase 10's bar, the median |dTdust|/Tdust over the
  active cells below 0.03 and the absorbed energy within 2%;
- save_state_dist/load_state_dist on 2 ranks: bit-equal round trip, the
  derived state rebuilt, and a ValueError on another grid.
The slice as a whole and the command line on 2 ranks are in
tests/test_torch_parallel_run.py (a file of its own, for a second
worker).
"""

import functools

import numpy as np
import pytest
import torch

import torch_dist_worker as w
from torch_mc_fixtures import one_torch_thread  # noqa: F401 (autouse)

from rac2d_torch.parallel import mesh


def test_mesh_and_placement():
    r0, r1 = w.run_ranks(w.mesh_placement)
    arr = np.arange(64.0).reshape(8, 8)
    for i, r in enumerate((r0, r1)):
        assert r["shape"] == (1, 2) and r["shape2"] == (2, 1)
        assert r["names"] == ("cells", "pkt")
        # each rank holds one block of rows along the sharded axis
        np.testing.assert_array_equal(r["pkt"], arr[4 * i:4 * i + 4])
        np.testing.assert_array_equal(r["cells"], arr[4 * i:4 * i + 4])
        np.testing.assert_array_equal(r["put"], arr[4 * i:4 * i + 4])
        np.testing.assert_array_equal(r["local"], arr[4 * i:4 * i + 4])
        # a mesh axis of one shard, and replication: the whole array
        np.testing.assert_array_equal(r["cells_one"], arr)
        np.testing.assert_array_equal(r["rep"], arr)
        assert r["any"] == (True, False, True)
        assert r["each"] == [True, False, True]
        assert r["min"] == 9.0
        np.testing.assert_array_equal(r["gather"],
                                      np.repeat([0.0, 1.0], 2)[:, None]
                                      * np.ones((1, 3)))
        assert r["device"] == "cpu"


def test_make_mesh_needs_a_group():
    with pytest.raises(RuntimeError, match="init_distributed"):
        mesh.make_mesh()
    assert mesh.world_size() == 1 and mesh.rank() == 0
    assert mesh.group_of() is None
    assert mesh.rank_device("cuda") == torch.device("cuda")


def _solve_single(B, t_max):
    ode, envs, y0b, T0b, touts, rtol_b, atol_b = w.dark_cloud_case(B, t_max)
    return ode.solve_batched(envs, y0b, T0b, touts, rtol_b, atol_b,
                             first_step=1e-8, evolT=False,
                             max_steps_per_interval=400)


CHEM_B, CHEM_T_MAX = 4, 1e-2


@functools.cache
def _solve_two_ranks():
    """The 2-rank sharded solve of the dark-cloud case (both ranks'
    results), shared by the tests that hold it to a reference."""
    return tuple(w.run_ranks(w.chem_solve, CHEM_B, CHEM_T_MAX, None))


def test_sharded_chemistry_matches_single():
    ref = _solve_single(CHEM_B, CHEM_T_MAX)
    r0, r1 = _solve_two_ranks()
    assert not ref.fail.any()
    for r in (r0, r1):
        assert not r["fail"].any()
        # the same algorithm and data; only the placement differs
        np.testing.assert_allclose(r["ys"], ref.ys.numpy(), rtol=1e-8,
                                   atol=1e-25)
        np.testing.assert_array_equal(r["n_steps"], ref.n_steps.numpy())
        assert r["n_rounds"] == ref.n_rounds
    # each rank holds the whole gathered result
    np.testing.assert_array_equal(r0["ys"], r1["ys"])


def test_sharded_chemistry_matches_jax_sharded():
    """The JAX package's sharded solve of the same lanes on a mesh of 2
    CPU devices, against the port's 2-rank solve."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from rac2d_tpu import defaults
    from rac2d_tpu.io import umist
    from rac2d_tpu.ops import bdf as jbdf, odesys
    from rac2d_tpu.ops.rates import CellEnv
    from rac2d_tpu.parallel import mesh as jmesh
    B = CHEM_B
    net = umist.load_network(defaults.NETWORK,
                             enthalpy_path=defaults.ENTHALPIES)
    y0 = umist.load_initial_abundances(net, defaults.INIT_ABUNDANCES)
    # w.dark_cloud_case's lanes
    n_gas = 10 ** np.random.default_rng(1).uniform(4, 6, B)
    d2g = 2.8e-12
    envs = jax.tree.map(lambda *a: jnp.stack(a), *[CellEnv.default(
        Tgas=15.0, Tdust=15.0, n_gas=n_gas[i], ratioDust2HnucNum=d2g,
        ndust_tot=d2g * n_gas[i], GrainRadius_CGS=1e-5,
        sigdust_ave=np.pi * 1e-10, SitesPerGrain=4 * np.pi * 1e-10 * 1e15)
        for i in range(B)])
    rtol, atol = odesys.tolerance_ladder(net, 1, 1e-4, 1e-30, d2g)
    touts = jnp.asarray(jbdf.log_output_times(1e-8, CHEM_T_MAX, 1.5))
    two = Mesh(np.array(jax.devices()[:2]).reshape(1, 2),
               axis_names=("cells", "pkt"))
    rj = jmesh.sharded_chemistry_solve(
        two, odesys.ChemicalODE(net), envs, None,
        jnp.tile(jnp.asarray(y0), (B, 1)), jnp.full(B, 15.0), touts,
        jnp.tile(rtol, (B, 1)), jnp.tile(atol, (B, 1)), 1e-8, False,
        max_steps_per_interval=400)
    r0, _ = _solve_two_ranks()
    assert not np.asarray(rj.fail).any() and not r0["fail"].any()
    np.testing.assert_array_equal(r0["n_steps"], np.asarray(rj.n_steps))
    np.testing.assert_allclose(r0["ys"], np.asarray(rj.ys), rtol=1e-8,
                               atol=1e-25)


def test_wall_guard_on_one_rank_stops_both():
    """Rank 1 runs out of its wall budget after the first output time;
    rank 0 has all the time it wants.  Rank 0 stops with it (otherwise it
    would wait in its next collective until the group's timeout)."""
    r0, r1 = w.run_ranks(w.chem_solve, CHEM_B, CHEM_T_MAX, [1e9, 0.0])
    for r in (r0, r1):
        assert r["fail"].all()
        assert r["n_rounds"] == r0["n_rounds"] > 0
        assert (r["t_final"] < CHEM_T_MAX).all()
        assert r["wall"] < 0.5 * w.GROUP_TIMEOUT_S
    np.testing.assert_array_equal(r0["ys"], r1["ys"])
    np.testing.assert_array_equal(r0["t_final"], r1["t_final"])


MC_NPH = 20000


def _tdust_bar(model, tall_a, tall_b):
    """chip_smoke.py phase 10's bar between two passes' tallies on the
    model: (median |dTdust|/Tdust over the active cells, relative
    difference of the absorbed energy there)."""
    cells = model.mc_cells()
    use = torch.as_tensor(model.grid.using)
    fa, fb = model.reduce(tall_a, cells), model.reduce(tall_b, cells)
    rel = ((fa.Tdust - fb.Tdust).abs() / fb.Tdust)[use].numpy()
    ea = float(tall_a.en_gain[:, use].sum())
    eb = float(tall_b.en_gain[:, use].sum())
    return float(np.median(rel)), abs(ea - eb) / eb


def test_sharded_mc_pass_is_the_sum_of_the_rank_passes():
    from rac2d_torch.models import driver
    from rac2d_torch.ops import mcrt
    key = 7
    r0, r1 = w.run_ranks(w.mc_pass, MC_NPH, key)
    m = w.mc_model(MC_NPH)
    lam, en, scale = m.packet_pool(MC_NPH)
    pad = -len(lam) % 2
    lam = np.concatenate([lam, np.full(pad, lam[-1])])
    en = np.concatenate([en, np.zeros(pad)])
    per = len(lam) // 2
    model = mcrt.McModel(tab=m.tab, gi=m.gi, cells=m.mc_cells(),
                         star_mass=m.cfg.star_mass)
    total = None
    fates = {}
    for r in range(2):
        gen = torch.Generator().manual_seed(mesh.rank_seed(key, r, 2))
        tall = mcrt.McTallies.zeros(m.grid.n_cells, len(m.tab.lam),
                                    m.n_dust, 5, device="cpu")
        _, tall, f = mcrt.mc_pass_streamed(
            model, gen, lam[r * per:(r + 1) * per],
            en[r * per:(r + 1) * per], 0.0, m.cfg.maxw, tall, **m.pass_kw())
        total = tall if total is None else mcrt.McTallies(
            *(a + b for a, b in zip(total, tall)))
        fates = {k: fates.get(k, 0) + v for k, v in f.items()}
    for r in (r0, r1):
        assert r["ranks"] == 2 and r["packets"] == len(lam) - pad
        assert r["fates"] == fates
        for f in total._fields:
            # DiskModel.mc_pass gives the energy channels in physical
            # units, in f64
            want = getattr(total, f).double().numpy()
            if f in driver.ENERGY_TALLIES:
                want = want * scale
            got = r["tallies"][f]
            tol = 1e-5 * max(np.abs(want).max(), 1e-300)
            assert np.abs(got - want).max() <= tol, f
    for f in r0["tallies"]:
        np.testing.assert_array_equal(r0["tallies"][f], r1["tallies"][f])
    assert sum(fates.values()) == len(lam) - pad
    # against the unsharded pass of the same pool: other random numbers
    tall1, fates1, _ = m.mc_pass(key, MC_NPH)
    shard = mcrt.McTallies(*(torch.as_tensor(r0["tallies"][f])
                             for f in total._fields))
    med, de = _tdust_bar(m, shard, tall1)
    print(f"sharded vs unsharded: median |dTdust|/Tdust {med:.4f}, "
          f"absorbed energy {de:.4f}")
    assert med < 0.03 and de < 0.02
    assert sum(fates1.values()) == sum(fates.values())


def test_distributed_checkpoint_round_trip(tmp_path):
    path = str(tmp_path / "ckpt")
    for r in w.run_ranks(w.checkpoint_round_trip, path):
        assert r["iiter"] == 3
        for k, v in r["saved"].items():
            np.testing.assert_array_equal(r["back"][k], v, err_msg=k)
        np.testing.assert_array_equal(r["back"]["d2h"], r["back"]["d2h_want"])
        assert r["refused"] is not None and "grid hash" in r["refused"]
    # one process reads what the two wrote
    from rac2d_torch import checkpoint
    m = w.tiny_model()
    assert checkpoint.load_state_dist(path, m) == 3
    np.testing.assert_array_equal(m.X, r["saved"]["X"])
