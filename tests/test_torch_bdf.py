"""Port parity: the BDF solver's drivers (rac2d_torch.ops.bdf), on the CPU.

tests/test_bdf.py's nine cases rerun on the port, each against scipy or
the JAX function as the JAX test holds its own, with that test's
tolerances: the single-system solver against scipy's BDF (and the JAX
solver), a batch of single solves, exact linear decay, the output-time
ladder, the batch record driver against the single solver, the host-loop
record driver bit-equal to the scan's counterpart, the continuous driver
against the record driver, and the budget and wall-clock guards.  Then
the continuous driver with its tolerance ladder and straggler compaction
against the JAX driver on one Robertson batch: the same failed lanes and
ladder levels, records within 1e-12 and record times within 1e-9.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rac2d_torch.ops import bdf

from torch_mc_fixtures import one_torch_thread  # noqa: F401 (autouse)

F64 = torch.float64


def _robertson():
    """Robertson's stiff kinetics, f and J over any leading lane axes."""
    def f(y):
        a, b, c = y[..., 0], y[..., 1], y[..., 2]
        return torch.stack([-0.04 * a + 1e4 * b * c,
                            0.04 * a - 1e4 * b * c - 3e7 * b ** 2,
                            3e7 * b ** 2], dim=-1)

    def jac(y):
        b, c = y[..., 1], y[..., 2]
        z = torch.zeros_like(b)
        return torch.stack([
            torch.stack([z - 0.04, 1e4 * c, 1e4 * b], dim=-1),
            torch.stack([z + 0.04, -1e4 * c - 6e7 * b, -1e4 * b], dim=-1),
            torch.stack([z, 6e7 * b, z], dim=-1)], dim=-2)

    return f, jac


def _batch():
    f, jac = _robertson()
    return (lambda y, a: f(y)), (lambda y, a: jac(y))


def _jax_robertson():
    from test_bdf import _robertson as jr
    return jr()


def _rows(v, B, n=3):
    return torch.full((B, n), v, dtype=F64)


def t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def test_robertson_against_scipy():
    from scipy.integrate import solve_ivp
    from rac2d_tpu.ops import bdf as jbdf
    f, jac = _robertson()
    touts = np.logspace(-5, 5, 20)
    y0 = t([1.0, 0.0, 0.0])
    res = bdf.bdf_solve(f, jac, y0, 0.0, touts, t(np.full(3, 1e-6)),
                        t(np.full(3, 1e-10)), 1e-6)
    assert not bool(res.fail)
    assert float(res.t_final) == 1e5
    sol = solve_ivp(lambda _, y: f(t(y)).numpy(), (0, 1e5), y0.numpy(),
                    method="BDF", rtol=1e-10, atol=1e-14, t_eval=touts,
                    jac=lambda _, y: jac(t(y)).numpy())
    ref = sol.y.T
    bound = 10.0 * (1e-6 * np.abs(ref) + 1e-10)
    assert (np.abs(res.ys.numpy() - ref) < bound).all()
    # the JAX solver, to the same bound
    jf, jj = _jax_robertson()
    rj = jbdf.bdf_solve(jf, jj, jnp.asarray(y0.numpy()), 0.0,
                        jnp.asarray(touts), jnp.full(3, 1e-6),
                        jnp.full(3, 1e-10), 1e-6)
    assert (np.abs(res.ys.numpy() - np.asarray(rj.ys)) < bound).all()


def test_batched_single_solves():
    """Two single-system solves (the JAX test vmaps bdf_solve): shapes,
    no failure, mass conserved per lane."""
    f, jac = _robertson()
    touts = np.logspace(-3, 3, 8)
    y0s = [t([1.0, 0.0, 0.0]), t([0.9, 0.0, 0.1])]
    res = [bdf.bdf_solve(f, jac, y, 0.0, touts, t(np.full(3, 1e-5)),
                         t(np.full(3, 1e-10)), 1e-6) for y in y0s]
    ys = torch.stack([r.ys for r in res]).numpy()
    assert ys.shape == (2, 8, 3)
    assert not any(bool(r.fail) for r in res)
    total = ys.sum(-1)
    assert np.abs(total[0] - 1.0).max() < 1e-8
    assert np.abs(total[1] - 1.0).max() < 1e-8


def test_linear_decay_exact():
    lam = 2.5
    touts = np.array([0.5, 1.0, 2.0])
    res = bdf.bdf_solve(lambda y: -lam * y,
                        lambda y: torch.full((1, 1), -lam, dtype=F64),
                        t([1.0]), 0.0, touts, t([1e-8]), t([1e-12]), 1e-4)
    assert np.abs(res.ys.numpy()[:, 0] - np.exp(-lam * touts)).max() < 1e-6


def test_log_output_times():
    from rac2d_tpu.ops import bdf as jbdf
    ts = bdf.log_output_times(1e-8, 1e6, 1.1)
    assert ts[0] == 1e-8
    assert ts[-1] == 1e6
    assert len(ts) > 300
    np.testing.assert_array_equal(ts, jbdf.log_output_times(1e-8, 1e6, 1.1))


def test_batch_matches_single():
    """The batch record driver against the single-system solver (two
    algorithms: batch-global refreshes against per-system ones)."""
    f, jac = _robertson()
    f_b, jac_b = _batch()
    B = 4
    touts = np.logspace(-3, 3, 8)
    y0 = t([1.0, 0.0, 0.0])
    res1 = bdf.bdf_solve(f, jac, y0, 0.0, touts, t(np.full(3, 1e-6)),
                         t(np.full(3, 1e-10)), 1e-6)
    resb = bdf.bdf_solve_batch(f_b, jac_b, y0.expand(B, 3).clone(), 0.0,
                               touts, _rows(1e-6, B), _rows(1e-10, B), 1e-6)
    assert resb.ys.shape == (B, 8, 3)
    assert not bool(resb.fail.any())
    ref = res1.ys.numpy()
    for b in range(B):
        d = np.abs(resb.ys[b].numpy() - ref)
        assert (d < 50 * (1e-6 * np.abs(ref) + 1e-10)).all()


def test_host_loop_matches_scan():
    """bdf_solve_batch_host (one record call per interval, progress after
    each) gives exactly bdf_solve_batch's numbers."""
    f_b, jac_b = _batch()
    B = 3
    touts = np.logspace(-3, 3, 6)
    y0b = t([1.0, 0.0, 0.0]).expand(B, 3).clone()
    r1 = bdf.bdf_solve_batch(f_b, jac_b, y0b, 0.0, touts, _rows(1e-6, B),
                             _rows(1e-10, B), 1e-6)
    seen = []
    r2 = bdf.bdf_solve_batch_host(f_b, jac_b, y0b, 0.0, touts,
                                  _rows(1e-6, B), _rows(1e-10, B), 1e-6,
                                  progress_cb=lambda i, s: seen.append(i))
    assert seen == list(range(6))
    assert not bool(r2.fail.any())
    assert torch.equal(r1.ys, r2.ys) and torch.equal(r1.ts, r2.ts)
    assert torch.equal(r1.n_steps, r2.n_steps)
    assert r1.n_rounds == r2.n_rounds > 0


def test_continuous_matches_record():
    """The continuous-recording driver reproduces the record driver's
    records within 100x the tolerance (the batch-global refreshes couple
    the lanes differently when none waits at a tout); its record times
    are the touts exactly."""
    f_b, jac_b = _batch()
    B = 4
    touts = np.logspace(-3, 3, 8)
    y0b = t([[1.0, 0.0, 0.0], [0.7, 0.2, 0.1], [0.5, 0.0, 0.5],
             [0.9, 0.05, 0.05]])
    r1 = bdf.bdf_solve_batch(f_b, jac_b, y0b, 0.0, touts, _rows(1e-6, B),
                             _rows(1e-10, B), 1e-6)
    r2 = bdf.bdf_solve_batch_cont(f_b, jac_b, y0b, 0.0, touts,
                                  _rows(1e-6, B), _rows(1e-10, B), 1e-6,
                                  rounds_per_call=64)
    assert r2.ys.shape == r1.ys.shape
    assert not bool(r2.fail.any())
    np.testing.assert_array_equal(r2.ts.numpy(), r1.ts.numpy())
    d = np.abs(r2.ys.numpy() - r1.ys.numpy())
    tol = 100 * (1e-6 * np.abs(r1.ys.numpy()) + 1e-10)
    assert (d < tol).all(), d.max()


def test_continuous_budget_guard():
    """A lane that cannot reach its next tout within the per-lane round
    budget fails; with a budget that suffices, no lane fails."""
    f_b, jac_b = _batch()
    B = 2
    touts = np.logspace(-3, 3, 6)
    y0b = t([1.0, 0.0, 0.0]).expand(B, 3).clone()
    r = bdf.bdf_solve_batch_cont(f_b, jac_b, y0b, 0.0, touts,
                                 _rows(1e-6, B), _rows(1e-10, B), 1e-6,
                                 max_steps_per_interval=3,
                                 rounds_per_call=32)
    assert bool(r.fail.all())
    r2 = bdf.bdf_solve_batch_cont(f_b, jac_b, y0b, 0.0, touts,
                                  _rows(1e-6, B), _rows(1e-10, B), 1e-6,
                                  max_steps_per_interval=2000,
                                  rounds_per_call=32)
    assert not bool(r2.fail.any())


def test_host_loop_wall_clock_guard():
    """With an exhausted wall budget the host loop fails the unfinished
    lanes instead of integrating every interval ('Premature finish',
    reference src/chemistry.f90:480-491); the records keep their shape."""
    f_b, jac_b = _batch()
    touts = np.logspace(-3, 3, 6)
    r = bdf.bdf_solve_batch_host(f_b, jac_b, t([[1.0, 0.0, 0.0]]), 0.0,
                                 touts, _rows(1e-6, 1), _rows(1e-10, 1),
                                 1e-6, max_wall_s=0.0)
    assert bool(r.fail.all())
    assert r.ys.shape == (1, 6, 3)
    # the repeated records after the abort are the last one integrated
    assert torch.equal(r.ys[0, -1], r.ys[0, 0])


def test_continuous_ladder_and_compaction_match_jax():
    """bdf_solve_batch_cont with retry_tols (two relaxed levels) and
    compact_min=2 on a Robertson batch of 8 lanes, with a tight first
    level and a round budget that only some lanes meet at each level: the
    same failed lanes and ladder levels as the JAX driver, and every
    record within 1e-12 absolute (the abundances are <= 1), every record
    time within 1e-9 relative (a failed lane's open entries hold its
    t_final, which carries the roundoff of its whole step sequence)."""
    from rac2d_tpu.ops import bdf as jbdf
    rng = np.random.default_rng(0)
    B = 8
    y0 = rng.dirichlet([1.0, 1.0, 1.0], B)
    y0[:2] = [1.0, 0.0, 0.0]
    touts = np.logspace(-4, 4, 10)
    rt, at = np.full((B, 3), 1e-12), np.full((B, 3), 1e-14)
    ladder = [(np.full(3, 1e-6), np.full(3, 1e-10)),
              (np.full(3, 1e-4), np.full(3, 1e-8))]
    kw = dict(max_steps_per_interval=150, rounds_per_call=16, compact_min=2)
    f_b, jac_b = _batch()
    r = bdf.bdf_solve_batch_cont(
        f_b, jac_b, t(y0), 0.0, touts, t(rt), t(at), 1e-6,
        retry_tols=[(t(a), t(b)) for a, b in ladder], **kw)
    jf, jj = _jax_robertson()
    rj = jbdf.bdf_solve_batch_cont(
        lambda y, a: jax.vmap(jf)(y), lambda y, a: jax.vmap(jj)(y),
        jnp.asarray(y0), 0.0, touts, jnp.asarray(rt), jnp.asarray(at),
        1e-6, retry_tols=[(jnp.asarray(a), jnp.asarray(b))
                          for a, b in ladder], **kw)
    fail = r.fail.numpy()
    np.testing.assert_array_equal(fail, np.asarray(rj.fail))
    np.testing.assert_array_equal(r.retry_level.numpy(),
                                  np.asarray(rj.retry_level))
    # the case exercises the ladder: lanes solved at a relaxed level,
    # lanes that exhaust it, and lanes clean at the first
    assert fail.any() and not fail.all()
    assert (r.retry_level.numpy()[~fail] > 0).any()
    np.testing.assert_allclose(r.ys.numpy(), np.asarray(rj.ys), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(r.ts.numpy(), np.asarray(rj.ts), rtol=1e-9,
                               atol=0)
    assert r.n_rounds > 0


@pytest.mark.parametrize("driver", ["host", "cont"])
def test_drivers_take_problem_args(driver):
    """The batch drivers hand `args` (one tensor per lane) to f_b and
    jac_b: lane-wise linear decay at rates from args, against exp."""
    lam = t([0.5, 1.0, 2.0])
    f_b = lambda y, a: -a[:, None] * y                     # noqa: E731
    jac_b = lambda y, a: -a[:, None, None] * torch.ones(   # noqa: E731
        y.shape[0], 1, 1, dtype=F64)
    touts = np.array([0.5, 1.0, 2.0])
    kw = dict(args=lam)
    fn = bdf.bdf_solve_batch_host if driver == "host" \
        else bdf.bdf_solve_batch_cont
    r = fn(f_b, jac_b, torch.ones(3, 1, dtype=F64), 0.0, touts,
           _rows(1e-8, 3, 1), _rows(1e-12, 3, 1), 1e-4, **kw)
    want = np.exp(-lam.numpy()[:, None] * touts[None, :])
    assert np.abs(r.ys.numpy()[:, :, 0] - want).max() < 1e-6
