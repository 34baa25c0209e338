"""The port's main-path slice against the JAX package, on the CPU.

(d) The pool driver (rac2d_torch.ops.bdf) on the stiff Robertson problem
    against scipy's BDF, as tests/test_bdf.py:26-45 holds the JAX solver,
    and against the JAX pool driver on the same inputs.
"""

import numpy as np

import jax
import jax.numpy as jnp
import torch

from torch_mc_fixtures import one_torch_thread  # noqa: F401 (autouse)


def _robertson_torch():
    def f_b(y, args):
        return torch.stack([
            -0.04 * y[:, 0] + 1e4 * y[:, 1] * y[:, 2],
            0.04 * y[:, 0] - 1e4 * y[:, 1] * y[:, 2] - 3e7 * y[:, 1] ** 2,
            3e7 * y[:, 1] ** 2], dim=1)

    def jac_b(y, args):
        z = torch.zeros_like(y[:, 0])
        return torch.stack([
            torch.stack([z - 0.04, 1e4 * y[:, 2], 1e4 * y[:, 1]], 1),
            torch.stack([z + 0.04, -1e4 * y[:, 2] - 6e7 * y[:, 1],
                         -1e4 * y[:, 1]], 1),
            torch.stack([z, 6e7 * y[:, 1], z], 1)], dim=1)

    return f_b, jac_b


def _robertson_jax():
    def f(y):
        return jnp.array([
            -0.04 * y[0] + 1e4 * y[1] * y[2],
            0.04 * y[0] - 1e4 * y[1] * y[2] - 3e7 * y[1] ** 2,
            3e7 * y[1] ** 2])

    def jac(y):
        return jnp.array([
            [-0.04, 1e4 * y[2], 1e4 * y[1]],
            [0.04, -1e4 * y[2] - 6e7 * y[1], -1e4 * y[1]],
            [0.0, 6e7 * y[1], 0.0]])

    return (lambda y, a: jax.vmap(f)(y)), (lambda y, a: jax.vmap(jac)(y))


Y0_ROB = np.array([[1.0, 0.0, 0.0], [0.7, 0.2, 0.1], [0.5, 0.0, 0.5],
                   [0.9, 0.05, 0.05], [1.0, 0.0, 0.0]])


def _scipy_robertson(y0, touts):
    from scipy.integrate import solve_ivp
    f_b, jac_b = _robertson_torch()
    sol = solve_ivp(
        lambda t, y: f_b(torch.as_tensor(y)[None], None)[0].numpy(),
        (0, touts[-1]), y0, method="BDF", rtol=1e-10, atol=1e-14,
        t_eval=touts,
        jac=lambda t, y: jac_b(torch.as_tensor(y)[None], None)[0].numpy())
    return sol.y.T


def test_advance_robertson_against_scipy():
    """Every recorded state of the continuous-recording advance loop."""
    from rac2d_torch.ops import bdf
    f_b, jac_b = _robertson_torch()
    touts = np.logspace(-5, 5, 20)
    B = 2
    y0 = torch.as_tensor(Y0_ROB[:B])
    rtol = torch.full((B, 3), 1e-6, dtype=torch.float64)
    atol = torch.full((B, 3), 1e-10, dtype=torch.float64)
    cst = bdf.ContState(
        st=bdf._batch_init(f_b, y0, 0.0, 1e-6, None),
        irec=torch.zeros(B, dtype=torch.int64),
        since=torch.zeros(B, dtype=torch.int64),
        ts=torch.zeros(B, 20, dtype=torch.float64),
        ys=torch.zeros(B, 20, 3, dtype=torch.float64))
    adv = bdf.make_advance(f_b, jac_b, 2000, None, 1)
    cst = adv(cst, torch.as_tensor(touts), float(touts[-1]), rtol, atol,
              None, 100000)
    assert not bool(cst.st.fail.any())
    assert (cst.irec == 20).all()
    np.testing.assert_array_equal(cst.ts.numpy(), np.tile(touts, (B, 1)))
    for b in range(B):
        ref = _scipy_robertson(Y0_ROB[b], touts)
        bound = 10.0 * (1e-6 * np.abs(ref) + 1e-10)
        assert (np.abs(cst.ys[b].numpy() - ref) < bound).all(), b


def test_pool_robertson_matches_scipy_and_jax():
    """5 lanes through a window of 2 (refills), final states vs scipy and
    vs the JAX pool driver on the same inputs."""
    from rac2d_tpu.ops import bdf as jbdf
    from rac2d_torch.ops import bdf
    touts = np.logspace(-3, 3, 8)
    N = len(Y0_ROB)
    rtol = np.full((N, 3), 1e-6)
    atol = np.full((N, 3), 1e-10)
    f_b, jac_b = _robertson_torch()
    tt = torch.as_tensor
    res = bdf.bdf_solve_batch_pool(f_b, jac_b, tt(Y0_ROB), 0.0, touts,
                                   tt(rtol), tt(atol), 1e-6, width=2,
                                   rounds_per_call=64)
    jf, jj = _robertson_jax()
    jres = jbdf.bdf_solve_batch_pool(jf, jj, jnp.asarray(Y0_ROB), 0.0,
                                     jnp.asarray(touts), jnp.asarray(rtol),
                                     jnp.asarray(atol), 1e-6, width=2,
                                     rounds_per_call=64)
    assert not bool(res.fail.any())
    np.testing.assert_array_equal(res.fail.numpy(), np.asarray(jres.fail))
    np.testing.assert_array_equal(res.t_final.numpy(),
                                  np.asarray(jres.t_final))
    y = res.ys[:, -1].numpy()
    yj = np.asarray(jres.ys[:, -1])
    for b in range(N):
        ref = _scipy_robertson(Y0_ROB[b], touts)[-1]
        bound = 10.0 * (1e-6 * np.abs(ref) + 1e-10)
        assert (np.abs(y[b] - ref) < bound).all(), b
        assert (np.abs(y[b] - yj[b]) < 0.1 * bound).all(), b


def test_pool_step_budget_and_ladder():
    """A lane that cannot reach its next tout within the round budget
    fails; with a retry ladder it is rolled back and retried at each
    level before it counts as failed."""
    from rac2d_torch.ops import bdf
    f_b, jac_b = _robertson_torch()
    touts = np.logspace(-3, 3, 6)
    tt = torch.as_tensor
    y0 = tt(Y0_ROB[:2])
    rtol = torch.full((2, 3), 1e-6, dtype=torch.float64)
    atol = torch.full((2, 3), 1e-10, dtype=torch.float64)
    ladder = [(torch.full((3,), 1e-5, dtype=torch.float64),
               torch.full((3,), 1e-9, dtype=torch.float64))] * 2
    res = bdf.bdf_solve_batch_pool(f_b, jac_b, y0, 0.0, touts, rtol, atol,
                                   1e-6, width=2, max_steps_per_interval=3,
                                   rounds_per_call=32, retry_tols=ladder)
    assert bool(res.fail.all())
    assert res.retry_level.tolist() == [2, 2]


def test_pool_wall_budget_marks_unfinished_lanes_failed():
    """When max_wall_s runs out (timed from the end of the first advance
    call), the lanes in the window are flushed as failed at their last
    state and the pool entries never started stay failed with y0."""
    from rac2d_torch.ops import bdf
    f_b, jac_b = _robertson_torch()
    touts = np.logspace(-3, 3, 6)
    tt = torch.as_tensor
    N = len(Y0_ROB)
    rtol = torch.full((N, 3), 1e-6, dtype=torch.float64)
    atol = torch.full((N, 3), 1e-10, dtype=torch.float64)
    res = bdf.bdf_solve_batch_pool(f_b, jac_b, tt(Y0_ROB), 0.0, touts, rtol,
                                   atol, 1e-6, width=2, rounds_per_call=1,
                                   max_wall_s=0.0)
    assert bool(res.fail.all())
    assert int(res.n_steps[:2].sum()) > 0
    assert (res.n_steps[2:] == 0).all() and (res.t_final[2:] == 0).all()
    np.testing.assert_array_equal(res.ys[2:, -1].numpy(), Y0_ROB[2:])
