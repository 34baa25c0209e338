"""Port parity: the explicit-inverse ("inv") and pivoted ("xla") LU
backends of the batched Newton solve, on the CPU.

Held to the JAX package's bars (tests/test_blocklu.py:92-132):
- ``blocklu.block_invert`` on the same seeded matrices as the JAX
  ``block_invert``: A @ inv(A) = I within 1e-9, and the two inverses
  within 1e-12 of each other;
- ``bdf._bsolve`` on "inv" and "xla" against "block" and against a
  direct solve, within 1e-8 * max|ref| + 1e-10, and the JAX package's
  ``_bsolve`` on "inv" on the same inputs;
- the RAC2D_LU_BACKEND mapping ("auto" and "pallas" are the kernels,
  "block", "inv" and "xla" their namesakes; an unknown value raises);
- a 2-lane coupled pool sweep to 1e-3 yr on "inv" against "block", within
  the bars of tests/test_torch_pool_sweep.py (key species within 5%
  where > 1e-12, Tgas within 2%) and with the same failed lanes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rac2d_torch.ops import bdf, blocklu

from torch_mc_fixtures import one_torch_thread  # noqa: F401 (autouse)


def _well_conditioned(n, rng):
    return rng.standard_normal((n, n)) / np.sqrt(n) + 2.0 * np.eye(n)


@pytest.mark.parametrize("n", [150, 192])
def test_block_invert_matches_jax(n):
    from rac2d_tpu.ops import blocklu as jblocklu
    rng = np.random.default_rng(9)
    A = np.stack([_well_conditioned(n, rng) for _ in range(3)])
    Ainv = blocklu.block_invert(blocklu.block_lu(torch.as_tensor(A))).numpy()
    assert Ainv.shape == (3, 192, 192)
    for i in range(3):
        assert np.abs(A[i] @ Ainv[i, :n, :n] - np.eye(n)).max() < 1e-9
        # the padding acts as the identity
        np.testing.assert_array_equal(Ainv[i, n:, n:], np.eye(192 - n))
    jinv = np.asarray(jax.vmap(
        lambda a: jblocklu.block_invert(jblocklu.block_lu(a)))(
            jnp.asarray(A)))
    np.testing.assert_allclose(Ainv, jinv, rtol=0, atol=1e-12)


def test_block_invert_reads_only_the_triangles_it_needs():
    """NaN in linv's unit diagonal and upper triangle and in uinv's strict
    lower triangle (entries block substitution never reads) leave the
    inverse unchanged; its apply agrees with block substitution."""
    rng = np.random.default_rng(4)
    n = 130
    A = torch.as_tensor(np.stack([_well_conditioned(n, rng)
                                  for _ in range(2)]), dtype=torch.float32)
    fac = blocklu.block_lu(A)
    want = blocklu.block_invert(fac)
    ones = torch.ones(blocklu.BK, blocklu.BK, dtype=torch.bool)
    linv, uinv = fac.linv.clone(), fac.uinv.clone()
    linv[:, :, torch.triu(ones)] = float("nan")
    uinv[:, :, torch.tril(ones, -1)] = float("nan")
    got = blocklu.block_invert(fac._replace(linv=linv, uinv=uinv))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    b = torch.as_tensor(rng.standard_normal((2, n)), dtype=torch.float32)
    torch.testing.assert_close(blocklu.inverse_apply(want, b),
                               blocklu.block_lu_solve(fac, b),
                               rtol=1e-5, atol=1e-5)


def _newton_case():
    rng = np.random.default_rng(10)
    B, n = 4, 70
    J = rng.standard_normal((B, n, n))
    c = np.full(B, 0.02)
    scale = 1.0 + rng.uniform(0, 1, (B, n))
    b = rng.standard_normal((B, n))
    return J, c, scale, b


def test_bsolve_backends_match_block_and_jax():
    from rac2d_tpu.ops import bdf as jbdf
    J, c, scale, b = _newton_case()
    n = J.shape[-1]
    tt = torch.as_tensor
    ref = np.stack([np.linalg.solve(np.eye(n) - ci * Ji, bi)
                    for Ji, ci, bi in zip(J, c, b)])
    xs = {}
    for backend in ("block", "inv", "xla", "kernel"):
        fac = bdf._bfac(tt(J), tt(c), tt(scale), backend)
        xs[backend] = bdf._bsolve(tt(J), tt(c), fac, tt(b), 2,
                                  backend).numpy()
        err = np.abs(xs[backend] - ref).max()
        assert err < 1e-8 * np.abs(ref).max() + 1e-10, (backend, err)
    bar = 1e-8 * np.abs(xs["block"]).max() + 1e-10
    for backend in ("inv", "xla"):
        assert np.abs(xs[backend] - xs["block"]).max() < bar, backend
    # the kernel backend on a CPU tensor is the plain blocked LU
    np.testing.assert_array_equal(xs["kernel"], xs["block"])
    old = jbdf.BATCH_LU_BACKEND
    try:
        jbdf.BATCH_LU_BACKEND = "inv"
        jfac = jbdf._bfac(jnp.asarray(J), jnp.asarray(c), jnp.asarray(scale))
        xj = np.asarray(jbdf._bsolve(jnp.asarray(J), jnp.asarray(c), jfac,
                                     jnp.asarray(b), 2))
    finally:
        jbdf.BATCH_LU_BACKEND = old
    assert np.abs(xs["inv"] - xj).max() < bar


@pytest.mark.parametrize("env,want", [
    (None, "kernel"), ("auto", "kernel"), ("pallas", "kernel"),
    ("kernel", "kernel"), ("block", "block"), ("inv", "inv"),
    ("xla", "xla")])
def test_lu_backend_from_the_environment(monkeypatch, env, want):
    if env is None:
        monkeypatch.delenv("RAC2D_LU_BACKEND", raising=False)
    else:
        monkeypatch.setenv("RAC2D_LU_BACKEND", env)
    assert bdf.lu_backend_of() == want
    assert bdf.lu_backend_of(None) == want
    # an explicit argument wins over the environment
    assert bdf.lu_backend_of("block") == "block"


def test_unknown_lu_backend_raises(monkeypatch):
    J, c, scale, b = _newton_case()
    tt = torch.as_tensor
    with pytest.raises(ValueError, match="unknown lu_backend"):
        bdf._bfac(tt(J), tt(c), tt(scale), "cholesky")
    monkeypatch.setenv("RAC2D_LU_BACKEND", "tpu")
    with pytest.raises(ValueError, match="unknown lu_backend"):
        bdf.lu_backend_of()
    with pytest.raises(ValueError, match="unknown lu_backend"):
        bdf._make_round_body(None, None, None, 1)


def test_inv_refuses_tf32_on_cuda(monkeypatch):
    """On a CUDA tensor the inverse and its apply refuse to run while
    TF32 is allowed (checked before any work, so a meta tensor stands in
    for the card's)."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    fake = torch.empty(1, 64, 64, device="meta")
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda s: True))
    with pytest.raises(RuntimeError, match="TF32"):
        blocklu.block_invert(blocklu.BlockLU(fake, fake[:, None],
                                             fake[:, None]))
    with pytest.raises(RuntimeError, match="TF32"):
        blocklu.inverse_apply(fake, torch.empty(1, 64, device="meta"))


def test_pool_sweep_on_inv_matches_block():
    from rac2d_tpu import defaults
    from rac2d_tpu.io import umist
    from rac2d_tpu.ops import thermal

    from rac2d_torch import convert
    from rac2d_torch.ops import odesys as t_odesys
    from test_chem_production import COUPLED_CELLS
    from test_parity_oracle import _env_pairs
    from test_torch_chem import D2G, _tenv_of

    cells = COUPLED_CELLS[:2]
    net = umist.load_network(defaults.NETWORK,
                             enthalpy_path=defaults.ENTHALPIES)
    y0 = umist.load_initial_abundances(net, defaults.INIT_ABUNDANCES)
    tb = thermal.ThermalBalance(net)
    envs = jax.tree.map(lambda *a: jnp.stack(a),
                        *[_env_pairs(p)[1] for p in cells])
    tenvs = jax.tree.map(lambda *a: jnp.stack(a),
                         *[_tenv_of(thermal.ThermalEnv, p) for p in cells])
    tnet = convert.chem_net(net)
    ode = t_odesys.ChemicalODE(tnet, thermal=convert.thermal_balance(tb,
                                                                     "cpu"),
                               device="cpu")
    rtol, atol = t_odesys.tolerance_ladder(tnet, 1, 1e-4, 1e-30, D2G, "cpu")
    T0 = torch.as_tensor([p["T"] for p in cells])
    y0b = torch.as_tensor(np.tile(y0, (len(cells), 1)))
    touts = bdf.log_output_times(1e-8, 1e-3, 2.0)
    res = {}
    for backend in ("block", "inv"):
        res[backend] = ode.solve_pool(
            convert.cell_env(envs, "cpu"), y0b, T0, touts, rtol, atol,
            width=2, first_step=1e-8, evolT=True,
            tenvs=convert.thermal_env(tenvs, "cpu"),
            max_steps_per_interval=500,
            retry_tols=ode.retry_ladder(3, 1e-4, 1e-30, D2G),
            lu_backend=backend)
    a, b = res["inv"], res["block"]
    np.testing.assert_array_equal(a.fail.numpy(), b.fail.numpy())
    assert not bool(a.fail.any())
    ya, yb = a.ys[:, -1].numpy(), b.ys[:, -1].numpy()
    assert np.isfinite(ya).all()
    nS = net.n_species
    ki = net.key_species_idx
    for i in range(len(cells)):
        big = np.abs(yb[i, ki]) > 1e-12
        rel = np.abs(ya[i, ki] - yb[i, ki])[big] / np.abs(yb[i, ki])[big]
        assert rel.max() < 0.05, (i, rel.max())
        assert abs(ya[i, nS] - yb[i, nS]) < 0.02 * yb[i, nS], i
