"""Parity of the port's blocked no-pivot LU (rac2d_torch.ops.blocklu, the
plain version of CUDA kernels K1/K2) and of its Newton solve
(rac2d_torch.ops.bdf._bfac/_bsolve) with the JAX package.

Inputs come from numpy seeds and go through both packages on the CPU:
  - f64: the same algorithm in both, so 1e-12 (summation order of the
    panel products differs between XLA and the CPU BLAS);
  - f32: f32 roundoff, <= 1e-5 relative to max(|ref|, 1);
  - against the Pallas kernels in interpret mode, run as
    tests/test_blocklu.py:50-89 runs them (B=2, n=100): <= 1e-4 relative
    to max(|x|, 1);
  - the Newton solve with f64 refinement on a Jacobian of the coupled
    chemistry: 1e-8, the bar of tests/test_blocklu.py:107-132.
On a CUDA tensor the wrappers of rac2d_torch.ops.kernels launch the
kernels instead (tests/test_torch_kernels.py, on the card).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from rac2d_tpu.ops import blocklu as jblu
from rac2d_torch.ops import blocklu as tblu

from torch_mc_fixtures import one_torch_thread  # noqa: F401 (autouse)


def _well_conditioned(B, n, rng, dtype=np.float64):
    A = rng.standard_normal((B, n, n)).astype(dtype)
    A += n * np.eye(n, dtype=dtype)           # diagonally dominant
    return A


def _jax_factor(A):
    return jax.vmap(jblu.block_lu)(jnp.asarray(A))


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() \
        / max(np.abs(np.asarray(b)).max(), 1.0)


@pytest.mark.parametrize("n", [64, 100, 150, 200])
def test_block_lu_f64_matches_jax(n):
    """n not a multiple of 64 exercises the identity padding."""
    rng = np.random.default_rng(n)
    A = _well_conditioned(3, n, rng)
    b = rng.standard_normal((3, n))
    ref = _jax_factor(A)
    fac = tblu.block_lu(torch.as_tensor(A))
    N = tblu.padded_size(n)
    assert fac.lu.shape == (3, N, N) and fac.linv.shape == (3, N // 64, 64, 64)
    for name in ("lu", "linv", "uinv"):
        assert _rel(getattr(fac, name), getattr(ref, name)) < 1e-12, name
    # the padding factors as the identity
    assert np.array_equal(fac.lu[:, n:, n:].numpy(), np.eye(N - n)[None]
                          .repeat(3, 0))
    x = tblu.block_lu_solve(fac, torch.as_tensor(b)).numpy()
    xr = np.asarray(jax.vmap(jblu.block_lu_solve)(ref, jnp.asarray(b)))
    assert _rel(x, xr) < 1e-12
    assert np.abs(np.einsum("bij,bj->bi", A, x) - b).max() < 1e-10


@pytest.mark.parametrize("n", [1, 65, 130, 485])
def test_factor_holds_exact_zeros_the_solve_kernel_skips(n):
    """Both packages' f32 factor hold what lets K2 skip entries: linv
    exactly unit lower triangular, uinv exactly upper triangular, and lu
    exactly the identity on its padded rows and columns."""
    rng = np.random.default_rng(n)
    A = (rng.standard_normal((2, n, n)) / np.sqrt(n)
         + 2.0 * np.eye(n)).astype(np.float32)
    N = tblu.padded_size(n)
    upper = np.triu(np.ones((64, 64), dtype=bool), 1)
    for fac in (tblu.block_lu(torch.as_tensor(A)), _jax_factor(A)):
        lu, linv, uinv = (np.asarray(t) for t in fac)
        assert lu.dtype == np.float32
        assert (linv[..., upper] == 0).all()
        assert (np.diagonal(linv, axis1=-2, axis2=-1) == 1).all()
        assert (uinv[..., upper.T] == 0).all()
        eye = np.eye(N, dtype=np.float32)
        assert (lu[:, n:, :] == eye[n:]).all()
        assert (lu[:, :, n:] == eye[:, n:]).all()


def test_block_lu_f32_matches_jax():
    rng = np.random.default_rng(1)
    A = _well_conditioned(2, 128, rng, np.float32)
    b = rng.standard_normal((2, 128)).astype(np.float32)
    ref = _jax_factor(A)
    fac = tblu.block_lu(torch.as_tensor(A))
    assert fac.lu.dtype == torch.float32
    for name in ("lu", "linv", "uinv"):
        assert _rel(getattr(fac, name), getattr(ref, name)) <= 1e-5, name
    x = tblu.block_lu_solve(fac, torch.as_tensor(b)).numpy()
    xr = np.asarray(jax.vmap(jblu.block_lu_solve)(ref, jnp.asarray(b)))
    assert _rel(x, xr) <= 1e-5


def test_block_lu_matches_pallas_interpret():
    """Torch plain LU/solve vs the Pallas kernels K1/K2 in interpret mode
    (B=2, n=100)."""
    from rac2d_tpu.ops.pallas.blocklu_pallas import (
        block_lu_batched_pallas, block_lu_solve_batched_pallas)
    rng = np.random.default_rng(7)
    A = _well_conditioned(2, 100, rng, np.float32)
    b = rng.standard_normal((2, 100)).astype(np.float32)
    pfac = block_lu_batched_pallas(jnp.asarray(A), interpret=True)
    px = np.asarray(block_lu_solve_batched_pallas(pfac, jnp.asarray(b),
                                                  interpret=True))
    fac = tblu.block_lu(torch.as_tensor(A))
    for name in ("lu", "linv", "uinv"):
        assert _rel(getattr(fac, name), getattr(pfac, name)) <= 1e-4, name
    x = tblu.block_lu_solve(fac, torch.as_tensor(b)).numpy()
    assert _rel(x, px) <= 1e-4


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_pivot_floor_matches_jax(dtype):
    """Zero and tiny pivots are floored to +-1e-20 with the pivot's sign,
    exactly as the JAX version does."""
    A = np.eye(70, dtype=dtype)[None].repeat(2, 0)
    A[0, 0, 0] = 0.0
    A[0, 0, 1] = A[0, 1, 0] = 1.0
    A[1, 3, 3] = -1e-30
    A[1, 5, 5] = 1e-25
    ref = _jax_factor(A)
    fac = tblu.block_lu(torch.as_tensor(A))
    assert fac.lu[0, 0, 0] == dtype(1e-20)
    assert fac.lu[1, 3, 3] == -dtype(1e-20)
    assert fac.lu[1, 5, 5] == dtype(1e-20)
    for name in ("lu", "linv", "uinv"):
        a = getattr(fac, name).numpy()
        r = np.asarray(getattr(ref, name))
        assert np.array_equal(np.isfinite(a), np.isfinite(r)), name
        fin = np.isfinite(r)
        assert np.allclose(a[fin], r[fin], rtol=1e-6, atol=0), name
    x = tblu.block_lu_solve(fac, torch.ones(2, 70, dtype=fac.lu.dtype))
    assert torch.isfinite(x).all()


def _slice_jacobian():
    """A Jacobian of the coupled chemistry (shipped network, 485 x 485):
    the dark-cloud production cell at its initial state."""
    from rac2d_tpu import defaults
    from rac2d_tpu.io import umist
    from rac2d_tpu.ops import odesys, thermal
    from test_chem_production import COUPLED_CELLS
    from test_parity_oracle import _env_pairs
    from test_torch_chem import D2G, _tenv_of
    net = umist.load_network(defaults.NETWORK,
                             enthalpy_path=defaults.ENTHALPIES)
    y0 = umist.load_initial_abundances(net, defaults.INIT_ABUNDANCES)
    ode = odesys.ChemicalODE(net, thermal=thermal.ThermalBalance(net))
    p = COUPLED_CELLS[0]
    env = _env_pairs(p)[1]
    tenv = _tenv_of(thermal.ThermalEnv, p)
    y = jnp.concatenate([jnp.asarray(y0), jnp.asarray([p["T"]])])
    J = np.asarray(jax.jit(ode.make_jac(env, True, tenv))(y))
    rtol, atol = odesys.tolerance_ladder(net, 1, 1e-4, 1e-30, D2G)
    scale = np.asarray(atol) + np.asarray(rtol) * np.abs(np.asarray(y))
    return J, scale


def test_newton_solve_matches_jax():
    """_bfac + _bsolve (block backend, f64 refinement) vs the JAX package's
    on a production Jacobian, at the c = h/alpha of early steps."""
    from rac2d_tpu.ops import bdf as jbdf
    from rac2d_torch.ops import bdf as tbdf
    assert jbdf._backend() == "block" and jbdf._refine_mode() == "f64"
    J1, scale1 = _slice_jacobian()
    B = 3
    J = np.stack([J1] * B)
    c = np.array([1e-8, 1e-6, 1e-4])
    scale = np.stack([scale1] * B)
    rng = np.random.default_rng(5)
    b = rng.standard_normal((B, J1.shape[0])) * scale
    fj = jbdf._bfac(jnp.asarray(J), jnp.asarray(c), jnp.asarray(scale))
    xj = np.asarray(jbdf._bsolve(jnp.asarray(J), jnp.asarray(c), fj,
                                 jnp.asarray(b), 2))
    tt = torch.as_tensor
    for backend in ("block", "kernel"):     # "kernel" on CPU: plain version
        ft = tbdf._bfac(tt(J), tt(c), tt(scale), backend)
        xt = tbdf._bsolve(tt(J), tt(c), ft, tt(b), 2, backend).numpy()
        ref = np.stack([np.linalg.solve(np.eye(len(scale1)) - c[i] * J[i],
                                        b[i]) for i in range(B)])
        for i in range(B):
            s = np.abs(ref[i]).max()
            assert np.abs(xt[i] - xj[i]).max() < 1e-8 * s, (backend, i)
            assert np.abs(xt[i] - ref[i]).max() < 1e-8 * s, (backend, i)
