"""The CUDA kernel wrappers (rac2d_torch.ops.kernels).

On the CPU: the wrappers run their plain versions, launch nothing, and
refuse devices that have neither.  Tests marked `cuda` need the card and
skip without one; this file imports neither JAX nor the JAX package, so
on the card run it without the repository's conftest (which imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

Tolerances on the card: f32 roundoff of a 512-wide factorization whose
kernel sums in another order (FMA, shuffles) than the plain version,
<= 1e-4 relative to max(|ref|, 1) per lane; the f64-refined Newton solve
at 1e-8, the bar of tests/test_blocklu.py:107-132.
"""

import numpy as np
import pytest
import torch

from rac2d_torch.ops import bdf, blocklu, kernels


@pytest.fixture
def cuda_device():
    """The card, for tests marked `cuda`; decided when the test runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run `python -m pytest --noconftest "
                    "-m cuda tests/test_torch_kernels.py` on the card")
    return torch.device("cuda")


def _matrices(B, n, seed, device="cpu"):
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
    A, b = _matrices(2, 90, 3)
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
        ["blocklu.cu"]
    assert "arch=compute_90a,code=sm_90a" in kernels.NVCC_FLAGS


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 100, 485])
def test_kernels_match_plain_on_card(cuda_device, n):
    A, b = _matrices(8, n, n, cuda_device)
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
