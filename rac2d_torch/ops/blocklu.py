"""Blocked no-pivot LU factorization + solves, plain PyTorch, batched.

Counterpart of the JAX package's ``ops/blocklu.py``: the classic
right-looking blocked LU *without pivoting*, in BK=64 panels, with the
explicit inverses of the diagonal blocks so that forward/backward
substitution is block matrix-vector products with no triangular solves.
This module is the plain version of both hand-written CUDA kernels
(``csrc/blocklu.cu``, wrapped by ``ops/kernels.py``); the CPU tests run it
and ``chip_smoke.py`` compares the kernels with it on the card.

Correctness contract (as in the JAX package):
  - inputs are row/column-equilibrated matrices of the form I - c J (the
    Newton matrices of the solvers here), for which no-pivot LU with a
    tiny pivot floor is stable enough in f32;
  - tiny pivots are floored to +-PIV_FLOOR (a small perturbation of A is
    factored instead) and the surrounding Newton / iterative-refinement
    loops absorb the difference.

Every function takes a leading batch axis: A[B, n, n], b[B, n].  Any
float dtype; f32 products run in full f32 (TF32 is off, see the package
``__init__``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

BK = 64          # panel size
PIV_FLOOR = 1e-20


class BlockLU(NamedTuple):
    lu: torch.Tensor       # [B, N, N] packed L\U (unit lower diag implied)
    linv: torch.Tensor     # [B, K, BK, BK] inverses of unit-lower diag blocks
    uinv: torch.Tensor     # [B, K, BK, BK] inverses of upper diag blocks


def padded_size(n: int) -> int:
    """N = BK * ceil(n / BK)."""
    return -(-n // BK) * BK


def _pad(A, N):
    """Zero-pad [..., n, n] to [..., N, N] with identity on the padding so
    the factorization stays nonsingular."""
    n = A.shape[-1]
    if n == N:
        return A
    P = A.new_zeros(A.shape[:-2] + (N, N))
    P[..., :n, :n] = A
    idx = torch.arange(n, N, device=A.device)
    P[..., idx, idx] = 1.0
    return P


def _floor_pivot(p):
    """|p| < PIV_FLOOR -> +-PIV_FLOOR with p's sign (0 -> +PIV_FLOOR)."""
    fl = torch.full_like(p, PIV_FLOOR)
    return torch.where(torch.abs(p) < PIV_FLOOR, torch.where(p < 0, -fl, fl),
                       p)


def _factor_block(D):
    """Unblocked no-pivot LU of [B, BK, BK] diagonal blocks (rank-1
    updates of the trailing part, multipliers stored below the
    diagonal, floored pivots on it)."""
    D = D.clone()
    for j in range(BK):
        piv = _floor_pivot(D[:, j, j])
        col = D[:, j + 1:, j] / piv[:, None]
        D[:, j + 1:, j + 1:] -= col[:, :, None] * D[:, j, None, j + 1:]
        D[:, j + 1:, j] = col
        D[:, j, j] = piv
    return D


def _unit_lower_inv(L):
    """Inverses of the unit-lower-triangular parts of [B, BK, BK]."""
    Y = torch.eye(BK, dtype=L.dtype, device=L.device).expand(
        L.shape[0], BK, BK).clone()
    for j in range(BK):
        Y[:, j + 1:, :] -= L[:, j + 1:, j, None] * Y[:, j, None, :]
    return Y


def _upper_inv(U):
    """Inverses of the upper-triangular parts of [B, BK, BK]."""
    d = torch.diagonal(U, dim1=-2, dim2=-1)
    d = torch.where(torch.abs(d) < PIV_FLOOR, PIV_FLOOR, d)
    Y = torch.diag_embed(1.0 / d)
    for jj in range(BK):
        j = BK - 1 - jj
        # X[i, :] -= U[i, j] / d_i * X[j, :] for rows i < j
        col = U[:, :j, j] / d[:, :j]
        Y[:, :j, :] -= col[:, :, None] * Y[:, j, None, :]
    return Y


def block_lu(A) -> BlockLU:
    """Factor a batch of matrices.  A: [B, n, n] -> BlockLU over the
    padded size N = BK * ceil(n / BK)."""
    n = A.shape[-1]
    N = padded_size(n)
    K = N // BK
    lu = _pad(A, N).clone()
    linvs, uinvs = [], []
    for k in range(K):
        kb = k * BK
        D = _factor_block(lu[:, kb:kb + BK, kb:kb + BK])
        lu[:, kb:kb + BK, kb:kb + BK] = D
        Li = _unit_lower_inv(D)
        Ui = _upper_inv(D)
        linvs.append(Li)
        uinvs.append(Ui)
        if kb + BK < N:
            # row panel: U_k* = Linv @ A_k*
            rowp = torch.matmul(Li, lu[:, kb:kb + BK, kb + BK:])
            lu[:, kb:kb + BK, kb + BK:] = rowp
            # column panel: L_*k = A_*k @ Uinv
            colp = torch.matmul(lu[:, kb + BK:, kb:kb + BK], Ui)
            lu[:, kb + BK:, kb:kb + BK] = colp
            # trailing update
            lu[:, kb + BK:, kb + BK:] -= torch.matmul(colp, rowp)
    return BlockLU(lu=lu, linv=torch.stack(linvs, 1),
                   uinv=torch.stack(uinvs, 1))


# (lane, j, diagonal value) of the zeroed rows/columns of
# floored_pivot_matrices
FLOOR_CASES = [(0, 0, -1e-25), (0, 64, 0.0), (0, 129, 3e-21),
               (1, 63, -3e-21), (1, 100, -0.0), (2, 64, 1e-30)]


def floored_pivot_matrices(device, seed=5, n=130):
    """The pivot-floor check case of the kernel tests and chip_smoke.py:
    three f32 2 I + N(0, 1/n) matrices in which the rows and columns of
    FLOOR_CASES are zero but for a diagonal entry below PIV_FLOOR, which
    no elimination step then changes, so the factor must hold it floored
    to +-PIV_FLOOR with its sign (0 and -0 to +PIV_FLOOR).  Returns A and
    {(lane, j): the floored pivot}."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((3, n, n)) / np.sqrt(n) + 2.0 * np.eye(n)
    want = {}
    for lane, j, v in FLOOR_CASES:
        A[lane, j, :] = 0.0
        A[lane, :, j] = 0.0
        A[lane, j, j] = v
        want[(lane, j)] = -PIV_FLOOR if v < 0 else PIV_FLOOR
    return torch.as_tensor(A, dtype=torch.float32, device=device), want


def poison_unneeded(fac: BlockLU, n: int) -> BlockLU:
    """A copy of a factorization of [B, n, n] with NaN in every entry that
    block substitution does not need: the padded rows and columns of lu
    and its diagonal blocks (the inverses stand in for them), the unit
    diagonal and upper triangle of linv, the lower triangle of uinv, and
    the padding of the last diagonal block's inverses.  The kernel K2
    must give the same x from it as from fac (chip_smoke.py phase 3,
    tests/test_torch_kernels.py)."""
    lu, linv, uinv = (t.clone() for t in fac)
    N = lu.shape[-1]
    K = N // BK
    lu[:, n:, :] = float("nan")
    lu[:, :, n:] = float("nan")
    for k in range(K):
        lu[:, k * BK:(k + 1) * BK, k * BK:(k + 1) * BK] = float("nan")
    ones = torch.ones(BK, BK, dtype=torch.bool, device=lu.device)
    linv[:, :, torch.triu(ones)] = float("nan")
    uinv[:, :, torch.tril(ones, -1)] = float("nan")
    s = n - (K - 1) * BK
    for t in (linv, uinv):
        t[:, K - 1, s:, :] = float("nan")
        t[:, K - 1, :, s:] = float("nan")
    return BlockLU(lu=lu, linv=linv, uinv=uinv)


def _mv(M, v):
    return torch.matmul(M, v[..., None])[..., 0]


def block_lu_solve(fac: BlockLU, b):
    """Solve A x = b given the blocked factorization.  b: [B, n] keeps its
    length n; the padded tail is zero."""
    N = fac.lu.shape[-1]
    K = N // BK
    n = b.shape[-1]
    y = b.new_zeros(b.shape[:-1] + (N,), dtype=fac.lu.dtype)
    y[..., :n] = b
    lu = fac.lu
    # forward: L y = b  (unit lower; diag-block inverses precomputed)
    for k in range(K):
        kb = k * BK
        yk = _mv(fac.linv[:, k], y[:, kb:kb + BK])
        y[:, kb:kb + BK] = yk
        if kb + BK < N:
            y[:, kb + BK:] -= _mv(lu[:, kb + BK:, kb:kb + BK], yk)
    # backward: U x = y
    for k in range(K - 1, -1, -1):
        kb = k * BK
        xk = _mv(fac.uinv[:, k], y[:, kb:kb + BK])
        y[:, kb:kb + BK] = xk
        if kb > 0:
            y[:, :kb] -= _mv(lu[:, :kb, kb:kb + BK], xk)
    return y[:, :n]


def _no_tf32(t, what):
    """Refuse a CUDA f32 matmul while TF32 is allowed: the explicit
    inverse must keep full f32 products (the JAX package pins
    Precision.HIGHEST for it)."""
    if t.is_cuda and t.dtype == torch.float32 and (
            torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(f"{what}: TF32 is allowed for CUDA matmuls; "
                           "the package switches it off at import "
                           "(rac2d_torch/__init__.py), turn it off again")


def block_invert(fac: BlockLU):
    """Explicit inverses [B, N, N] from a blocked factorization (the
    plain one or kernel K1's), as the JAX package's ``block_invert``: inv(L)
    and inv(U) by block substitution against the identity, K panel steps
    of batched matmuls each, then inv(U) @ inv(L).  Reads only the
    entries block substitution needs (the strict lower triangle of linv,
    the upper triangle of uinv, the off-diagonal blocks of lu).  The
    top-left n x n block inverts A; a solve is then one batched matvec."""
    lu = fac.lu
    _no_tf32(lu, "block_invert")
    B, N, _ = lu.shape
    K = N // BK
    ones = torch.ones(BK, BK, dtype=torch.bool, device=lu.device)
    eye_k = torch.eye(BK, dtype=lu.dtype, device=lu.device)
    linv = torch.where(torch.tril(ones, -1), fac.linv, 0.0) + eye_k
    uinv = torch.where(torch.triu(ones), fac.uinv, 0.0)
    eye = torch.eye(N, dtype=lu.dtype, device=lu.device).expand(B, N, N)
    # inv(L): forward block substitution L X = I
    Xl = lu.new_zeros(B, N, N)
    R = eye.clone()
    for k in range(K):
        kb = k * BK
        Xk = torch.matmul(linv[:, k], R[:, kb:kb + BK, :])
        Xl[:, kb:kb + BK, :] = Xk
        if kb + BK < N:
            R[:, kb + BK:, :] -= torch.matmul(lu[:, kb + BK:, kb:kb + BK], Xk)
    # inv(U): backward block substitution U X = I
    Xu = lu.new_zeros(B, N, N)
    R = eye.clone()
    for k in range(K - 1, -1, -1):
        kb = k * BK
        Xk = torch.matmul(uinv[:, k], R[:, kb:kb + BK, :])
        Xu[:, kb:kb + BK, :] = Xk
        if kb > 0:
            R[:, :kb, :] -= torch.matmul(lu[:, :kb, kb:kb + BK], Xk)
    return torch.matmul(Xu, Xl)


def inverse_apply(Ainv, b):
    """x = A^-1 b for b [B, n] from block_invert's Ainv [B, N, N]: one
    batched matvec over the whole (contiguous) inverse in its dtype, with
    b's padded tail zero."""
    _no_tf32(Ainv, "inverse_apply")
    n = b.shape[-1]
    bp = b.new_zeros(b.shape[:-1] + (Ainv.shape[-1],), dtype=Ainv.dtype)
    bp[..., :n] = b
    return torch.matmul(Ainv, bp[..., None])[..., :n, 0]
