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
