"""Mixed-precision dense linear solves, batched.

Counterpart of the JAX package's ``ops/linalg.py``: classic mixed
precision for float64 systems,

    1. row- and column-equilibrate A in float64,
    2. factor the scaled matrix in float32 with partial pivoting
       (torch.linalg.lu_factor, the counterpart of
       jax.scipy.linalg.lu_factor),
    3. solve in float32, then refine twice in float64 against the exact
       residual r = b - A x of the stored float64 matrix.

With equilibration, the f32 factor and two refinements recover about f64
accuracy whenever the scaled condition number is well below 1/eps_f32;
the Newton iterations around it (statistical equilibrium) absorb the
rest.  Every function takes any leading batch dimensions: A [..., n, n],
b [..., n].
"""

from __future__ import annotations

from typing import NamedTuple

import torch

N_REFINE = 2


class MPFactor(NamedTuple):
    A: torch.Tensor          # f64 [..., n, n] original matrix
    row_scale: torch.Tensor  # f64 [..., n]
    col_scale: torch.Tensor  # f64 [..., n]
    lu: torch.Tensor         # f32 [..., n, n]
    piv: torch.Tensor        # int32 [..., n]


def mp_factor(A, col_scale=None) -> MPFactor:
    """Row+column-equilibrated f32 factorization of an f64 matrix.

    col_scale: natural magnitudes of the unknowns; scaling the columns by
    them makes the solved variables O(1)."""
    if col_scale is None:
        col_scale = torch.ones(A.shape[:-1], dtype=A.dtype, device=A.device)
    Ac = A * col_scale[..., None, :]
    amax = Ac.abs().amax(dim=-1)
    s = torch.where(amax > 0.0, 1.0 / amax, 1.0)
    As = (Ac * s[..., :, None]).to(torch.float32)
    lu, piv = torch.linalg.lu_factor(As)
    return MPFactor(A=A, row_scale=s, col_scale=col_scale, lu=lu, piv=piv)


def mp_solve(fac: MPFactor, b, n_refine: int = N_REFINE):
    """Solve A x = b (f64) using the mixed-precision factorization."""
    def f32_solve(r):
        rs = (r * fac.row_scale).to(torch.float32)[..., None]
        xp = torch.linalg.lu_solve(fac.lu, fac.piv, rs)[..., 0]
        return xp.to(torch.float64) * fac.col_scale

    x = f32_solve(b)
    for _ in range(n_refine):
        r = b - (fac.A @ x[..., None])[..., 0]
        x = x + f32_solve(r)
    return x


def mp_linsolve(A, b, col_scale=None, n_refine: int = N_REFINE):
    """One-shot mixed-precision solve."""
    return mp_solve(mp_factor(A, col_scale), b, n_refine)
