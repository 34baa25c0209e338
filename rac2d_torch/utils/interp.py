"""Table interpolation on tensors.

Counterpart of the JAX package's ``utils/interp.py`` (reference
src/interpolation.f90): tables are built on the host with numpy/scipy and
evaluated here with linear/bilinear/trilinear lookups that clamp at the
table edges.
"""

import torch


def interp1(x, xp, fp):
    """Piecewise-linear interpolation with edge clamping (``jnp.interp``
    semantics: below xp[0] -> fp[0], above xp[-1] -> fp[-1])."""
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, n - 1)
    dx = xp[i] - xp[i - 1]
    df = fp[i] - fp[i - 1]
    delta = x - xp[i - 1]
    f = torch.where(dx == 0, fp[i], fp[i - 1] + (delta / dx) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def loglog_interp1(x, xp, fp, floor=1e-300):
    """Linear interpolation in log-log space (positive tables)."""
    lx = torch.log(torch.clamp_min(x, floor))
    lxp = torch.log(torch.clamp_min(xp, floor))
    lfp = torch.log(torch.clamp_min(fp, floor))
    return torch.exp(interp1(lx, lxp, lfp))


def _locate(x, grid):
    """Index i such that grid[i] <= x < grid[i+1], clamped to valid cells."""
    i = torch.searchsorted(grid, x, right=True) - 1
    return torch.clamp(i, 0, grid.shape[0] - 2)


def bilinear(x, y, xgrid, ygrid, table):
    """Bilinear interpolation of table[len(xgrid), len(ygrid)] at (x, y),
    clamped outside the grid (no extrapolation)."""
    i = _locate(x, xgrid)
    j = _locate(y, ygrid)
    x0, x1 = xgrid[i], xgrid[i + 1]
    y0, y1 = ygrid[j], ygrid[j + 1]
    tx = torch.clamp((x - x0) / (x1 - x0), 0.0, 1.0)
    ty = torch.clamp((y - y0) / (y1 - y0), 0.0, 1.0)
    f00 = table[i, j]
    f10 = table[i + 1, j]
    f01 = table[i, j + 1]
    f11 = table[i + 1, j + 1]
    return ((1 - tx) * (1 - ty) * f00 + tx * (1 - ty) * f10
            + (1 - tx) * ty * f01 + tx * ty * f11)


def trilinear(x, y, z, xg, yg, zg, table):
    """Trilinear interpolation of table[nx, ny, nz] with edge clamping."""
    i = _locate(x, xg)
    j = _locate(y, yg)
    k = _locate(z, zg)
    tx = torch.clamp((x - xg[i]) / (xg[i + 1] - xg[i]), 0.0, 1.0)
    ty = torch.clamp((y - yg[j]) / (yg[j + 1] - yg[j]), 0.0, 1.0)
    tz = torch.clamp((z - zg[k]) / (zg[k + 1] - zg[k]), 0.0, 1.0)
    out = 0.0
    for di, wx in ((0, 1 - tx), (1, tx)):
        for dj, wy in ((0, 1 - ty), (1, ty)):
            for dk, wz in ((0, 1 - tz), (1, tz)):
                out = out + wx * wy * wz * table[i + di, j + dj, k + dk]
    return out


def logspace(a, b, n, device="cpu"):
    """log10-spaced float64 grid from 10^a to 10^b inclusive."""
    return torch.logspace(a, b, n, dtype=torch.float64, device=device)
