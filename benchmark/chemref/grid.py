"""The disk's cells, worked out again from the configuration: the
Andrews et al. (2009) density and the reference's columnwise adaptive
grid (src/grid.f90: get_column_locations :621, grid_init_columnwise_new
:477, the uniformity tests :1245-1330), in the leaf order the program
numbers its cells.

Part of the benchmark's plain reference: the grid is deterministic, so
the reference builds it itself rather than take the program's; this is a
frozen copy of the construction the port shares with the JAX package
(rac2d_torch/models/grid.py make_grid, models/density.py), the
leaves' bounds, density and active flag only.
"""

import math

import numpy as np

from . import constants as c

GRID_DEFAULTS = dict(
    zmin=0.0, max_ratio_to_be_uniform=2.0, density_log_range=5.0,
    density_scale=14.0, min_val_considered=50.0, smallest_cell_size=1e-2,
    largest_cell_size=1e3, largest_cell_size_frac=1.0,
    small_len_frac=1e-2)


def andrews_density(cfg, r, z):
    """Number density [cm^-3] at (r, z) in AU of the configuration's
    Andrews disk (gamma = psi = 1, no tapers or bumps)."""
    rin, rout = cfg["andrews_rin"], cfg["andrews_rout"]
    rc, hc, Md = cfg["andrews_rc"], cfg["andrews_hc"], cfg["andrews_Md"]
    r = np.asarray(r, dtype=float)
    z = np.asarray(z, dtype=float)
    t3 = math.exp(-(rin / rc))
    t4 = math.exp(-(rout / rc))
    sigma_c = Md / (c.two_pi * rc ** 2) / (t3 - t4)
    rrc = np.maximum(r / rc, 1e-300)
    t1 = np.exp(-np.log(rrc))
    sigma = sigma_c * t1 * np.exp(-(rrc * rrc * t1))
    h = hc * np.exp(np.log(rrc))
    zh2 = 0.5 * (z / h) ** 2
    dens = sigma / (c.sqrt_2pi * h) * np.exp(-np.minimum(zh2, c.max_exp)) \
        * c.Msun_CGS / (c.AU2cm ** 3) / (1.4 * c.mProton_CGS)
    ok = (r >= rin) & (r <= rout) & (zh2 < c.max_exp)
    return np.where(ok, dens, 0.0)


def _log_ratio(y0, y1, dy0, n):
    total = y1 - y0
    if dy0 * n >= total:
        return 1.0
    lo, hi = 1.0 + 1e-12, 10.0
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if dy0 * (mid ** n - 1.0) / (mid - 1.0) > total:
            hi = mid
        else:
            lo = mid
    return 0.5 * (lo + hi)


def _surface(x, y0, y1, dens, min_val, frac=1e-4, n=100):
    dy = (y1 - y0) * frac
    q = _log_ratio(y0, y1, dy, n)
    dy = dy * q ** (n - 1)
    y = y1
    for _ in range(n):
        if dens(x, y) >= min_val:
            return y
        y -= dy
        dy /= q
    return 0.0


def _uniform(g, dens, xmin, xmax, ymin, ymax):
    dy = ymax - ymin
    rmid = 0.25 * (xmax + xmin + ymax + ymin)
    if dy > g["largest_cell_size"] \
            or dy > g["largest_cell_size_frac"] * rmid:
        return False
    d = np.hypot(0.5 * (xmax + xmin), 0.5 * (ymax + ymin))
    if dy < g["smallest_cell_size"] or dy < g["small_len_frac"] * d:
        return True
    xm = 0.5 * (xmin + xmax)
    vals = np.array([dens(xm, ymin), dens(xm, 0.5 * (ymin + ymax)),
                     dens(xm, ymax)])
    maxv = max(vals.max(), 1e-100)
    thresh = g["max_ratio_to_be_uniform"] + (
        (np.log10(maxv) - g["density_scale"]) / g["density_log_range"]) ** 2
    if maxv <= g["min_val_considered"]:
        return True
    return maxv / (vals.min() + 1e-100) <= thresh


def make_grid(cfg):
    """{rmin, rmax, zmin, zmax, n0, using} of the configuration's grid."""
    g = dict(GRID_DEFAULTS, rmin=cfg["grid_rmin"], rmax=cfg["grid_rmax"],
             zmax=cfg["grid_zmax"], ncol=cfg["grid_ncol"],
             max_num_of_cells=cfg["grid_max_num_of_cells"])

    def dens(r, z):
        return andrews_density(cfg, r, z)

    locs = np.logspace(np.log10(g["rmin"]), np.log10(g["rmax"]),
                       g["ncol"] + 1)
    small = g["smallest_cell_size"]
    leaves = []
    for i in range(g["ncol"]):
        x0, x1 = locs[i], locs[i + 1]
        xm = 0.5 * (x0 + x1)
        top = _surface(xm, g["zmin"], g["zmax"], dens,
                       g["min_val_considered"])
        if top - g["zmin"] <= small:
            top = _surface(xm, g["zmin"],
                           g["zmin"] + 5e-4 * (g["zmax"] - g["zmin"]),
                           dens, g["min_val_considered"])
        top = min(top, g["zmax"] / 1.5)
        if top - g["zmin"] < small:
            top = g["zmin"] + small * 4.0
        stack = [(x0, x1, g["zmin"], top)]
        while stack:
            xmin, xmax, ymin, ymax = stack.pop()
            if len(leaves) + len(stack) > g["max_num_of_cells"] * 4 \
                    or _uniform(g, dens, xmin, xmax, ymin, ymax):
                leaves.append((xmin, xmax, ymin, ymax))
                continue
            ymid = 0.5 * (ymin + ymax)
            small_len = max(abs(ymid) * g["small_len_frac"], small)
            if min(ymid - ymin, ymax - ymid) <= small_len:
                leaves.append((xmin, xmax, ymin, ymax))
                continue
            stack.append((xmin, xmax, ymid, ymax))
            stack.append((xmin, xmax, ymin, ymid))
        leaves.append((x0, x1, top, g["zmax"]))
    arr = np.array(leaves)

    def avg(xmin, xmax, ymin, ymax, n=4):
        X, Y = np.meshgrid(np.linspace(xmin, xmax, n + 2)[1:-1],
                           np.linspace(ymin, ymax, n + 2)[1:-1])
        return float(np.mean(dens(X, Y)))

    n0 = np.array([avg(*l) for l in leaves])
    return dict(rmin=arr[:, 0], rmax=arr[:, 1], zmin=arr[:, 2],
                zmax=arr[:, 3], n0=n0, using=n0 > g["min_val_considered"])
