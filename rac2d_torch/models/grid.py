"""Column-based adaptive (r, z) grid, built host-side into SoA arrays.

Rebuild of the reference grid layer (reference: src/grid.f90 —
``make_grid`` :94, ``grid_init_columnwise_new`` :477,
``get_column_locations`` :621, ``grid_refine``/``sub_divide_columnwise``
:746,1191, uniformity tests :1245-1330, ``make_neighbors`` :785).

Inversion: the reference's pointer quadtree is replaced by a flat
structure of arrays over leaf cells.  The tree exists only transiently
during host-side construction; what ships to the device is
[n_cells]-shaped bounds, per-column index lists (top-to-bottom, for
column-density prefix scans), and CSR-style neighbor lists.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .density import AndrewsDisk


@dataclasses.dataclass
class GridConfig:
    """Reference grid_configure namelist (src/grid.f90:21-43)."""
    rmin: float = 0.5
    rmax: float = 200.0
    zmin: float = 0.0
    zmax: float = 200.0
    ncol: int = 120
    refine_at_r0_in_exp: bool = True
    max_ratio_to_be_uniform: float = 2.0
    density_log_range: float = 5.0
    density_scale: float = 14.0
    min_val_considered: float = 50.0
    very_small_len: float = 1e-4
    smallest_cell_size: float = 1e-2
    largest_cell_size: float = 1e3
    largest_cell_size_frac: float = 1.0
    small_len_frac: float = 1e-2
    max_num_of_cells: int = 10000


@dataclasses.dataclass
class Grid:
    """SoA leaf-cell grid (all numpy, host side)."""
    rmin: np.ndarray         # [n] AU
    rmax: np.ndarray
    zmin: np.ndarray
    zmax: np.ndarray
    using: np.ndarray        # [n] bool: participates in chemistry/RT
    n0: np.ndarray           # [n] initial number density (cm^-3)
    col_id: np.ndarray       # [n] radial column index
    # per-column cell lists, ordered top -> bottom (for N_col scans)
    col_ptr: np.ndarray      # [n_columns + 1]
    col_cells: np.ndarray    # [n] cell indices
    # CSR neighbor lists
    nb_above_ptr: np.ndarray
    nb_above: np.ndarray
    nb_below_ptr: np.ndarray
    nb_below: np.ndarray
    nb_inner_ptr: np.ndarray
    nb_inner: np.ndarray
    nb_outer_ptr: np.ndarray
    nb_outer: np.ndarray
    surf_cells: np.ndarray   # topmost using cell of each column
    bott_cells: np.ndarray

    @property
    def n_cells(self):
        return len(self.rmin)

    @property
    def n_columns(self):
        return len(self.col_ptr) - 1

    def centers(self):
        return 0.5 * (self.rmin + self.rmax), 0.5 * (self.zmin + self.zmax)

    def volumes_cm3(self):
        """Full annulus volume (both sides of midplane are mirrored; the
        reference models z>=0 with mirror symmetry and uses the z>0
        volume: V = pi (r2^2 - r1^2) (z2 - z1))."""
        from .. import constants as c
        return (np.pi * (self.rmax ** 2 - self.rmin ** 2)
                * (self.zmax - self.zmin) * c.AU2cm ** 3)


def column_locations(cfg: GridConfig, andrews: AndrewsDisk) -> np.ndarray:
    """Radial column edges; optionally refined around the inner taper
    radius (reference get_column_locations, src/grid.f90:621-663)."""
    r0 = andrews.r0_in_exp
    if (cfg.rmin >= r0 or cfg.rmax <= r0) or not cfg.refine_at_r0_in_exp:
        return np.logspace(np.log10(cfg.rmin), np.log10(cfg.rmax),
                           cfg.ncol + 1)
    tmp = np.sqrt(cfg.rmax * cfg.rmin / r0 ** 2)
    n1 = int(np.ceil(cfg.ncol * 0.8 / (0.8 + tmp)))
    n2 = int(np.ceil(cfg.ncol * tmp / (0.8 + tmp) * 0.2))
    n3 = cfg.ncol + 1 - n1 - n2
    if n1 * n2 * n3 == 0:
        raise ValueError("bad column split around r0_in_exp")
    delr = r0 * 8e-2
    delr1 = r0 * 1e-3
    a = np.logspace(np.log10(cfg.rmin), np.log10(r0 - delr1), n1)
    b = np.logspace(np.log10(r0 - delr1), np.log10(r0 + delr), n2 + 1)
    cc = np.logspace(np.log10(r0 + delr), np.log10(cfg.rmax), n3 + 1)
    return np.concatenate([a, b[1:], cc[1:]])


def _log_ratio(y0, y1, dy0, n):
    """Ratio q such that dy0 * (q^n - 1)/(q - 1) = y1 - y0 (bisection)."""
    total = y1 - y0
    if dy0 * n >= total:
        return 1.0
    lo, hi = 1.0 + 1e-12, 10.0
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        s = dy0 * (mid ** n - 1.0) / (mid - 1.0)
        if s > total:
            hi = mid
        else:
            lo = mid
    return 0.5 * (lo + hi)


def find_surface(x, y0, y1, dens_fn, min_val, frac=1e-4, n=100):
    """Highest y in [y0, y1] where density >= min_val, sampled on the
    reference's top-down log-spaced ladder (src/grid.f90:664-700)."""
    dy = (y1 - y0) * frac
    q = _log_ratio(y0, y1, dy, n)
    dy = dy * q ** (n - 1)
    y = y1
    for _ in range(n):
        if dens_fn(x, y) >= min_val:
            return y
        y -= dy
        dy /= q
    return 0.0


def _is_uniform(cfg, dens_fn, xmin, xmax, ymin, ymax):
    dy = ymax - ymin
    rmid = 0.25 * (xmax + xmin + ymax + ymin)
    if dy > cfg.largest_cell_size or dy > cfg.largest_cell_size_frac * rmid:
        return False
    d = np.hypot(0.5 * (xmax + xmin), 0.5 * (ymax + ymin))
    if dy < cfg.smallest_cell_size or dy < cfg.small_len_frac * d:
        return True
    xm = 0.5 * (xmin + xmax)
    vals = np.array([dens_fn(xm, ymin), dens_fn(xm, 0.5 * (ymin + ymax)),
                     dens_fn(xm, ymax)])
    maxv = max(vals.max(), 1e-100)
    minv = vals.min()
    thresh = cfg.max_ratio_to_be_uniform + (
        (np.log10(maxv) - cfg.density_scale) / cfg.density_log_range) ** 2
    if maxv <= cfg.min_val_considered:
        return True
    return maxv / (minv + 1e-100) <= thresh


def _avg_density(dens_fn, xmin, xmax, ymin, ymax, n=4):
    xs = np.linspace(xmin, xmax, n + 2)[1:-1]
    ys = np.linspace(ymin, ymax, n + 2)[1:-1]
    X, Y = np.meshgrid(xs, ys)
    return float(np.mean(dens_fn(X, Y)))


def make_grid(cfg: GridConfig, andrews: AndrewsDisk,
              dens_fn=None) -> Grid:
    """Build the columnwise adaptive grid as SoA arrays."""
    if dens_fn is None:
        dens_fn = lambda r, z: andrews.density(r, z)

    locs = column_locations(cfg, andrews)
    ncol = len(locs) - 1

    leaves = []      # (xmin, xmax, ymin, ymax, col)
    for i in range(ncol):
        x0, x1 = locs[i], locs[i + 1]
        xm = 0.5 * (x0 + x1)
        ymax_col = find_surface(xm, cfg.zmin, cfg.zmax, dens_fn,
                                cfg.min_val_considered)
        if ymax_col - cfg.zmin <= cfg.smallest_cell_size:
            ymax_col = find_surface(
                xm, cfg.zmin,
                cfg.zmin + 5e-4 * (cfg.zmax - cfg.zmin), dens_fn,
                cfg.min_val_considered)
        ymax_col = min(ymax_col, cfg.zmax / 1.5)
        if ymax_col - cfg.zmin < cfg.smallest_cell_size:
            ymax_col = cfg.zmin + cfg.smallest_cell_size * 4.0
        # bottom (disk) block subdivided; top (empty) block kept whole
        stack = [(x0, x1, cfg.zmin, ymax_col)]
        while stack:
            xmin, xmax, ymin, ymax = stack.pop()
            if len(leaves) + len(stack) > cfg.max_num_of_cells * 4:
                leaves.append((xmin, xmax, ymin, ymax, i))
                continue
            if _is_uniform(cfg, dens_fn, xmin, xmax, ymin, ymax):
                leaves.append((xmin, xmax, ymin, ymax, i))
                continue
            ymid = 0.5 * (ymin + ymax)
            d = np.hypot(0.0, ymid)
            small_len = max(np.hypot(0.0, ymid) * cfg.small_len_frac,
                            cfg.smallest_cell_size)
            if min(ymid - ymin, ymax - ymid) <= small_len:
                leaves.append((xmin, xmax, ymin, ymax, i))
                continue
            stack.append((xmin, xmax, ymid, ymax))
            stack.append((xmin, xmax, ymin, ymid))
        leaves.append((x0, x1, ymax_col, cfg.zmax, i))

    arr = np.array([l[:4] for l in leaves])
    col = np.array([l[4] for l in leaves], dtype=np.int64)
    n0 = np.array([_avg_density(dens_fn, *l[:4]) for l in leaves])
    using = n0 > cfg.min_val_considered
    return build_grid_from_leaves(arr, col, n0, using)


def build_grid_from_leaves(arr, col, n0, using) -> Grid:
    """Assemble the SoA Grid (columns, neighbors, surf/bott) from leaf
    bounds [n, 4], column ids, densities and the using mask.  Shared by
    the initial build and the AMR refine/merge rebuilds."""
    ncol = int(col.max()) + 1 if len(col) else 0

    # per-column lists, top -> bottom
    col_cells = []
    col_ptr = [0]
    for i in range(ncol):
        members = np.nonzero(col == i)[0]
        order = np.argsort(-arr[members, 2])  # by ymin descending
        col_cells.extend(members[order].tolist())
        col_ptr.append(len(col_cells))
    col_cells = np.array(col_cells, dtype=np.int64)
    col_ptr = np.array(col_ptr, dtype=np.int64)

    # neighbors by shared-edge overlap
    eps = 1e-10
    n = len(arr)
    ab, bl, inn, out = [[] for _ in range(n)], [[] for _ in range(n)], \
        [[] for _ in range(n)], [[] for _ in range(n)]
    xmin, xmax, ymin, ymax = arr.T
    for i in range(n):
        xo = (np.minimum(xmax, xmax[i]) - np.maximum(xmin, xmin[i])) > eps
        yo = (np.minimum(ymax, ymax[i]) - np.maximum(ymin, ymin[i])) > eps
        ab[i] = np.nonzero(xo & (np.abs(ymin - ymax[i]) < eps))[0].tolist()
        bl[i] = np.nonzero(xo & (np.abs(ymax - ymin[i]) < eps))[0].tolist()
        inn[i] = np.nonzero(yo & (np.abs(xmax - xmin[i]) < eps))[0].tolist()
        out[i] = np.nonzero(yo & (np.abs(xmin - xmax[i]) < eps))[0].tolist()

    def csr(lists):
        ptr = np.zeros(n + 1, dtype=np.int64)
        flat = []
        for i, li in enumerate(lists):
            flat.extend(li)
            ptr[i + 1] = len(flat)
        return ptr, np.array(flat, dtype=np.int64)

    ab_ptr, ab_f = csr(ab)
    bl_ptr, bl_f = csr(bl)
    in_ptr, in_f = csr(inn)
    ou_ptr, ou_f = csr(out)

    # surface / bottom cells per column (highest/lowest *using* cell)
    surf, bott = [], []
    for i in range(ncol):
        members = col_cells[col_ptr[i]:col_ptr[i + 1]]
        used = members[using[members]]
        if len(used):
            surf.append(int(used[0]))
            bott.append(int(used[-1]))
    return Grid(rmin=xmin.copy(), rmax=xmax.copy(), zmin=ymin.copy(),
                zmax=ymax.copy(), using=using, n0=n0, col_id=col,
                col_ptr=col_ptr, col_cells=col_cells,
                nb_above_ptr=ab_ptr, nb_above=ab_f,
                nb_below_ptr=bl_ptr, nb_below=bl_f,
                nb_inner_ptr=in_ptr, nb_inner=in_f,
                nb_outer_ptr=ou_ptr, nb_outer=ou_f,
                surf_cells=np.array(surf, dtype=np.int64),
                bott_cells=np.array(bott, dtype=np.int64))
