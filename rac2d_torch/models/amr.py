"""Adaptive refinement/merging of the vertical grid during iteration.

Rebuild of reference src/disk.f90:3646-4033 (``do_refine`` /
``need_to_refine`` — refine a cell whose watched-species abundances jump
by more than a threshold factor against its vertical neighbors;
``refine_this_cell_vertical`` — split into children inheriting the parent
state; ``merge_cells``/``need_to_merge`` — collapse vertically-adjacent
cells that became uniform in density/temperature/extinction;
``remake_index`` — rebuild the leaf/column/neighbor structures).

Host-side numpy (a copy of the JAX package's ``models/amr.py``): the grid
is regenerated on the host between outer iterations.  State is transferred
parent -> children verbatim; a merged cell takes its lower cell's state.
"""

from __future__ import annotations

import numpy as np

from .grid import Grid, build_grid_from_leaves


def load_watch_list(path, net):
    """Parse a reference-format refine watch list (species_check_refine
    .dat: 'name  min_abundance' per line, disk.f90:3908-3968); returns
    (watch_idx, min_abun arrays) restricted to species in the network."""
    idx, mins = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 2 or parts[0].startswith(("!", "#")):
                continue
            if parts[0] in net.idx:
                idx.append(net.idx[parts[0]])
                mins.append(float(parts[1]))
    return np.asarray(idx, dtype=np.int64), np.asarray(mins)


def need_refine(grid: Grid, X, watch_idx, thresh=10.0, min_abun=1e-15,
                min_dz=None):
    """Cells whose watched abundances jump by > thresh against the cell
    above or below (reference need_to_refine, disk.f90:3908-3968).
    min_abun: scalar or per-watched-species array."""
    n = grid.n_cells
    mask = np.zeros(n, dtype=bool)
    dz = grid.zmax - grid.zmin
    for i in range(n):
        if not grid.using[i]:
            continue
        if min_dz is not None and dz[i] <= min_dz:
            continue
        for ptr, nb in ((grid.nb_above_ptr, grid.nb_above),
                        (grid.nb_below_ptr, grid.nb_below)):
            for j in nb[ptr[i]:ptr[i + 1]]:
                if not grid.using[j]:
                    continue
                a = X[watch_idx, i]
                b = X[watch_idx, j]
                big = (np.maximum(a, b) > min_abun)
                ratio = np.maximum(a, b) / np.maximum(np.minimum(a, b),
                                                      1e-300)
                if (big & (ratio > thresh)).any():
                    mask[i] = True
    return mask


def need_merge(grid: Grid, n_gas, Tdust, Av, tol=1.5):
    """Vertically-adjacent same-column pairs uniform within tol
    (reference need_to_merge, disk.f90:3786-3845)."""
    pairs = []
    for icol in range(grid.n_columns):
        members = grid.col_cells[grid.col_ptr[icol]:grid.col_ptr[icol + 1]]
        order = np.argsort(grid.zmin[members])
        colm = members[order]
        for a, b in zip(colm[:-1], colm[1:]):
            if not (grid.using[a] and grid.using[b]):
                continue
            ok = True
            for v in (n_gas, Tdust, Av):
                x, y = v[a], v[b]
                if max(x, y) > tol * max(min(x, y), 1e-300):
                    ok = False
                    break
            if ok:
                pairs.append((a, b))
    return pairs


def disjoint_pairs(pairs):
    """The merge pairs in which no cell is in an earlier pair: of a chain
    (a, b), (b, c) of uniform neighbours, (a, b) is kept.  In the port
    only: the JAX package hands need_merge's chains to adapt_grid, which
    merges b into a and drops c, merged into the dropped b, so that c's
    extent is missing from the column (a hole in the grid)."""
    taken, out = set(), []
    for a, b in pairs:
        if a not in taken and b not in taken:
            out.append((a, b))
            taken.update((a, b))
    return out


def adapt_grid(grid: Grid, refine_mask, merge_pairs=()):
    """Split marked cells vertically in two; merge the given pairs.

    Returns (new_grid, parent_of): parent_of[j] = index of the old cell
    each new cell inherits state from (for merge pairs, the lower cell;
    callers may re-average using old volumes).
    """
    merged_away = {}
    for a, b in merge_pairs:
        merged_away[b] = a

    bounds = []
    cols = []
    n0 = []
    using = []
    parent = []
    for i in range(grid.n_cells):
        if i in merged_away:
            continue
        z0, z1 = grid.zmin[i], grid.zmax[i]
        # absorb any merged partner
        for b, a in merged_away.items():
            if a == i:
                z1 = max(z1, grid.zmax[b])
                z0 = min(z0, grid.zmin[b])
        if refine_mask[i] and i not in [a for _, a in merged_away.items()]:
            zm = 0.5 * (z0 + z1)
            for lo, hi in ((z0, zm), (zm, z1)):
                bounds.append((grid.rmin[i], grid.rmax[i], lo, hi))
                cols.append(grid.col_id[i])
                n0.append(grid.n0[i])
                using.append(grid.using[i])
                parent.append(i)
        else:
            bounds.append((grid.rmin[i], grid.rmax[i], z0, z1))
            cols.append(grid.col_id[i])
            n0.append(grid.n0[i])
            using.append(grid.using[i])
            parent.append(i)
    arr = np.array(bounds)
    new = build_grid_from_leaves(
        arr, np.array(cols, dtype=np.int64), np.array(n0),
        np.array(using, dtype=bool))
    return new, np.array(parent, dtype=np.int64)


def remap_state(parent_of, *arrays):
    """Gather per-cell state arrays (last axis = cells) onto a new grid."""
    return tuple(np.asarray(a)[..., parent_of] for a in arrays)
