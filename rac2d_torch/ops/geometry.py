"""Ray/cell geometry for annular (r, z) cells, on tensors.

Counterpart of the JAX package's ``ops/geometry.py`` (reference:
src/ray_propagating.f90:365-504 ``calc_intersection_ray_cell`` — six
candidate surfaces: top/bottom planes and inner/outer cylinders; :276-362
the mirror (z<0) variant; point location :136-178).  All six candidate
lengths are evaluated branch-free and reduced with a masked min; point
location uses a log-uniform radial lookup table and the column's z-edge
ladder.  ``locate`` keeps both of the JAX package's paths: the packed
float32 one that the walk uses and the full-precision one.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# constants must stay representable in float32 (the MC walk runs in f32)
FL_BIG = 1e30
MIN_LEN = 1e-30
MIN_VZ = 1e-20
MIN_VXY = 1e-30
MIN_LEN_FRAC = 1e-6

# exit direction codes (reference dirtype):
# 1 top, 2 bottom, 3/4 inner cylinder, 5/6 outer cylinder
DIR_TOP, DIR_BOTTOM, DIR_INNER, DIR_OUTER = 1, 2, 3, 5


def ray_cell_exit(x, y, z, vx, vy, vz, rmin, rmax, zmin, zmax):
    """Distance to the first exit surface of the annular box.

    Returns (length, eps, dirtype, found), batched like the inputs.
    Mirrors reference calc_intersection_ray_cell semantics including the
    minimum-length cut and the eps nudge."""
    # top & bottom planes
    vz_ok = torch.abs(vz) >= MIN_VZ
    vz_safe = torch.where(vz_ok, vz, 1.0)
    L1 = torch.where(vz_ok, (zmax - z) / vz_safe, -1.0)
    L2 = torch.where(vz_ok, (zmin - z) / vz_safe, -1.0)

    def rr_at(L):
        tx = x + L * vx
        ty = y + L * vy
        return tx * tx + ty * ty

    rmin2 = rmin * rmin
    rmax2 = rmax * rmax
    r1 = rr_at(L1)
    L1 = torch.where((L1 >= 0) & (r1 >= rmin2) & (r1 <= rmax2), L1, -1.0)
    r2 = rr_at(L2)
    L2 = torch.where((L2 >= 0) & (r2 >= rmin2) & (r2 <= rmax2), L2, -1.0)

    # cylinders: A t^2 + B t + C = 0
    A = vx * vx + vy * vy
    B = 2.0 * (x * vx + y * vy)
    rr0 = x * x + y * y
    A_ok = torch.abs(A) > MIN_VXY
    A_safe = torch.where(A_ok, A, 1.0)

    def cyl_roots(r2_):
        C = rr0 - r2_
        D = B * B - 4.0 * A * C
        ok = (D > 0.0) & A_ok
        sq = torch.sqrt(torch.clamp(D, min=0.0))
        La = (-B + sq) / (2.0 * A_safe)
        Lb = (-B - sq) / (2.0 * A_safe)

        def zcheck(L):
            zz = z + vz * L
            return (zz >= zmin) & (zz <= zmax)

        La = torch.where(ok & zcheck(La), La, -1.0)
        Lb = torch.where(ok & zcheck(Lb), Lb, -1.0)
        return La, Lb

    L3, L4 = cyl_roots(rmin2)
    L5, L6 = cyl_roots(rmax2)

    Ls = torch.stack([L1, L2, L3, L4, L5, L6], dim=-1)
    valid = Ls > MIN_LEN
    Lm = torch.where(valid, Ls, FL_BIG)
    length, idx = torch.min(Lm, dim=-1)
    found = valid.any(dim=-1)
    # boundary-crossing nudge: cell-size fraction, floored by the ULP of
    # the position magnitude (a thin cell's 1e-6*dz nudge can be below
    # the representable step at |pos| in f32)
    ulp = 8.0 * torch.finfo(x.dtype).eps
    pos_scale = torch.abs(x) + torch.abs(y) + torch.abs(z) + length
    eps = torch.maximum(
        torch.minimum(rmax - rmin, zmax - zmin) * MIN_LEN_FRAC,
        pos_scale * ulp)
    return torch.where(found, length, 0.0), eps, idx + 1, found


def ray_cell_exit_mirror(x, y, z, vx, vy, vz, rmin, rmax, zmin, zmax):
    """Mirror-symmetric variant: the cell occupies zmin<=|z|<=zmax
    (reference calc_intersection_ray_cell_mirror, :276-362), as ONE
    ray_cell_exit call with the sign of (z, vz) folded in."""
    direct = (z >= zmin) & (z <= zmax)
    sgn = torch.where(direct, 1.0, -1.0).to(z.dtype)
    return ray_cell_exit(x, y, z * sgn, vx, vy, vz * sgn,
                         rmin, rmax, zmin, zmax)


class GridIndex(NamedTuple):
    """Point-location structure for the columnwise grid (tensors on one
    device; scalars as Python floats)."""
    r_edges: torch.Tensor       # [n_col + 1] column boundaries (AU), f64
    z_edges: torch.Tensor       # [n_col, max_nz + 1] per-column z edges,
                                # padded with +inf, f64
    cell_of: torch.Tensor       # [n_col, max_nz] leaf index, -1 pad
    n_z: torch.Tensor           # [n_col] cells per column
    zmax_dom: float
    rmin_dom: float
    rmax_dom: float
    # log-uniform radial lookup table (None -> searchsorted, for
    # hand-built fixtures)
    r_lut: torch.Tensor = None  # [n_lut] column of each slot edge
    r_lut_log0: float = 0.0     # ln(r_edges[0])
    r_lut_inv_d: float = 1.0    # n_lut / ln(r_max/r_min)
    # packed float32 variants for the walk: locate reads two rows
    #   r_lut_pack[slot] -> (ic0, r_edges[ic0], r_edges[ic0+1])
    #   zc_pack[ic]      -> (z_edges row .. cell_of row as f32)
    r_lut_pack: torch.Tensor = None   # [n_lut, 3] f32
    zc_pack: torch.Tensor = None      # [n_col, 2*max_nz + 1] f32


def build_grid_index(grid, device) -> GridIndex:
    """Host-side: per-column sorted z-edge ladders + cell map."""
    ncol = grid.n_columns
    # the packed path stores column/cell ids as f32, exact below 2**24
    n_cells_tot = len(np.asarray(grid.zmin))
    if n_cells_tot >= (1 << 24) or ncol >= (1 << 24):
        raise ValueError(
            f"grid too large for the packed f32 locate tables "
            f"(n_cells={n_cells_tot}, ncol={ncol} must be < 2**24)")
    nz = np.diff(grid.col_ptr)
    max_nz = int(nz.max())
    z_edges = np.full((ncol, max_nz + 1), np.inf)
    cell_of = np.full((ncol, max_nz), -1, dtype=np.int32)
    r_edges = np.zeros(ncol + 1)
    for i in range(ncol):
        members = grid.col_cells[grid.col_ptr[i]:grid.col_ptr[i + 1]]
        order = np.argsort(grid.zmin[members])   # bottom -> top
        m = members[order]
        z_edges[i, :len(m)] = grid.zmin[m]
        z_edges[i, len(m)] = grid.zmax[m[-1]]
        cell_of[i, :len(m)] = m
        r_edges[i] = grid.rmin[m[0]]
        r_edges[i + 1] = grid.rmax[m[0]]
    # radial lookup table: slots fine enough that at most one column
    # boundary falls inside any slot (single +1 correction in locate)
    ln_r = np.log(r_edges)
    min_dlog = np.diff(ln_r).min()
    span = ln_r[-1] - ln_r[0]
    n_lut = int(min(max(4096, 4.0 * span / max(min_dlog, 1e-12)), 1 << 20))
    r_lut = None
    log0 = inv_d = 0.0
    if span / n_lut < min_dlog:
        slot_left = np.exp(ln_r[0] + span * np.arange(n_lut) / n_lut)
        r_lut = np.clip(np.searchsorted(r_edges, slot_left,
                                        side="right") - 1, 0, ncol - 1)
        log0 = float(ln_r[0])
        inv_d = float(n_lut / span)
    r_lut_pack = None
    if r_lut is not None:
        r_lut_pack = np.stack(
            [r_lut.astype(np.float32),
             r_edges[r_lut].astype(np.float32),
             r_edges[np.minimum(r_lut + 1, ncol)].astype(np.float32)],
            axis=1)
    zc_pack = np.concatenate(
        [z_edges.astype(np.float32), cell_of.astype(np.float32)], axis=1)

    def t(a, dtype=None):
        return None if a is None else torch.as_tensor(a, dtype=dtype,
                                                      device=device)
    return GridIndex(
        r_edges=t(r_edges), z_edges=t(z_edges), cell_of=t(cell_of),
        n_z=t(nz, torch.int32),
        zmax_dom=float(grid.zmax.max()), rmin_dom=float(r_edges[0]),
        rmax_dom=float(r_edges[-1]),
        r_lut=t(r_lut, torch.int32), r_lut_log0=log0, r_lut_inv_d=inv_d,
        r_lut_pack=t(r_lut_pack), zc_pack=t(zc_pack))


def locate(gi: GridIndex, rsq, z_abs):
    """Leaf cell (int32) containing (r, |z|); -1 if outside the domain.

    A float32 rsq with the packed tables takes the walk's path (two row
    reads); anything else the full-precision path, in the dtype of the
    tables."""
    r = torch.sqrt(rsq)
    ncol = gi.r_edges.shape[0] - 1
    max_nz = gi.cell_of.shape[1]
    if gi.r_lut_pack is not None and gi.zc_pack is not None \
            and r.dtype == torch.float32:
        n_lut = gi.r_lut_pack.shape[0]
        slot = torch.clamp(torch.floor(
            (torch.log(torch.clamp(r, min=1e-30)) - gi.r_lut_log0)
            * gi.r_lut_inv_d).to(torch.int64), 0, n_lut - 1)
        prow = gi.r_lut_pack[slot]                      # [..., 3]
        ic0 = prow[..., 0].to(torch.int64)
        # at most one boundary per slot by construction: +-1 correction
        # (the -1 guards f32 log round-off landing one slot high)
        ic = ic0 + (r >= prow[..., 2]).to(torch.int64) \
            - (r < prow[..., 1]).to(torch.int64)
        ic = torch.clamp(ic, 0, ncol - 1)
        zc = gi.zc_pack[ic]                  # [..., 2*max_nz + 1]
        zrow = zc[..., :max_nz + 1]
        iz = (zrow <= z_abs[..., None]).sum(-1) - 1
        iz = torch.clamp(iz, 0, max_nz - 1)
        cell = torch.gather(zc[..., max_nz + 1:], -1, iz[..., None])[..., 0] \
            .to(torch.int32)
        z0 = zrow[..., 0]
    else:
        # compare in the promoted dtype of the point and the tables, as
        # JAX does (the walk casts the tables to f32 first)
        cd = torch.promote_types(r.dtype, gi.r_edges.dtype)
        rp = r.to(cd)
        re = gi.r_edges.to(cd)
        if gi.r_lut is not None:
            n_lut = gi.r_lut.shape[0]
            slot = torch.clamp(torch.floor(
                (torch.log(torch.clamp(r, min=1e-30)) - gi.r_lut_log0)
                * gi.r_lut_inv_d).to(torch.int64), 0, n_lut - 1)
            ic0 = gi.r_lut[slot].to(torch.int64)
            ic = ic0 + (rp >= re[torch.clamp(ic0 + 1, max=ncol)]
                        ).to(torch.int64) - (rp < re[ic0]).to(torch.int64)
            ic = torch.clamp(ic, 0, ncol - 1)
        else:
            ic = torch.clamp(
                torch.searchsorted(re, rp.contiguous(), right=True) - 1,
                0, ncol - 1)
        zrow = gi.z_edges.to(torch.promote_types(
            z_abs.dtype, gi.z_edges.dtype))[ic]     # [..., max_nz + 1]
        # comparison-count "searchsorted" along the ragged z ladder (the
        # pad value +inf never counts)
        iz = (zrow <= z_abs[..., None]).sum(-1) - 1
        iz = torch.clamp(iz, 0, max_nz - 1)
        cell = gi.cell_of[ic, iz].to(torch.int32)
        z0 = zrow[..., 0]
    inside = (r >= gi.rmin_dom) & (r <= gi.rmax_dom) \
        & (z_abs <= gi.zmax_dom) & (z_abs.to(z0.dtype) >= z0) & (cell >= 0)
    return torch.where(inside, cell, -1)
