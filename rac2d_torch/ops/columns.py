"""Column densities, self-shielding factors, X-ray ionization.

Counterpart of the JAX package's ``ops/columns.py`` (reference:
src/disk.f90:2526-2729 ``calc_Ncol_from_cell_to_point`` /
``calc_Ncol_to_ISM`` / ``calc_Ncol_to_Star``, :1823-1897
``update_params_above_alt`` and ``get_H2_self_shielding``, :1969-2010
``calc_Xray_ionization_rate``).

The geometry is static between grid rebuilds, so the rays are traced once,
on the host, into sparse path matrices W[i, j] = path length (cm) of cell
i's ray through cell j, toward the star and toward the ISM (vertically up).
Every column density is then one sparse mat-vec N = W @ (n_gas * X) on the
model's device, in float64: an ``index_add_`` where the JAX package uses
``segment_sum``.
"""

from __future__ import annotations

import types
from typing import NamedTuple

import numpy as np
import torch

from .. import constants as c
from ..io import bethell

F64 = torch.float64


class PathMatrix(NamedTuple):
    """COO sparse [n_cells x n_cells] path-length matrix (cm), rows
    sorted; rows/cols int64 and w float64 tensors on one device."""
    rows: torch.Tensor     # [nnz] target cell
    cols: torch.Tensor     # [nnz] crossed cell
    w: torch.Tensor        # [nnz] path length in cm
    n_cells: int

    def matvec(self, v):
        """(W @ v) for per-cell values v [n_cells]."""
        out = torch.zeros(self.n_cells, dtype=v.dtype, device=v.device)
        return out.index_add_(0, self.rows, self.w * v[self.cols])


def _trace_ray(grid, gi_host, i, tx, tz):
    """Host-side: march from (near) cell i toward point (tx, tz), returning
    (cells crossed, lengths in AU).  Mirrors the reference's corner-start
    rule (disk.f90:2577-2616: start from the cell corner closest to the
    target)."""
    x0, x1 = grid.rmin[i], grid.rmax[i]
    y0, y1 = grid.zmin[i], grid.zmax[i]
    dx, dy = x1 - x0, y1 - y0
    sf = 1e-6
    corners = [(x0 + dx * sf, y0 + dy * sf), (x0 + dx * sf, y1 - dy * sf),
               (x1 - dx * sf, y0 + dy * sf), (x1 - dx * sf, y1 - dy * sf),
               (0.5 * (x0 + x1), 0.5 * (y0 + y1))]
    d2 = [(tx - cx) ** 2 + (tz - cz) ** 2 for cx, cz in corners]
    cx, cz = corners[int(np.argmin(d2))]
    vx = tx - cx
    vz = tz - cz
    t = np.hypot(vx, vz)
    if t < 1e-50:
        return [], []
    vx /= t
    vz /= t
    # march through cells in the (r, z) half-plane at y = 0, with the full
    # 3D exit formulas
    x, y, z = cx, 0.0, cz
    cells, lens = [], []
    cur = i
    for _ in range(4 * grid.n_columns + len(grid.rmin)):
        if cur < 0:
            break
        rm, rM = grid.rmin[cur], grid.rmax[cur]
        zm, zM = grid.zmin[cur], grid.zmax[cur]
        L = _exit_len(x, y, z, vx, 0.0, vz, rm, rM, zm, zM)
        if L is None:
            break
        cells.append(cur)
        lens.append(L)
        eps = min(rM - rm, zM - zm) * 1e-6
        x += vx * (L + eps)
        z += vz * (L + eps)
        r = np.hypot(x, y)
        cur = _locate_host(grid, gi_host, r, abs(z))
    return cells, lens


def _exit_len(x, y, z, vx, vy, vz, rmin, rmax, zmin, zmax):
    cands = []
    if abs(vz) > 1e-20:
        for zb in (zmin, zmax):
            L = (zb - z) / vz
            if L > 1e-30:
                rr = np.hypot(x + vx * L, y + vy * L)
                if rmin <= rr <= rmax:
                    cands.append(L)
    A = vx * vx + vy * vy
    if A > 1e-40:
        B = 2 * (x * vx + y * vy)
        for rb in (rmin, rmax):
            C = x * x + y * y - rb * rb
            D = B * B - 4 * A * C
            if D > 0:
                for L in ((-B + np.sqrt(D)) / (2 * A),
                          (-B - np.sqrt(D)) / (2 * A)):
                    if L > 1e-30:
                        zz = z + vz * L
                        if zmin <= zz <= zmax:
                            cands.append(L)
    return min(cands) if cands else None


def _locate_host(grid, gi_host, r, z_abs):
    r_edges = gi_host.r_edges
    if r < r_edges[0] or r > r_edges[-1]:
        return -1
    ic = min(np.searchsorted(r_edges, r, side="right") - 1,
             len(r_edges) - 2)
    ic = max(ic, 0)
    zrow = gi_host.z_edges[ic]
    iz = int((zrow <= z_abs).sum()) - 1
    if iz < 0 or iz >= gi_host.cell_of.shape[1]:
        return -1
    cell = int(gi_host.cell_of[ic, iz])
    if cell < 0 or z_abs > zrow[iz + 1]:
        return -1
    return cell


def _host_index(gi):
    """The locate tables of a GridIndex as host numpy arrays."""
    def h(a):
        return a.cpu().numpy() if isinstance(a, torch.Tensor) \
            else np.asarray(a)
    return types.SimpleNamespace(r_edges=h(gi.r_edges),
                                 z_edges=h(gi.z_edges),
                                 cell_of=h(gi.cell_of))


def _path_matrix(rows, cols, w, n_cells, device):
    order = np.argsort(np.asarray(rows), kind="stable")
    return PathMatrix(
        rows=torch.as_tensor(np.asarray(rows, dtype=np.int64)[order],
                             device=device),
        cols=torch.as_tensor(np.asarray(cols, dtype=np.int64)[order],
                             device=device),
        w=torch.as_tensor(np.asarray(w, dtype=np.float64)[order],
                          device=device),
        n_cells=n_cells)


def build_path_matrices(grid, gi_host, use_native=True, device="cuda"):
    """Star-directed and ISM-directed (vertical, upward) path matrices,
    traced on the host (the native library, or the Python trace when
    use_native=False) and held on device."""
    if use_native:
        from ..io import native
        rs, cs, ws = native.trace_path_matrix(grid, gi_host, to_ism=False)
        ri, ci, wi = native.trace_path_matrix(grid, gi_host, to_ism=True)
        return (_path_matrix(rs, cs, ws * c.AU2cm, grid.n_cells, device),
                _path_matrix(ri, ci, wi * c.AU2cm, grid.n_cells, device))

    gi_h = _host_index(gi_host)
    zfar = grid.zmax.max() * 2.0
    rows_s, cols_s, w_s = [], [], []
    rows_i, cols_i, w_i = [], [], []
    for i in range(grid.n_cells):
        if not grid.using[i]:
            continue
        cells, lens = _trace_ray(grid, gi_h, i, 0.0, 0.0)
        for cc, ll in zip(cells, lens):
            if grid.using[cc]:
                rows_s.append(i)
                cols_s.append(cc)
                w_s.append(ll * c.AU2cm)
        xm = 0.5 * (grid.rmin[i] + grid.rmax[i])
        cells, lens = _trace_ray(grid, gi_h, i, xm, zfar)
        for cc, ll in zip(cells, lens):
            if grid.using[cc]:
                rows_i.append(i)
                cols_i.append(cc)
                w_i.append(ll * c.AU2cm)
    return (_path_matrix(rows_s, cols_s, w_s, grid.n_cells, device),
            _path_matrix(rows_i, cols_i, w_i, grid.n_cells, device))


def h2_self_shielding(N_H2, dv_turb):
    """Draine & Bertoldi 1996 eq 37 (reference disk.f90:1887-1897)."""
    x = N_H2 / 5e14
    b5 = dv_turb / 1e5
    t = torch.sqrt(1.0 + x)
    return torch.clamp_max(0.965 / (1.0 + x / b5) ** 2
                           + 0.035 / t * torch.exp(-8.5e-4 * t), 1.0)


class ShieldingFactors(NamedTuple):
    """[5, n_cells] self-shielding arrays ordered (none,H2,CO,H2O,OH) for
    direct use as CellEnv.f_selfshielding_*."""
    toISM: torch.Tensor
    toStar: torch.Tensor
    Ncol_toISM: torch.Tensor
    Ncol_toStar: torch.Tensor
    colden_toISM: dict
    colden_toStar: dict


def compute_shielding(W_star: PathMatrix, W_ism: PathMatrix, n_gas, X,
                      idx: dict, dv_turb, visser):
    """All shielding factors for all cells at once.

    n_gas [n_cells], X [n_species, n_cells] and dv_turb [n_cells] are
    float64 tensors on the matrices' device; idx: species name -> row
    index; visser: io.tables.VisserCOShielding on the same device.
    """
    def col(W, name):
        return W.matvec(n_gas * X[idx[name]])

    N = {(s, d): col(W, s) for s in ("H2", "CO", "H2O", "OH")
         for d, W in (("s", W_star), ("i", W_ism))}
    Ntot_s = W_star.matvec(n_gas)
    Ntot_i = W_ism.matvec(n_gas)
    ones = torch.ones_like(Ntot_s)

    def factors(d):
        return torch.stack([
            ones,
            h2_self_shielding(N["H2", d], dv_turb),
            torch.clamp(visser.shielding(N["H2", d], N["CO", d]), 0.0, 1.0),
            torch.clamp_max(torch.exp(-N["H2O", d] * c.LyAlpha_cross_H2O),
                            1.0),
            torch.clamp_max(torch.exp(-N["OH", d] * c.LyAlpha_cross_OH),
                            1.0)])

    return ShieldingFactors(
        toISM=factors("i"), toStar=factors("s"), Ncol_toISM=Ntot_i,
        Ncol_toStar=Ntot_s,
        colden_toISM={s: N[s, "i"] for s in ("H2", "CO", "H2O", "OH")},
        colden_toStar={s: N[s, "s"] for s in ("H2", "CO", "H2O", "OH")})


def _f64(a, device):
    return torch.as_tensor(a, dtype=F64, device=device)


def _xray_sigma(E, dust_depletion, d2h, grain_a):
    """Per-cell X-ray cross section [n_cells, nlam] with the dust
    self-blanketing factor; E the host photon energies (keV)."""
    dev = d2h.device
    sraw = _f64(bethell.sigma_dust_raw(E), dev)[None, :] \
        * dust_depletion[:, None]
    f = bethell.dust_blanketing(sraw, d2h[:, None], grain_a[:, None], torch)
    return _f64(bethell.sigma_gas(E), dev)[None, :] + f * sraw


def _ion_pairs(flux, E, sig, is_xray):
    """Ionizations per H: photon flux x cross section x (E / 37 eV),
    summed over the X-ray channels."""
    dev = sig.device
    contrib = flux / _f64(E * c.keV2erg, dev)[None, :] * sig \
        * (_f64(E, dev)[None, :] * 1e3 / 37.0)
    mask = torch.as_tensor(np.asarray(is_xray), device=dev)
    return torch.where(mask[None, :], contrib, 0.0).sum(1)


def _photon_energy_keV(lam_A):
    lam_A = np.asarray(lam_A, dtype=np.float64)
    return c.hPlanck_CGS * c.SpeedOfLight_CGS / (lam_A * 1e-8) / c.keV2erg


def xray_ionization_rate(lam_A, flux_cell_lam, is_xray, dust_depletion,
                         d2h, grain_a):
    """zeta_X per H [s^-1] from the local MC flux (reference
    disk.f90:1969-2010; 37 eV per ion pair).  lam_A and is_xray are the
    host wavelength grid; the per-cell arguments are tensors."""
    E = _photon_energy_keV(lam_A)
    sig = _xray_sigma(E, dust_depletion, d2h, grain_a)
    return _ion_pairs(flux_cell_lam, E, sig, is_xray)


def xray_ionization_rate_ncol(lam_A, star_vals, is_xray, dust_depletion,
                              d2h, grain_a, Ncol_toStar, r_AU, z_AU):
    """zeta_X per H [s^-1] from direct Ncol attenuation of the stellar
    X-ray spectrum (the calc_zetaXray_from_Ncol mode of reference
    disk.f90:1969-2010): flux = L_lam dlam exp(-sigma Ncol)/(4 pi d^2)
    instead of the MC-tallied local flux.

    lam_A, star_vals (erg/s/A) and is_xray: the stellar spectrum on the
    master grid, host arrays [nlam]; per-cell tensors dust_depletion,
    d2h, grain_a, Ncol_toStar, r_AU, z_AU.
    """
    lam_h = np.asarray(lam_A, dtype=np.float64)
    E = _photon_energy_keV(lam_h)
    sig = _xray_sigma(E, dust_depletion, d2h, grain_a)
    dlam = np.concatenate([np.diff(lam_h), np.diff(lam_h)[-1:]])
    d2 = (r_AU ** 2 + z_AU ** 2) * c.AU2cm ** 2
    flux = _f64(np.asarray(star_vals, dtype=np.float64) * dlam,
                sig.device)[None, :] \
        * torch.exp(-torch.clamp(sig * Ncol_toStar[:, None], 0.0, 500.0)) \
        / (4.0 * np.pi * d2[:, None])
    return _ion_pairs(flux, E, sig, is_xray)
