"""Vertical hydrostatic structure adjustment.

Rebuild of reference src/vertical_structure.f90:16-246
(``vertical_pressure_gravity_balance_alt`` fixed-grid variant +
``calc_dustgas_struct_snippet1/2`` and ``calc_disk_gas_mass``): each
column's density profile is rebuilt from isothermal-layer hydrostatic
factors between adjacent cells, then renormalized to conserve the column
surface density (and optionally a preset total disk mass); cells dropping
below density floors are deactivated.

Host-side numpy (a copy of the JAX package's ``ops/vertical.py``), run
between iteration stages like the grid rebuild: O(n_cells) work per outer
iteration, far off the hot path.
"""

from __future__ import annotations

import numpy as np

from .. import constants as c


def disk_gas_mass(grid, n_gas, mean_mol_weight=1.4):
    """Total gas mass [Msun], both sides of the midplane."""
    vol = grid.volumes_cm3()
    m = (vol * n_gas * c.mProton_CGS * mean_mol_weight)[grid.using].sum()
    return m * 2.0 / c.Msun_CGS


def pressure_gravity_balance_moving(grid, n_gas, T, rho_dust, star_mass,
                                    use_Tdust=True, Tdust_lowerlimit=5.0,
                                    mean_mol_weight=1.4, max_dz=None,
                                    zmax_dom=None):
    """Moving-grid hydrostatic variant (reference
    ``vertical_pressure_gravity_balance`` + ``shift_and_scale_above``,
    src/vertical_structure.f90:354-518): every cell's thermal pressure is
    driven toward the weight of the column above it by rescaling BOTH its
    density (x f) and its vertical extent (/ f), then the cells of each
    column are restacked bottom-to-top and the top cell is stretched to
    the domain top with its density rescaled to conserve mass.

    Returns (zmin_new, zmax_new, n_gas_new, rho_dust_new, maxfac,
    minfac).  The caller must rebuild geometry indices and path matrices
    afterwards (the grid moved).
    """
    g = grid
    n_gas = n_gas.copy()
    rho_dust = rho_dust.copy()
    zmin_new = g.zmin.copy()
    zmax_new = g.zmax.copy()
    GM = c.GravitationConst_CGS * star_mass * c.Msun_CGS
    mmw_mp = mean_mol_weight * c.mProton_CGS
    ztop = zmax_dom if zmax_dom is not None else float(g.zmax.max())
    maxfac, minfac = 0.0, 1e100

    for icol in range(g.n_columns):
        members = g.col_cells[g.col_ptr[icol]:g.col_ptr[icol + 1]]
        order = np.argsort(g.zmin[members])
        col = members[order]
        dz = (g.zmax[col] - g.zmin[col]).astype(float)
        rmid = 0.5 * (g.rmin[col] + g.rmax[col])
        zmid = 0.5 * (g.zmin[col] + g.zmax[col])
        rho = n_gas[col] * mmw_mp
        gz = GM * (zmid * c.AU2cm) / np.maximum(
            ((rmid ** 2 + zmid ** 2) ** 1.5) * c.AU2cm ** 3, 1e-30)
        w = rho * gz * dz * c.AU2cm
        # weight of the column above each cell (incl. own upper half)
        W = np.cumsum(w[::-1])[::-1] - 0.5 * w
        pold = n_gas[col] * np.maximum(T[col], 1e-30) * c.kBoltzmann_CGS
        pnew = np.maximum(W, 1e-300)
        # damped update (reference: pnew = (pnew^3 * pold)^(1/4))
        pnew = np.sqrt(np.sqrt(pnew ** 3 * pold))
        pnew = np.clip(pnew, pold * 1e-2, pold * 1e2)
        if max_dz is not None:
            mdz = max_dz
        else:
            mdz = 0.25 * (g.rmin[col] + g.rmax[col]
                          + g.zmin[col] + g.zmax[col]) + ztop
        frescale = np.maximum(pnew / np.maximum(pold, 1e-300), dz / mdz)
        skip = ~g.using[col]
        if use_Tdust:
            skip |= T[col] <= Tdust_lowerlimit
        frescale = np.where(skip, 1.0, frescale)
        maxfac = max(maxfac, float(frescale[~skip].max())
                     if (~skip).any() else maxfac)
        minfac = min(minfac, float(frescale[~skip].min())
                     if (~skip).any() else minfac)
        n_gas[col] *= frescale
        rho_dust[:, col] *= frescale[None, :]
        dz = dz / frescale
        # restack bottom -> top from the original column base
        zb = g.zmin[col[0]]
        for k, ci in enumerate(col):
            zmin_new[ci] = zb
            zmax_new[ci] = zb + dz[k]
            zb = zmax_new[ci]

    # the domain top follows the tallest column (reference root%ymax
    # update in shift_and_scale_above), then every column's top cell is
    # stretched to it with its mass conserved
    tops = np.asarray([
        mem[np.argmax(zmax_new[mem])] for mem in
        (g.col_cells[g.col_ptr[i]:g.col_ptr[i + 1]]
         for i in range(g.n_columns)) if len(mem)])
    if tops.size:
        ztop = max(ztop, float(zmax_new[tops].max()))
    for top in tops:
        if zmax_new[top] < ztop:
            f = (zmax_new[top] - zmin_new[top]) \
                / max(ztop - zmin_new[top], 1e-30)
            n_gas[top] *= f
            rho_dust[:, top] *= f
            zmax_new[top] = ztop
    return zmin_new, zmax_new, n_gas, rho_dust, maxfac, minfac


def pressure_gravity_balance(grid, n_gas, T, rho_dust, star_mass,
                             use_Tdust=True, Tdust_lowerlimit=5.0,
                             ngas_lowerlimit=1e-4, ndust_lowerlimit=1e-20,
                             fix_dust_struct=True, pmass=None,
                             disk_gas_mass_preset=None,
                             mean_mol_weight=1.4):
    """Returns (n_gas_new, rho_dust_new, using_new, maxfac, minfac).

    n_gas [n]; T [n] (Tdust or Tgas per use_Tdust); rho_dust [n_dust, n].
    """
    g = grid
    n_gas = n_gas.copy()
    rho_dust = rho_dust.copy()
    using = g.using.copy()
    maxfac, minfac = 0.0, 1e100

    f_glob = 1.0
    if disk_gas_mass_preset is not None:
        m = disk_gas_mass(g, n_gas, mean_mol_weight)
        f_glob = disk_gas_mass_preset / m

    GM = c.GravitationConst_CGS * star_mass * c.Msun_CGS
    mmw_mp = mean_mol_weight * c.mProton_CGS

    for icol in range(g.n_columns):
        members = g.col_cells[g.col_ptr[icol]:g.col_ptr[icol + 1]]
        order = np.argsort(g.zmin[members])     # bottom -> top
        col = members[order]
        dz = g.zmax[col] - g.zmin[col]
        Sig0 = (dz * n_gas[col] * mmw_mp * using[col]).sum()
        SigD0 = (dz[None, :] * rho_dust[:, col]
                 * using[col][None, :]).sum(1)
        for k in range(1, len(col)):
            c1, c2 = col[k - 1], col[k]
            if not using[c2]:
                break
            r1 = np.hypot(g.rmin[c1] + g.rmax[c1],
                          g.zmin[c1] + g.zmax[c1]) * 0.5 * c.AU2cm
            r2 = np.hypot(g.rmin[c2] + g.rmax[c2],
                          g.zmin[c2] + g.zmax[c2]) * 0.5 * c.AU2cm
            z0 = 0.5 * (g.zmax[c1] + g.zmin[c1]) * c.AU2cm
            z1 = g.zmax[c1] * c.AU2cm
            z2 = 0.5 * (g.zmax[c2] + g.zmin[c2]) * c.AU2cm
            T1, T2 = T[c1], T[c2]
            if use_Tdust and (T1 <= Tdust_lowerlimit
                              or T2 <= Tdust_lowerlimit):
                continue
            if T1 <= 0 or T2 <= 0:
                continue
            fac1 = GM * mmw_mp / 2.0 / r1 ** 3 / (c.kBoltzmann_CGS * T1) \
                * (z1 - z0) * (z1 + z0)
            fac2 = GM * mmw_mp / 2.0 / r2 ** 3 / (c.kBoltzmann_CGS * T2) \
                * (z2 - z1) * (z2 + z1)
            fac = min(np.exp(-fac1 - fac2) * T1 / T2, 1.0)
            fac_ch = n_gas[c1] * fac / (n_gas[c2] + 1e-100)
            n_gas[c2] = n_gas[c1] * fac
            if not fix_dust_struct:
                rho_dust[:, c2] = rho_dust[:, c1] * min(1.0, fac)
            if n_gas[c1] >= ngas_lowerlimit:
                maxfac = max(maxfac, fac_ch)
                minfac = min(minfac, fac_ch)
        Sig1 = (dz * n_gas[col] * mmw_mp * using[col]).sum()
        SigD1 = (dz[None, :] * rho_dust[:, col]
                 * using[col][None, :]).sum(1)
        fac = f_glob * Sig0 / (Sig1 + 1e-100)
        facD = f_glob * SigD0 / (SigD1 + 1e-100)
        n_gas[col] *= fac
        if not fix_dust_struct:
            rho_dust[:, col] *= facD[:, None]
        # deactivate unusable cells (reference :168-178)
        if pmass is not None:
            ndust_tot = (rho_dust[:, col] / pmass[:, None]).sum(0)
            bad = ((ndust_tot <= ndust_lowerlimit)
                   | (n_gas[col] <= ngas_lowerlimit)
                   | (n_gas[col] * 1e-3 <= ndust_tot)
                   | (ndust_tot <= n_gas[col] * 1e-30))
            using[col[bad]] = False
    return n_gas, rho_dust, using, maxfac, minfac
