"""Radiation-field reductions after a Monte Carlo pass.

Counterpart of the JAX package's ``ops/fields.py`` (reference
``post_montecarlo``, src/disk.f90:1204-1441): dust temperatures from the
cumulative-energy LUT, flux normalization by cell volume, band-integrated
fluxes, G0 factors, Lyman-alpha photon flux, Av from the UV attenuation
ratio and the X-ray ionization rate, as masked sums over the wavelength
axis for the whole grid at once (float64).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import constants as c
from . import columns, mcrt, optics


class RadiationFields(NamedTuple):
    flux: torch.Tensor          # [n_cells, nlam]  erg cm^-2 s^-1 per bin
    Tdusts: torch.Tensor        # [n_dust, n_cells]
    Tdust: torch.Tensor         # [n_cells] sigma-weighted mean
    flux_tot: torch.Tensor
    flux_Xray: torch.Tensor
    flux_UV: torch.Tensor       # Lya-subtracted, like the reference
    flux_Lya: torch.Tensor
    flux_Vis: torch.Tensor
    flux_NIR: torch.Tensor
    flux_MIR: torch.Tensor
    flux_FIR: torch.Tensor
    phflux_Lya: torch.Tensor
    G0_UV_toStar: torch.Tensor  # unattenuated, Lya-subtracted
    Av_toStar: torch.Tensor
    G0_UV_H2phd: torch.Tensor
    G0_UV_toStar_photoDesorb: torch.Tensor
    zeta_Xray: torch.Tensor
    dir_flux: torch.Tensor      # [n, 3] net photon-flux direction


def _band_mask(lam_A, band_um):
    lo = band_um[0] / c.Angstrom2micron
    hi = band_um[1] / c.Angstrom2micron
    return (lam_A >= lo) & (lam_A <= hi)


def fill_blank(lam_A, flux, phc, nth=3, nrange=None):
    """Smear energy from well-sampled wavelength channels over adjacent
    poorly-sampled ones, conserving the window's integral (reference
    ``fill_blank``, src/disk.f90:1444-1479).  Host-side numpy, like the
    JAX package: each bad bin's fill reads the previous fill's window,
    so the inner loop is order-dependent.  flux/phc: [n_cells, nlam]."""
    lam = np.asarray(lam_A, dtype=float)
    flux = np.array(flux, dtype=float)
    phc = np.asarray(phc)
    n = flux.shape[1]
    if nrange is None:
        nrange = 3 + n // 100
    good = phc >= nth
    for ic in np.nonzero((~good[:, :]).any(axis=1)
                         & good.any(axis=1))[0]:
        v = flux[ic]
        g = good[ic]
        for i in np.nonzero(~g)[0]:
            left = np.nonzero(g[:i])[0]
            right = np.nonzero(g[i + 1:])[0]
            jmin = left[-1] if len(left) else n - 1
            jmax = right[0] + i + 1 if len(right) else 0
            jmin = min(jmin, max(0, i - nrange))
            jmax = max(jmax, min(n - 1, i + nrange))
            if jmax <= jmin:
                continue
            s = v[jmin:jmax].sum()
            smean = s / abs(lam[jmax] - lam[jmin])
            v[jmin:jmax] = smean * np.abs(np.diff(lam[jmin:jmax + 1]))
        flux[ic] = v
    return flux


def reduce_fields(tab: optics.McTables, cells: mcrt.McCells,
                  tallies: mcrt.McTallies, volumes_cm3, r2av,
                  star_lumi_UV0, star_lumi_Lya, star_lumi_H2phd,
                  r_cells_AU, z_cells_AU,
                  UV_G0_background: float = 1.0,
                  minimum_Tdust: float = 1.0) -> RadiationFields:
    """Convert the (float64, physical-unit) MC tallies into the scalar
    fields chemistry needs.  r2av: [n_dust] mean grain r^2 per
    component; star_lumi_*: band luminosities of the stellar spectrum."""
    dev = tallies.flux.device

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float64,
                               device=dev)

    lam_np = np.asarray(tab.lam, dtype=np.float64)
    n_dust = cells.rho_dust.shape[0]
    vol = t(volumes_cm3)

    # flux normalization: tallies are sum(length_AU * en)
    flux = tallies.flux * (c.AU2cm / vol[:, None])

    # Tdust per component from the LUT; sigma-weighted mean
    Tds = []
    for i in range(n_dust):
        val = tallies.en_gain[i] / (4.0 * np.pi * torch.clamp(
            cells.mdust_cell[i], min=1e-300))
        Ti = optics.tdust_from_energy(tab, i, val)
        Ti = torch.where(cells.mdust_cell[i] > 1e-50, Ti, 0.0)
        Tds.append(Ti)
    Tdusts = torch.stack(Tds)
    n_dusts = cells.rho_dust / t(tab.pmass)[:, None]
    wei = n_dusts * t(r2av)[:, None]
    wsum = wei.sum(0)
    Tdust = torch.where(wsum > 0.0, (Tdusts * wei).sum(0)
                        / torch.clamp(wsum, min=1e-300), minimum_Tdust)
    Tdust = torch.clamp(Tdust, min=minimum_Tdust)

    def band_sum(band):
        m = torch.as_tensor(_band_mask(lam_np, band), device=dev)
        return torch.where(m[None, :], flux, 0.0).sum(1)

    flux_tot = flux.sum(1)
    flux_Xray = band_sum(c.lam_range_Xray)
    flux_UV_raw = band_sum(c.lam_range_UV)
    flux_Lya = band_sum(c.lam_range_LyA)
    flux_Vis = band_sum(c.lam_range_Vis)
    flux_NIR = band_sum(c.lam_range_NIR)
    flux_MIR = band_sum(c.lam_range_MIR)
    flux_FIR = band_sum(c.lam_range_FIR)
    flux_UV = flux_UV_raw - flux_Lya

    phflux_Lya = flux_Lya / c.LyAlpha_energy_CGS

    # unattenuated stellar UV at the cell (Lya-subtracted), G0 factors
    RRcm2 = (r_cells_AU ** 2 + z_cells_AU ** 2) * c.AU2cm ** 2
    flux_UV_unatten = (star_lumi_UV0 - star_lumi_Lya) \
        / (4.0 * np.pi * RRcm2)
    G0_toStar = flux_UV_unatten / c.Habing_energy_flux_CGS
    # Av from the attenuation ratio (reference default path,
    # disk.f90:1413-1426); unlit cells get the opaque sentinel 1e4
    ratio = flux_UV / torch.clamp(flux_UV_unatten, min=1e-300)
    Av_toStar = torch.where(
        (flux_UV > 0.0) & (flux_UV_unatten > 0.0),
        torch.clamp(-1.086 * torch.log(torch.clamp(ratio, min=1e-30))
                    / c.UVext2Av, 0.0, 1e4),
        1e4)
    G0_photoDesorb = flux_UV / c.Habing_energy_flux_CGS
    G0_H2phd = band_sum(c.lam_range_UV_H2phd) / c.Habing_energy_flux_CGS

    zeta_X = columns.xray_ionization_rate(
        lam_np, flux, tab.is_xray, cells.dust_depletion, cells.d2h,
        cells.grain_a)

    dirf = tallies.dir_flux / vol[:, None] * c.AU2cm \
        / (1e-100 + flux_tot[:, None])
    return RadiationFields(
        flux=flux, Tdusts=Tdusts, Tdust=Tdust, flux_tot=flux_tot,
        flux_Xray=flux_Xray, flux_UV=flux_UV, flux_Lya=flux_Lya,
        flux_Vis=flux_Vis, flux_NIR=flux_NIR, flux_MIR=flux_MIR,
        flux_FIR=flux_FIR, phflux_Lya=phflux_Lya, G0_UV_toStar=G0_toStar,
        Av_toStar=Av_toStar, G0_UV_H2phd=G0_H2phd,
        G0_UV_toStar_photoDesorb=G0_photoDesorb, zeta_Xray=zeta_X,
        dir_flux=dirf)
