"""Stellar spectra and the deterministic photon-packet wavelength ladder.

Rebuild of the reference photon-source machinery (reference:
src/montecarlo.f90:1238-1331 — file spectrum, blackbody
``make_stellar_spectrum``, thermal X-ray ``make_stellar_spectrum_Xray``;
:515-573 ``emit_a_photon``/``get_next_lam``).

The reference sweeps the spectrum deterministically: each photon packet
carries a fixed energy eph (scaled by per-band refinement factors) and the
wavelength advances so consecutive packets tile the stellar luminosity.
Because the ladder depends only on the spectrum, we precompute the whole
packet list (lam_i, en_i) host-side — a perfect SoA input for the batched
transport.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import constants as c
from ..utils import planck


@dataclasses.dataclass
class Star:
    mass: float = 0.6          # Msun
    radius: float = 1.0        # Rsun
    T: float = 4000.0          # K
    lam: np.ndarray = None     # [n] angstrom, ascending
    vals: np.ndarray = None    # [n] erg/s/angstrom
    lumi: float = 0.0
    lumi_Xray: float = 0.0
    T_Xray: float = 1e7
    E0_Xray: float = 0.1       # keV
    E1_Xray: float = 10.0

    def luminosity(self, lam1=None, lam2=None):
        lam, vals = self.lam, self.vals
        if lam1 is not None:
            # trapezoids fully inside [lam1, lam2] (reference
            # get_stellar_luminosity, montecarlo.f90:1217-1234)
            keep = (lam[:-1] >= lam1) & (lam[:-1] <= lam2) \
                & (lam[1:] >= lam1) & (lam[1:] <= lam2)
        else:
            keep = np.ones(len(lam) - 1, dtype=bool)
        seg = 0.5 * (vals[1:] + vals[:-1]) * np.diff(lam)
        return float(seg[keep].sum())


def blackbody_star(T, radius, lam0=100.0, lam1=1e8, nlam=2000, **kw) -> Star:
    lam = np.logspace(np.log10(lam0), np.log10(lam1), nlam)
    coeff = 4.0 * np.pi ** 2 * (radius * c.Rsun_CGS) ** 2
    # numpy variant: host-side table, must not run on the accelerator
    vals = planck.B_lambda_np(T, lam * c.Angstrom2cm) * coeff \
        * c.Angstrom2cm
    st = Star(T=T, radius=radius, lam=lam, vals=vals, **kw)
    st.lumi = st.luminosity()
    return st


def merge_spectra(base_lam, base_vals, over_lam, over_vals):
    """Union-grid merge; the overlay replaces the base wherever the
    overlay has coverage (reference merge_stellar_spectrum,
    disk.f90:629-650: s1 'has a higher priority over s2')."""
    lam = np.union1d(base_lam, over_lam)
    vals = np.interp(lam, base_lam, base_vals)
    inside = (lam >= over_lam[0]) & (lam <= over_lam[-1])
    vals[inside] = np.interp(lam[inside], over_lam, over_vals)
    return lam, vals


def load_star_spectrum(path: str, *, T: float, radius: float,
                       lam0: float = 100.0, lam1: float = 1e8,
                       **kw) -> Star:
    """File spectrum MERGED INTO the photosphere blackbody.

    The reference always builds the full-range blackbody first and then
    overlays the observed spectrum on its own wavelength range
    (disk.f90:462-510: make_stellar_spectrum -> merge X-ray -> merge
    file).  Observed input files often cover only the UV (e.g.
    tw_hya_spec_combined.dat spans 909-3150 A); using the file alone
    would leave the star with no optical/IR photosphere and starve the
    disk of its main dust-heating channel.

    T and radius are REQUIRED (the blackbody photosphere is not
    optional); [lam0, lam1] is the blackbody range in angstrom — the
    reference ties it to the dust opacity table range (disk.f90:465-468),
    so callers with tables should pass that range."""
    rows = []
    with open(path) as f:
        for line in f:
            if line.strip() and not line.startswith("!"):
                t = line.split()
                rows.append((float(t[0]), float(t[1])))
    arr = np.array(rows)
    order = np.argsort(arr[:, 0])
    bb = blackbody_star(T, radius, lam0=lam0, lam1=lam1)
    lam, vals = merge_spectra(bb.lam, bb.vals,
                              arr[order, 0], arr[order, 1])
    st = Star(T=T, radius=radius, lam=lam, vals=vals, **kw)
    st.lumi = st.luminosity()
    return st


def xray_spectrum(star: Star, nlam=200) -> tuple[np.ndarray, np.ndarray]:
    """Thermal X-ray spectrum normalized to star.lumi_Xray."""
    E0, E1 = star.E0_Xray, star.E1_Xray
    lam_min = c.hPlanck_CGS * c.SpeedOfLight_CGS / (E1 * c.keV2erg) * 1e8
    lam_max = c.hPlanck_CGS * c.SpeedOfLight_CGS / (E0 * c.keV2erg) * 1e8
    lam = np.logspace(np.log10(lam_min), np.log10(lam_max), nlam)
    E_erg = c.hPlanck_CGS * c.SpeedOfLight_CGS / (lam * 1e-8)
    vals = np.exp(-E_erg / (c.kBoltzmann_CGS * star.T_Xray)) / lam ** 2
    lumi = np.trapezoid(vals, lam)
    vals *= star.lumi_Xray / lumi
    return lam, vals


def merge_xray(star: Star, nlam_xray=200) -> Star:
    """Prepend the X-ray component to the stellar spectrum."""
    if star.lumi_Xray <= 0:
        return star
    lx, vx = xray_spectrum(star, nlam_xray)
    keep = star.lam > lx[-1]
    star.lam = np.concatenate([lx, star.lam[keep]])
    star.vals = np.concatenate([vx, star.vals[keep]])
    star.lumi = star.luminosity()
    return star


def in_band(lam, band):
    lo, hi = band[0] / c.Angstrom2micron, band[1] / c.Angstrom2micron
    return (lam >= lo) & (lam <= hi)


def packet_ladder(star: Star, nph: int, refine_UV=0.2, refine_LyA=0.1,
                  refine_Xray=1e-3, max_packets=20_000_000):
    """Deterministic packet list: wavelengths and energies.

    Walks the spectrum like the reference get_next_lam loop
    (montecarlo.f90:430-447,515-573): base packet energy
    eph = L / nph; packets in the UV/LyA/X-ray bands carry
    eph * refine factor, so those bands get proportionally more packets.
    Returns (lam [angstrom], energy [erg/s]) arrays.
    """
    eph0 = star.lumi / nph
    lam_grid = star.lam
    # piecewise-linear cumulative luminosity C(lam)
    seg = 0.5 * (star.vals[1:] + star.vals[:-1]) * np.diff(lam_grid)
    C = np.concatenate([[0.0], np.cumsum(seg)])

    # split the wavelength axis into refinement-band segments; within each
    # segment packets are equally spaced in cumulative luminosity
    edges_A = sorted(set(
        [lam_grid[0], lam_grid[-1]]
        + [b / c.Angstrom2micron for band in
           (c.lam_range_Xray, c.lam_range_UV, c.lam_range_LyA)
           for b in band]))
    lams, ens = [], []
    total = 0
    for lo, hi in zip(edges_A[:-1], edges_A[1:]):
        if hi <= lam_grid[0] or lo >= lam_grid[-1]:
            continue
        lo = max(lo, lam_grid[0])
        hi = min(hi, lam_grid[-1])
        mid = 0.5 * (lo + hi)
        if in_band(np.array([mid]), c.lam_range_Xray)[0]:
            en = eph0 * refine_Xray
        elif in_band(np.array([mid]), c.lam_range_LyA)[0]:
            en = eph0 * refine_LyA
        elif in_band(np.array([mid]), c.lam_range_UV)[0]:
            en = eph0 * refine_UV
        else:
            en = eph0
        c_lo = np.interp(lo, lam_grid, C)
        c_hi = np.interp(hi, lam_grid, C)
        n_pk = min(int(np.floor((c_hi - c_lo) / en)), max_packets - total)
        if n_pk <= 0:
            continue
        cvals = c_lo + (np.arange(n_pk) + 0.5) * en
        lam_pk = np.interp(cvals, C, lam_grid)
        lams.append(lam_pk)
        ens.append(np.full(n_pk, en))
        total += n_pk
    lam_all = np.concatenate(lams)
    en_all = np.concatenate(ens)
    order = np.argsort(lam_all)
    return lam_all[order], en_all[order]
