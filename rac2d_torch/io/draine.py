"""Dust optical properties: Draine-format .opti tables + MRN size averaging.

Rebuild of the reference dust-optics pipeline (reference:
src/load_Draine_dusts.f90:258-306 ``load_Draine_dust`` — per-radius
Q_abs/Q_sca/g tables converted to cross sections pi r^2 Q in micron^2;
:108-170 ``mix_rawdusts``; src/disk.f90:653-738 ``make_dusts_data`` and
:3522-3552 ``calc_dust_MRN_par`` — power-law size-distribution averaging
into per-gram opacities).  Host-side numpy; outputs feed the MC optics
tables.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import constants as c


@dataclasses.dataclass
class RawDust:
    name: str
    r: np.ndarray        # [n_rad] micron
    lam: np.ndarray      # [n_lam] micron, ascending
    ab: np.ndarray       # [n_lam, n_rad] micron^2 (pi r^2 Q_abs)
    sc: np.ndarray       # [n_lam, n_rad]
    g: np.ndarray        # [n_lam, n_rad]


@dataclasses.dataclass
class DustMixture:
    """Size-averaged opacity of one dust component."""
    lam: np.ndarray      # [n_lam] angstrom, ascending
    kab: np.ndarray      # [n_lam] cm^2 / g
    ksc: np.ndarray      # [n_lam]
    g: np.ndarray        # [n_lam]
    pmass: float         # mean particle mass, g
    rav: float           # <r>, micron
    r2av: float          # <r^2>
    r3av: float          # <r^3>
    rho_material: float  # bulk density g/cm^3


def load_opti(path: str) -> RawDust:
    with open(path) as f:
        f.readline()
        name = f.readline().strip()
        f.readline()
        toks = f.readline().split()
        n_rad = int(toks[0])
        toks = f.readline().split()
        n_lam = int(toks[0])
        f.readline()
        r = np.zeros(n_rad)
        lam = None
        ab = np.zeros((n_lam, n_rad))
        sc = np.zeros((n_lam, n_rad))
        g = np.zeros((n_lam, n_rad))
        for i in range(n_rad):
            r[i] = float(f.readline().split()[0])
            f.readline()  # column header
            block = np.array([f.readline().split()[:4]
                              for _ in range(n_lam)], dtype=float)
            if lam is None:
                lam = block[:, 0]
            ab[:, i] = block[:, 1] * (np.pi * r[i] ** 2)
            sc[:, i] = block[:, 2] * (np.pi * r[i] ** 2)
            g[:, i] = block[:, 3]
            f.readline()  # blank separator
    if lam[0] > lam[-1]:   # store ascending
        lam = lam[::-1]
        ab = ab[::-1]
        sc = sc[::-1]
        g = g[::-1]
    return RawDust(name=name, r=r, lam=lam, ab=ab, sc=sc, g=g)


def mix_raw(dusts: list[RawDust], weights) -> RawDust:
    """Weighted mixture of materials sharing the same (r, lam) grids."""
    w = np.asarray(weights, dtype=float)
    w = w / w.sum()
    base = dusts[0]
    ab = sum(wi * d.ab for wi, d in zip(w, dusts))
    sc = sum(wi * d.sc for wi, d in zip(w, dusts))
    g = sum(wi * d.g for wi, d in zip(w, dusts))
    return RawDust(name="mix", r=base.r, lam=base.lam, ab=ab, sc=sc, g=g)


def _mrn_moments(rmin, rmax, n):
    """<r>, <r^2>, <r^3> of dn/dr ~ r^-n on [rmin, rmax]
    (reference calc_dust_MRN_par, src/disk.f90:3522-3552)."""
    small = 1e-6
    t1 = rmin ** (1.0 - n)
    t2 = rmax ** (1.0 - n)
    norm = np.log(rmax / rmin) if abs(n - 1.0) <= small \
        else (t2 - t1) / (1.0 - n)

    def mom(k):
        if abs(n - (k + 1.0)) <= small:
            return np.log(rmax / rmin) / norm
        return (t2 * rmax ** k - t1 * rmin ** k) / ((k + 1.0 - n) * norm)

    return mom(1), mom(2), mom(3)


def _clipped_trapz(x, y, a, b):
    """Trapezoidal integral of y(x) over [a, b] with linear interpolation
    at the clip points (reference discrete_integral)."""
    a = max(a, x[0])
    b = min(b, x[-1])
    if b <= a:
        return 0.0
    xs = np.concatenate([[a], x[(x > a) & (x < b)], [b]])
    ys = np.interp(xs, x, y)
    return np.trapezoid(ys, xs)


def mrn_average(raw: RawDust, rmin: float, rmax: float, n: float,
                rho_material: float) -> DustMixture:
    """Integrate cross sections over the MRN distribution -> cm^2/g."""
    rmax = max(rmax, rmin * 1.0001)
    rav, r2av, r3av = _mrn_moments(rmin, rmax, n)
    pmass = 4.0 * np.pi / 3.0 * r3av * c.micron2cm ** 3 * rho_material
    wdist = raw.r ** (-n)
    swei = _clipped_trapz(raw.r, wdist, rmin, rmax)
    n_lam = len(raw.lam)
    kab = np.zeros(n_lam)
    ksc = np.zeros(n_lam)
    g = np.zeros(n_lam)
    for j in range(n_lam):
        kab[j] = _clipped_trapz(raw.r, wdist * raw.ab[j], rmin, rmax)
        ksc[j] = _clipped_trapz(raw.r, wdist * raw.sc[j], rmin, rmax)
        g[j] = _clipped_trapz(raw.r, wdist * raw.g[j], rmin, rmax)
    kab = kab / swei * c.micron2cm ** 2 / pmass
    ksc = ksc / swei * c.micron2cm ** 2 / pmass
    g = g / swei
    return DustMixture(lam=raw.lam / c.Angstrom2micron, kab=kab, ksc=ksc,
                       g=g, pmass=pmass, rav=rav, r2av=r2av, r3av=r3av,
                       rho_material=rho_material)


def load_h2o_cross_section(path: str):
    """Water UV absorption cross section (reference
    src/montecarlo.f90:1392-1419; two header rows, then
    lam1 lam2 sigma/1e-18)."""
    rows = []
    with open(path) as f:
        f.readline()
        f.readline()
        for line in f:
            t = line.split()
            if len(t) >= 3:
                rows.append(((float(t[0]) + float(t[1])) * 0.5,
                             float(t[2]) * 1e-18))
    arr = np.array(rows)
    return arr[:, 0], arr[:, 1]   # lam [angstrom], sigma [cm^2]
