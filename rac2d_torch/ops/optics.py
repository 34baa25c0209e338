"""Optical tables for the Monte Carlo transport.

Counterpart of the JAX package's ``ops/optics.py`` (reference:
src/montecarlo.f90:110-210 ``align_optical_data``/``make_global_coll``,
:214-266 ``make_Xray_abs_sca``, :271-302 ``update_gl_optical_OTF``,
:1392-1419 water cross section, :1487-1526 ``make_LUT_Tdust``).

The tables are built in float64 numpy on the host, exactly as the JAX
package builds them; the walk reads float32 copies on the device.  The
extinction is computed on the fly as a sum over interaction channels of
(shared sigma[lam] table) x (per-cell density), the Lyman-alpha cross
section comes from a (lambda, T) table, and dust re-emission samples
precomputed inverse-CDF quantile tables.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .. import constants as c
from ..io import bethell
from ..io.draine import DustMixture
from ..utils import planck


@dataclasses.dataclass
class McConfig:
    """Subset of the reference montecarlo_configure namelist."""
    nph: int = 100_000
    refine_UV: float = 0.2
    refine_LyA: float = 0.1
    refine_Xray: float = 1e-3
    nmax_cross: int = 2_000_000
    nmax_encounter: int = 200_000
    minw: float = 0.0        # min w (= sin of latitude) of emission cone
    maxw: float = 1.0
    ph_init_symmetric: bool = True
    TdustMin: float = 1.0
    TdustMax: float = 2000.0
    nlen_lut: int = 1024
    n_quantile: int = 512    # reemission inverse-CDF resolution
    allow_Xray_scattering: bool = True
    disallow_any_scattering: bool = False
    nlam_xray: int = 100
    n_channel_Lya: int = 200
    dist: float = 100.0      # pc, for SEDs
    # smear poorly-sampled spectral channels of the per-cell MC flux
    # (reference mc_conf%do_fill_blank, data_struct.f90:175)
    do_fill_blank: bool = False
    fill_blank_threshold: int = 3
    # Modified Random Walk (Min et al. 2009; Robitaille 2010): collapse
    # the O((R/mfp)^2)-step random walk deep inside optically thick
    # cells into single diffusion steps (the reference walks every
    # scattering, montecarlo.f90:577)
    use_mrw: bool = True
    mrw_gamma: float = 4.0       # require R0 > gamma * transport mfp
    mrw_lam_min: float = 1e4     # only thermalized (IR) packets, angstrom
    # walk steps per chunk of the streamed pass: the host reads the live
    # count once per chunk and refills or compacts the batch
    steps_per_call: int = 64
    # direction-weighted flux tally (reference SAVE_PHOTON_FIELD_DIR,
    # data_struct.f90:114-116); nothing in the pipeline consumes it
    save_dir_flux: bool = False
    # count diagnostics (photon counts per channel, cell crossings,
    # discrete absorption); forced on by do_fill_blank
    save_counts: bool = False
    # packets transported at once (the streamed pass's batch width)
    max_batch: int = 262_144


class McTables(NamedTuple):
    """Shared (cell-independent) optical tables, float64 numpy."""
    lam: np.ndarray          # [nlam] angstrom ascending (bin left edges)
    is_xray: np.ndarray      # [nlam] bool
    kab: np.ndarray          # [n_dust, nlam] cm^2/g (0 in X-ray band)
    ksc: np.ndarray          # [n_dust, nlam]
    g: np.ndarray            # [n_dust, nlam] HG asymmetry
    xr_gas_abs: np.ndarray   # [nlam] cm^2 per H
    xr_gas_sca: np.ndarray   # [nlam]
    xr_dus_abs0: np.ndarray  # [nlam] cm^2 per H before depletion/shielding
    xr_dus_sca: np.ndarray   # [nlam]
    sigma_h2o: np.ndarray    # [nlam] cm^2
    # Tdust lookup: cumulative integral of kappa_abs * B_lambda
    lut_Tds: np.ndarray      # [nT]
    lut_vals: np.ndarray     # [n_dust, nT]  (erg cm^2 g^-1 s^-1 sr^-1)
    # reemission sampling: lambda-bin index quantiles per (dust, T)
    reemit_q: np.ndarray     # [n_dust, nT, n_quantile] int32
    pmass: np.ndarray        # [n_dust] particle mass g
    # Modified-Random-Walk tables (Min et al. 2009)
    kap_P: np.ndarray        # [n_dust, nT] Planck-mean kappa_abs, cm^2/g
    kap_trR: np.ndarray      # [n_dust, nT] Rosseland-mean transport
    #                          extinction kab + ksc*(1-g), cm^2/g
    mrw_lnx: np.ndarray      # [n_mrw] inverse CDF of the first-passage
    #                          time: uniform u -> ln(y)
    lam_seg: object = None   # LamSeg closed-form lambda->bin descriptor


def lam_to_keV(lam_A):
    return c.hPlanck_CGS * c.SpeedOfLight_CGS / (np.asarray(lam_A) * 1e-8) \
        / c.keV2erg


def lya_sigma(lam_A, T):
    """Lyman-alpha scattering cross section at gas temperature T, on
    tensors (reference make_H_Lya / update_gl_optical_OTF,
    src/montecarlo.f90:1423-1475, 271-302)."""
    from ..utils.voigt import voigt
    dnu_th = c.LyAlpha_nu0 * torch.sqrt(
        8.0 * c.kBoltzmann_SI * T / np.pi / 1.67262158e-27) / 299792458.0
    a = c.LyAlpha_dnul / (2.0 * dnu_th)
    coeff = c.LyAlpha_f12 * np.sqrt(np.pi) \
        * c.electronClassicalRadius_CGS * c.SpeedOfLight_CGS / dnu_th
    nu = 299792458.0 / (lam_A * 1e-10)
    x = torch.abs(nu - c.LyAlpha_nu0) / dnu_th
    return coeff * torch.clamp(voigt(x, a), min=0.0)


class LamSeg(NamedTuple):
    """Closed-form lambda -> bin-index descriptor for the SEGMENTED
    master grid (see master_lam_grid): three log-uniform segments
    (X-ray / mid / high) plus the +-logspace Lyman-alpha ladder."""
    log0: np.ndarray     # [3] ln(first lambda) of xray/mid/high segments
    inv_d: np.ndarray    # [3] 1/dlnlam
    i0: np.ndarray       # [3] global index of each segment start
    n: np.ndarray        # [3] points per segment
    b_mid: float         # first lambda of the mid segment
    b_lya: float         # first lambda of the Lya ladder
    b_high: float        # first lambda of the high segment
    lya_i0: int          # global index of the first Lya point
    lya_n2: int          # points per Lya side
    lya_a: float         # log10(x_min) of the ladder
    lya_inv_d: float     # 1/dlog10(x)
    lya_K: float         # |dx/dlam| at line center, 1/angstrom
    lam0: float          # Lya line center, angstrom


def f32(x):
    """x rounded to float32, as a Python float (or numpy array)."""
    if np.ndim(x):
        return np.asarray(x, np.float32).astype(np.float64)
    return float(np.float32(x))


def lam_to_bin(seg: LamSeg, lam, seg_f32: bool):
    """Bin index i such that lam_grid[i] <= lam < lam_grid[i+1]
    (clipped at the ends), in closed form, for a float32 tensor lam.

    seg_f32 picks the precision of the three log-uniform segments: the
    walk casts those constants to float32 first (``_WalkSetup``), while
    the terminal fold reads the float64 host values and so compares and
    indexes in float64.  The Lyman-alpha ladder runs in float32 either
    way, as in the JAX package."""
    ll = torch.log(torch.clamp(lam, min=1e-30))
    if seg_f32:
        llk, lamk, cv = ll, lam, f32
    else:
        llk, lamk, cv = ll.double(), lam.double(), float

    def lu(k):
        j = torch.floor((llk - cv(seg.log0[k])) * cv(seg.inv_d[k])) \
            .to(torch.int32)
        return int(seg.i0[k]) + torch.clamp(j, 0, int(seg.n[k]) - 1)

    i = lu(0)
    i = torch.where(lamk >= cv(seg.b_mid), lu(1), i)
    # Lyman-alpha ladder: x = |nu-nu0|/dnu_th = 10^(a + m/inv_d), dx from
    # the wavelength difference (float32-stable near the core)
    dl = seg.lam0 - lam
    adx = torch.abs(dl) * seg.lya_K * (seg.lam0 / lam)
    t = (torch.log10(torch.clamp(adx, min=1e-30)) - seg.lya_a) \
        * f32(seg.lya_inv_d)
    n2 = int(seg.lya_n2)
    m_pos = torch.clamp(torch.ceil(t), 0, n2 - 1).to(torch.int32)
    k_pos = n2 - 1 - m_pos
    m_neg = torch.clamp(torch.floor(t), 0, n2 - 1).to(torch.int32)
    x_min = 10.0 ** seg.lya_a
    k_neg = torch.where(adx < x_min, n2 - 1, n2 + m_neg)
    i_lya = int(seg.lya_i0) + torch.where(dl > 0, k_pos, k_neg)
    i = torch.where(lamk >= cv(seg.b_lya), i_lya, i)
    i = torch.where(lamk >= cv(seg.b_high), lu(2), i)
    return i.to(torch.int32)


def tdust_bin(lut_Tds, Td):
    """searchsorted(lut_Tds, Td) in closed form: the Tdust LUT grid is
    log-uniform by construction (build_tables)."""
    nT = lut_Tds.shape[0]
    T0 = lut_Tds[0]
    dln = (torch.log(lut_Tds[-1]) - torch.log(T0)) / (nT - 1)
    t = (torch.log(torch.clamp(Td, min=1e-30)) - torch.log(T0)) / dln
    return torch.clamp(torch.ceil(t), 0, nT - 1).to(torch.int64)


def master_lam_grid(dusts: list[DustMixture], cfg: McConfig,
                    T_lya_profile=1000.0):
    """SEGMENTED master wavelength grid: X-ray logspace | mid logspace |
    fine Lyman-alpha channels | high logspace.  The dust-table regions
    are resampled onto log-uniform segments at >= the dust table's own
    resolution, so lambda -> bin is closed form (lam_to_bin).
    Returns (lam, LamSeg)."""
    lam_d = dusts[0].lam
    # X-ray segment
    xr0 = c.lam_range_Xray[0] / c.Angstrom2micron
    xr1 = c.lam_range_Xray[1] / c.Angstrom2micron
    lam_x = np.logspace(np.log10(xr0), np.log10(xr1), cfg.nlam_xray)
    # Lyman-alpha ladder, +-2000 thermal widths like the reference
    dnu_th = c.LyAlpha_nu0 * np.sqrt(
        8.0 * c.kBoltzmann_SI * T_lya_profile / np.pi / 1.67262158e-27) \
        / 299792458.0
    n2 = cfg.n_channel_Lya // 2
    lya_a = -3.0
    lya_hi = np.log10(2e3)
    x = np.logspace(lya_a, lya_hi, n2)
    nus = c.LyAlpha_nu0 + np.concatenate([-x[::-1], x]) * dnu_th
    lam_lya = np.sort(299792458.0 / nus * 1e10)
    lam0 = 299792458.0 / c.LyAlpha_nu0 * 1e10

    # mid / high segments: log-uniform at >= dust-table resolution
    dens_d = (len(lam_d) - 1) / np.log10(lam_d[-1] / lam_d[0])
    dens = max(dens_d, 40.0)
    lam_max = max(lam_d[-1], 1.0001 * lam_lya[-1])
    b_mid = xr1 * 1.0005
    b_high = lam_lya[-1] * 1.0005
    n_mid = max(int(np.ceil(np.log10(lam_lya[0] / b_mid) * dens)), 8)
    n_high = max(int(np.ceil(np.log10(lam_max / b_high) * dens)), 8)
    # endpoint=False: the next segment's first point closes the last bin
    lam_m = np.logspace(np.log10(b_mid), np.log10(lam_lya[0]), n_mid,
                        endpoint=False)
    lam_h = np.logspace(np.log10(b_high), np.log10(lam_max), n_high)

    lam = np.concatenate([lam_x, lam_m, lam_lya, lam_h])
    assert np.all(np.diff(lam) > 0), "master grid must be ascending"
    seg = LamSeg(
        log0=np.log(np.array([lam_x[0], lam_m[0], lam_h[0]])),
        inv_d=np.array([
            (cfg.nlam_xray - 1) / np.log(lam_x[-1] / lam_x[0]),
            n_mid / np.log(lam_lya[0] / lam_m[0]),
            (n_high - 1) / np.log(lam_h[-1] / lam_h[0]),
        ]),
        i0=np.array([0, cfg.nlam_xray, cfg.nlam_xray + n_mid + 2 * n2],
                    dtype=np.int32),
        n=np.array([cfg.nlam_xray, n_mid, n_high], dtype=np.int32),
        b_mid=lam_m[0], b_lya=lam_lya[0], b_high=lam_h[0],
        lya_i0=cfg.nlam_xray + n_mid, lya_n2=n2, lya_a=lya_a,
        lya_inv_d=(n2 - 1) / (lya_hi - lya_a),
        lya_K=float(c.LyAlpha_nu0 / (dnu_th * lam0)),
        lam0=lam0)
    return lam, seg


def mrw_lnx_table(n: int = 256, n_terms: int = 64):
    """Inverse CDF of the diffusion first-passage time from the center of
    a sphere (Min et al. 2009 eq. 8): the escape-time CDF is
    P(t) = 2 sum_n (-1)^{n+1} y^{n^2} with y = exp(-t/t0),
    t0 = 3 R0^2 / (pi^2 c mfp).  Returns ln(y) sampled at n uniform
    quantiles; the traveled path is ct = -3 R0^2/(pi^2 mfp) ln(y)."""
    a = np.logspace(-6, np.log10(60.0), 4001)        # a = -ln y
    S = np.empty_like(a)
    big = a >= 0.7
    # direct alternating series (converges fast for a >= ~0.7)
    ns = np.arange(1, n_terms + 1)
    sgn = np.where(ns % 2 == 1, 1.0, -1.0)
    S[big] = 2.0 * (sgn[None, :]
                    * np.exp(-a[big][:, None] * (ns * ns)[None, :])).sum(1)
    # small a: the truncated series is non-monotone; use the Jacobi
    # theta modular transform S = 1 - sqrt(pi/a) theta2(exp(-pi^2/a))
    q = np.exp(-np.pi ** 2 / a[~big])
    m = np.arange(0, 8)
    th2 = 2.0 * (q[:, None] ** (((m + 0.5) ** 2))[None, :]).sum(1)
    S[~big] = 1.0 - np.sqrt(np.pi / a[~big]) * th2
    S = np.clip(S, 0.0, 1.0)
    # S(a) is the survival function (decreasing in a); sample u = S
    u = (np.arange(n) + 0.5) / n
    a_of_u = np.interp(u, S[::-1], a[::-1])
    return -a_of_u


def build_tables(dusts: list[DustMixture], cfg: McConfig,
                 h2o_lam=None, h2o_sigma=None) -> McTables:
    lam, lam_seg = master_lam_grid(dusts, cfg)
    nlam = len(lam)
    n_dust = len(dusts)
    E = lam_to_keV(lam)
    xr_lo = c.lam_range_Xray[0] / c.Angstrom2micron
    xr_hi = c.lam_range_Xray[1] / c.Angstrom2micron
    is_xray = (lam >= xr_lo) & (lam <= xr_hi)

    kab = np.zeros((n_dust, nlam))
    ksc = np.zeros((n_dust, nlam))
    g = np.zeros((n_dust, nlam))
    for i, d in enumerate(dusts):
        kab[i] = np.interp(lam, d.lam, d.kab)
        ksc[i] = np.interp(lam, d.lam, d.ksc)
        g[i] = np.interp(lam, d.lam, d.g)
        # X-ray band: dust optics replaced by Bethell cross sections and a
        # strongly forward-peaked g (reference align_optical_data,
        # montecarlo.f90:130-153)
        mu_med = np.cos(np.minimum(1.0, 0.1 / 180.0 / np.maximum(E, 1e-10))
                        * np.pi)
        g[i] = np.where(is_xray, np.sqrt(np.maximum(mu_med, 0.0)), g[i])
        kab[i] = np.where(is_xray, 0.0, kab[i])
        ksc[i] = np.where(is_xray, 0.0, ksc[i])

    xr_gas_abs = np.where(is_xray, bethell.sigma_gas(E), 0.0)
    xr_gas_sca = np.where(
        is_xray & cfg.allow_Xray_scattering,
        c.ThomsonScatterCross_CGS * (1.0 + 1.0 / 6.0), 0.0)
    xr_dus_abs0 = np.where(is_xray, bethell.sigma_dust_raw(E), 0.0)
    xr_dus_sca = np.where(
        is_xray & cfg.allow_Xray_scattering,
        1.3e-22 / (E ** 1.8 + 0.4), 0.0)

    sigma_h2o = np.zeros(nlam)
    if h2o_lam is not None:
        sigma_h2o = np.interp(lam, h2o_lam, h2o_sigma, left=0.0, right=0.0)

    if cfg.disallow_any_scattering:
        # debugging switch: pure-absorption transport (reference
        # mc_conf%disallow_any_scattering)
        ksc[:] = 0.0
        xr_gas_sca[:] = 0.0
        xr_dus_sca[:] = 0.0

    # Tdust LUT: cumulative integral over lambda of kab * B_lambda
    nT = cfg.nlen_lut
    Tds = np.logspace(np.log10(cfg.TdustMin), np.log10(cfg.TdustMax), nT)
    lam_cm = lam * c.Angstrom2cm
    dlam = np.diff(lam_cm)
    lam_mid = 0.5 * (lam_cm[1:] + lam_cm[:-1])
    lut_vals = np.zeros((n_dust, nT))
    reemit_q = np.zeros((n_dust, nT, cfg.n_quantile), dtype=np.int32)
    kap_P = np.zeros((n_dust, nT))
    kap_trR = np.zeros((n_dust, nT))
    qs = (np.arange(cfg.n_quantile) + 0.5) / cfg.n_quantile
    for i in range(n_dust):
        kmid = 0.5 * (kab[i][1:] + kab[i][:-1])
        smid = 0.5 * (ksc[i][1:] + ksc[i][:-1])
        gmid = 0.5 * (g[i][1:] + g[i][:-1])
        ktr = kmid + smid * (1.0 - gmid)      # transport extinction
        for t in range(nT):
            B = planck.B_lambda_np(Tds[t], lam_mid)
            seg = dlam * kmid * B
            cum = np.concatenate([[0.0], np.cumsum(seg)])
            tot = cum[-1]
            lut_vals[i, t] = tot
            if tot > 0:
                reemit_q[i, t] = np.clip(
                    np.searchsorted(cum / tot, qs) - 1, 0, nlam - 2)
            # Planck mean (kappa_abs B-weighted) and Rosseland mean of
            # the transport extinction (dB/dT-weighted harmonic mean)
            wB = dlam * B
            sB = wB.sum()
            if sB > 0:
                kap_P[i, t] = tot / sB
            xx = np.clip(c.hPlanck_CGS * c.SpeedOfLight_CGS
                         / (lam_mid * c.kBoltzmann_CGS * Tds[t]), 0, 700.0)
            # dB/dT = B * x e^x / ((e^x - 1) T)
            dBdT = B * xx / (-np.expm1(-xx)) / Tds[t]
            wR = dlam * dBdT
            # harmonic mean restricted to bands with opacity (the dust
            # kappa is zero in the X-ray band)
            valid = (wR > 0) & (ktr > 0)
            sR = np.where(valid, wR, 0.0).sum()
            den = np.where(valid, wR / np.maximum(ktr, 1e-300), 0.0).sum()
            if sR > 0 and den > 0:
                kap_trR[i, t] = sR / den
    return McTables(
        lam=lam, is_xray=is_xray, kab=kab, ksc=ksc, g=g,
        xr_gas_abs=xr_gas_abs, xr_gas_sca=xr_gas_sca,
        xr_dus_abs0=xr_dus_abs0, xr_dus_sca=xr_dus_sca,
        sigma_h2o=sigma_h2o, lut_Tds=Tds, lut_vals=lut_vals,
        reemit_q=reemit_q,
        pmass=np.array([d.pmass for d in dusts]),
        kap_P=kap_P, kap_trR=kap_trR, mrw_lnx=mrw_lnx_table(),
        lam_seg=lam_seg)


def tdust_from_energy(tab: McTables, idust: int, val):
    """Invert the cumulative-emission LUT: val = en_gain/(4 pi m_dust)
    -> Tdust, in float64 (reference get_Tdust_from_LUT,
    montecarlo.f90:856-930)."""
    vals = torch.as_tensor(tab.lut_vals[idust], dtype=torch.float64,
                           device=val.device)
    Tds = torch.as_tensor(tab.lut_Tds, dtype=torch.float64,
                          device=val.device)
    val = val.to(torch.float64)
    n = vals.shape[0]
    i = torch.clamp(torch.searchsorted(vals, val.contiguous()), 1, n - 1)
    t = (val - vals[i - 1]) / torch.clamp(vals[i] - vals[i - 1], min=1e-300)
    T = Tds[i - 1] + torch.clamp(t, 0.0, 1.0) * (Tds[i] - Tds[i - 1])
    T = torch.where(val <= vals[0],
                    Tds[0] * val / torch.clamp(vals[0], min=1e-300), T)
    T = torch.where(val >= vals[-1], Tds[-1], T)
    return T
