"""Vectorized reaction-rate coefficients, batch-native.

Counterpart of the JAX package's ``ops/rates.py`` (reference
src/chemistry.f90:591-966 ``chem_cal_rates``).  Every itype's formula is
evaluated for all its reactions at once as masked tensor ops, with the
per-reaction discrete decisions resolved on the host into static index
tensors by :func:`build_rate_tables`.  Where the JAX package vmaps one
cell, the functions here take a leading lane axis: every field of a
:class:`CellEnv` is ``[B]`` (``[B, 5]`` for the shielding factors) and the
result is ``k[B, nR]``.

k is in yr^-1 (1-body) or yr^-1 per unit fractional abundance (2-body,
already multiplied by n_gas), exactly like the reference
(src/chemistry.f90:936-942).  Everything runs in float64.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import constants as c
from ..io.umist import ChemNet, COSMICRAY_INTENSITY_0, \
    COSMIC_DESORP_PREFACTOR, COSMIC_DESORP_GRAIN_T

F64 = torch.float64


class CellEnv(NamedTuple):
    """Per-cell physical environment entering the rate formulas
    (reference ``chem_params``, src/data_struct.f90:316-442).  Fields are
    float64 tensors with a leading lane axis (or 0-d for one cell)."""
    Tgas: torch.Tensor
    Tdust: torch.Tensor
    n_gas: torch.Tensor
    zeta_cosmicray_H2: torch.Tensor
    zeta_Xray_H2: torch.Tensor
    Ncol_toISM: torch.Tensor
    Av_toISM: torch.Tensor
    Av_toStar: torch.Tensor
    G0_UV_toISM: torch.Tensor
    G0_UV_toStar: torch.Tensor
    G0_UV_H2phd: torch.Tensor
    G0_UV_toStar_photoDesorb: torch.Tensor
    phflux_Lya: torch.Tensor
    omega_albedo: torch.Tensor
    # self-shielding factors, order [none, H2, CO, H2O, OH]
    f_selfshielding_toISM: torch.Tensor    # [..., 5]
    f_selfshielding_toStar: torch.Tensor   # [..., 5]
    GrainRadius_CGS: torch.Tensor
    sigdust_ave: torch.Tensor
    ndust_tot: torch.Tensor
    ratioDust2HnucNum: torch.Tensor
    SitesPerGrain: torch.Tensor

    @staticmethod
    def default(device, **kw):
        """A neutral single-cell environment (0-d fields); override fields
        via kw.  Stack cells with ``utils.tree.stack``."""
        d = dict(
            Tgas=10.0, Tdust=10.0, n_gas=1e5,
            zeta_cosmicray_H2=1.36e-17, zeta_Xray_H2=0.0,
            Ncol_toISM=0.0, Av_toISM=10.0, Av_toStar=10.0,
            G0_UV_toISM=1.0, G0_UV_toStar=0.0, G0_UV_H2phd=0.0,
            G0_UV_toStar_photoDesorb=0.0, phflux_Lya=0.0,
            omega_albedo=0.5,
            f_selfshielding_toISM=np.ones(5),
            f_selfshielding_toStar=np.ones(5),
            GrainRadius_CGS=1e-5, sigdust_ave=np.pi * 1e-10,
            ndust_tot=1e5 * 2.8 * c.mProton_CGS * 0.01
            / (4.0 / 3.0 * np.pi * 1e-15 * 2.0),
            ratioDust2HnucNum=0.0, SitesPerGrain=4e5,
        )
        d.update(kw)
        if "ratioDust2HnucNum" not in kw:
            d["ratioDust2HnucNum"] = d["ndust_tot"] / d["n_gas"]
        return CellEnv(**{k: torch.as_tensor(np.asarray(v, np.float64),
                                             device=device)
                          for k, v in d.items()})


class RateTables(NamedTuple):
    """Static per-reaction data for rate evaluation (tensors)."""
    abc: torch.Tensor           # [nR, 3]
    T_range: torch.Tensor       # [nR, 2]
    itype: torch.Tensor         # [nR]
    is_two_body_gas: torch.Tensor   # [nR] bool: n_reac==2 and itype<60
    shield_code: torch.Tensor       # [nR] 0 none, 1 H2, 2 CO, 3 H2O, 4 OH
    is_H2_photo: torch.Tensor       # [nR] bool (itype 3 with reac1 == H2)
    ion_mass: torch.Tensor          # [nR] mass of non-grain reactant (21)
    ion_neg_posi: torch.Tensor      # [nR] bool: charge product == -1 (21)
    mass1: torch.Tensor             # [nR] mass_num of reac1
    vib1: torch.Tensor              # [nR] vib freq of reac1 (0 where undef)
    edes1: torch.Tensor             # [nR] Edesorb of reac1
    vib2: torch.Tensor              # [nR]
    edes2: torch.Tensor             # [nR]
    mass2: torch.Tensor             # [nR]
    is_gH_63: torch.Tensor          # [nR] bool: itype 63 with reac1 == gH
    i_desorb_gH: int                # reaction index of gH desorption or -1
    i_adsorb_H: int                 # reaction index of H adsorption or -1
    dupli_group: torch.Tensor       # [nR] (-1 no group)
    n_dupli_groups: int
    reac1: torch.Tensor             # [nR] species idx (clipped >= 0)
    reac2: torch.Tensor


SHIELD_SPECIES = {"H2": 1, "CO": 2, "H2O": 3, "OH": 4}

# exp() arguments are clamped below at the true f64 underflow limit
# (exp(-745) ~ 5e-324, so the result equals unclamped f64 exp) and above
# at +222 as an overflow guard for insane inputs
_EXP_LO = -745.0


def _exp(x):
    return torch.exp(torch.clamp(x, _EXP_LO, c.max_exp))


def build_rate_tables(net: ChemNet, device) -> RateTables:
    nR = net.n_reactions
    itype = net.itype
    is_two_body_gas = (net.n_reac == 2) & (itype < 60)

    shield_code = np.zeros(nR, dtype=np.int64)
    is_H2_photo = np.zeros(nR, dtype=bool)
    for i in range(nR):
        # self-shielding applies only to photo (PH) / Lyman-alpha (LA)
        # reactions (reference src/chemistry.f90:1007-1063)
        if net.ctype[i] in ("PH", "LA"):
            name = net.species[net.reac[i, 0]] if net.reac[i, 0] >= 0 else ""
            shield_code[i] = SHIELD_SPECIES.get(name, 0)
        if itype[i] == 3 and net.reac[i, 0] >= 0 \
                and net.species[net.reac[i, 0]] == "H2":
            is_H2_photo[i] = True

    # itype 21: which reactant is the ion/neutral (non-grain) partner
    ion_mass = np.zeros(nR)
    ion_neg_posi = np.zeros(nR, dtype=bool)
    for i in range(nR):
        if itype[i] != 21:
            continue
        id1, id2 = net.reac[i, 0], net.reac[i, 1]
        if net.elements[id1, 2] == 0:
            id3 = id1
        elif net.elements[id2, 2] == 0:
            id3 = id2
        else:
            raise ValueError(f"type-21 reaction {i} has no non-grain reactant")
        ion_mass[i] = net.mass_num[id3]
        ch = net.elements[id1, 0] * net.elements[id2, 0]
        if ch == -1:
            ion_neg_posi[i] = True
        elif ch != 0:
            raise ValueError(f"type-21 reaction {i} charge problem")

    r1 = np.clip(net.reac[:, 0], 0, None)
    r2 = np.clip(net.reac[:, 1], 0, None)
    i_gH = net.idx.get("gH", -1)
    i_H = net.idx.get("H", -1)
    i_desorb_gH = -1
    i_adsorb_H = -1
    for i in range(nR):
        if itype[i] == 62 and net.reac[i, 0] == i_gH:
            i_desorb_gH = i
        if itype[i] == 61 and net.reac[i, 0] == i_H:
            i_adsorb_H = i

    def f(a):
        a = np.asarray(a)
        if a.dtype.kind == "f":
            a = a.astype(np.float64)
        return torch.as_tensor(a, device=device)

    return RateTables(
        abc=f(net.abc), T_range=f(net.T_range), itype=f(itype),
        is_two_body_gas=f(is_two_body_gas), shield_code=f(shield_code),
        is_H2_photo=f(is_H2_photo), ion_mass=f(ion_mass),
        ion_neg_posi=f(ion_neg_posi), mass1=f(net.mass_num[r1]),
        vib1=f(np.nan_to_num(net.vib_freq[r1])),
        edes1=f(np.nan_to_num(net.Edesorb[r1])),
        vib2=f(np.nan_to_num(net.vib_freq[r2])),
        edes2=f(np.nan_to_num(net.Edesorb[r2])), mass2=f(net.mass_num[r2]),
        is_gH_63=f((itype == 63) & (net.reac[:, 0] == i_gH)),
        i_desorb_gH=int(i_desorb_gH), i_adsorb_H=int(i_adsorb_H),
        dupli_group=f(net.dupli_group),
        n_dupli_groups=int(net.dupli_group.max()) + 1,
        reac1=f(r1), reac2=f(r2),
    )


def _sticking_coeff(mass_num, T):
    """Chaabouni 2012-style sticking coefficient (reference
    src/chemistry.f90:1068-1086): S = (1 + beta r) / (1 + r)^beta with
    beta=2.5, r = T / (m * T0_H), T0_H = (52 + 25) / 2."""
    T0 = mass_num * 38.5
    r = T / T0
    return (1.0 + 2.5 * r) / ((1.0 + r) ** 2 * torch.sqrt(1.0 + r))


def _mobility(vibfreq, mass_num, Edesorb, Tdust, diff2des):
    """Surface hopping rate: thermal hop or tunneling, whichever is faster
    (reference src/chemistry.f90:1542-1568; barrier width 1 Angstrom)."""
    tunnel = -2e-8 / c.hbarPlanck_CGS * torch.sqrt(
        2.0 * mass_num * (c.mProton_CGS * c.kBoltzmann_CGS * diff2des)
        * torch.clamp_min(Edesorb, 0.0))
    arg = torch.maximum(-Edesorb * diff2des / Tdust, tunnel)
    out = vibfreq * torch.exp(torch.clamp(arg, _EXP_LO, 0.0))
    return torch.nan_to_num(out)


def _branching_ratio(abc, T_range, Tdust):
    """Reaction-barrier branching ratio with tunneling (reference
    src/chemistry.f90:1571-1590): ABC(1)=prefactor, ABC(2)=barrier width
    in Angstrom, ABC(3)=barrier K, T_range(1) = reduced mass."""
    A, B, C0 = abc[:, 0], abc[:, 1], abc[:, 2]
    tunnel = -2.0 * B * 1e-8 / c.hbarPlanck_CGS * torch.sqrt(
        2.0 * T_range[:, 0] * c.mProton_CGS * c.kBoltzmann_CGS
        * torch.clamp_min(C0, 0.0))
    arg = torch.maximum(-C0 / Tdust, tunnel)
    br = torch.where(C0 != 0.0, A * torch.exp(torch.clamp(arg, _EXP_LO, 0.0)),
                     A)
    return torch.nan_to_num(br)


def _dupli_select(k, d_endpoint, group, n_groups):
    """Winner-takes-all inside each duplicate-reaction group, per lane.

    Reference src/chemistry.f90:944-964: among duplicated reactions only
    the one whose T_range endpoint lies closest to the current Tgas keeps
    its rate; ties resolve to the earliest reaction.  k, d_endpoint:
    [B, nR]; group: [nR].  The two segment minima of the JAX version are
    ``scatter_reduce(amin)`` over the group axis; both are exact, so the
    winners are the same reactions.
    """
    if n_groups == 0:
        return k
    nR = k.shape[-1]
    lead = k.shape[:-1]
    idx = torch.arange(nR, device=k.device)
    seg = torch.where(group >= 0, group, n_groups).expand(lead + (nR,))
    dmin = torch.full(lead + (n_groups + 1,), float("inf"), dtype=k.dtype,
                      device=k.device).scatter_reduce(
        -1, seg, d_endpoint, reduce="amin")
    is_min = (group >= 0) & (d_endpoint == torch.gather(dmin, -1, seg))
    cand_idx = torch.where(is_min, idx, nR)
    winner = torch.full(lead + (n_groups + 1,), nR, dtype=idx.dtype,
                        device=k.device).scatter_reduce(
        -1, seg, cand_idx, reduce="amin")
    keep = (group < 0) | (idx == torch.gather(winner, -1, seg))
    return torch.where(keep, k, 0.0)


def compute_rates(tab: RateTables, env: CellEnv, Tgas, diff2des=0.5,
                  h2_form_use_moeq: bool = False) -> torch.Tensor:
    """Rate coefficients k[B, nR] for B cells at gas temperatures Tgas[B].

    The formulas follow reference src/chemistry.f90:591-966 case by case,
    in float64, written as the JAX package writes them.
    """
    def col(v):          # per-lane scalar -> broadcast against reactions
        return v[..., None]

    T = col(torch.clamp_min(Tgas, 1e-30))
    Td = col(torch.clamp_min(env.Tdust, 1e-30))
    A, B, C0 = tab.abc[:, 0], tab.abc[:, 1], tab.abc[:, 2]
    Tl, Tu = tab.T_range[:, 0], tab.T_range[:, 1]
    it = tab.itype

    def arrh(Te):
        return A * (Te / 300.0) ** B * _exp(-C0 / Te)

    # Pagani 2009 Coulomb-focusing factors (reference :603-620)
    Tred = c.kBoltzmann_SI * T / (
        c.elementaryCharge_SI ** 2 * 8.9875517873681764e9
        / (col(env.GrainRadius_CGS) * 1e-2))
    JNegaPosi = (1.0 + 1.0 / Tred) * (1.0 + torch.sqrt(2.0 / (2.0 + Tred)))
    JChargeNeut = 1.0 + torch.sqrt(c.pi / 2.0 / Tred)

    sig_dust = col(env.sigdust_ave)
    d2h = col(env.ratioDust2HnucNum)
    spg = col(env.SitesPerGrain)
    cr_rel = col(env.zeta_cosmicray_H2) / COSMICRAY_INTENSITY_0 * torch.exp(
        -col(env.Ncol_toISM) / c.cosmicray_attenuate_N)
    xr_rel = col(env.zeta_Xray_H2) / COSMICRAY_INTENSITY_0

    # --- itype 5: modified Arrhenius with T-range clamping for C<0 ---
    Tc = torch.where(C0 < 0.0,
                     torch.where(Tl > T, Tl, torch.where(Tu < T, Tu, T)), T)
    k5 = A * (Tc / 300.0) ** B * _exp(-C0 / Tc)

    # --- itype 6: strict T range ---
    k6 = torch.where((Tl > T) | (Tu < T), 0.0, arrh(T))

    # --- itype 1 / 2,20 (cosmic-ray) ---
    k1 = A * (cr_rel + xr_rel)
    k2 = A * (C0 / (1.0 - col(env.omega_albedo)) * cr_rel + xr_rel)

    # --- itype 3: photo-reactions ---
    fss_ism = env.f_selfshielding_toISM[..., tab.shield_code]
    fss_star = env.f_selfshielding_toStar[..., tab.shield_code]
    term_ism = col(env.G0_UV_toISM) * _exp(-C0 * col(env.Av_toISM)) * fss_ism
    term_star = torch.where(
        tab.is_H2_photo,
        col(env.G0_UV_H2phd) * fss_star,
        col(env.G0_UV_toStar) * _exp(-C0 * col(env.Av_toStar)) * fss_star)
    k3 = A * (term_ism + term_star)

    # --- itype 13: Lyman-alpha driven ---
    k13 = col(env.phflux_Lya) * A * fss_star

    # --- itype 21: ion/neutral + grain ---
    vth21 = torch.sqrt(8.0 * c.kBoltzmann_CGS / c.pi * T
                       / (torch.clamp_min(tab.ion_mass, 1e-30)
                          * c.mProton_CGS))
    k21 = vth21 * sig_dust * torch.where(tab.ion_neg_posi, JNegaPosi,
                                         JChargeNeut)

    # --- itype 0: parametric H2 formation on grains ---
    stick1 = _sticking_coeff(torch.clamp_min(tab.mass1, 1e-30), T)
    vthH = torch.sqrt(8.0 / c.pi * c.kBoltzmann_CGS * T / c.mProton_CGS)
    k0 = 0.5 * stick1 * sig_dust * vthH * d2h

    # --- itype 61: adsorption ---
    vth1 = torch.sqrt(8.0 / c.pi * c.kBoltzmann_CGS * T
                      / (torch.clamp_min(tab.mass1, 1e-30) * c.mProton_CGS))
    k61 = stick1 * A * sig_dust * col(env.ndust_tot) * vth1

    # --- itype 62: thermal + cosmic-ray desorption ---
    kdes = tab.vib1 * (
        _exp(-C0 / Td)
        + COSMIC_DESORP_PREFACTOR * cr_rel
        * torch.exp(-C0 / COSMIC_DESORP_GRAIN_T))
    # top-layer-only correction (reference :848-851)
    k62 = kdes * (spg * d2h)

    # --- itype 63/64: Langmuir-Hinshelwood surface reactions ---
    mob1 = _mobility(tab.vib1, tab.mass1, tab.edes1, Td, diff2des)
    mob2 = _mobility(tab.vib2, tab.mass2, tab.edes2, Td, diff2des)
    br = _branching_ratio(tab.abc, tab.T_range, Td)
    tmp63 = mob1 / spg
    k63 = tmp63 / d2h * br
    if h2_form_use_moeq and tab.i_desorb_gH >= 0 and tab.i_adsorb_H >= 0:
        kdes_gH = kdes[..., tab.i_desorb_gH:tab.i_desorb_gH + 1]
        kads_H = k61[..., tab.i_adsorb_H:tab.i_adsorb_H + 1]
        k63_moeq = tmp63 / (tmp63 + kdes_gH) * kads_H / d2h
        k63 = torch.where(tab.is_gH_63, k63_moeq, k63)
    k64 = (mob1 + mob2) / (spg * d2h) * br

    # --- itype 75: photodesorption ---
    photoyield = A + B * Td
    k75 = (col(env.G0_UV_toStar_photoDesorb) * c.Habing_photon_flux_CGS
           + col(env.G0_UV_toISM) * c.Habing_photon_flux_CGS
           * _exp(-c.UVext2Av * col(env.Av_toISM))) \
        * sig_dust * d2h * photoyield

    k = torch.zeros(T.shape[:-1] + A.shape, dtype=F64, device=A.device)
    for ityp, kv in ((5, k5), (6, k6), (1, k1), (2, k2), (20, k2), (3, k3),
                     (13, k13), (21, k21), (0, k0), (61, k61), (62, k62),
                     (63, k63), (64, k64), (75, k75)):
        k = torch.where(it == ityp, kv, k)

    # dust-dependent rates vanish when there is no dust (reference checks
    # sig_dust <= 1e-30 inside cases 0,21,61,62,63(gH),64,75)
    dustless = sig_dust <= 1e-30
    dust_types = (it == 0) | (it == 21) | (it == 61) | (it == 62) \
        | (it == 64) | (it == 75) | (tab.is_gH_63 & h2_form_use_moeq)
    k = torch.where(dustless & dust_types, 0.0, k)

    # seconds -> years; two-body gas rates scale with n_gas
    k = k * c.SecondsPerYear
    k = torch.where(tab.is_two_body_gas, k * col(env.n_gas), k)

    # duplicate-reaction resolution by T-range proximity
    d_end = torch.minimum(torch.abs(Tl - T), torch.abs(Tu - T))
    return _dupli_select(k, d_end, tab.dupli_group, tab.n_dupli_groups)
