"""Gas thermal balance: 11 heating + 17 cooling processes, batch-native.

Counterpart of the JAX package's ``ops/thermal.py`` (reference
src/heating_cooling.f90:179-1269).  Every process is a function of the
abundance vectors y[B, NEQ], Tgas[B] and the cell environments (fields
with a leading lane axis), evaluated as tensor ops so that it can sit
inside the chemistry ODE right-hand side as the dT/dt equation (reference
src/disk.f90:4653-4657,4739).

The nested-NLTE cooling paths of the reference are replaced by the
analytic and LUT paths the reference itself prefers by default, as in the
JAX package.  ``solve_equilibrium_T`` gives the equilibrium temperature
of the ``evolT=False`` sweep.  The gas-dust energy-exchange modes
(``tdust_iter_tandem`` with ``allow_gas_dust_en_exch``: each dust
component's temperature re-solved with the gas-collision energy included;
``dust_gas_linear_couple``: the gas-dust temperature difference damped by
the dust emission's response) take the Tdust(energy) lookup table of the
optics tables, ``ThermalBalance(tdust_lut=...)``, and run under the JAX
package's conditions.
"""

from __future__ import annotations

import dataclasses
import math
import pathlib
from typing import NamedTuple

import numpy as np
import torch

from .. import constants as c
from .. import defaults
from ..io import tables
from ..io.umist import ChemNet
from ..utils.planck import tau2beta
from .rates import CellEnv

TINY = 1e-100
FRAC_DUST_LOSE_EN = 0.8
F64 = torch.float64


@dataclasses.dataclass(frozen=True)
class HcConfig:
    """Static switches/efficiencies (reference heating_cooling_configure
    namelist defaults, src/heating_cooling.f90:16-39)."""
    use_analytical_CII_OI: bool = True
    use_mygasgraincooling: bool = True
    use_chemicalheatingcooling: bool = True
    use_Xray_heating: bool = True
    use_phdheating_H2: bool = True
    use_phdheating_H2OOH: bool = True
    heating_eff_chem: float = 1.0
    heating_eff_H2form: float = 0.1
    heating_eff_phd_H2: float = 1.0
    heating_eff_phd_H2O: float = 0.1
    heating_eff_phd_OH: float = 0.1
    cooling_gg_coeff: float = 0.3
    # when False, alpha_viscosity in ThermalEnv is the *base* alpha,
    # modulated by the ambipolar-diffusion MRI fit from the instantaneous
    # ion fraction (reference src/disk.f90:30,3415-3427)
    use_fixed_alpha_visc: bool = True
    # gas<->dust energy-exchange modes (reference a_disk flags
    # src/disk.f90:31,35 + tandem Tdust re-solve src/disk.f90:4702-4721);
    # both need a Tdust(energy) LUT passed to ThermalBalance(tdust_lut=...)
    allow_gas_dust_en_exch: bool = False
    tdust_iter_tandem: bool = False
    dust_gas_linear_couple: bool = False


class ThermalEnv(NamedTuple):
    """Extra per-cell fields beyond CellEnv that thermal balance needs
    (reference src/data_struct.f90:316-442).  Leading lane axis; the
    per-dust-component fields are [..., 4]."""
    PAH_abundance: torch.Tensor
    MeanMolWeight: torch.Tensor
    alpha_viscosity: torch.Tensor
    omega_Kepler: torch.Tensor
    velo_width_turb: torch.Tensor      # cm/s
    coherent_length: torch.Tensor      # cm
    Ncol_toStar: torch.Tensor
    Neufeld_G: torch.Tensor
    Neufeld_dv_dz: torch.Tensor        # km s-1 cm-1
    n_dusts: torch.Tensor              # [..., 4]
    sig_dusts: torch.Tensor            # [..., 4]
    Tdusts: torch.Tensor               # [..., 4]
    en_gains: torch.Tensor             # [..., 4] erg/s absorbed per cell
    mdusts_cell: torch.Tensor          # [..., 4] dust mass per cell, g
    volume: torch.Tensor               # AU^3 (kept in AU^3 as in the JAX
    #                                    package; use sites multiply by
    #                                    AU2cm^3 in a range-safe order)

    @staticmethod
    def default(device, **kw):
        d = dict(
            PAH_abundance=c.PAH_abundance_0, MeanMolWeight=1.4,
            alpha_viscosity=0.0, omega_Kepler=0.0, velo_width_turb=1e5,
            coherent_length=1e14, Ncol_toStar=0.0, Neufeld_G=1.0,
            Neufeld_dv_dz=1e-9,
            n_dusts=np.zeros(4), sig_dusts=np.zeros(4),
            Tdusts=np.zeros(4), en_gains=np.full(4, np.inf),
            mdusts_cell=np.zeros(4), volume=1.0)
        d.update(kw)
        return ThermalEnv(**{k: torch.as_tensor(np.asarray(v, np.float64),
                                                device=device)
                             for k, v in d.items()})


class HeatingCoolingRates(NamedTuple):
    """All individual rates [erg cm^-3 s^-1], each [B] (reference
    type_heating_cooling_rates_list, src/data_struct.f90:489-520)."""
    heating_photoelectric: torch.Tensor
    heating_formation_H2: torch.Tensor
    heating_cosmic_ray: torch.Tensor
    heating_vibrational_H2: torch.Tensor
    heating_ionization_CI: torch.Tensor
    heating_photodissociation_H2: torch.Tensor
    heating_photodissociation_H2O: torch.Tensor
    heating_photodissociation_OH: torch.Tensor
    heating_Xray: torch.Tensor
    heating_viscosity: torch.Tensor
    heating_chem: torch.Tensor
    cooling_photoelectric: torch.Tensor
    cooling_vibrational_H2: torch.Tensor
    cooling_gas_grain: torch.Tensor
    cooling_OI: torch.Tensor
    cooling_CII: torch.Tensor
    cooling_H2O_rot: torch.Tensor
    cooling_H2O_vib: torch.Tensor
    cooling_CO_rot: torch.Tensor
    cooling_CO_vib: torch.Tensor
    cooling_H2_rot: torch.Tensor
    cooling_LymanAlpha: torch.Tensor
    cooling_free_bound: torch.Tensor
    cooling_free_free: torch.Tensor
    cooling_NII: torch.Tensor
    cooling_SiII: torch.Tensor
    cooling_FeII: torch.Tensor
    cooling_OH_rot: torch.Tensor

    def net(self):
        h = (self.heating_photoelectric + self.heating_formation_H2
             + self.heating_cosmic_ray + self.heating_vibrational_H2
             + self.heating_ionization_CI + self.heating_photodissociation_H2
             + self.heating_photodissociation_H2O
             + self.heating_photodissociation_OH + self.heating_Xray
             + self.heating_viscosity + self.heating_chem)
        l = (self.cooling_photoelectric + self.cooling_vibrational_H2
             + self.cooling_gas_grain + self.cooling_OI + self.cooling_CII
             + self.cooling_H2O_rot + self.cooling_H2O_vib
             + self.cooling_CO_rot + self.cooling_CO_vib
             + self.cooling_H2_rot + self.cooling_LymanAlpha
             + self.cooling_free_bound + self.cooling_free_free
             + self.cooling_NII + self.cooling_SiII + self.cooling_FeII
             + self.cooling_OH_rot)
        return h - l


def _pos(x):
    return torch.clamp_min(x, 0.0)


def _exp(x):
    return torch.exp(torch.clamp(x, -c.max_exp, c.max_exp))


class ThermalBalance:
    """Holds static data (tables, species indices, reaction heats) on one
    device."""

    def __init__(self, net: ChemNet, config: HcConfig = HcConfig(),
                 device="cuda", data_dir: str | None = None,
                 tdust_lut=None):
        if not config.use_analytical_CII_OI:
            raise NotImplementedError(
                "NLTE CII/OI cooling inside the RHS is replaced by the "
                "analytic path")
        self.cfg = config
        self.net = net
        self.device = torch.device(device)
        # (lut_Tds [nT], lut_vals [n_dust, nT]) from ops.optics.McTables:
        # the cumulative kappa_abs*B integral of get_Tdust_from_LUT
        # (reference montecarlo.f90:1487-1526); enables the tandem and
        # linear-couple gas-dust exchange modes
        self.tdust_lut = None
        if tdust_lut is not None:
            self.tdust_lut = tuple(
                torch.as_tensor(np.asarray(a, dtype=np.float64),
                                device=self.device) for a in tdust_lut)
            # the LUT's top temperature, read once here: the exchange
            # loops below clamp to it without a host read
            self._Td_top = float(np.asarray(tdust_lut[0])[-1])
        ddir = pathlib.Path(data_dir) if data_dir else defaults.DATA
        self.neufeld_h2 = tables.NeufeldH2(device)
        self.neufeld_h2o = tables.NeufeldH2O(device)
        self.neufeld_co = tables.NeufeldCO(device)
        self.lut_NII = tables.IonCoolingLUT(ddir / "N+_LUT.bin", device)
        self.lut_SiII = tables.IonCoolingLUT(ddir / "Si+_LUT.bin", device)
        self.lut_FeII = tables.IonCoolingLUT(ddir / "Fe+_LUT.bin", device)

        self.i = {k: int(v) for k, v in net.idx.items()}

        def t(a):
            return torch.as_tensor(np.asarray(a), device=device)

        # reactions contributing chemical heating (itype 5 with enthalpy
        # data; reference chem_get_reaction_heat, src/chemistry.f90:2083)
        if net.reac_heat is not None:
            sel = np.nonzero(net.has_heat)[0]
            self.heat_reac1 = t(np.clip(net.reac[sel, 0], 0, None))
            self.heat_reac2 = t(np.clip(net.reac[sel, 1], 0, None))
            self.heat_idx = t(sel)
            self.heat_val = t(net.reac_heat[sel].astype(np.float64))
        else:
            self.heat_idx = t(np.zeros(0, dtype=np.int64))
        # the H2-formation surface reaction (gH + gH -> gH2)
        gh63 = np.nonzero((net.itype == 63)
                          & (net.reac[:, 0] == net.idx.get("gH", -1)))[0]
        self.i_gH63 = int(gh63[0]) if len(gh63) else -1
        # positive charge per species, for the dynamic-alpha ion fraction
        # (reference get_ion_charge_y, src/disk.f90:3446-3460)
        self.pos_charge = t(np.clip(net.elements[:, 0], 0, None)
                            .astype(np.float64))

    # -- helpers ----------------------------------------------------------
    def _chi_uv(self, env: CellEnv):
        return (env.G0_UV_toISM * _exp(-c.UVext2Av * env.Av_toISM)
                + env.G0_UV_toStar * _exp(-c.UVext2Av * env.Av_toStar))

    def _chi_h2(self, env: CellEnv):
        return (env.G0_UV_toISM * _exp(-c.UVext2Av * env.Av_toISM)
                * env.f_selfshielding_toISM[..., 1]
                + env.G0_UV_H2phd * env.f_selfshielding_toStar[..., 1])

    def _lut_Td(self, val):
        """Energy per dust mass -> Tdust per component (forward interp on
        the cumulative emission LUT, reference get_Tdust_from_LUT
        montecarlo.f90:856).  val: [..., nd], component j on the LUT's
        row j."""
        Tds, vals = self.tdust_lut
        nd, nT = vals.shape
        q = val.reshape(-1, nd).T.contiguous()              # [nd, M]
        i = torch.clamp(torch.searchsorted(vals, q), 1, nT - 1)
        v0 = torch.gather(vals, 1, i - 1)
        v1 = torch.gather(vals, 1, i)
        t = (q - v0) / torch.clamp_min(v1 - v0, 1e-300)
        Tv = Tds[i - 1] + torch.clamp(t, 0.0, 1.0) * (Tds[i] - Tds[i - 1])
        first, last = vals[:, :1], vals[:, -1:]
        Tv = torch.where(q <= first,
                         Tds[0] * q / torch.clamp_min(first, 1e-300), Tv)
        Tv = torch.where(q >= last, Tds[-1], Tv)
        return Tv.T.reshape(val.shape)

    def _lut_val(self, Td):
        """Tdust -> energy per dust mass per component (inverse of
        _lut_Td).  Td: [..., nd]."""
        Tds, vals = self.tdust_lut
        nd, nT = vals.shape
        i = torch.clamp(torch.searchsorted(Tds, Td.contiguous()), 1, nT - 1)
        comp = torch.arange(nd, device=Td.device)
        t = (Td - Tds[i - 1]) / torch.clamp_min(Tds[i] - Tds[i - 1], 1e-300)
        return vals[comp, i - 1] + torch.clamp(t, 0.0, 1.0) \
            * (vals[comp, i] - vals[comp, i - 1])

    def _tandem_tdusts(self, Tg, coeff_i, tenv: ThermalEnv):
        """Re-solve each component's Tdust with the gas-collision energy
        included: Td = LUT((en_gain + en_exchange(Tg, Td)) / 4 pi m_dust),
        damped Newton with a secant slope, 16 iterations (reference
        solve_a_Tdust, src/disk.f90:4536-4548).  Tg: [B]; coeff_i and the
        result: [B, 4], the padded components unchanged.  The fixed
        iteration count needs no host read."""
        nd = self.tdust_lut[1].shape[0]
        gains = tenv.en_gains[..., :nd]
        gains = torch.where(torch.isfinite(gains), gains, 0.0)
        inv4pm = 1.0 / torch.clamp_min(
            4.0 * math.pi * tenv.mdusts_cell[..., :nd], TINY)
        active = (tenv.n_dusts[..., :nd] > 1e-20) \
            & (tenv.mdusts_cell[..., :nd] > TINY)
        coeff = coeff_i[..., :nd]
        vol = tenv.volume[..., None]
        floor = -FRAC_DUST_LOSE_EN * gains

        def en_ex(Td):
            per_vol = coeff * (Tg[..., None] - Td)
            # (per_vol * AU2cm^3) first, as the JAX package orders it
            return torch.maximum((per_vol * c.AU2cm ** 3) * vol, floor)

        Td = tenv.Tdusts[..., :nd]
        for _ in range(16):
            dTd = 1e-2 * Td + 1e-1
            # both LUT evaluations of the secant in one call
            Ts = self._lut_Td(torch.stack([
                (gains + en_ex(Td)) * inv4pm,
                (gains + en_ex(Td + dTd)) * inv4pm]))
            Ts1, Ts2 = Ts[0], Ts[1]
            kk = (Ts2 - Ts1) / dTd
            prop = torch.where(torch.abs(1.0 - kk) <= 1e-15, Td,
                               (Ts1 - kk * Td) / (1.0 - kk))
            # damped and clamped: when the exchange term saturates the
            # LUT, the undamped Newton ping-pongs between its endpoints
            prop = torch.clamp(prop, 0.0, self._Td_top)
            Td_new = 0.5 * (Td + prop)
            ok = active & (Td_new > 0.0) & torch.isfinite(Td_new)
            Td = torch.where(ok, Td_new, Td)
        return torch.cat([Td, tenv.Tdusts[..., nd:]], dim=-1)

    def _demit_dtd(self, Td_i, tenv: ThermalEnv):
        """d(emitted power per volume)/dTdust per component from the LUT
        slope (reference get_dEmit_dTd, src/disk.f90:4550-4562).  Td_i:
        [B, 4]; the padded components give 0."""
        nd = self.tdust_lut[1].shape[0]
        Td = Td_i[..., :nd]
        dT = 1e-2 * Td + 1e-2
        e = self._lut_val(torch.stack([Td, Td + dT]))
        slope = (e[1] - e[0]) / dT * 4.0 * math.pi \
            * (tenv.mdusts_cell[..., :nd] / c.AU2cm ** 3) \
            / torch.clamp_min(tenv.volume, TINY)[..., None]
        return torch.cat([torch.clamp_min(slope, 0.0),
                          torch.zeros_like(Td_i[..., nd:])], dim=-1)

    def h2_form_rate(self, k_gH63_per_sec, X_gH, X_HI, n_gas):
        """dn(H2)/dt from grain surface (reference disk.f90:4302-4315,
        H2_form_use_moeq = false path)."""
        if self.i["gH"] >= 0:
            return k_gH63_per_sec * X_gH * X_gH * n_gas
        return k_gH63_per_sec * X_HI * n_gas

    # -- main entry -------------------------------------------------------
    def rates(self, y, Tgas, env: CellEnv, tenv: ThermalEnv,
              k=None) -> HeatingCoolingRates:
        """All heating/cooling rates [erg cm^-3 s^-1], each [B].

        y: abundances [B, n_species(+1)]; Tgas: [B]; k: optional rate
        coefficients [B, nR] (yr^-1, as from compute_rates) used for
        chemical heating and the H2 formation rate.
        """
        cfg = self.cfg
        i = self.i
        T = Tgas
        Tpos = torch.clamp_min(T, 1e-30)
        n = env.n_gas
        zero = torch.zeros_like(T)

        def X(name):
            return y[..., i[name]] if i[name] >= 0 else zero

        X_H2, X_HI, X_E = X("H2"), X("H"), X("E-")
        X_CI, X_CII, X_OI = X("C"), X("C+"), X("O")
        X_CO, X_H2O, X_OH = X("CO"), X("H2O"), X("OH")
        X_Hplus, X_Heplus = X("H+"), X("He+")
        X_NII, X_SiII, X_FeII = X("N+"), X("Si+"), X("Fe+")
        X_gH = X("gH")

        chi_pe = self._chi_uv(env)
        chi_h2 = self._chi_h2(env)
        n_e = X_E * n

        # ---- heating ----
        # 1. photoelectric on small grains (Bakes & Tielens via Wolfire 95)
        tmp = chi_pe * torch.sqrt(Tpos) / (n_e + TINY)
        t1 = torch.where(tmp > 0, tmp ** 0.73, 0.0)
        t2 = (1e-4 * Tpos) ** 0.70
        h_pe = torch.where(
            (X_E > 0) & (T > 0),
            1e-24 * chi_pe * n * tenv.PAH_abundance / c.PAH_abundance_0
            * (4.87e-2 / (1.0 + 4e-3 * t1) + 3.65e-2 * t2 / (1.0 + 2e-4 * tmp)),
            0.0)

        # 2. H2 formation (1/3 of 4.5 eV per event)
        if k is not None and self.i_gH63 >= 0:
            kcoeff = k[..., self.i_gH63] / c.SecondsPerYear
        else:
            kcoeff = zero
        r_h2form = self.h2_form_rate(kcoeff, X_gH, X_HI, n)
        h_h2form = 2.4e-12 * r_h2form * cfg.heating_eff_H2form

        # 3. cosmic ray (Bruderer 2009)
        h_cr = 1.5e-11 * env.zeta_cosmicray_H2 * n * _exp(
            -env.Ncol_toISM / c.cosmicray_attenuate_N)

        # 4. H2 vibrational pumping (Rollig 2006 C.2-C.3)
        gamma_10 = 5.4e-13 * torch.sqrt(Tpos)
        h_vibH2 = torch.where(
            T > 0,
            (n * X_H2) * chi_h2 * 9.4e-22
            / (1.0 + (1.9e-6 + chi_h2 * 4.7e-10) / (n * gamma_10)),
            0.0)

        # 5. CI ionization (Tielens 2005 eq 3.8)
        h_ci = 2.2e-22 * X_CI * n * chi_pe

        # 6. H2 photodissociation (Tielens 2005 eq 3.18-3.19)
        h_phd_h2 = (4e-14 * (n * X_H2) * 3.4e-10 * chi_h2
                    * cfg.heating_eff_phd_H2) if cfg.use_phdheating_H2 \
            else zero

        # 7/8. H2O & OH photodissociation by Lyman-alpha
        if cfg.use_phdheating_H2OOH:
            h_phd_h2o = (8.07e-12 * cfg.heating_eff_phd_H2O * n * X_H2O
                         * c.LyAlpha_cross_H2O
                         * env.phflux_Lya * env.f_selfshielding_toStar[..., 3])
            h_phd_oh = (9.19e-12 * cfg.heating_eff_phd_OH * n * X_OH
                        * c.LyAlpha_cross_OH
                        * env.phflux_Lya * env.f_selfshielding_toStar[..., 4])
        else:
            h_phd_h2o = h_phd_oh = zero

        # 9. X-ray heating per ion pair (Glassgold 2012 table 4)
        if cfg.use_Xray_heating:
            gam1 = torch.where(T > 0, 1e-12 * torch.sqrt(Tpos)
                               * _exp(-1000.0 / Tpos), 0.0)
            gam2 = torch.where(T > 0, 1.4e-12 * torch.sqrt(Tpos)
                               * _exp(-18100.0 / (Tpos + 1200.0)), 0.0)
            Xep = torch.clamp_min(X_E, 0.0)
            pos = X_E > 0
            t2_ = torch.where(pos, 7.95 * Xep ** 0.678, 0.0)
            t3_ = torch.where(pos, 2.17 * Xep ** 0.366, 0.0)
            t4_ = torch.where(pos, 22.0 * Xep ** 0.574, 0.0)
            t5_ = torch.where(pos, 23500.0 * Xep ** 0.955, 0.0)
            t6_ = torch.where(pos, 10700.0 * Xep ** 0.907, 0.0)
            t7_ = torch.where(pos, 7.09 * Xep ** 0.779, 0.0)
            t8_ = torch.where(pos, 6.88 * Xep ** 0.802, 0.0)
            eta_H = 1.0 - (1.0 - 0.117) / (1.0 + t2_)
            eta_H2 = 1.0 - (1.0 - 0.055) / (1.0 + t3_)
            fH2 = X_H2 / torch.clamp_min(X_H2 + X_HI, TINY)
            Q_el_rot = 37.0 * (X_HI * eta_H + X_H2 * eta_H2) \
                / torch.clamp_min(X_HI + X_H2, TINY)
            Q_diss = 2.14 * fH2 / (1.0 + t4_)
            eps1 = 7.81 * (1.0 + t5_)
            eps2 = 109.0 * (1.0 + t6_)
            Q_dirvib = 19.0 * fH2 * (1.0 / eps1 + 2.0 / eps2)
            epsB = 117.0 * (1.0 + t7_)
            epsC = 132.0 * (1.0 + t8_)
            Q_BCvib = 147.0 * fH2 * (1.0 / epsB + 1.0 / epsC)
            denom = gam1 * X_HI + gam2 * X_H2
            n_crit = torch.where(denom > 0,
                                 2e-7 / torch.clamp_min(denom, TINY), math.inf)
            Q_vib = torch.where(denom > 0,
                                n / (n + n_crit) * (Q_dirvib + Q_BCvib), 0.0)
            h_xray = env.zeta_Xray_H2 * n * c.eV2erg \
                * (Q_el_rot + Q_diss + Q_vib)
        else:
            h_xray = zero

        # 10. viscous (alpha-disk)
        rho = n * c.mProton_CGS * tenv.MeanMolWeight
        c2 = c.kBoltzmann_CGS * Tpos / (c.mProton_CGS * tenv.MeanMolWeight)
        if cfg.use_fixed_alpha_visc:
            alpha = tenv.alpha_viscosity
        else:
            # ambipolar-diffusion-modulated MRI alpha from the current ion
            # fraction (reference src/disk.f90:3391-3427,4737; the 2e-9
            # ion-neutral collision beta is src/disk.f90:191)
            ysp = y[..., :self.net.n_species]
            ion = torch.sum(torch.where(ysp >= 1e-30, ysp, 0.0)
                            * self.pos_charge, dim=-1)
            am = n * ion * 2e-9 / torch.clamp_min(tenv.omega_Kepler, TINY)
            la = torch.log(torch.clamp_min(am, 1e-20))
            fmri = 0.5 / torch.sqrt(2500.0 * torch.exp(-2.4 * la)
                                    + (8.0 * torch.exp(-0.3 * la) + 1.0) ** 2)
            alpha = torch.where(am <= 1e-20, 0.0, fmri) * tenv.alpha_viscosity
        h_visc = torch.where(
            T > 0,
            2.25 * alpha * rho * c2 * tenv.omega_Kepler
            * _pos(1.0 - T / 2e4),
            0.0)

        # 11. chemical reaction heat
        if cfg.use_chemicalheatingcooling and k is not None \
                and self.heat_idx.shape[0] > 0:
            kr = k[..., self.heat_idx]
            h_chem = torch.sum(kr * y[..., self.heat_reac1]
                               * y[..., self.heat_reac2] * self.heat_val,
                               dim=-1)
            h_chem = torch.where(T > 0,
                                 h_chem * n / c.SecondsPerYear
                                 * cfg.heating_eff_chem, 0.0)
        else:
            h_chem = zero

        # ---- cooling ----
        # 1. photoelectric recombination (Bakes 1994 eq 44)
        t0l = torch.log(Tpos)
        c_pe = torch.where(
            (X_E > 0) & (T > 0) & (tmp > 0),
            tenv.PAH_abundance / c.PAH_abundance_0 * 3.49e-30
            * _exp(0.944 * t0l)
            * _exp(0.735 * _exp(-0.068 * t0l)
                   * torch.log(torch.clamp_min(tmp, TINY)))
            * n_e * n,
            0.0)

        # 2. H2 vibrational
        A10, D1 = 8.6e-7, 2.6e-11
        c_vibH2 = torch.where(
            T > 0,
            8.26e-13 * gamma_10 * _exp(-5988.0 / Tpos) * (n * n * X_H2)
            * (A10 + chi_h2 * D1) / (gamma_10 * n + A10 + chi_h2 * D1),
            0.0)

        # 3. gas-grain collisions (per dust component, reference "my own
        #    formula" path, heating_cooling.f90:758-786)
        f_a = cfg.cooling_gg_coeff
        cs_H = torch.sqrt((8.0 / c.pi * c.kBoltzmann_CGS / c.mProton_CGS)
                          * Tpos)
        cs_H2 = cs_H / math.sqrt(2.0)
        base = 2.0 * c.kBoltzmann_CGS * f_a * n * (
            cs_H * (X_HI + X_Hplus) + cs_H2 * X_H2)
        coeff_i = base[..., None] * tenv.sig_dusts * tenv.n_dusts
        if cfg.allow_gas_dust_en_exch and cfg.tdust_iter_tandem \
                and self.tdust_lut is not None:
            Td_i = self._tandem_tdusts(Tpos, coeff_i, tenv)
        else:
            Td_i = tenv.Tdusts
        dT_i = T[..., None] - Td_i
        if cfg.dust_gas_linear_couple and self.tdust_lut is not None:
            # damp the gas-dust temperature difference by how fast dust
            # emission responds (reference heating_cooling.f90:775-777
            # with dEmit_dTd from src/disk.f90:4550-4562; the slope comes
            # from the Tdust LUT, as in the JAX package)
            demit = self._demit_dtd(Td_i, tenv)
            dT_i = dT_i * demit / torch.clamp_min(demit + coeff_i, TINY)
        # the inf sentinel ("unlimited dust heating budget") must not
        # enter arithmetic
        eg_fin = torch.isfinite(tenv.en_gains)
        eg = torch.where(eg_fin, tenv.en_gains, 0.0)
        clamp = torch.where(
            eg_fin,
            -FRAC_DUST_LOSE_EN * (eg / c.AU2cm ** 3)
            / torch.clamp_min(tenv.volume, TINY)[..., None],
            -1e30)
        en_ex = torch.maximum(coeff_i * dT_i, clamp)
        c_gg = torch.where(T > 0, torch.sum(en_ex, dim=-1), 0.0)

        # 4. OI fine structure + 6300A (Rollig 2006 A.5/A.6, Tielens 2.69)
        Ncol_min = torch.minimum(
            torch.minimum(env.Ncol_toISM, tenv.Ncol_toStar),
            n * tenv.coherent_length)
        Z_O = X_OI / 3.2e-4
        beta63 = tau2beta(Ncol_min * Z_O / 4.9e20)
        beta146 = tau2beta(Ncol_min * Z_O / 3.7e20)
        t2o = Tpos ** 0.45
        t3o = Tpos ** 0.66
        # normalized by n (u1,u2) and n^2 (tmp5n); algebraically
        # identical to heating_cooling.f90:936-1026
        u1 = 1.0 + beta63 * 1.66e-5 / (1.35e-11 * t2o * n)
        u2 = 1.0 + beta146 * 8.46e-5 / (4.37e-12 * t3o * n)
        tmp3 = _exp(98.0 / Tpos)
        tmp4 = _exp(228.0 / Tpos)
        tmp5n = 1.0 + tmp3 * u1 * (3.0 + tmp4 * 5.0 * u2)
        cool_63 = 3.15e-14 * 8.46e-5 * beta63 * Z_O * 3.2e-4 * n * tmp3 \
            * 3.0 * u1 / tmp5n
        cool_146 = 1.35e-14 * 1.66e-5 * beta146 * Z_O * 3.2e-4 * n / tmp5n
        n_cr_E = 1.3e6 * (Tpos / 1e4) ** (-0.58)
        # 6.63e-34 (SI Planck constant) reproduced verbatim from the
        # reference (heating_cooling.f90:986 uses phy_hPlanck_SI)
        cool_6300 = 6.62606896e-34 * 4.7e14 * (6.5e-3 + 2.1e-3) * X_OI * (
            X_E / n_cr_E + X_HI / 6.6e9) * n * n
        c_oi = torch.where(T > 0, cool_63 + cool_146 + cool_6300, 0.0)

        # 5. CII 158 um (Rollig 2006 A.2)
        Z_C = X_CII / 1.4e-4
        beta158 = tau2beta(Ncol_min * Z_C / 6.5e20)
        c_cii = torch.where(
            T > 0,
            4.04e-24 * n * Z_C * beta158
            / (1.0 + 0.5 * _exp(92.0 / Tpos) * (1.0 + 2600.0 * beta158 / n)),
            0.0)

        # 6-10. Neufeld LVG molecular cooling
        vturb_kms = tenv.velo_width_turb * 1e-5

        def log10N_of(n_M):
            return torch.log10(torch.clamp_min(torch.minimum(
                tenv.Neufeld_G * n_M / (tenv.Neufeld_dv_dz + TINY),
                n_M * env.Ncol_toISM / n / (9.0 * vturb_kms)), TINY))

        n_H2 = n * X_H2

        def rot_cool(p: tables.NeufeldParams, n_M):
            L0 = p.L0 + TINY
            L_LTE = p.L_LTE + TINY
            n12 = p.n_12 + TINY
            t1_ = (n_H2 / n12) ** p.alpha
            denom = 1.0 / L0 + n_H2 / L_LTE \
                + 1.0 / L0 * t1_ * (1.0 - n12 * L0 / L_LTE)
            return n_H2 * n_M / denom

        n_h2o = n * X_H2O
        p = self.neufeld_h2o.params(Tpos, log10N_of(n_h2o))
        c_h2o_rot = torch.where((X_H2O > 0) & (X_H2 > 0) & (T > 0),
                                rot_cool(p, n_h2o), 0.0)
        L0v, LTEv = self.neufeld_h2o.vib_params(Tpos, log10N_of(n_h2o))
        c_h2o_vib = torch.where(
            (X_H2O > 0) & (X_H2 > 0) & (T > 0),
            n_H2 * n_h2o / (1.0 / (L0v + TINY) + n_H2 / (LTEv + TINY)), 0.0)

        n_co = n * X_CO
        p = self.neufeld_co.params(Tpos, log10N_of(n_co))
        c_co_rot = torch.where((X_CO > 0) & (X_H2 > 0) & (T > 0),
                               rot_cool(p, n_co), 0.0)
        L0v, LTEv = self.neufeld_co.vib_params(Tpos, log10N_of(n_co))
        c_co_vib = torch.where(
            (X_CO > 0) & (X_H2 > 0) & (T > 0),
            n_H2 * n_co / (1.0 / (L0v + TINY) + n_H2 / (LTEv + TINY)), 0.0)

        # the exp(-509/T) Boltzmann factor is factored OUT of the 1/L0
        # division chain (C = boltz * n^2 / D with D built from the
        # unsuppressed L values), as in the JAX package
        ph2, h2_boltz = self.neufeld_h2.params_scaled(Tpos)
        L0 = ph2.L0 + TINY
        L_LTE = ph2.L_LTE + TINY
        t1h2 = torch.where(ph2.alpha > 0,
                           (n_H2 / ph2.n_12) ** ph2.alpha
                           * (1.0 - ph2.n_12 * L0 / L_LTE) / L0,
                           0.0)
        c_h2_rot = torch.where(
            (X_H2 > 0) & (T > 0),
            h2_boltz * n_H2 * n_H2
            / (1.0 / L0 + n_H2 / L_LTE + t1h2), 0.0)

        # 11. Lyman-alpha (collisional excitation of H)
        c_lya = torch.where(T > 0, 7.3e-19 * n * n * X_HI * X_E
                            * _exp(-118400.0 / Tpos), 0.0)

        # 12. free-bound (Draine 2011 eq 14.5/27.22-23)
        T4l = torch.log(Tpos / 1e4)
        alpha_A = 4.13e-13 * _exp(T4l * (-0.7131 - 0.0115 * T4l))
        c_fb = torch.where(
            T > 0,
            (n * X_E) * (n * X_Hplus) * alpha_A
            * (0.787 - 0.0230 * T4l) * c.kBoltzmann_CGS * Tpos, 0.0)

        # 13. free-free
        c_ff = torch.where(
            T > 0,
            1.4e-27 * torch.sqrt(Tpos) * 1.3 * (n * X_E)
            * (n * (X_Hplus + X_Heplus)), 0.0)

        # 14-16. NII / SiII / FeII from (ne, T) lookup tables
        def ion_cool(lut, Xion):
            ok = (Xion > 1e-15) & (X_E > 0) & (T > 0)
            return torch.where(ok, Xion * n * lut.cooling_per_ion(n_e, Tpos),
                               0.0)

        c_nii = ion_cool(self.lut_NII, X_NII)
        c_siii = ion_cool(self.lut_SiII, X_SiII)
        c_feii = ion_cool(self.lut_FeII, X_FeII)

        # 17. OH rotational (Gorti 2004 appendix D)
        A0, E0, sig_oh, eta = 7.6e-4, 5.4, 8e-16, 10.0
        N_OH = X_OH * n * tenv.coherent_length
        N_tau = 1.18e7 * vturb_kms * E0 ** 3 / A0
        tau_oh = 4.0 * N_OH / N_tau / (eta * Tpos / E0)
        ctau = tau_oh * torch.sqrt(
            2.0 * c.pi * torch.log(2.13 + (tau_oh / math.e) ** 2))
        v_T = torch.sqrt((8.0 / c.pi * c.kBoltzmann_CGS / c.mProton_CGS)
                         * Tpos)
        tmp_oh = 4.0 * (Tpos / E0) * A0 / (
            n * torch.clamp_min(1.0 - X_H2, TINY) * sig_oh * v_T)
        ym = torch.log(1.0 + ctau / (1.0 + 10.0 * tmp_oh))
        tmp1_oh = (2.0 + ym + 0.6 * ym ** 2) \
            / (1.0 + ctau + tmp_oh + 1.5 * torch.sqrt(tmp_oh))
        L_oh = 2.0 * c.kBoltzmann_CGS * Tpos ** 2 * A0 / E0 * tmp1_oh
        c_oh = torch.where((X_OH > 0) & (X_H2 >= 0) & (X_H2 < 1.0) & (T > 0),
                           L_oh * n * X_OH, 0.0)

        return HeatingCoolingRates(
            heating_photoelectric=h_pe, heating_formation_H2=h_h2form,
            heating_cosmic_ray=h_cr, heating_vibrational_H2=h_vibH2,
            heating_ionization_CI=h_ci, heating_photodissociation_H2=h_phd_h2,
            heating_photodissociation_H2O=h_phd_h2o,
            heating_photodissociation_OH=h_phd_oh, heating_Xray=h_xray,
            heating_viscosity=h_visc, heating_chem=h_chem,
            cooling_photoelectric=c_pe, cooling_vibrational_H2=c_vibH2,
            cooling_gas_grain=c_gg, cooling_OI=c_oi, cooling_CII=c_cii,
            cooling_H2O_rot=c_h2o_rot, cooling_H2O_vib=c_h2o_vib,
            cooling_CO_rot=c_co_rot, cooling_CO_vib=c_co_vib,
            cooling_H2_rot=c_h2_rot, cooling_LymanAlpha=c_lya,
            cooling_free_bound=c_fb, cooling_free_free=c_ff,
            cooling_NII=c_nii, cooling_SiII=c_siii, cooling_FeII=c_feii,
            cooling_OH_rot=c_oh)

    def net_rate(self, y, Tgas, env, tenv, k=None):
        """Gamma - Lambda [erg cm^-3 s^-1], [B]."""
        return self.rates(y, Tgas, env, tenv, k).net()

    def solve_equilibrium_T(self, y, env, tenv, T0, tab, n_expand=60,
                            n_bisect=80, rtol=1e-5, atol=1e-1,
                            diff2des=0.5, h2_form_use_moeq=False):
        """Equilibrium Tgas of each lane from Gamma(T) = Lambda(T) by
        bracketed bisection (reference solve_bisect_T,
        src/heating_cooling.f90:1273-1403): expand a bracket around T0
        (bounds floored at 1 K) until the net rate changes sign, then
        bisect until the bracket is narrower than rtol x its mid-point +
        atol.  y: [B, nS(+1)] (a last column is set to the trial T); T0:
        [B].  Returns (T [B], bracketed [B]), T0 where no bracket was
        found.

        The lanes run as the JAX package's while loops run under vmap: a
        lane whose loop condition no longer holds keeps its bracket while
        the others go on, so each lane gets the T it would get alone.  A
        step evaluates the net rate once a lane, at the bound that moves.
        """
        from .rates import compute_rates
        nS = self.net.n_species

        def fnet(T):
            k = compute_rates(tab, env, T, diff2des, h2_form_use_moeq)
            yT = y
            if y.shape[-1] == nS + 1:
                yT = y.clone()
                yT[:, nS] = T
            return self.net_rate(yT, T, env, tenv, k)

        x1, x2 = T0 / 1.1, T0 * 1.1
        f1, f2 = fnet(x1), fnet(x2)
        for _ in range(n_expand):
            go = f1 * f2 > 0.0
            if not bool(go.any()):
                break
            move1 = torch.abs(f1) < torch.abs(f2)
            x1n = torch.clamp_min(x1 + 0.5 * (x1 - x2), 1.0)
            x2n = torch.clamp_min(x2 + 0.5 * (x2 - x1), 1.0)
            fn = fnet(torch.where(move1, x1n, x2n))
            lo, hi = go & move1, go & ~move1
            x1, f1 = torch.where(lo, x1n, x1), torch.where(lo, fn, f1)
            x2, f2 = torch.where(hi, x2n, x2), torch.where(hi, fn, f2)
        bracketed = f1 * f2 <= 0.0
        for _ in range(n_bisect):
            # a lane without a bracket returns T0 whatever it bisects to
            go = bracketed & ((x2 - x1) > (rtol * 0.5 * (x1 + x2) + atol))
            if not bool(go.any()):
                break
            xm = 0.5 * (x1 + x2)
            fm = fnet(xm)
            lo = fm * f1 < 0.0
            up, down = go & ~lo, go & lo
            x1, f1 = torch.where(up, xm, x1), torch.where(up, fm, f1)
            x2, f2 = torch.where(down, xm, x2), torch.where(down, fm, f2)
        return torch.where(bracketed, 0.5 * (x1 + x2), T0), bracketed

    def dTdt(self, y, T, env, tenv, k):
        """dT/dt [K/yr] given rate coefficients k (reference
        realtime_heating_cooling_rate, disk.f90:4664-4741; the K/yr
        conversion is disk.f90:4739)."""
        net = self.net_rate(y, T, env, tenv, k)
        return net * c.SecondsPerYear / (env.n_gas * c.kBoltzmann_CGS)
