"""Disk model orchestration: the thermo-chemical fixed-point iteration.

Counterpart of the JAX package's ``models/driver.py`` (reference:
src/disk.f90:224-394 ``disk_iteration``, :1519 ``disk_iteration_prepare``,
:1629 ``calc_this_cell``, :1901-1933 convergence checks):

    prepare -> [MC passes -> field reduction -> column/shielding update
               -> pool chemistry(+T) sweep -> convergence check] x n_iter

Ported: the configuration, ``prepare`` (with the column-density path
matrices), the per-cell state, ``run_mc`` on a single device (the streamed
pass, whose walk and terminal fold are kernels K3 and K4 on a CUDA
device), ``prepare_sweep_fields`` and ``assemble_envs`` (columns,
self-shielding and the per-cell environments, float64 on the model's
device), the pool chemistry sweep on its ``evolT=True`` branch (whose
Newton factor and solve are kernels K1 and K2), ``chemistry_step`` with its
convergence bookkeeping, and ``run``.  Not ported yet, each raising
``NotImplementedError`` when asked for: ``evolT=False`` (the
equilibrium-temperature update), ``chem_stream=False`` (the chunked
sweep), the vertical structure, AMR refine/merge, and the per-iteration
outputs (``run(save_dir=...)``); the sharded multi-device pass.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
from torch.profiler import record_function

from .. import constants as c
from ..io import draine, umist
from ..ops import bdf as bdfmod
from ..ops import (columns, fields, geometry, mcrt, odesys, optics,
                   thermal)
from ..ops.rates import CellEnv
from . import density, star as starmod
from .grid import Grid, GridConfig, make_grid


# BDF rounds between two refills of the pool window (solve_pool's
# rounds_per_call).  The JAX package keeps 256, a bound on one TPU device
# program; there a lane that finishes early waits for the call's slowest
# lane.  On the card the loop is host-driven and a refill costs a few host
# reads, so the window is refilled more often (PERF.md §5).  A lane's
# solution does not depend on its slot or on the round it starts in:
# tests/test_torch_run.py runs more cells than window slots through both
# packages and compares the results.
POOL_ROUNDS_PER_CALL = 32


@dataclasses.dataclass
class DustComponent:
    opti_files: list[str]
    weights: list[float]
    rho_material: float = 2.0     # g/cm^3
    mrn_rmin: float = 0.01        # micron
    mrn_rmax: float = 1.0
    mrn_n: float = 3.5
    d2g_mass: float = 0.01        # mass ratio to gas
    andrews: density.AndrewsDisk | None = None   # None = follow gas


@dataclasses.dataclass
class DiskConfig:
    """The fields of the JAX package's DiskConfig that the port reads
    (same names and defaults)."""
    # star
    star_mass: float = 0.6
    star_radius: float = 1.0
    star_T: float = 4000.0
    star_spectrum_file: str | None = None
    lumi_Xray: float = 0.0
    T_Xray: float = 1e7
    # disk structure
    andrews: density.AndrewsDisk = None
    grid: GridConfig = None
    dust: list[DustComponent] = None
    # chemistry
    network_file: str = ""
    enthalpy_file: str | None = None
    init_abundances_file: str = ""
    h2o_cross_file: str | None = None
    # iteration control (reference iteration_configure defaults)
    n_iter: int = 4
    rtol_abun: float = 0.2
    atol_abun: float = 1e-12
    converged_fraction: float = 0.95
    evolT: bool = True
    t_max: float = 1e6
    dt_first: float = 1e-8
    ratio_tstep: float = 1.1
    rtol_chem: float = 1e-4
    atol_chem: float = 1e-30
    nlocal_iter: int = 4
    chem_chunk: int = 256
    # per-output-interval BDF round budget; lanes that cannot reach the
    # next output time within it are marked failed
    max_steps_per_interval: int = 500
    # wall-clock budget per chemistry chunk, seconds; 0 = unlimited (the
    # pool sweep's budget is chunk_wall_s x chunks x nlocal_iter)
    chunk_wall_s: float = 0.0
    # pool-refill chemistry sweep: all active cells stream through one
    # constant-width window with per-lane ladder retries
    chem_stream: bool = True
    # MC control
    mc: optics.McConfig = None
    n_mc_passes: int = 3
    nph_per_pass: int = 200_000
    maxw: float = 0.95
    UV_G0_background: float = 1.0
    zeta_cosmicray_H2: float = 1.36e-17
    base_alpha: float = 0.01
    minimum_Tdust: float = 1.0
    dust_depletion: float = 1.0
    hc: thermal.HcConfig = dataclasses.field(default_factory=thermal.HcConfig)
    # hydrostatic vertical structure and AMR refine/merge (reference
    # disk.f90:984-1093, 3646-4033): not ported, off
    do_vertical_with_Tdust: bool = False
    do_vertical_every: int = 0        # 0 = off
    do_refine: bool = False
    do_merge: bool = False
    # ad-hoc O/C(/N) depletion of the initial abundances
    # (models.depletion.DepletionConfig); None = off
    depletion: object = None
    # zeta_X from stellar-spectrum Ncol attenuation instead of the MC
    # local-flux tally (reference calc_zetaXray_from_Ncol mode,
    # disk.f90:1994-2001)
    calc_zetaXray_from_Ncol: bool = False
    # dust albedo entering the CR-induced-photon rate correction
    # (reference template_configure.dat:233)
    cell_omega_albedo: float = 0.5


class DiskModel:
    """Holds the prepared state on one device; run() drives the
    fixed-point loop.  The evolving per-cell state (X, Tgas, Tdust,
    Tdusts, quality) lives on the host as numpy arrays; tallies, fields,
    path matrices, columns and environments live on the device."""

    def __init__(self, cfg: DiskConfig, device="cuda"):
        if isinstance(device, (list, tuple)):
            if len(device) > 1:
                raise NotImplementedError(
                    "the sharded multi-device MC pass is not ported yet")
            device = device[0]
        self.cfg = cfg
        self.device = torch.device(device)
        # a device that cannot hold tensors (the default "cuda" on a
        # machine without one) fails here, with torch's own error
        torch.empty(0, device=self.device)
        self.log = []
        # one record per MC pass: wall time, packets, walk chunks,
        # refills, kernel launches, fates and the cells it read
        self.mc_stats = []

    def say(self, msg):
        self.log.append(msg)
        print(msg, flush=True)

    def _t(self, a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    # ------------------------------------------------------------------
    def prepare(self):
        cfg = self.cfg
        dev = self.device
        t0 = time.time()
        self.say("loading chemical network...")
        self.net = umist.load_network(cfg.network_file, cfg.enthalpy_file)
        self.y0 = umist.load_initial_abundances(
            self.net, cfg.init_abundances_file)
        self.thermal = thermal.ThermalBalance(self.net, config=cfg.hc,
                                              device=dev)
        self.ode = odesys.ChemicalODE(self.net, thermal=self.thermal,
                                      device=dev)

        self.say("loading dust optics...")
        self.mixtures = []
        for dc in cfg.dust:
            raws = [draine.load_opti(f) for f in dc.opti_files]
            raw = draine.mix_raw(raws, dc.weights) if len(raws) > 1 \
                else raws[0]
            self.mixtures.append(draine.mrn_average(
                raw, dc.mrn_rmin, dc.mrn_rmax, dc.mrn_n, dc.rho_material))

        self.say("building grid...")
        self.grid: Grid = make_grid(cfg.grid, cfg.andrews)
        self.gi = geometry.build_grid_index(self.grid, dev)
        self.say(f"  {self.grid.n_cells} cells, "
                 f"{int(self.grid.using.sum())} active")

        self.say("building optics tables...")
        h2o_lam = h2o_sig = None
        if cfg.h2o_cross_file:
            h2o_lam, h2o_sig = draine.load_h2o_cross_section(
                cfg.h2o_cross_file)
        self.mc_cfg = cfg.mc or optics.McConfig(nph=cfg.nph_per_pass)
        self.tab = optics.build_tables(self.mixtures, self.mc_cfg,
                                       h2o_lam, h2o_sig)

        self.say("preparing star...")
        if cfg.star_spectrum_file:
            # blackbody range tied to the opacity-table lambda grid
            # (reference disk.f90:465-468)
            self.star = starmod.load_star_spectrum(
                cfg.star_spectrum_file, mass=cfg.star_mass,
                radius=cfg.star_radius, T=cfg.star_T,
                lam0=min(100.0, float(self.tab.lam[0])),
                lam1=max(1e8, float(self.tab.lam[-1])))
        else:
            self.star = starmod.blackbody_star(
                cfg.star_T, cfg.star_radius, mass=cfg.star_mass)
        self.star.lumi_Xray = cfg.lumi_Xray
        self.star.T_Xray = cfg.T_Xray
        self.star = starmod.merge_xray(self.star)
        A = 1.0 / c.Angstrom2micron
        self.lumi_UV0 = self.star.luminosity(
            c.lam_range_UV[0] * A, c.lam_range_UV[1] * A)
        self.lumi_Lya = self.star.luminosity(
            c.lam_range_LyA[0] * A, c.lam_range_LyA[1] * A)
        self.lumi_H2phd = self.star.luminosity(
            c.lam_range_UV_H2phd[0] * A, c.lam_range_UV_H2phd[1] * A)

        self.say("tracing column-density rays...")
        t_tr = time.time()
        self.W_star, self.W_ism = columns.build_path_matrices(
            self.grid, self.gi, device=dev)
        self.t_trace = time.time() - t_tr

        # --- per-cell static state ---
        g = self.grid
        n = g.n_cells
        self.n_dust = len(self.mixtures)
        mu = 1.4 * c.mProton_CGS
        rho_gas = g.n0 * mu
        self.rho_dust = np.stack([rho_gas * dc.d2g_mass
                                  for dc in cfg.dust])
        self.pmass = np.array([m.pmass for m in self.mixtures])
        self.sig_dusts = np.array([np.pi * m.r2av for m in self.mixtures]) \
            * c.micron2cm ** 2
        self.r2av = np.array([m.r2av for m in self.mixtures])
        self._derive_cell_state()

        # --- evolving state ---
        self.X = np.tile(self.y0[:, None], (1, n))        # [nS, n]
        self.Tgas = np.full(n, 0.0)
        self.Tdust = np.full(n, cfg.minimum_Tdust)
        self.Tdusts = np.zeros((self.n_dust, n))
        self.fields = None
        self.quality = np.zeros(n, dtype=np.int64)
        self.say(f"prepare done in {time.time() - t0:.1f}s")

    # ------------------------------------------------------------------
    def _derive_cell_state(self):
        """Per-cell quantities derived from (grid, rho_dust)."""
        cfg = self.cfg
        g = self.grid
        n = g.n_cells
        n_dusts = self.rho_dust / self.pmass[:, None]
        sig_nd = n_dusts * self.sig_dusts[:, None]
        self.abso_wei = sig_nd / np.maximum(sig_nd.sum(0), 1e-300)
        self.n_dusts = n_dusts
        self.vol = g.volumes_cm3()
        self.d2h = n_dusts.sum(0) / np.maximum(g.n0, 1e-300)
        self.grain_a = np.full(n, np.sqrt(
            sum(m.r2av for m in self.mixtures) / self.n_dust) * c.micron2cm)
        rc, zc = g.centers()
        self.r_cells = rc
        self.z_cells = zc
        self.omega_K = np.sqrt(c.GravitationConst_CGS * cfg.star_mass
                               * c.Msun_CGS / (rc * c.AU2cm) ** 3)
        self.velo_grad = 0.5 * np.sqrt(
            c.GravitationConst_CGS * cfg.star_mass * c.Msun_CGS
            / (rc * c.AU2cm)) / (rc * c.AU2cm)

    # ------------------------------------------------------------------
    def mc_cells(self) -> mcrt.McCells:
        g = self.grid
        t = self._t
        i_HI = self.net.idx["H"]
        i_H2O = self.net.idx["H2O"]
        return mcrt.McCells(
            rmin=t(g.rmin), rmax=t(g.rmax), zmin=t(g.zmin), zmax=t(g.zmax),
            using=t(g.using), n_gas=t(g.n0),
            n_HI=t(g.n0 * self.X[i_HI]), n_H2O=t(g.n0 * self.X[i_H2O]),
            # Lya Voigt width at the cell Tgas (reference
            # update_gl_optical_OTF, montecarlo.f90:374); before the
            # first chemistry sweep Tgas is unset -> Tdust
            Tgas=t(np.where(self.Tgas > 0.0, np.maximum(self.Tgas, 1.0),
                            np.maximum(self.Tdust, 1.0))),
            rho_dust=t(self.rho_dust),
            dust_depletion=t(np.full(g.n_cells, self.cfg.dust_depletion,
                                     dtype=np.float64)),
            d2h=t(self.d2h), grain_a=t(self.grain_a),
            Tdust=t(self.Tdusts),
            mdust_cell=t(self.rho_dust * self.vol[None, :]),
            abso_wei=t(self.abso_wei))

    def packet_pool(self, nph=None):
        """The pass's packet ladder: wavelengths, energies normalized to
        O(1) for the f32 transport, and the energy scale."""
        cfg = self.cfg
        lam_pk, en_pk = starmod.packet_ladder(
            self.star, nph or cfg.nph_per_pass, self.mc_cfg.refine_UV,
            self.mc_cfg.refine_LyA, self.mc_cfg.refine_Xray)
        # upper-cone launch carries maxw/2 of L (reference both-cone
        # convention, montecarlo.f90:82-106 with minw=-maxw)
        en_pk = en_pk * (cfg.maxw / 2.0)
        en_scale = float(np.max(en_pk)) or 1.0
        return lam_pk, np.asarray(en_pk) / en_scale, en_scale

    def mc_pass(self, key_seed, nph=None, cells=None, walk="kernel",
                max_batch=None, max_steps=100_000):
        """One streamed MC pass with the model's current state (or the
        given cells), at most max_steps walk steps.  Leaves the model
        unchanged.  Returns (tallies in float64 physical units, fates,
        stats)."""
        from ..ops import kernels
        cfg = self.cfg
        mc = self.mc_cfg
        t0 = time.time()
        lam_pk, en_norm, en_scale = self.packet_pool(nph)
        if cells is None:
            cells = self.mc_cells()
        model = mcrt.McModel(tab=self.tab, gi=self.gi, cells=cells,
                             star_mass=cfg.star_mass)
        gen = torch.Generator(device=self.device).manual_seed(key_seed)
        tall = mcrt.McTallies.zeros(self.grid.n_cells, len(self.tab.lam),
                                    self.n_dust, 5, device=self.device)
        l0 = (kernels.mc_walk.launches, kernels.fold_terminal.launches)
        stats = {"packets": len(lam_pk), "cells": cells}
        _, tall, fates = mcrt.mc_pass_streamed(
            model, gen, lam_pk, en_norm, 0.0, cfg.maxw, tall,
            max_batch=max_batch or mc.max_batch, max_steps=max_steps,
            steps_per_call=mc.steps_per_call, n_quantile=mc.n_quantile,
            nmax_encounter=mc.nmax_encounter, use_mrw=mc.use_mrw,
            mrw_gamma=mc.mrw_gamma, mrw_lam_min=mc.mrw_lam_min,
            save_dir=mc.save_dir_flux,
            save_counts=mc.save_counts or mc.do_fill_blank,
            walk=walk, stats=stats)
        # scale the energy tallies back to physical units, in f64
        with record_function("mc.rescale"):
            tall = tall._replace(**{
                f: getattr(tall, f).to(torch.float64) * en_scale
                for f in ("flux", "dir_flux", "en_gain", "en_gain_abso",
                          "ab_en_water", "collector", "collector_img",
                          "mrw_path")})
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        stats["wall_s"] = time.time() - t0
        stats["k3_launches"] = kernels.mc_walk.launches - l0[0]
        stats["k4_launches"] = kernels.fold_terminal.launches - l0[1]
        stats["fates"] = fates
        return tall, fates, stats

    def reduce(self, tall, cells):
        """Radiation fields from one pass's tallies."""
        if self.mc_cfg.do_fill_blank:
            sm = fields.fill_blank(self.tab.lam, tall.flux.cpu().numpy(),
                                   tall.phc.cpu().numpy(),
                                   nth=self.mc_cfg.fill_blank_threshold)
            tall = tall._replace(flux=self._t(sm))
        return fields.reduce_fields(
            self.tab, cells, tall, self.vol, self.r2av,
            self.lumi_UV0, self.lumi_Lya, self.lumi_H2phd,
            self._t(self.r_cells), self._t(self.z_cells),
            self.cfg.UV_G0_background, self.cfg.minimum_Tdust)

    def run_mc(self, n_passes=None, seed=0, nph=None):
        """Lucy-iterated Monte Carlo: repeat passes, freezing Tdust within
        each pass and updating it from the absorbed-energy tallies."""
        n_passes = n_passes or self.cfg.n_mc_passes
        for ip in range(n_passes):
            cells = self.mc_cells()
            tall, fates, stats = self.mc_pass(seed * 1000 + ip, nph, cells)
            self.tallies = tall
            fld = self.reduce(tall, cells)
            self.fields = fld
            self.Tdusts = fld.Tdusts.cpu().numpy()
            self.Tdust = fld.Tdust.cpu().numpy()
            self.mc_counts = fates
            use = self.grid.using
            stats["tdust_active"] = (float(self.Tdust[use].min()),
                                     float(self.Tdust[use].max()))
            self.mc_stats.append(stats)
            self.say(f"  MC pass {ip + 1}/{n_passes}: "
                     f"{stats['packets']} packets in {stats['wall_s']:.1f}s; "
                     f"Tdust {self.Tdust[use].min():.1f}.."
                     f"{self.Tdust[use].max():.1f} K; "
                     f"esc {fates['escaped']} "
                     f"destr {fates['destructed']} "
                     f"prem {fates['premature']}")

    # ------------------------------------------------------------------
    def prepare_sweep_fields(self):
        """Full-disk column/shielding quantities, computed once per
        chemistry sweep from the previous iterate (the reference instead
        walks rays against the live state cell by cell,
        disk.f90:1823 update_params_above_alt; PARITY.md)."""
        g = self.grid
        t = self._t
        t_sh = time.time()
        dv = np.sqrt(c.kBoltzmann_CGS * np.maximum(self.Tgas, 10.0)
                     / (c.mProton_CGS * 1.4 * 2.0))
        sh = columns.compute_shielding(
            self.W_star, self.W_ism, t(g.n0), t(self.X), self.net.idx,
            t(dv), self.thermal_visser())
        self._shield = sh
        # Av to ISM: dust column scaled by the geometric cross section x2
        # (reference mode -6 of calc_Ncol_from_cell_to_point,
        # disk.f90:2691-2700, applied at disk.f90:1430)
        Ncol_dust_ism = self.W_ism.matvec(t(self.n_dusts.sum(0)))
        self._Av_ism = 1.086 * Ncol_dust_ism * np.pi \
            * t(self.grain_a) ** 2 * 2.0
        self._zetaX_ncol = None
        if self.cfg.calc_zetaXray_from_Ncol:
            lam = np.asarray(self.tab.lam, dtype=np.float64)
            sv = np.interp(lam, self.star.lam, self.star.vals, left=0.0,
                           right=0.0)
            xr_lo = c.lam_range_Xray[0] / c.Angstrom2micron
            xr_hi = c.lam_range_Xray[1] / c.Angstrom2micron
            self._zetaX_ncol = columns.xray_ionization_rate_ncol(
                lam, sv, (lam >= xr_lo) & (lam <= xr_hi),
                t(np.full(g.n_cells, self.cfg.dust_depletion,
                          dtype=np.float64)),
                t(self.d2h), t(self.grain_a), sh.Ncol_toStar,
                t(self.r_cells), t(self.z_cells))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._t_shield = time.time() - t_sh

    def assemble_envs(self, idx):
        """CellEnv/ThermalEnv for the cells in index array idx, float64 on
        the model's device (uses the sweep-level fields from
        prepare_sweep_fields)."""
        cfg = self.cfg
        g = self.grid
        f = self.fields
        if getattr(self, "_shield", None) is None:
            self.prepare_sweep_fields()
        sh = self._shield
        dev = self.device
        idx = np.asarray(idx)
        it = torch.as_tensor(idx, device=dev)
        B = len(idx)

        def take(a):
            if isinstance(a, torch.Tensor):
                return a.to(torch.float64)[it]
            return self._t(np.asarray(a, dtype=np.float64)[idx])

        def take2(a):           # [5, n] -> [B, 5]
            return a[:, it].T.contiguous()

        def full(v):
            return torch.full((B,), float(v), dtype=torch.float64,
                              device=dev)

        # [B, n_dust] -> [B, 4], as the JAX package pads (@ eye(n_dust, 4))
        eye = torch.eye(self.n_dust, 4, dtype=torch.float64, device=dev)

        def pad4(a):
            return self._t(np.asarray(a, dtype=np.float64)).T @ eye

        n_dust_tot = self.n_dusts.sum(0)
        env = CellEnv(
            Tgas=take(self.Tgas),
            Tdust=take(self.Tdust),
            n_gas=take(g.n0),
            zeta_cosmicray_H2=full(cfg.zeta_cosmicray_H2),
            zeta_Xray_H2=take(self._zetaX_ncol)
            if self._zetaX_ncol is not None else take(f.zeta_Xray),
            Ncol_toISM=take(sh.Ncol_toISM),
            Av_toISM=take(self._Av_ism),
            Av_toStar=take(f.Av_toStar),
            G0_UV_toISM=full(cfg.UV_G0_background),
            G0_UV_toStar=take(f.G0_UV_toStar),
            G0_UV_H2phd=take(f.G0_UV_H2phd),
            G0_UV_toStar_photoDesorb=take(f.G0_UV_toStar_photoDesorb),
            phflux_Lya=take(f.phflux_Lya),
            omega_albedo=full(cfg.cell_omega_albedo),
            f_selfshielding_toISM=take2(sh.toISM),
            f_selfshielding_toStar=take2(sh.toStar),
            GrainRadius_CGS=take(self.grain_a),
            sigdust_ave=self._t(
                (self.sig_dusts[:, None] * self.n_dusts).sum(0)[idx]
                / np.maximum(n_dust_tot[idx], 1e-300)),
            ndust_tot=take(n_dust_tot),
            ratioDust2HnucNum=take(self.d2h),
            SitesPerGrain=self._t(
                4.0 * np.pi * self.grain_a[idx] ** 2 * c.SitesDensity_CGS),
        )
        cs = np.sqrt(c.kBoltzmann_CGS * np.maximum(self.Tgas[idx], 1.0)
                     / (c.mProton_CGS * 1.4 * 2.0))
        missing = torch.where(torch.arange(4, device=dev) >= self.n_dust,
                              torch.inf, 0.0).to(torch.float64)
        en_gain = self.tallies.en_gain.to(torch.float64)[:, it]
        tenv = thermal.ThermalEnv(
            PAH_abundance=full(c.PAH_abundance_0),
            MeanMolWeight=full(1.4),
            alpha_viscosity=full(cfg.base_alpha),
            omega_Kepler=take(self.omega_K),
            velo_width_turb=self._t(cs),
            coherent_length=self._t(cs / self.velo_grad[idx]),
            Ncol_toStar=take(sh.Ncol_toStar),
            Neufeld_G=full(1.0),
            Neufeld_dv_dz=self._t(self.velo_grad[idx] * 1e-5),
            n_dusts=pad4(self.n_dusts[:, idx]),
            sig_dusts=pad4(np.tile(self.sig_dusts[:, None], (1, B))),
            Tdusts=pad4(self.Tdusts[:, idx]),
            en_gains=en_gain.T @ eye + missing,
            mdusts_cell=pad4((self.n_dusts[:, idx] * self.vol[None, idx])
                             * self.pmass[:, None]),
            # AU^3, as the JAX package keeps it (ThermalEnv.volume)
            volume=take(self.vol / c.AU2cm ** 3),
        )
        return env, tenv

    def thermal_visser(self):
        from ..io import tables
        if not hasattr(self, "_visser"):
            self._visser = tables.VisserCOShielding(self.device)
        return self._visser

    # ------------------------------------------------------------------
    def _refuse_unported(self, loop=True, save_dir=None):
        """Raise NotImplementedError for an option whose code path is not
        ported yet: the chemistry sweep's, and with loop those of run."""
        cfg = self.cfg
        asks = [("evolT=False (equilibrium-temperature update)",
                 not cfg.evolT, "thermal.solve_equilibrium_T"),
                ("chem_stream=False (chunked sweep)", not cfg.chem_stream,
                 "the chunked sweep")]
        if loop:
            asks += [("do_vertical_with_Tdust", cfg.do_vertical_with_Tdust,
                      "the vertical structure"),
                     ("do_vertical_every", cfg.do_vertical_every > 0,
                      "the vertical structure"),
                     ("do_refine", cfg.do_refine, "AMR"),
                     ("do_merge", cfg.do_merge, "AMR"),
                     ("run(save_dir=...)", save_dir is not None,
                      "the per-iteration outputs")]
        for name, asked, item in asks:
            if asked:
                raise NotImplementedError(
                    f"{name}: {item} is not ported yet")

    def _pool_sweep(self, act, touts):
        """Stream all active cells through one constant-width solver
        window (odesys.solve_pool): finished lanes retire and refill
        from the pool, the per-lane tolerance ladder replaces the
        chunk-level re-solve ladder.  evolT=True only.  Returns the
        indices of cells that failed every ladder level."""
        cfg = self.cfg
        nS = self.net.n_species
        t_env0 = time.time()
        env, tenv = self.assemble_envs(act)
        self._t_envs = getattr(self, "_t_envs", 0.0) \
            + (time.time() - t_env0)
        y0b = self._t(np.ascontiguousarray(self.X[:, act].T))
        T0b = self._t(self.Tgas[act])
        d2g = float(self.d2h.mean())
        rtol, atol = odesys.tolerance_ladder(
            self.net, 1, cfg.rtol_chem, cfg.atol_chem, d2g, self.device)
        retry = self.ode.retry_ladder(
            max(cfg.nlocal_iter - 1, 0), cfg.rtol_chem, cfg.atol_chem,
            d2g) or None
        W = min(cfg.chem_chunk, len(act))
        n_chunks = -(-len(act) // W)
        wall = (cfg.chunk_wall_s * n_chunks * cfg.nlocal_iter) or None
        t0 = time.time()
        res = self.ode.solve_pool(
            env, y0b, T0b, touts, rtol, atol, width=W,
            first_step=cfg.dt_first, evolT=cfg.evolT, tenvs=tenv,
            max_steps_per_interval=cfg.max_steps_per_interval,
            retry_tols=retry, max_wall_s=wall,
            rounds_per_call=POOL_ROUNDS_PER_CALL,
            progress_cb=lambda k, st: (
                self.say(f"      ...pool call {k}")
                if k and k % 32 == 0 else None))
        self.pool_result = res
        ok = ~res.fail.numpy()
        yf = res.ys[:, -1, :].numpy()
        self.X[:, act[ok]] = yf[ok, :nS].T
        self.Tgas[act[ok]] = yf[ok, nS]
        lvl = res.retry_level.numpy().astype(int)
        self.say(f"    pool sweep: {len(act)} cells, width {W}, "
                 f"{int(res.n_steps.sum())} steps, "
                 f"{int((~ok).sum())} failed, ladder levels "
                 f"{np.bincount(lvl, minlength=4).tolist()}, "
                 f"{time.time() - t0:.1f}s")
        return act[~ok]

    # ------------------------------------------------------------------
    def chemistry_step(self, iiter=1):
        """One full-disk chemistry(+T) sweep over the active cells.

        Cells are ordered by density so that neighbouring lanes of the
        window are similarly stiff.  Returns the converged fraction."""
        self._refuse_unported(loop=False)
        cfg = self.cfg
        act = np.nonzero(self.grid.using)[0]
        act = act[np.argsort(self.grid.n0[act])]
        touts = bdfmod.log_output_times(cfg.dt_first, cfg.t_max,
                                        cfg.ratio_tstep)
        # initial Tgas guess (reference set_initial_condition_4solver,
        # disk.f90:2014-2047): slightly above Tdust on first iteration
        if iiter == 1:
            self.Tgas = np.maximum(self.Tdust * 1.1 + 10.0, self.Tgas)
            if cfg.depletion is not None:
                from . import depletion as depl
                self.say("  applying O/C depletion to initial abundances")
                self.X = depl.apply_depletion(
                    self.net, self.X, self.grid, self.grid.n0, self.Tgas,
                    cfg.depletion, star_mass=cfg.star_mass,
                    t_evol=cfg.t_max)
        abun_prev = self.X.copy()
        self.prepare_sweep_fields()
        pending = self._pool_sweep(act, touts) if len(act) \
            else np.array([], dtype=np.int64)
        self.quality[pending] += 512
        if len(pending):
            self.say(f"  {len(pending)} cells failed all "
                     f"{cfg.nlocal_iter} tolerance levels (quality +512)")
        # convergence bookkeeping on the 10 key species (reference
        # check_convergency_cell, disk.f90:1901-1915)
        ki = self.net.key_species_idx
        d = np.abs(self.X[ki][:, act] - abun_prev[ki][:, act])
        tol = cfg.atol_abun + cfg.rtol_abun * np.abs(
            self.X[ki][:, act] + abun_prev[ki][:, act])
        self.converged_cells = (d <= tol).all(axis=0)
        frac = self.converged_cells.mean() if len(act) else 1.0
        self.say(f"  converged cells: {self.converged_cells.sum()}"
                 f"/{len(act)} ({frac * 100:.1f}%)")
        return frac

    # ------------------------------------------------------------------
    def run(self, n_iter=None, save_dir=None):
        """The fixed-point loop: the initial MC, then per iteration a MC
        run (from the second on), the chemistry sweep and the convergence
        check.  Each iteration's stage times (s) go to self.stage_times
        and a "stage timing" line, printed before the convergence check
        (the JAX package prints it after, so not on the last iteration
        of a converged run)."""
        n_iter = self.cfg.n_iter if n_iter is None else n_iter
        self._refuse_unported(save_dir=save_dir)
        self.say("initial Monte Carlo (Tdust bootstrap)...")
        t_st = time.time()
        self.run_mc()
        self.t_mc_initial = time.time() - t_st
        self.stage_times = []
        for it in range(1, n_iter + 1):
            self.say(f"=== iteration {it}/{n_iter} ===")
            stage_t = {}
            t_st = time.time()
            if it > 1:
                self.run_mc(seed=it)
            stage_t["mc"] = time.time() - t_st
            t_st = time.time()
            self._t_envs = 0.0
            frac = self.chemistry_step(iiter=it)
            stage_t["chemistry"] = time.time() - t_st
            stage_t["shielding"] = self._t_shield
            stage_t["env-assembly"] = self._t_envs
            self.stage_times.append(stage_t)
            self.say("  stage timing: " + "  ".join(
                f"{k} {v:.1f}s" for k, v in stage_t.items()))
            if frac >= self.cfg.converged_fraction:
                self.say("converged.")
                break
        return self
