"""Disk model orchestration: prepare the model and run the
Lucy-iterated Monte Carlo dust pass.

Counterpart of the JAX package's ``models/driver.py`` (reference:
src/disk.f90:1519 ``disk_iteration_prepare``, :1204-1441
``post_montecarlo``).  Ported so far: the configuration, ``prepare``
without the column-density path matrices, the per-cell state, and
``run_mc`` on a single device (the streamed pass, whose walk and
terminal fold are kernels K3 and K4 on a CUDA device).  The chemistry
sweep, columns, vertical structure, AMR and outputs come with later
slices.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
from torch.profiler import record_function

from .. import constants as c
from ..io import draine, umist
from ..ops import fields, geometry, mcrt, odesys, optics, thermal
from . import density, star as starmod
from .grid import Grid, GridConfig, make_grid


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
    """The star, disk structure, chemistry files and MC control fields of
    the JAX package's DiskConfig (same names and defaults)."""
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
    # MC control
    mc: optics.McConfig = None
    n_mc_passes: int = 3
    nph_per_pass: int = 200_000
    maxw: float = 0.95
    UV_G0_background: float = 1.0
    minimum_Tdust: float = 1.0
    dust_depletion: float = 1.0
    hc: thermal.HcConfig = dataclasses.field(default_factory=thermal.HcConfig)


class DiskModel:
    """Holds the prepared state on one device; run_mc drives the
    Lucy-iterated MC passes."""

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
