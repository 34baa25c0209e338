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
device), both chemistry sweeps (whose Newton factor and solve are kernels
K1 and K2): the pool sweep (``chem_stream=True``) and the chunked sweep
(``chem_stream=False``), each on both branches, ``evolT=True`` (the
coupled chemistry and temperature) and ``evolT=False`` (fixed-T
chemistry, then the equilibrium temperature by bisection), with the
gas-dust energy-exchange modes of ``cfg.hc``; ``chemistry_step`` with its
convergence bookkeeping, the hydrostatic vertical structure
(``vertical_bootstrap``, ``vertical_adjust``), AMR refine/merge
(``amr_step``, ``adopt_grid``), ``run`` with its per-iteration outputs
(``save_dir``), and ``sed``.  Not ported yet, raising
``NotImplementedError`` when asked for: the sharded multi-device pass.
"""

from __future__ import annotations

import dataclasses
import pathlib
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
# solution does not depend on its slot or on the round it starts in, as
# tests/test_torch_run.py shows on more cells than window slots in both
# packages; a stiff lane's can, through the window's shared Newton
# refresh (ROADMAP.md §3).
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
    # hydrostatic vertical structure (reference
    # do_vertical_struct_with_Tdust, disk.f90:984-1093) and its re-balance
    # every k-th iteration
    do_vertical_with_Tdust: bool = False
    n_vert_iter_tdust: int = 4
    do_vertical_every: int = 0        # 0 = off
    # moving-grid hydrostatic variant (reference
    # vertical_structure.f90:354-518) instead of the fixed-grid one
    vertical_moving: bool = False
    disk_gas_mass_preset: float | None = None
    # AMR refine/merge during iteration (reference disk.f90:3646-4033)
    do_refine: bool = False
    do_merge: bool = False
    refine_watch_species: tuple = ("H2", "H2O", "CO", "E-")
    # reference-format watch-list file (species_check_refine.dat); overrides
    # refine_watch_species when set
    refine_watch_file: str | None = None
    refine_threshold: float = 10.0
    merge_tol: float = 1.5
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
    # the JAX package shards its chemistry over several devices with it;
    # on one device, as here, it has no effect there either
    shard_chemistry: bool = True


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
        # when set, say() also appends each line to this file as it runs
        # (the reference tees to logs/log.dat, sub_trivials.f90:1088)
        self.log_path = None
        # one record per MC pass: wall time, packets, walk chunks,
        # refills, kernel launches, fates and the cells it read
        self.mc_stats = []

    def say(self, msg):
        self.log.append(msg)
        print(msg, flush=True)
        if self.log_path is not None:
            with open(self.log_path, "a") as f:
                f.write(msg + "\n")

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
        if cfg.hc.tdust_iter_tandem or cfg.hc.dust_gas_linear_couple:
            # the gas-dust exchange modes need the Tdust(energy) LUT, which
            # exists once the optics tables are built
            self.thermal = thermal.ThermalBalance(
                self.net, config=cfg.hc, device=dev,
                tdust_lut=(self.tab.lut_Tds, self.tab.lut_vals))
            self.ode = odesys.ChemicalODE(self.net, thermal=self.thermal,
                                          device=dev)

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
    def adopt_grid(self, new_grid, rho_dust=None):
        """Swap in another grid (the checkpoint restore of an AMR-refined
        mesh, reference use_backup_grid_data) and rebuild every
        geometry-dependent structure on the model's device.  The caller
        supplies the matching per-cell state afterwards (or rho_dust
        here)."""
        self.grid = new_grid
        if rho_dust is not None:
            self.rho_dust = rho_dust
        elif self.rho_dust.shape[1] != new_grid.n_cells:
            # keep shapes coherent until the caller restores the real
            # per-cell state
            self.rho_dust = np.zeros((self.n_dust, new_grid.n_cells))
        self._rebuild_geometry()
        self._derive_cell_state()
        self.fields = None

    def _rebuild_geometry(self):
        """The grid index and both path matrices, on the model's device,
        for the grid as it now is."""
        self.gi = geometry.build_grid_index(self.grid, self.device)
        self.W_star, self.W_ism = columns.build_path_matrices(
            self.grid, self.gi, device=self.device)

    def _derive_cell_state(self):
        """Per-cell quantities derived from (grid, rho_dust); re-run after
        any density (vertical balance) or geometry (AMR) change."""
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
        # the sweep-level shielding cache is stale after any density or
        # geometry change
        self._shield = None
        self.omega_K = np.sqrt(c.GravitationConst_CGS * cfg.star_mass
                               * c.Msun_CGS / (rc * c.AU2cm) ** 3)
        self.velo_grad = 0.5 * np.sqrt(
            c.GravitationConst_CGS * cfg.star_mass * c.Msun_CGS
            / (rc * c.AU2cm)) / (rc * c.AU2cm)

    def vertical_adjust(self):
        """Hydrostatic re-balance of the gas columns from the current
        Tdust, on the host (reference vertical_structure.f90: the
        fixed-grid `_alt` variant, or with cfg.vertical_moving the
        moving-grid `_balance` + `shift_and_scale_above`).  Called by the
        Tdust bootstrap and every do_vertical_every iterations.  Returns
        whether every rescale factor lies in [0.5, 2] (reference
        disk.f90:1082-1085)."""
        from ..ops import vertical
        cfg = self.cfg
        g = self.grid
        m_before = vertical.disk_gas_mass(g, g.n0)
        T = np.maximum(self.Tdust, cfg.minimum_Tdust)
        if cfg.vertical_moving:
            zmin_n, zmax_n, n_new, rho_d_new, maxf, minf = \
                vertical.pressure_gravity_balance_moving(
                    g, g.n0, T, self.rho_dust, cfg.star_mass,
                    use_Tdust=True, zmax_dom=cfg.grid.zmax)
            g.zmin = zmin_n
            g.zmax = zmax_n
            # the grid moved: its index and path matrices with it
            self._rebuild_geometry()
            using_new = g.using
        else:
            n_new, rho_d_new, using_new, maxf, minf = \
                vertical.pressure_gravity_balance(
                    g, g.n0, T, self.rho_dust, cfg.star_mass,
                    use_Tdust=True, pmass=self.pmass,
                    disk_gas_mass_preset=cfg.disk_gas_mass_preset)
        g.n0 = n_new
        g.using = using_new
        self.rho_dust = rho_d_new
        self._derive_cell_state()
        m_after = vertical.disk_gas_mass(g, g.n0)
        self.say(f"  vertical balance: gas mass {m_before:.4e} -> "
                 f"{m_after:.4e} Msun, rescale range [{minf:.3g}, {maxf:.3g}]")
        return (maxf <= 2.0) and (minf >= 0.5)

    def vertical_bootstrap(self):
        """Alternate MC and hydrostatic passes until the rescale factors
        settle, at most n_vert_iter_tdust times (reference
        do_vertical_struct_with_Tdust, disk.f90:984-1093)."""
        cfg = self.cfg
        for j in range(cfg.n_vert_iter_tdust):
            self.say(f"vertical-structure pass {j + 1}/"
                     f"{cfg.n_vert_iter_tdust}")
            self.run_mc(seed=1000 + j)
            if self.vertical_adjust() and j >= 1:
                self.say("  vertical structure converged (with Tdust)")
                break

    def amr_step(self):
        """Refine cells on chemistry fronts and (with cfg.do_merge) merge
        uniform vertical pairs, on the host; remap the per-cell state and
        rebuild the geometry on the device (reference do_refine /
        merge_cells + remake_index, disk.f90:3646-4033, 3887).  The fields
        are dropped; the tallies keep the old grid's length until the next
        MC pass, which rebuilds both.  Returns whether the grid changed."""
        from . import amr
        cfg = self.cfg
        if cfg.refine_watch_file:
            watch, min_abun = amr.load_watch_list(cfg.refine_watch_file,
                                                  self.net)
        else:
            watch = np.asarray([self.net.idx[s]
                                for s in cfg.refine_watch_species
                                if s in self.net.idx])
            min_abun = 1e-15
        mask = amr.need_refine(self.grid, self.X, watch,
                               thresh=cfg.refine_threshold,
                               min_abun=min_abun,
                               min_dz=cfg.grid.smallest_cell_size)
        pairs = []
        if cfg.do_merge and self.fields is not None:
            pairs = amr.need_merge(
                self.grid, self.grid.n0, self.Tdust,
                self.fields.Av_toStar.cpu().numpy(), tol=cfg.merge_tol)
            # never merge a pair involving a refine-marked cell, nor a cell
            # in two pairs (a departure from the JAX package, which leaves
            # a hole in the column there; amr.disjoint_pairs)
            pairs = amr.disjoint_pairs(
                [(a, b) for a, b in pairs if not (mask[a] or mask[b])])
        if not mask.any() and not pairs:
            return False
        self.say(f"  AMR: refining {int(mask.sum())} cells, "
                 f"merging {len(pairs)} pairs")
        n_was, act_was = self.grid.n_cells, int(self.grid.using.sum())
        self.grid, parent = amr.adapt_grid(self.grid, mask, pairs)
        self._rebuild_geometry()
        (self.X, self.Tgas, self.Tdust, self.Tdusts, self.quality,
         self.rho_dust) = amr.remap_state(
            parent, self.X, self.Tgas, self.Tdust, self.Tdusts,
            self.quality, self.rho_dust)
        self._derive_cell_state()
        self.fields = None
        self.say(f"  AMR: grid now {self.grid.n_cells} cells, "
                 f"{int(self.grid.using.sum())} active (was {n_was}, "
                 f"{act_was})")
        return True

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
                     f"{stats['packets']} packets in {stats['wall_s']:.1f}s, "
                     f"{stats['chunks']} walk chunks ("
                     f"{stats['tail_chunks']} with at most "
                     f"{mcrt.TAIL_LANES} live lanes); "
                     f"Tdust {self.Tdust[use].min():.1f}.."
                     f"{self.Tdust[use].max():.1f} K; "
                     f"esc {fates['escaped']} "
                     f"destr {fates['destructed']} "
                     f"prem {fates['premature']}")

    # ------------------------------------------------------------------
    def sed(self, dist_pc=100.0):
        """Observed SED per viewing-angle bin from the escape collector,
        in float64 on the host, as the JAX package computes it.

        Role of the reference photon collector output
        (save_collected_photons_iter, montecarlo.f90:1869-2097): the
        escaped-packet energy tally [erg/s] per (mu, lambda) bin becomes
        F_lambda [erg s^-1 cm^-2 A^-1] at the given distance, assuming
        each mu bin's energy spreads over its solid-angle annulus (x2 for
        the mirrored lower hemisphere).  Returns (bin centres [A],
        F [n_mu, nlam - 1]).
        """
        coll = self.tallies.collector.cpu().numpy()     # [n_mu, nlam]
        lam = np.asarray(self.tab.lam, dtype=np.float64)
        dlam = np.diff(lam)
        n_mu = coll.shape[0]
        dmu = 1.0 / n_mu
        d2 = (dist_pc * c.pc2cm) ** 2
        # solid angle of one |mu| bin, both hemispheres: 2 x 2 pi dmu
        omega_bin = 4.0 * np.pi * dmu
        F = coll[:, :-1] / dlam[None, :] / (omega_bin * d2)
        return 0.5 * (lam[1:] + lam[:-1]), F

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
    def _sweep_d2g(self, act):
        """The dust-to-H ratio of a sweep's tolerance ladder (its grain
        atols): the mean over the cells the sweep solves.  In the port
        only: the JAX package averages over every cell, in both sweeps,
        and a hydrostatic pass that empties a cell of gas (n0 -> 0, the
        dust kept) makes that mean ~1e161, so the grain species lose all
        error control."""
        return float(self.d2h[act].mean())

    def _pool_sweep(self, act, touts):
        """Stream all active cells through one constant-width solver
        window (odesys.solve_pool): finished lanes retire and refill
        from the pool, the per-lane tolerance ladder replaces the
        chunk-level re-solve ladder.  With evolT=False the gas temperature
        is then set to its equilibrium (_equilibrium_T).  Returns the
        indices of cells that failed every ladder level."""
        cfg = self.cfg
        nS = self.net.n_species
        t_env0 = time.time()
        env, tenv = self.assemble_envs(act)
        self._t_envs = getattr(self, "_t_envs", 0.0) \
            + (time.time() - t_env0)
        y0b = self._t(np.ascontiguousarray(self.X[:, act].T))
        T0b = self._t(self.Tgas[act])
        d2g = self._sweep_d2g(act)
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
        if cfg.evolT:
            self.Tgas[act[ok]] = yf[ok, nS]
        lvl = res.retry_level.numpy().astype(int)
        self.say(f"    pool sweep: {len(act)} cells, width {W}, "
                 f"{int(res.n_steps.sum())} steps, "
                 f"{int((~ok).sum())} failed, ladder levels "
                 f"{np.bincount(lvl, minlength=4).tolist()}, "
                 f"{res.n_rounds} BDF rounds, {time.time() - t0:.1f}s"
                 + (f" of a {wall:.0f}s budget" if wall else ""))
        if not cfg.evolT:
            self._equilibrium_T(act, ok, W)
        return act[~ok]

    def _equilibrium_T(self, act, ok, W):
        """The evolT=False temperature update, as the JAX package's pool
        sweep makes it: in windows of W cells (the last padded by
        repeating its last cell), each with its environments assembled
        afresh, y = [X after the sweep, Tgas] and T0 = max(Tgas, 2) K,
        solve_equilibrium_T; a cell takes the new T only where it was
        both bracketed and solved (ok)."""
        t0 = time.time()
        n_brk = 0
        for lo in range(0, len(act), W):
            idx = act[lo:lo + W]
            n_real = len(idx)
            if n_real < W:
                idx = np.concatenate([idx, np.repeat(idx[-1:], W - n_real)])
            env, tenv = self.assemble_envs(idx)
            y = self._t(np.concatenate([self.X[:, idx].T,
                                        self.Tgas[idx][:, None]], axis=1))
            Teq, brk = self.thermal.solve_equilibrium_T(
                y, env, tenv, self._t(np.maximum(self.Tgas[idx], 2.0)),
                self.ode.tab)
            brk = brk.cpu().numpy()[:n_real]
            n_brk += int(brk.sum())
            upd = brk & ok[lo:lo + n_real]
            self.Tgas[idx[:n_real][upd]] = Teq.cpu().numpy()[:n_real][upd]
        self.say(f"    equilibrium T: {n_brk} cells bracketed, "
                 f"{len(act) - n_brk} not, {time.time() - t0:.1f}s")

    def _solve_chunk(self, idx, n_real, level, touts, d2g):
        """Solve one chunk of cells (idx, padded to the chunk width by
        repeating its last cell; the first n_real are real) at tolerance
        level `level` through the record driver
        (ChemicalODE.solve_batched(host_loop=True), a barrier at every
        output time, chunk_wall_s its wall budget), and write the solved
        cells back into (X, Tgas); with evolT=False their equilibrium T
        follows.  Returns (ok over the n_real cells, their accepted
        steps, the BDF rounds run)."""
        cfg = self.cfg
        nS = self.net.n_species
        t_env0 = time.time()
        env, tenv = self.assemble_envs(idx)
        self._t_envs = getattr(self, "_t_envs", 0.0) \
            + (time.time() - t_env0)
        rtol, atol = odesys.tolerance_ladder(
            self.net, level, cfg.rtol_chem, cfg.atol_chem, d2g, self.device)
        res = self.ode.solve_batched(
            env, self._t(np.ascontiguousarray(self.X[:, idx].T)),
            self._t(self.Tgas[idx]), touts, rtol, atol,
            first_step=cfg.dt_first, evolT=cfg.evolT, tenvs=tenv,
            max_steps_per_interval=cfg.max_steps_per_interval,
            host_loop=True, max_wall_s=cfg.chunk_wall_s or None,
            progress_cb=lambda i, s: (
                self.say(f"      ...interval {i}")
                if i and i % 16 == 0 else None))
        ok = ~res.fail[:n_real].cpu().numpy()
        cells = idx[:n_real]
        yf = res.ys[:n_real, -1, :].cpu().numpy()
        self.X[:, cells[ok]] = yf[ok, :nS].T
        if cfg.evolT:
            self.Tgas[cells[ok]] = yf[ok, nS]
        else:
            self._equilibrium_T(cells, ok, n_real)
        return ok, int(res.n_steps[:n_real].sum()), res.n_rounds

    def _chunked_sweep(self, act, touts):
        """The chunked sweep (chem_stream=False): the active cells in
        chunks of chem_chunk (the last padded to full width by repeating
        its last cell), each solved alone (_solve_chunk); at each
        tolerance level of 1..nlocal_iter the cells still failing are
        re-solved, in whole chunks of them, at the next level.  d2g is
        taken over act, as in the pool sweep (_sweep_d2g).  Returns the
        cells that failed every level."""
        cfg = self.cfg
        d2g = self._sweep_d2g(act)
        W = cfg.chem_chunk
        pending = act
        n_done = 0
        self.chunk_rounds = 0
        for level in range(1, cfg.nlocal_iter + 1):
            if len(pending) == 0:
                break
            if level > 1:
                self.say(f"  retry level {level}: "
                         f"{len(pending)} cells at relaxed tolerances")
            failed = []
            for lo in range(0, len(pending), W):
                idx = pending[lo:lo + W]
                t_chunk = time.time()
                n_real = len(idx)
                if n_real < W:
                    idx = np.concatenate([idx,
                                          np.repeat(idx[-1:], W - n_real)])
                ok, steps, rounds = self._solve_chunk(idx, n_real, level,
                                                      touts, d2g)
                self.chunk_rounds += rounds
                n_done += int(ok.sum())
                failed.append(idx[:n_real][~ok])
                self.say(f"    chunk {lo // W} (level {level}): {n_real} "
                         f"cells, {steps} steps, {int((~ok).sum())} failed, "
                         f"{rounds} BDF rounds, "
                         f"{time.time() - t_chunk:.1f}s; "
                         f"done {n_done}/{len(act)}")
            pending = np.concatenate(failed)
        return pending

    # ------------------------------------------------------------------
    def chemistry_step(self, iiter=1):
        """One full-disk chemistry(+T) sweep over the active cells.

        Cells are ordered by density so that neighbouring lanes of the
        window are similarly stiff.  The cells go through the pool sweep,
        or with chem_stream=False through the chunked sweep.  Returns the
        converged fraction."""
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
        if not len(act):
            pending = np.array([], dtype=np.int64)
        elif cfg.chem_stream:
            pending = self._pool_sweep(act, touts)
        else:
            pending = self._chunked_sweep(act, touts)
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
        """The fixed-point loop: with do_vertical_with_Tdust the hydrostatic
        bootstrap (vertical_bootstrap), the initial MC, then per iteration
        a MC run (from the second on), the chemistry sweep and the
        convergence check; after the check, while it < n_iter, the
        hydrostatic re-balance (vertical_adjust, every do_vertical_every
        iterations) and AMR (amr_step, with do_refine).  Each iteration's
        stage times (s) go to self.stage_times ("vertical" and "amr" where
        those are switched on) and two "stage timing" lines: the first
        before the convergence check (the JAX package prints one line
        after the re-balance and AMR, so none on the last iteration of a
        converged run), the second with the re-balance and AMR.  save_dir:
        if given, the per-cell table of every iteration goes to
        save_dir/iter_NNNN.npz after its chemistry step, before the
        convergence check (reference iter_NNNN.dat, disk.f90:2745-3074)."""
        cfg = self.cfg
        n_iter = cfg.n_iter if n_iter is None else n_iter
        if cfg.do_vertical_with_Tdust:
            self.vertical_bootstrap()
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
            if save_dir is not None:
                from . import output as outmod
                p = pathlib.Path(save_dir) / f"iter_{it:04d}.npz"
                outmod.save_iter_npz(p, self, it)
                self.say(f"  saved {p}")
            if frac >= cfg.converged_fraction:
                self.say("converged.")
                break
            if it == n_iter:
                break
            after = {}
            if cfg.do_vertical_every > 0:
                t_st = time.time()
                if it % cfg.do_vertical_every == 0:
                    self.vertical_adjust()
                after["vertical"] = time.time() - t_st
            if cfg.do_refine:
                t_st = time.time()
                self.amr_step()
                after["amr"] = time.time() - t_st
            if after:
                stage_t.update(after)
                self.say("  stage timing: " + "  ".join(
                    f"{k} {v:.1f}s" for k, v in after.items()))
        return self
