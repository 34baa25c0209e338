"""Batched Monte Carlo continuum radiative transfer.

Counterpart of the JAX package's ``ops/mcrt.py`` (reference:
src/montecarlo.f90:398-800 ``montecarlo_do`` /
``walk_scatter_absorb_reemit``).

- Packets are a structure of arrays.  The walk advances every live
  packet by up to ``max_steps`` steps per call: on a CUDA tensor that is
  kernel K3 (``csrc/mcwalk.cu``, a persistent grid whose threads walk
  packets one after another, the step loop inside the kernel, tallies by
  atomic adds); on a CPU tensor, or with
  ``walk="plain"``, it is ``_walk_plain``, the JAX walk body as batched
  torch ops, one step per loop iteration.  Both advance the packet
  arrays and the tallies IN PLACE.
- The walk RNG is a per-lane xorshift128 carried in the packets (the
  same words and draws as the JAX package's ``_xs_draws``), so a chunked
  walk draws the same stream as an unchunked one.
- Dust temperature is frozen within a pass (Lucy iteration): absorbed
  energy is tallied and Tdust re-derived between passes.
- Terminal tallies (escape collector, water deposit) are folded once per
  retired lane, outside the walk: kernel K4 or ``_fold_terminal_plain``.
- Packet launch draws from an explicit ``torch.Generator``; the JAX
  package's threefry stream has no torch twin, so passes agree with it
  statistically, and walks agree lane by lane when they start from the
  same packets (``convert.packets``).
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from .. import constants as c
from ..io import bethell
from ..utils.spans import span
from . import geometry, optics
from .optics import f32

F = torch.float32

ST_ACTIVE = 0
ST_ESCAPED = 1
ST_DESTRUCTED = 2
ST_PREMATURE = 3
ST_PADDING = 4      # compaction filler lane: never tallied, never counted
ST_DESTR_WATER = 5  # destroyed by water absorption (its en deposit is
                    # folded outside the walk loop; counts as destructed)

N_CODES = 6         # status codes 0-5, counted per pass by the fold
N_TLYA = 64         # ln T bins of the Lyman-alpha sigma table
TAIL_LANES = 64     # a streamed pass's tail: at most this many live lanes
M32 = 0xFFFFFFFF
XS_MUL = 2654435761  # Knuth multiplicative scramble of the xorshift output
# G Msun / AU: v_kepler^2 = DOPPLER_K * star_mass / r[AU]  (cm^2/s^2)
DOPPLER_K = c.GravitationConst_CGS * c.Msun_CGS / c.AU2cm


class McCells(NamedTuple):
    """Per-cell physical state entering the transport (tensors)."""
    rmin: torch.Tensor
    rmax: torch.Tensor
    zmin: torch.Tensor
    zmax: torch.Tensor
    using: torch.Tensor          # [n] bool
    n_gas: torch.Tensor          # [n]
    n_HI: torch.Tensor           # [n]
    n_H2O: torch.Tensor          # [n]
    Tgas: torch.Tensor           # [n] (Lyman-alpha profile width)
    rho_dust: torch.Tensor       # [n_dust, n] g/cm^3
    dust_depletion: torch.Tensor  # [n]
    d2h: torch.Tensor            # [n] dust/H number ratio
    grain_a: torch.Tensor        # [n] grain radius cm
    Tdust: torch.Tensor          # [n_dust, n] frozen reemission temperature
    mdust_cell: torch.Tensor     # [n_dust, n] total dust mass in cell, g
    abso_wei: torch.Tensor       # [n_dust, n] absorption weight per dust


class McTallies(NamedTuple):
    flux: torch.Tensor          # [n_cells, nlam]  sum of length*en (AU erg/s)
    phc: torch.Tensor           # [n_cells, nlam]  photon segment counts
    dir_flux: torch.Tensor      # [n_cells, 3] direction-weighted flux
    en_gain: torch.Tensor       # [n_dust, n_cells] continuous absorption
    en_gain_abso: torch.Tensor  # [n_dust, n_cells] discrete absorption
    ab_en_water: torch.Tensor   # [n_cells]
    cr_count: torch.Tensor      # [n_cells]
    collector: torch.Tensor     # [n_mu, nlam] escaped-energy SED bins
    collector_img: torch.Tensor  # [n_mu, n_r, n_phi, nlam] image-plane bins
    mrw_path: torch.Tensor      # [n_cells] en-weighted MRW path (AU)
    en_gain_mrw: torch.Tensor   # [n_dust, n_cells] MRW absorption beyond
                                # the lam >= mrw_lam_min flux window

    @staticmethod
    def zeros(n_cells, nlam, n_dust, n_mu, n_r=8, n_phi=8, *, device):
        def z(*shape):
            return torch.zeros(shape, dtype=F, device=device)
        return McTallies(z(n_cells, nlam), z(n_cells, nlam), z(n_cells, 3),
                         z(n_dust, n_cells), z(n_dust, n_cells),
                         z(n_cells), z(n_cells), z(n_mu, nlam),
                         z(n_mu, n_r, n_phi, nlam), z(n_cells),
                         z(n_dust, n_cells))


class Packets(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    vx: torch.Tensor
    vy: torch.Tensor
    vz: torch.Tensor
    lam: torch.Tensor        # angstrom, global frame
    en: torch.Tensor
    cell: torch.Tensor       # int32
    tau: torch.Tensor        # remaining optical depth to next event
    status: torch.Tensor     # int32
    e_count: torch.Tensor    # int32 encounter counter
    # per-lane xorshift128 state: the uint32 words' bit patterns, int32
    rs0: torch.Tensor = None
    rs1: torch.Tensor = None
    rs2: torch.Tensor = None
    rs3: torch.Tensor = None

    def clone(self) -> "Packets":
        return Packets(*(a.clone() for a in self))

    def take(self, idx) -> "Packets":
        return Packets(*(a[idx] for a in self))


def _u32(a):
    """int32 bit pattern -> its uint32 value, as int64."""
    return a.to(torch.int64) & M32


def _i32(v):
    """uint32 value in int64 -> the int32 with the same bits."""
    return torch.where(v >= (1 << 31), v - (1 << 32), v).to(torch.int32)


def _mul32(t, k):
    """(t * k) mod 2**32 for t < 2**32, without int64 overflow."""
    lo, hi = k & 0xFFFF, k >> 16
    return (t * lo + (((t * hi) & 0xFFFF) << 16)) & M32


def xorshift_draws(st, n):
    """n xorshift128 draws per lane from st = (s0, s1, s2, s3), uint32
    values held in int64.  Marsaglia xorshift128 + Knuth multiplicative
    scramble, top 24 bits -> f32 in [0, 1) (JAX ``_xs_draws``).
    Returns ([n, B] f32, new state)."""
    s0, s1, s2, s3 = st
    outs = []
    for _ in range(n):
        t = s3 ^ ((s3 << 11) & M32)
        t = t ^ (t >> 8)
        t = t ^ s0 ^ (s0 >> 19)
        s3, s2, s1, s0 = s2, s1, s0, t
        outs.append((_mul32(t, XS_MUL) >> 8).to(F) * (1.0 / (1 << 24)))
    return torch.stack(outs), (s0, s1, s2, s3)


def _unit_sphere_dir(gen, n, minw, maxw, device):
    w = torch.rand(n, generator=gen, dtype=F, device=device) \
        * (maxw - minw) + minw
    phi = torch.rand(n, generator=gen, dtype=F, device=device) \
        * (2.0 * np.pi)
    s = torch.sqrt(torch.clamp(1.0 - w * w, min=0.0))
    return s * torch.cos(phi), s * torch.sin(phi), w


def _rotate_about(vx, vy, vz, cost, phi):
    """New direction at angle acos(cost) from (vx,vy,vz), azimuth phi
    (reference combine_dir/rot_around_*, montecarlo.f90:1768-1824)."""
    sint = torch.sqrt(torch.clamp(1.0 - cost * cost, min=0.0))
    ux = sint * torch.cos(phi)
    uy = sint * torch.sin(phi)
    uz = cost
    ct = vz
    st = torch.sqrt(torch.clamp(1.0 - vz * vz, min=0.0))
    safe = st > 0.0
    st_safe = torch.where(safe, st, 1.0)
    cp = torch.where(safe, vx / st_safe, 0.0)
    sp = torch.where(safe, vy / st_safe, 1.0)
    ux2 = ux * ct + uz * st
    uy2 = uy
    uz2 = uz * ct - ux * st
    return ux2 * cp - uy2 * sp, uy2 * cp + ux2 * sp, uz2


def _thomson_cost(u):
    """cos(theta) from the dipole phase function: solve y = 3x + x^3 by
    three Newton steps (reference get_reemit_dir_Thomson,
    montecarlo.f90:1725-1762)."""
    y = 8.0 * u - 4.0
    x = y / 3.5
    for _ in range(3):
        x = x - (x * x * x + 3.0 * x - y) / (3.0 * x * x + 3.0)
    return torch.clamp(x, -1.0, 1.0)


def _hg_cost(u, g):
    small = torch.abs(g) <= 1e-2
    g_safe = torch.where(small, 1.0, g)
    t = (1.0 - g * g) / (1.0 + g * (2.0 * u - 1.0))
    cost_hg = 0.5 / g_safe * (1.0 + g * g - t * t)
    return torch.clamp(torch.where(small, 2.0 * u - 1.0, cost_hg), -1.0, 1.0)


def _doppler_vd(star_mass, x, y, z, vx, vy):
    """Line-of-sight Keplerian velocity (reference get_doppler_lam,
    montecarlo.f90:997-1013)."""
    rr = x * x + y * y
    r3 = torch.sqrt(rr + z * z)
    v = torch.sqrt(DOPPLER_K * star_mass / torch.clamp(r3, min=1e-30))
    return (-y * vx + x * vy) * v / torch.sqrt(torch.clamp(rr, min=1e-30))


class McModel(NamedTuple):
    """What one MC pass reads: host tables, grid index, cell state."""
    tab: optics.McTables
    gi: geometry.GridIndex
    cells: McCells
    star_mass: float


def _cellmat_layout(n_dust):
    """Column layout of the packed per-cell matrix (one row read per
    walk step)."""
    base = 12 + 3 * n_dust
    return {
        "rmin": 0, "rmax": 1, "zmin": 2, "zmax": 3, "using": 4,
        "n_gas": 5, "n_HI": 6, "n_H2O": 7, "Tgas": 8,
        "depl": 9, "d2h": 10, "grain_a": 11,
        "rho0": 12,          # per dust i: 12+3i rho, 13+3i Td, 14+3i wei
        "mrw_inv_mfp": base,
        "mrw_base": base + 1,   # precomputed MRW reemission flat base
    }


class WalkSetup:
    """The walk's float32 tables and constants for one pass, on the
    model's device (JAX ``_WalkSetup``).  Both walks read it."""

    def __init__(self, model: McModel, n_quantile: int):
        tab = model.tab
        cells = model.cells
        dev = cells.rmin.device
        self.model = model
        self.device = dev
        self.star_mass = float(model.star_mass)
        self.n_quantile = int(n_quantile)

        def t32(a):
            return torch.as_tensor(np.asarray(a), dtype=F, device=dev)

        # the walk runs in f32: gi and the lambda-segment constants are
        # cast first, so locate and lam_to_bin stay on their f32 paths
        gi = model.gi
        self.gi = gi._replace(r_edges=gi.r_edges.to(F),
                              z_edges=gi.z_edges.to(F))
        self.seg = tab.lam_seg
        cf = {f: getattr(cells, f).to(F)
              for f in ("rmin", "rmax", "zmin", "zmax", "n_gas", "n_HI",
                        "n_H2O", "Tgas", "rho_dust", "dust_depletion",
                        "d2h", "grain_a", "Tdust", "abso_wei")}
        lam_grid = t32(tab.lam)
        self.lam_grid = lam_grid
        self.nlam = lam_grid.shape[0]
        self.n_cells = cells.rmin.shape[0]
        self.n_dust = cells.rho_dust.shape[0]
        self.lam_lo = float(lam_grid[0])
        self.lam_hi = float(lam_grid[-1])
        self.xr_lo = c.lam_range_Xray[0] / c.Angstrom2micron
        self.xr_hi = c.lam_range_Xray[1] / c.Angstrom2micron

        # Tdust LUT index in closed form (log-uniform grid)
        lut_Tds = t32(tab.lut_Tds)
        self.nT = lut_Tds.shape[0]
        lnT0 = torch.log(lut_Tds[0])
        self.lnT0 = float(lnT0)
        self.inv_dlnT = float((self.nT - 1) / (torch.log(lut_Tds[-1])
                                               - lnT0))
        self.td_cold = float(lut_Tds[0])

        # reemission wavelengths pre-baked: one flat read
        self.reemit_lam = lam_grid[torch.as_tensor(
            tab.reemit_q.astype(np.int64), device=dev)].reshape(-1) \
            .contiguous()

        # Lyman-alpha sigma(lam bin, T bin) pairs: linear interpolation
        # in ln T between adjacent bins, 64 log bins over [1, 1e5] K.
        # Evaluated in f64 at the f32 abscissae, then rounded: the JAX
        # package evaluates it in f32, where nu - nu0 cancels and the
        # line-core values are off by up to 13% (tests/
        # test_torch_mc_tables.py measures both against f64)
        self.lnT_lo_lya = 0.0
        self.inv_dlnT_lya = f32((N_TLYA - 1) / np.log(1.0e5))
        T_bins = torch.exp(torch.arange(N_TLYA, dtype=F, device=dev)
                           / self.inv_dlnT_lya)
        lut2d = optics.lya_sigma(lam_grid.double()[:, None],
                                 T_bins.double()[None, :]).to(F)
        self.lya_pair = torch.stack(
            [lut2d, torch.cat([lut2d[:, 1:], lut2d[:, -1:]], 1)],
            dim=-1).reshape(-1, 2).contiguous()        # [nlam*64, 2]

        # Modified Random Walk per-cell precomputation (Min et al. 2009)
        itd_cell = optics.tdust_bin(lut_Tds, cf["Tdust"])
        kap_trR = t32(tab.kap_trR)
        kap_P = t32(tab.kap_P)
        rho_kaptr = torch.gather(kap_trR, 1, itd_cell) * cf["rho_dust"]
        rho_kapP = torch.gather(kap_P, 1, itd_cell) * cf["rho_dust"]
        mrw_inv_mfp = rho_kaptr.sum(0)
        mrw_idom = torch.argmax(rho_kapP, dim=0)
        mrw_itd = torch.gather(itd_cell, 0, mrw_idom[None, :])[0]
        mrw_base = ((mrw_idom * self.nT + mrw_itd) * n_quantile).to(F)
        self.mrw_lnx = t32(tab.mrw_lnx)
        self.n_mrw = self.mrw_lnx.shape[0]

        # packed per-cell matrix (ONE row read per step)
        self.L = _cellmat_layout(self.n_dust)
        cols = [cf["rmin"], cf["rmax"], cf["zmin"], cf["zmax"],
                cells.using.to(F), cf["n_gas"], cf["n_HI"], cf["n_H2O"],
                cf["Tgas"], cf["dust_depletion"], cf["d2h"], cf["grain_a"]]
        for i in range(self.n_dust):
            cols += [cf["rho_dust"][i], cf["Tdust"][i], cf["abso_wei"][i]]
        cols += [mrw_inv_mfp, mrw_base]
        self.cellmat = torch.stack(cols, dim=1).contiguous()  # [n, C]

        # per-lambda-bin optics columns
        tcols = [tab.xr_gas_abs, tab.xr_gas_sca, tab.sigma_h2o,
                 tab.xr_dus_abs0, tab.xr_dus_sca]
        for i in range(self.n_dust):
            tcols += [tab.kab[i], tab.ksc[i], tab.g[i]]
        self.tabmat = t32(np.stack(tcols, axis=1)).contiguous()  # [nlam, K]

    def tdust_idx(self, Td):
        t = (torch.log(torch.clamp(Td, min=1e-30)) - self.lnT0) \
            * self.inv_dlnT
        return torch.clamp(torch.ceil(t), 0, self.nT - 1).to(torch.int64)


def _walk_plain(ws: WalkSetup, pk: Packets, tallies: McTallies,
                max_steps: int, nmax_encounter: int = 200_000,
                use_mrw: bool = True, mrw_gamma: float = 4.0,
                mrw_lam_min: float = 1e4, save_dir: bool = False,
                save_counts: bool = True):
    """K3's plain version: the JAX walk body (``_mc_walk``,
    mcrt.py:438-815) as batched torch ops, one step per iteration, for
    exactly max_steps steps.  Like JAX it advances the RNG of every lane
    every step.  Tallies accumulate per call in sink-padded buffers
    (``index_add_``) and are added once at the end, as JAX folds its
    event log.  Updates pk and tallies in place; returns the number of
    lanes still active (a 0-d tensor).

    Two departures from the JAX walk end lanes that it walks forever
    (K3 makes both, in the same f32 operation order): a crossing through
    a z face lands strictly past the face (``torch.nextafter``), where
    JAX can leave it on the face and locate it back into its own cell;
    and a stuck lane whose relocation leaves it where it was ends as
    ST_PREMATURE, the fate JAX gives it at the encounter cap."""
    L = ws.L
    cm, tm = ws.cellmat, ws.tabmat
    n_cells, nlam, n_dust = ws.n_cells, ws.nlam, ws.n_dust
    nT, nq = ws.nT, ws.n_quantile
    B = pk.x.shape[0]
    dev = pk.x.device
    NCL = n_cells * nlam
    au = f32(c.AU2cm)
    imfp, ibase = L["mrw_inv_mfp"], L["mrw_base"]

    x, y, z = pk.x, pk.y, pk.z
    vx, vy, vz = pk.vx, pk.vy, pk.vz
    lam, en, tau = pk.lam, pk.en, pk.tau
    cellv, status, e_count = pk.cell, pk.status, pk.e_count
    rng = tuple(_u32(a) for a in (pk.rs0, pk.rs1, pk.rs2, pk.rs3))
    extA = torch.zeros(NCL + n_cells + 1, dtype=F, device=dev)
    sinkA = torch.full((B,), NCL + n_cells, dtype=torch.int64, device=dev)
    if save_counts:
        extP = torch.zeros(NCL + 1, dtype=F, device=dev)
        extB = torch.zeros((n_dust + 1) * n_cells + 1, dtype=F, device=dev)
    if save_dir:
        extD = torch.zeros(n_cells, 3, dtype=F, device=dev)

    for _ in range(max_steps):
        u, rng = xorshift_draws(rng, 10)
        u_tau = torch.clamp(u[0], min=1e-12)
        u_ev, u_d1, u_d2, u_q = u[1], u[2], u[3], u[4]
        active = status == ST_ACTIVE

        cell = torch.clamp(cellv, 0, n_cells - 1).to(torch.int64)
        crow = cm[cell]                                  # [B, C]
        rmin, rmax = crow[:, 0], crow[:, 1]
        zmin, zmax = crow[:, 2], crow[:, 3]
        using_c = crow[:, L["using"]] > 0.5
        n_gas = crow[:, L["n_gas"]]
        n_HI = crow[:, L["n_HI"]]
        n_H2O = crow[:, L["n_H2O"]]
        Tg = torch.clamp(crow[:, L["Tgas"]], min=1.0)

        # Modified Random Walk: packets deep inside an optically thick
        # cell take one diffusion step; R0 = inscribed-sphere radius
        if use_mrw:
            r_pk = torch.sqrt(x * x + y * y)
            az = torch.abs(z)
            dz_lo = torch.where(zmin <= 0.0, geometry.FL_BIG, az - zmin)
            R0 = torch.minimum(torch.minimum(r_pk - rmin, rmax - r_pk),
                               torch.minimum(dz_lo, zmax - az)) * 0.999
            mrw = (active & using_c & (lam > mrw_lam_min)
                   & (R0 * c.AU2cm * crow[:, imfp] > mrw_gamma))
            active = active & ~mrw

        length, eps, dirtype, found = geometry.ray_cell_exit_mirror(
            x, y, z, vx, vy, vz, rmin, rmax, zmin, zmax)
        # a ray that misses its own cell relocates (below)
        stuck = active & ~found
        active = active & found

        vd = _doppler_vd(ws.star_mass, x, y, z, vx, vy)
        lam_local = lam * (1.0 + vd / c.SpeedOfLight_CGS)
        ilam = optics.lam_to_bin(ws.seg, lam_local, True).to(torch.int64)
        in_grid = (lam_local >= ws.lam_lo) & (lam_local < ws.lam_hi)
        using = using_c & in_grid
        trow = tm[ilam]                                  # [B, K]
        tT = torch.clamp((torch.log(Tg) - ws.lnT_lo_lya) * ws.inv_dlnT_lya,
                         0.0, N_TLYA - 1.0)
        iT = tT.to(torch.int64)
        fT = tT - iT.to(F)
        sl_pair = ws.lya_pair[ilam * N_TLYA + iT]        # [B, 2]
        sigma_lya = sl_pair[:, 0] * (1.0 - fT) + sl_pair[:, 1] * fT
        ab_gas = trow[:, 0] * n_gas
        sc_gas = trow[:, 1] * n_gas + sigma_lya * n_HI
        ab_h2o = trow[:, 2] * n_H2O
        ab_d, sc_d = [], []
        for i in range(n_dust):
            rho = crow[:, L["rho0"] + 3 * i]
            ab_i = trow[:, 5 + 3 * i] * rho
            sc_i = trow[:, 6 + 3 * i] * rho
            if i == n_dust - 1:
                # X-ray dust terms ride on the last component (reference
                # update_current_accum, montecarlo.f90:1193-1201)
                epsd = crow[:, L["depl"]]
                sraw = trow[:, 3] * epsd
                f = bethell.dust_blanketing(sraw, crow[:, L["d2h"]],
                                            crow[:, L["grain_a"]], torch)
                ab_i = ab_i + f * sraw * n_gas
                sc_i = sc_i + trow[:, 4] * n_gas * epsd
            ab_d.append(ab_i)
            sc_d.append(sc_i)
        ext_ab = ab_gas + ab_h2o + sum(ab_d)
        ext_sc = sc_gas + sum(sc_d)
        ext_tot = torch.where(using, ext_ab + ext_sc, 0.0)

        tau_this = ext_tot * c.AU2cm * length
        enc = (tau_this >= tau) & active & (tau_this > 0.0)
        move_len = torch.where(
            enc, length * tau / torch.clamp(tau_this, min=1e-33),
            length + eps)
        nx = x + vx * move_len
        ny = y + vy * move_len
        nz = z + vz * move_len
        # a crossing through a z face ends strictly past the face: at a
        # grazing angle vz * eps is below one ulp of z, and a packet left
        # on its cell's bottom face is located back in that cell
        zface = active & ~enc & (dirtype <= geometry.DIR_BOTTOM)
        face = torch.where((z >= zmin) & (z <= zmax), 1.0, -1.0) \
            * torch.where(dirtype == geometry.DIR_TOP, zmax, zmin)
        up = vz > 0.0
        past = torch.nextafter(face, torch.where(up, np.inf, -np.inf)
                               .to(F))
        nz = torch.where(zface, torch.where(up, torch.maximum(nz, past),
                                            torch.minimum(nz, past)), nz)

        tmask = active & using
        wflux = torch.where(tmask, move_len * en, 0.0)
        flat = cell * nlam + ilam
        # event selection: first channel whose running sum exceeds u
        probs = torch.stack([ab_gas, sc_gas, ab_h2o, torch.zeros_like(ab_h2o)]
                            + [v for pair in zip(ab_d, sc_d) for v in pair])
        cum = torch.cumsum(probs, dim=0)
        u_ev2 = u_ev * cum[-1]
        ev = torch.argmax((cum > u_ev2[None, :]).to(torch.uint8), dim=0)

        is_x = (lam_local >= ws.xr_lo) & (lam_local <= ws.xr_hi)
        ev_gas_abs = enc & (ev == 0)
        ev_gas_sca = enc & (ev == 1)
        ev_h2o_abs = enc & (ev == 2)
        idust_ev = torch.clamp(torch.div(ev - 4, 2, rounding_mode="floor"),
                               0, n_dust - 1)
        ev_dust = enc & (ev >= 4)
        ev_dust_abs = ev_dust & (ev % 2 == 0)
        ev_dust_sca = ev_dust & (ev % 2 == 1)
        dust_abs_keep = ev_dust_abs & ~is_x

        # new directions
        phi = 2.0 * np.pi * u_d2
        g_pk = trow[:, 7]
        for i in range(1, n_dust):
            g_pk = torch.where(idust_ev == i, trow[:, 7 + 3 * i], g_pk)
        cost_sca = torch.where(ev_gas_sca & is_x, _thomson_cost(u_d1),
                               torch.where(ev_dust_sca, _hg_cost(u_d1, g_pk),
                                           2.0 * u_d1 - 1.0))
        sx, sy, sz = _rotate_about(vx, vy, vz, cost_sca, phi)
        # isotropic reemission after dust absorption
        rz = 2.0 * u_d1 - 1.0
        rs = torch.sqrt(torch.clamp(1.0 - rz * rz, min=0.0))
        rx = torch.cos(phi) * rs
        ry = torch.sin(phi) * rs
        scatterish = ev_gas_sca | ev_dust_sca
        reemitish = dust_abs_keep
        nvx = torch.where(scatterish, sx, torch.where(reemitish, rx, vx))
        nvy = torch.where(scatterish, sy, torch.where(reemitish, ry, vy))
        nvz = torch.where(scatterish, sz, torch.where(reemitish, rz, vz))

        # new wavelengths: doppler out after scattering; reemission at the
        # frozen Tdust from the quantile table (the MRW thermal wavelength
        # shares the same read)
        vd_new = _doppler_vd(ws.star_mass, nx, ny, nz, nvx, nvy)
        lam_scat = lam_local * (1.0 - vd_new / c.SpeedOfLight_CGS)
        Td = crow[:, L["rho0"] + 1]
        for i in range(1, n_dust):
            Td = torch.where(idust_ev == i, crow[:, L["rho0"] + 3 * i + 1],
                             Td)
        itd = ws.tdust_idx(Td)
        iq = torch.clamp((u_q * nq).to(torch.int64), 0, nq - 1)
        idx_re = (idust_ev * nT + itd) * nq + iq
        if use_mrw:
            iqm = torch.clamp((u[7] * nq).to(torch.int64), 0, nq - 1)
            idx_mrw = crow[:, ibase].to(torch.int64) + iqm
            idx_re = torch.where(mrw, idx_mrw, idx_re)
        lam_re = ws.reemit_lam[idx_re]
        cold = Td <= ws.td_cold
        new_lam = torch.where(scatterish, lam_scat,
                              torch.where(reemitish & ~cold, lam_re, lam))

        # status updates
        destro_water = enc & ev_h2o_abs
        destro = enc & (ev_gas_abs | (ev_dust_abs & is_x)
                        | (dust_abs_keep & cold))
        new_status = torch.where(active & destro, ST_DESTRUCTED, status)
        new_status = torch.where(active & destro_water, ST_DESTR_WATER,
                                 new_status)
        # encounter cap (reference nmax_encounter, montecarlo.f90:690-693)
        e_count2 = e_count + (enc | stuck).to(torch.int32)
        new_status = torch.where((active | stuck)
                                 & (e_count2 >= nmax_encounter),
                                 ST_PREMATURE, new_status)

        # non-encounter: cross into the next cell or escape; stuck lanes
        # relocate from their current position
        crossed = active & ~enc
        rsq_new = torch.where(stuck, x * x + y * y, nx * nx + ny * ny)
        z_q = torch.where(stuck, z, nz)
        new_cell_loc = geometry.locate(ws.gi, rsq_new, torch.abs(z_q))
        escaped = (crossed | stuck) & (new_cell_loc < 0)
        new_status = torch.where(escaped, ST_ESCAPED, new_status)
        new_cell = torch.where(crossed | stuck,
                               torch.clamp(new_cell_loc, min=0), cellv)
        # repeat-stuck: pull the packet a relative 2e-6 inside the cell
        stuck_same = stuck & (new_cell_loc == cellv)
        rc = torch.sqrt(rsq_new)
        r_t = torch.clamp(rc, rmin * (1.0 + 2e-6), rmax * (1.0 - 2e-6))
        s_r = torch.where(stuck_same, r_t / torch.clamp(rc, min=1e-30), 1.0)
        dz6 = 2e-6 * (zmax - zmin)
        z_t = torch.sign(z) * torch.clamp(torch.abs(z), zmin + dz6,
                                          zmax - dz6)
        # a relocation that leaves the packet where it was is a fixed
        # point (same position, direction and cell: stuck again at every
        # step, tallying nothing) that would walk to the encounter cap:
        # it ends now, with the cap's fate
        pinned = stuck_same & (x * s_r == x) & (y * s_r == y) & (z_t == z)
        new_status = torch.where(pinned, ST_PREMATURE, new_status)

        new_tau = torch.where(enc, -torch.log(u_tau), tau - tau_this)
        new_tau = torch.where(crossed, tau - tau_this, new_tau)
        new_tau = torch.clamp(new_tau, min=0.0)

        # MRW diffusion step: first-passage path from the inverse CDF,
        # exit on the inscribed sphere with a fresh thermal wavelength
        if use_mrw:
            lnx = ws.mrw_lnx[torch.clamp((u[5] * ws.n_mrw).to(torch.int64),
                                         0, ws.n_mrw - 1)]
            R0cm = R0 * au
            L_cm = torch.maximum(
                -3.0 * R0cm * R0cm * crow[:, imfp] * lnx / f32(np.pi ** 2),
                R0cm)
            mrw_w = torch.where(mrw, L_cm / au * en, 0.0)
            mw = 2.0 * u[6] - 1.0
            mphi = 2.0 * np.pi * u[8]
            ms = torch.sqrt(torch.clamp(1.0 - mw * mw, min=0.0))
            mv = (ms * torch.cos(mphi), ms * torch.sin(mphi), mw)
            tau_m = -torch.log(torch.clamp(u[9], min=1e-12))

            def sel(m_val, n_mask, n_val, old):
                return torch.where(mrw, m_val,
                                   torch.where(n_mask, n_val, old))
        else:
            mv = (0.0, 0.0, 0.0)
            lam_re = tau_m = 0.0

            def sel(m_val, n_mask, n_val, old):
                return torch.where(n_mask, n_val, old)

        pos = []
        for p, npos, m in ((x, nx, mv[0]), (y, ny, mv[1])):
            pos.append(torch.where(stuck_same, p * s_r,
                                   sel(p + R0 * m if use_mrw else 0.0,
                                       active, npos, p)))
        pos.append(torch.where(stuck_same, z_t,
                               sel(z + R0 * mv[2] if use_mrw else 0.0,
                                   active, nz, z)))
        # the per-step tallies read the state BEFORE this step's update
        if save_counts:
            absoed = dust_abs_keep & active
            inx = crossed & ~escaped
            iB = torch.where(
                absoed, idust_ev * n_cells + cell,
                torch.where(inx, n_dust * n_cells + new_cell.to(torch.int64),
                            (n_dust + 1) * n_cells))
            wB = torch.where(absoed, en, torch.where(inx, 1.0, 0.0))
            extB.index_add_(0, iB, wB)
            extP.index_add_(0, torch.where(tmask, flat, NCL),
                            tmask.to(F))
        if save_dir:
            extD.index_add_(0, cell, torch.stack(
                [wflux * vx, wflux * vy, wflux * vz], dim=1))
        iA = torch.where(tmask, flat,
                         torch.where(mrw, NCL + cell, sinkA)
                         if use_mrw else sinkA)
        wA = torch.where(tmask, wflux, mrw_w) if use_mrw else wflux
        extA.index_add_(0, iA, wA)

        x, y, z = pos
        vx, vy, vz = (sel(m, enc, nv, v) for m, nv, v in
                      zip(mv, (nvx, nvy, nvz), (vx, vy, vz)))
        lam = sel(lam_re, enc, new_lam, lam)
        cellv = new_cell.to(torch.int32)
        tau = sel(tau_m, enc | crossed, new_tau, tau)
        status = new_status.to(torch.int32)
        e_count = (e_count2 + mrw.to(torch.int32)) if use_mrw else e_count2

    for dst, src in zip(pk, (x, y, z, vx, vy, vz, lam, en, cellv, tau,
                             status, e_count) + tuple(map(_i32, rng))):
        if dst is not src:
            dst.copy_(src)
    tallies.flux.add_(extA[:NCL].view(n_cells, nlam))
    tallies.mrw_path.add_(extA[NCL:NCL + n_cells])
    if save_counts:
        tallies.phc.add_(extP[:NCL].view(n_cells, nlam))
        tallies.en_gain_abso.add_(extB[:n_dust * n_cells]
                                  .view(n_dust, n_cells))
        tallies.cr_count.add_(extB[n_dust * n_cells:(n_dust + 1) * n_cells])
    if save_dir:
        tallies.dir_flux.add_(extD)
    return (status == ST_ACTIVE).sum()


class FoldBins(NamedTuple):
    """Image-plane binning constants of the terminal fold."""
    r0: float          # inner image radius, AU (f32 value)
    log_ratio: float   # ln(rmax_dom / r0) (f32 value)


def fold_bins(gi: geometry.GridIndex) -> FoldBins:
    r0 = gi.rmin_dom * 0.3
    return FoldBins(f32(r0), f32(np.log(gi.rmax_dom / r0)))


def _fold_terminal_plain(model: McModel, pk: Packets, tallies: McTallies,
                         n_mu: int, fates=None):
    """K4's plain version (JAX ``_fold_terminal``, mcrt.py:832-897): the
    escape collector (mu x lambda SED bins + image-plane r/phi bins;
    reference collect_photon_do, montecarlo.f90:1960-2043) and the water
    deposit, over the terminated lanes, added in place.  With `fates`
    (int64 [N_CODES]), the lanes of each status code 0-5 are added into
    it, padding included, with no read back to the host.

    Valid because a terminated lane's (x, v, lam, en, cell) freeze at
    its terminal step."""
    if fates is not None:
        # a bincount of the codes; torch.bincount would read the largest
        # code back to the host on a CUDA tensor
        codes = torch.arange(N_CODES, dtype=pk.status.dtype,
                             device=pk.status.device)
        fates.add_((pk.status[:, None] == codes).sum(0))
    seg = model.tab.lam_seg
    nlam = tallies.collector.shape[1]
    escaped = pk.status == ST_ESCAPED
    w_esc = torch.where(escaped, pk.en, 0.0)

    imu = torch.clamp((torch.abs(pk.vz) * n_mu).to(torch.int64), 0, n_mu - 1)
    ilam = torch.clamp(optics.lam_to_bin(seg, pk.lam, False), 0,
                       nlam - 1).to(torch.int64)
    tallies.collector.view(-1).index_add_(0, imu * nlam + ilam, w_esc)

    # image-plane (r, phi) bins: displacement orthogonal to the ray, in a
    # local frame with the ray as z axis
    n_r, n_phi = tallies.collector_img.shape[1:3]
    x, y, z, vx, vy, vz = pk.x, pk.y, pk.z, pk.vx, pk.vy, pk.vz
    dotp = x * vx + y * vy + z * vz
    rox = x - dotp * vx
    roy = y - dotp * vy
    roz = z - dotp * vz
    # ux = normalize(z_hat x v), uy = v x ux; x-axis fallback when the
    # ray is (anti)parallel to z
    degen = torch.abs(vz) >= 0.99
    uxn = torch.sqrt(torch.clamp(vx * vx + vy * vy, min=1e-30))
    ux_x = torch.where(degen, 1.0, -vy / uxn)
    ux_y = torch.where(degen, 0.0, vx / uxn)
    ux_z = torch.zeros_like(ux_x)
    uy_x = torch.where(degen, 0.0, vy * ux_z - vz * ux_y)
    uy_y = torch.where(degen, 1.0, vz * ux_x - vx * ux_z)
    uy_z = torch.where(degen, 0.0, vx * ux_y - vy * ux_x)
    r_o_x = rox * ux_x + roy * ux_y + roz * ux_z
    r_o_y = rox * uy_x + roy * uy_y + roz * uy_z
    r_img = torch.sqrt(r_o_x * r_o_x + r_o_y * r_o_y)
    phi_img = torch.atan2(r_o_y, r_o_x)
    fb = fold_bins(model.gi)
    ir = torch.clamp((torch.log(torch.clamp(r_img, min=1e-30) / fb.r0)
                      / fb.log_ratio * (n_r - 1)).to(torch.int64) + 1,
                     0, n_r - 1)
    ir = torch.where(r_img < fb.r0, 0, ir)
    iphi = torch.clamp(((phi_img + np.pi) / (2 * np.pi)
                        * n_phi).to(torch.int64), 0, n_phi - 1)
    flat_img = ((imu * n_r + ir) * n_phi + iphi) * nlam + ilam
    tallies.collector_img.view(-1).index_add_(0, flat_img, w_esc)

    # water-absorption deposits (terminal: the packet is destroyed)
    n_cells = tallies.ab_en_water.shape[0]
    tallies.ab_en_water.index_add_(
        0, torch.clamp(pk.cell, 0, n_cells - 1).to(torch.int64),
        torch.where(pk.status == ST_DESTR_WATER, pk.en, 0.0))
    return tallies


def _pass_launchers(model, ws, tallies, n_mu, walk, **kw):
    """A pass's walk ``(pk, tallies, steps) -> lanes still active`` and
    fold ``(pk, tallies, fates=None)``, built once: K3's and K4's launch
    objects (their plain versions on CPU tensors), or the plain versions
    when walk == "plain"."""
    if walk == "plain":
        def walk_fn(pk, tl, steps):
            return _walk_plain(ws, pk, tl, steps, **kw)

        def fold_fn(pk, tl, fates=None):
            return _fold_terminal_plain(model, pk, tl, n_mu, fates)
        return walk_fn, fold_fn
    if walk != "kernel":
        raise ValueError(f"walk must be 'kernel' or 'plain', got {walk!r}")
    from . import kernels
    return (kernels.WalkLaunch(ws, tallies, **kw),
            kernels.FoldLaunch(model, tallies, n_mu))


def _mrw_fold_tallies(tallies, rho_kapP, Tdust, rho_dust, lam_grid,
                      mrw_lam_min, kab):
    """Deposit the accumulated MRW path tally as local-blackbody flux
    (lam >= mrw_lam_min only) and keep the below-cutoff part of the
    Planck-mean absorption in en_gain_mrw (JAX ``_mrw_fold_tallies``).
    In place; mrw_path is consumed (zeroed)."""
    from ..utils import planck
    mp = tallies.mrw_path                           # [n_cells] AU*en
    wsum = torch.clamp(rho_kapP.sum(0), min=1e-30)
    Tbar = (rho_kapP * Tdust).sum(0) / wsum
    dl = torch.diff(lam_grid)
    dlam = torch.cat([dl, dl[-1:]])
    lam_cm_mid = (lam_grid + 0.5 * dlam) * f32(c.Angstrom2cm)
    ir = lam_grid >= mrw_lam_min
    Bm = planck.B_lambda(Tbar[:, None], lam_cm_mid[None, :])
    # f32 B_lambda overflows at small lam / small T: no Planck weight
    Bm = torch.where(torch.isfinite(Bm), Bm, 0.0)
    wf = Bm * dlam[None, :]
    wf = wf / torch.clamp(wf.sum(1, keepdim=True), min=1e-30)
    w = torch.where(ir[None, :], wf, 0.0)
    w = w / torch.clamp(w.sum(1, keepdim=True), min=1e-30)
    dw = wf - w                                      # [n_cells, nlam]
    au = f32(c.AU2cm)
    resid = torch.stack([
        mp * rho_dust[i].to(F)
        * (dw @ torch.as_tensor(kab[i], dtype=F, device=mp.device)) * au
        for i in range(rho_kapP.shape[0])])
    tallies.flux.add_(mp[:, None] * w)
    tallies.en_gain_mrw.add_(resid)
    tallies.mrw_path.zero_()
    return tallies


def _en_gain_from_flux(model: McModel, tallies: McTallies) -> McTallies:
    """Per-dust absorbed energy as the flux tally contracted against the
    dust absorption extinction (the Lucy 1999 path-length estimator):
    en_gain[i, cell] = AU2cm * sum_lam flux[cell, lam] * ab_i(cell, lam),
    plus the MRW full-Planck residual.  Overwrites en_gain in place."""
    tab = model.tab
    cells = model.cells
    dev = tallies.flux.device

    def t32(a):
        return torch.as_tensor(np.asarray(a), dtype=F, device=dev)

    flux = tallies.flux
    n_dust = cells.rho_dust.shape[0]
    n_gas = cells.n_gas.to(F)
    gains = []
    for i in range(n_dust):
        rho = cells.rho_dust[i].to(F)
        ab = rho[:, None] * t32(tab.kab[i])[None, :]
        if i == n_dust - 1:
            # X-ray dust terms ride on the last component
            epsd = cells.dust_depletion.to(F)
            sraw = epsd[:, None] * t32(tab.xr_dus_abs0)[None, :]
            f = bethell.dust_blanketing(
                sraw, cells.d2h.to(F)[:, None], cells.grain_a.to(F)[:, None],
                torch)
            ab = ab + f * sraw * n_gas[:, None]
        gains.append((flux * ab).sum(1) * f32(c.AU2cm))
    # a cell with no dust absorbs nothing; there the f32 blanketing
    # factor divides by d2h = 0 and is NaN (JAX leaves the NaN in place)
    tallies.en_gain.copy_(torch.where(
        cells.d2h.to(F) > 0.0, torch.stack(gains) + tallies.en_gain_mrw,
        0.0))
    return tallies


def _mc_mrw_finalize(model: McModel, tallies: McTallies,
                     mrw_lam_min: float = 1e4):
    """The MRW fold after the last chunk, with the per-cell Planck-mean
    opacities recomputed (JAX ``_mc_mrw_finalize``)."""
    tab = model.tab
    cells = model.cells
    dev = tallies.flux.device
    lut_Tds = torch.as_tensor(tab.lut_Tds, dtype=F, device=dev)
    Tdust = cells.Tdust.to(F)
    itd = optics.tdust_bin(lut_Tds, Tdust)
    rho_kapP = torch.gather(torch.as_tensor(tab.kap_P, dtype=F, device=dev),
                            1, itd) * cells.rho_dust.to(F)
    return _mrw_fold_tallies(
        tallies, rho_kapP, Tdust, cells.rho_dust,
        torch.as_tensor(tab.lam, dtype=F, device=dev), mrw_lam_min, tab.kab)


_FATE_GROUPS = {"escaped": (ST_ESCAPED,),
                "destructed": (ST_DESTRUCTED, ST_DESTR_WATER),
                "premature": (ST_PREMATURE,),
                "active": (ST_ACTIVE,)}


def fates_of_counts(counts) -> dict:
    """Fate counts from lanes per status code 0-5 (a list), ignoring
    compaction padding."""
    return {name: int(sum(counts[k] for k in codes))
            for name, codes in _FATE_GROUPS.items()}


def packet_fates(status) -> dict:
    """Fate counts of a packet batch, ignoring compaction padding."""
    return fates_of_counts(
        torch.bincount(status.to(torch.int64), minlength=N_CODES).tolist())


def _finish_pass(model, pk, tallies, use_mrw, mrw_lam_min, fold,
                 fates=None):
    if use_mrw:
        _mc_mrw_finalize(model, tallies, mrw_lam_min=mrw_lam_min)
    fold(pk, tallies, fates)
    _en_gain_from_flux(model, tallies)


def mc_pass(model: McModel, packets: Packets, tallies: McTallies,
            max_steps: int = 100_000, n_quantile: int = 512, n_mu: int = 5,
            nmax_encounter: int = 200_000, use_mrw: bool = True,
            mrw_gamma: float = 4.0, mrw_lam_min: float = 1e4,
            save_dir: bool = False, save_counts: bool = True,
            steps_per_call: int = 64, walk: str = "kernel"):
    """Run one batch of packets to completion: walk chunks until every
    packet has terminated (or max_steps), then the MRW fold, the
    terminal fold and en_gain, with no compaction (JAX ``mc_pass``).
    Packets and tallies advance in place; returns (packets, tallies)."""
    ws = WalkSetup(model, n_quantile)
    walk_fn, fold = _pass_launchers(
        model, ws, tallies, n_mu, walk, nmax_encounter=nmax_encounter,
        use_mrw=use_mrw, mrw_gamma=mrw_gamma, mrw_lam_min=mrw_lam_min,
        save_dir=save_dir, save_counts=save_counts)
    done = 0
    while done < max_steps:
        chunk = min(steps_per_call, max_steps - done)
        n_active = int(walk_fn(packets, tallies, chunk))
        done += chunk
        if n_active == 0:
            break
    _finish_pass(model, packets, tallies, use_mrw, mrw_lam_min, fold)
    return packets, tallies


def _compact_packets(packets: Packets, tier: int) -> Packets:
    """Shrink the batch to `tier` lanes: live packets first (stable sort
    by liveness), the rest ST_PADDING filler."""
    live = packets.status == ST_ACTIVE
    perm = torch.argsort((~live).to(torch.uint8), stable=True)[:tier]
    pk = packets.take(perm)
    keep = torch.arange(tier, device=live.device) < live.sum()
    return pk._replace(status=torch.where(
        keep, pk.status, ST_PADDING).to(torch.int32))


def _refill_packets(packets: Packets, fresh: Packets, n_active: int):
    """Merge `fresh` packets into the batch: live lanes first (stable
    sort by liveness), fresh lanes right after them, any remaining dead
    tail becomes ST_PADDING."""
    B = packets.status.shape[0]
    t = fresh.status.shape[0]
    live = packets.status == ST_ACTIVE
    perm = torch.argsort((~live).to(torch.uint8), stable=True)
    pk = packets.take(perm)
    pos = torch.arange(B, device=live.device)
    j = pos - n_active
    usef = (j >= 0) & (j < t)
    jc = torch.clamp(j, 0, t - 1)
    pk2 = Packets(*(torch.where(usef, f[jc], a) for a, f in zip(pk, fresh)))
    status = torch.where(
        usef, fresh.status[jc],
        torch.where(pos < n_active, pk.status, ST_PADDING))
    return pk2._replace(status=status.to(torch.int32))


def mc_pass_streamed(model: McModel, gen: torch.Generator, lam_all, en_all,
                     minw, maxw, tallies: McTallies, max_batch: int,
                     steps_per_call: int = 64, max_steps: int = 100_000,
                     n_quantile: int = 512, n_mu: int = 5,
                     nmax_encounter: int = 200_000, use_mrw: bool = True,
                     mrw_gamma: float = 4.0, mrw_lam_min: float = 1e4,
                     progress_cb=None, compact_floor: int = 1024,
                     save_dir: bool = False, save_counts: bool = True,
                     walk: str = "kernel", stats: dict | None = None):
    """Full pass at CONSTANT batch width with packet refill (JAX
    ``mc_pass_streamed``): the batch is topped up with fresh packets from
    the pool whenever the live count drops to half; once the pool is dry
    a pow2 compaction ladder shrinks the batch for the tail.  Retired
    lanes are folded (K4) at each refill or compaction; the fold also
    counts them into a device counter that the pass reads once, at its
    end.  The walk's and the fold's launch objects are built once, after
    WalkSetup.

    lam_all/en_all are host arrays (the pool).  Returns (packets,
    tallies, fates); a packet still walking after max_steps is counted
    as "active", as in the JAX package.  With a `stats` dict, adds the
    counts of walk chunks, refills, compactions and walk steps to it, the
    chunks and host seconds spent on a tail of at most TAIL_LANES live
    lanes after the pool ran dry, the reads back to the host by the pass
    loop ("host_reads"), the host seconds spent in K3's and K4's launch
    objects ("k3_host_s", "k4_host_s"; kernel walk only), and (as
    "live_lanes") the packets still walking at max_steps, if any."""
    dev = tallies.flux.device
    lam_all = np.asarray(lam_all, dtype=np.float64)
    en_all = np.asarray(en_all, dtype=np.float64)
    N = len(lam_all)
    mb = min(max_batch, N)
    topup = max(mb // 2, 1)
    # pad the pool so every top-up is exactly `topup` wide; zero-energy
    # lanes launch as ST_PADDING and are excluded from transport and fates
    if N > mb and (N - mb) % topup:
        pad = topup - (N - mb) % topup
        lam_all = np.concatenate([lam_all, np.full(pad, lam_all[-1])])
        en_all = np.concatenate([en_all, np.zeros(pad)])
        N += pad
    st = {"chunks": 0, "refills": 0, "compactions": 0, "tail_chunks": 0,
          "tail_s": 0.0}
    ws = WalkSetup(model, n_quantile)
    walk_fn, fold = _pass_launchers(
        model, ws, tallies, n_mu, walk, nmax_encounter=nmax_encounter,
        use_mrw=use_mrw, mrw_gamma=mrw_gamma, mrw_lam_min=mrw_lam_min,
        save_dir=save_dir, save_counts=save_counts)
    # lanes per status code, folded at a refill or compaction (row 0) and
    # at the end (row 1); read once, at the end of the pass
    counts = torch.zeros(2, N_CODES, dtype=torch.int64, device=dev)
    retired, final = counts[0], counts[1]

    def launch(a, b):
        return launch_packets(model, gen, torch.as_tensor(lam_all[a:b],
                                                          device=dev),
                              torch.as_tensor(en_all[a:b], device=dev),
                              minw, maxw)

    with span("mc.launch"):
        packets = launch(0, mb)
    pool = mb
    done = 0
    t_chunk = time.perf_counter()
    while done < max_steps:
        chunk = min(steps_per_call, max_steps - done)
        with span("mc.walk"):
            live = walk_fn(packets, tallies, chunk)
        with span("mc.live_count"):
            n_active = int(live)
        st["chunks"] += 1
        done += chunk
        now = time.perf_counter()
        if pool >= N and n_active <= TAIL_LANES:
            st["tail_chunks"] += 1
            st["tail_s"] += now - t_chunk
        t_chunk = now
        if progress_cb is not None:
            progress_cb(done, n_active, N - pool)
        if n_active == 0 and pool >= N:
            break
        if pool + topup <= N and n_active <= mb - topup:
            # retire the dead lanes (fold + count), then top up
            with span("mc.retire"):
                fold(packets, tallies, retired)
            with span("mc.launch"):
                fresh = launch(pool, pool + topup)
            with span("mc.refill"):
                packets = _refill_packets(packets, fresh, n_active)
            pool += topup
            st["refills"] += 1
        elif pool >= N:
            # pool dry: pow2 compaction ladder for the final tail
            tier = max(1 << int(np.ceil(np.log2(max(n_active, 1)))),
                       compact_floor)
            if tier < int(packets.status.shape[0]):
                with span("mc.retire"):
                    fold(packets, tallies, retired)
                with span("mc.compact"):
                    packets = _compact_packets(packets, tier)
                st["compactions"] += 1
    with span("mc.finish"):
        _finish_pass(model, packets, tallies, use_mrw, mrw_lam_min, fold,
                     final)
        c = counts.tolist()
    # a retired batch's live lanes walk on and are counted again later:
    # only the final batch's count "active"
    ret, fin = fates_of_counts(c[0]), fates_of_counts(c[1])
    fates = {k: fin[k] + (ret[k] if k != "active" else 0) for k in fin}
    st["steps"] = done
    # reads back to the host by the pass loop: a live count a chunk and
    # the fate counts
    st["host_reads"] = st["chunks"] + 1
    for name, fn in (("k3_host_s", walk_fn), ("k4_host_s", fold)):
        if hasattr(fn, "host_s"):
            st[name] = fn.host_s
    if stats is not None:
        for k2, v in st.items():
            stats[k2] = stats.get(k2, 0) + v
        if fin["active"]:
            # the lanes still walking at max_steps, for diagnosis
            stats["live_lanes"] = packets.take(
                packets.status == ST_ACTIVE)
    return packets, tallies, fates


def launch_packets(model: McModel, gen: torch.Generator, lam, en, minw,
                   maxw) -> Packets:
    """Initialize packets at the star and propagate them to the domain;
    every random number comes from `gen` (on the packets' device)."""
    B = lam.shape[0]
    dev = lam.device
    gi = model.gi
    vx, vy, vz = _unit_sphere_dir(gen, B, minw, maxw, dev)
    zero = torch.zeros(B, dtype=F, device=dev)

    def full(v):
        return torch.full((B,), v, dtype=F, device=dev)

    # entry into the domain bounding annulus
    length, eps, _, found = geometry.ray_cell_exit_mirror(
        zero, zero, zero, vx, vy, vz, full(gi.rmin_dom), full(gi.rmax_dom),
        zero, full(gi.zmax_dom))
    x = vx * (length + eps)
    y = vy * (length + eps)
    z = vz * (length + eps)
    cell = geometry.locate(gi, x * x + y * y, torch.abs(z))
    status = torch.where(found & (cell >= 0), ST_ACTIVE, ST_ESCAPED)
    # zero-energy lanes are alignment filler: excluded from transport
    # and fate counts
    status = torch.where(en > 0.0, status, ST_PADDING)
    tau = -torch.log(torch.clamp(
        torch.rand(B, generator=gen, dtype=F, device=dev), min=1e-12))
    rs = torch.randint(0, 1 << 32, (4, B), generator=gen, dtype=torch.int64,
                       device=dev)
    rs = _i32(rs)
    return Packets(x=x, y=y, z=z, vx=vx, vy=vy, vz=vz,
                   lam=lam.to(F), en=en.to(F),
                   cell=torch.clamp(cell, min=0).to(torch.int32), tau=tau,
                   status=status.to(torch.int32),
                   e_count=torch.zeros(B, dtype=torch.int32, device=dev),
                   rs0=rs[0] | 1, rs1=rs[1], rs2=rs[2], rs3=rs[3])


EDGE_VZ = (-1e-3, -3e-4, -1e-4, -3e-5)   # grazing descents


def edge_lanes(ws: WalkSetup, n_cells: int = 4, seed: int = 0):
    """Hand-built lanes that the JAX walk never ends, on ws's grid:
    - "grazing": on the bottom face of each of the first n_cells cells
      above the midplane, mid-radius, descending at the slopes EDGE_VZ
      (it lands back on the face after every crossing);
    - "corner": one interior lane per cell for the same cells, aimed at
      a corner of its cell in the x-z plane so that f32 roundoff rejects
      both surfaces of the corner (no exit; the relocation nudge leaves
      an interior point where it is), found by a search over points
      drawn from a numpy seed.
    A visible wavelength (no MRW) and tau = 1e30 (no encounter).  Returns
    (Packets on ws.device, list of kinds)."""
    cm = ws.cellmat.cpu()
    rmin, rmax, zmin = cm[:, 0], cm[:, 1], cm[:, 2]
    gi = ws.gi._replace(**{f: getattr(ws.gi, f).cpu() for f in
                           ("r_edges", "z_edges", "cell_of", "n_z", "r_lut",
                            "r_lut_pack", "zc_pack")
                           if getattr(ws.gi, f) is not None})
    upper = torch.nonzero(zmin > 0.0).flatten()[:n_cells].tolist()
    rng = np.random.default_rng(seed)
    rows, kinds = [], []
    for ci in upper:
        r = float((rmin[ci] + rmax[ci]) / 2)
        for vz in EDGE_VZ:
            rows.append((r, float(zmin[ci]), np.sqrt(1.0 - vz * vz), vz, ci))
            kinds.append("grazing")
    N = 16384
    zero = torch.zeros(N, dtype=F)
    one = torch.ones(N, dtype=F)
    for ci in upper:
        lo = cm[ci, :4].double().numpy()
        for cr, cz in ((lo[1], lo[3]), (lo[0], lo[3]), (lo[1], lo[2]),
                       (lo[0], lo[2])):
            # aimed in f64, then rounded: f32 roundoff of the exit test
            # decides whether the corner's surfaces are hit
            px = lo[0] + rng.uniform(0.2, 0.8, N) * (lo[1] - lo[0])
            pz = lo[2] + rng.uniform(0.2, 0.8, N) * (lo[3] - lo[2])
            dx, dz = cr - px, cz - pz
            nrm = np.sqrt(dx * dx + dz * dz)
            px, pz, vx, vz = (torch.as_tensor(a, dtype=F) for a in
                              (px, pz, dx / nrm, dz / nrm))
            _, _, _, found = geometry.ray_cell_exit_mirror(
                px, zero, pz, vx, zero, vz, *(one * float(v) for v in lo))
            ok = ~found & (geometry.locate(gi, px * px, pz) == ci)
            if bool(ok.any()):
                i = int(torch.nonzero(ok)[0])
                rows.append((float(px[i]), float(pz[i]), float(vx[i]),
                             float(vz[i]), ci))
                kinds.append("corner")
                break
    x, z, vx, vz, cell = (np.array(v) for v in zip(*rows))
    B = len(rows)
    dev = ws.device

    def t(a, dtype=F):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
    zf = t(np.zeros(B))
    zi = t(np.zeros(B), torch.int32)
    words = [t(np.full(B, w), torch.int32) for w in (12345, 678, 91011, 1213)]
    return Packets(x=t(x), y=zf, z=t(z), vx=t(vx), vy=zf.clone(), vz=t(vz),
                   lam=t(np.full(B, 5000.0)), en=t(np.ones(B)),
                   cell=t(cell, torch.int32), tau=t(np.full(B, 1e30)),
                   status=zi, e_count=zi.clone(), rs0=words[0],
                   rs1=words[1], rs2=words[2], rs3=words[3]), kinds


def update_tdust(tab: optics.McTables, cells: McCells,
                 tallies: McTallies) -> torch.Tensor:
    """Lucy temperature update: invert absorbed energy -> Tdust per
    component, in float64 (role of reference dust_reemit,
    montecarlo.f90:804-852, done once per pass)."""
    n_dust = cells.rho_dust.shape[0]
    out = []
    for i in range(n_dust):
        val = tallies.en_gain[i].to(torch.float64) / (
            4.0 * np.pi * torch.clamp(cells.mdust_cell[i].to(torch.float64),
                                      min=1e-300))
        out.append(optics.tdust_from_energy(tab, i, val))
    return torch.stack(out)
