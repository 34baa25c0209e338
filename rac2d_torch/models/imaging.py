"""Line/continuum imaging pipeline: excitation + cube synthesis + FITS.

Counterpart of the JAX package's ``models/imaging.py`` (reference:
src/ray_tracing.f90:975-1401 ``line_tran_prep``/``load_exc_molecule``/
``line_excitation_do``/``do_exc_calc``, :39-256 the cube loops, and
src/continuum_lookuptable.f90 ``make_local_cont_lut``): select
transitions by frequency window / upper-level energy / Aul, compute per-
cell level populations (LTE or batched NLTE), then synthesize
position-position-velocity cubes per transition per viewing angle and
write FITS.  Everything runs on the disk model's device.

One departure: an NLTE excitation on a model whose sweep fields were
never computed (a run resumed with zero iterations) computes them first,
as ``DiskModel.assemble_envs`` does; the JAX package raises there.
Beside the JAX package's functions, ``LineImaging.exc_envs`` and
``cube_axes`` and ``continuum_model`` return the inputs of the solve and
of the ray march, so that a caller can run a part of them elsewhere.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import constants as c
from ..io import fits as fitsio
from ..io import lamda
from ..ops import raytrace, stateq


@dataclasses.dataclass
class LineConfig:
    mol_file: str
    database: str = "lamda"       # lamda | hitran | cdms
    mole_name: str = ""
    abundance_factor: float = 1.0
    useLTE: bool = False
    # transition selection (reference raytracing_configure)
    freq_min: float = 0.0         # Hz
    freq_max: float = 1e99
    E_min: float = 0.0            # K
    E_max: float = 5000.0
    Aul_min: float = 0.0
    # cube geometry
    nx: int = 201
    ny: int = 201
    nf: int = 100
    view_thetas: tuple = (7.0,)
    vel_half_width: float = 6e5   # cm/s
    dist_pc: float = 100.0


def _rt_cells(disk, n_mol, f_up, f_low, dv):
    g = disk.grid
    t = disk._t
    f64 = torch.float64
    return raytrace.RtCells(
        rmin=t(g.rmin, f64), rmax=t(g.rmax, f64), zmin=t(g.zmin, f64),
        zmax=t(g.zmax, f64), using=t(g.using),
        Tdusts=t(disk.Tdusts, f64), rho_dust=t(disk.rho_dust, f64),
        n_mol=t(n_mol, f64), f_up=t(f_up, f64), f_low=t(f_low, f64),
        dv=t(dv, f64))


def _kext(disk, lam_A):
    """Dust extinction per mixture at the wavelengths lam_A: [n_dust,
    n_lam] (interpolated per wavelength, reference
    ray_tracing.f90:338-364)."""
    return np.stack([np.interp(lam_A, m.lam, m.kab + m.ksc)
                     for m in disk.mixtures])


class LineImaging:
    def __init__(self, disk, cfg: LineConfig):
        """disk: a prepared (and iterated) models.driver.DiskModel."""
        self.disk = disk
        self.cfg = cfg
        if cfg.database == "lamda":
            self.mol = lamda.load_lamda(cfg.mol_file)
        elif cfg.database == "hitran":
            from ..io import hitran
            self.mol = hitran.load_hitran(cfg.mol_file)
        elif cfg.database == "cdms":
            from ..io import cdms
            self.mol = cdms.load_cdms(cfg.mol_file)
        else:
            raise ValueError(cfg.database)
        self.tab = stateq.build_mol_tables(self.mol, disk.device)
        # transitions to image
        keep = ((self.mol.freq >= cfg.freq_min)
                & (self.mol.freq <= cfg.freq_max)
                & (self.mol.Eup_K >= cfg.E_min)
                & (self.mol.Eup_K <= cfg.E_max)
                & (self.mol.Aul >= cfg.Aul_min))
        self.transitions = np.nonzero(keep)[0]
        # molecule abundance from the chemistry state
        name = cfg.mole_name or self.mol.name.strip()
        base = name.split("(")[0].strip()
        self.i_spe = disk.net.idx.get(base, -1)
        if self.i_spe < 0 and base in disk.net.species:
            self.i_spe = disk.net.species.index(base)
        if self.i_spe < 0:
            raise ValueError(f"species {base} not in network")
        self.fpop = None

    # ------------------------------------------------------------------
    def cont_J_at(self, lam_A):
        """Local continuum mean intensity at wavelength(s) from the MC
        flux (reference make_local_cont_lut,
        continuum_lookuptable.f90:25-42): host float64 [n_cells, n_lam]."""
        d = self.disk
        lamg = np.asarray(d.tab.lam, dtype=np.float64)
        flux = d.fields.flux.cpu().numpy()       # [n, nlam]
        dlam = np.diff(lamg)
        lam_mid = 0.5 * (lamg[1:] + lamg[:-1])
        Jlam = flux[:, :-1] / dlam[None, :] * lam_mid[None, :] ** 2 \
            * c.Angstrom2cm / c.SpeedOfLight_CGS / (4.0 * np.pi)
        j = np.clip(np.searchsorted(lam_mid, np.atleast_1d(lam_A)), 0,
                    len(lam_mid) - 1)
        return Jlam[:, j]

    def exc_envs(self):
        """(the using cells, their CellExcEnv on the disk's device) for the
        NLTE solve.  A model whose sweep fields were never computed (a run
        resumed with zero iterations) computes them first, as
        assemble_envs does (the JAX package raises here)."""
        d = self.disk
        g = d.grid
        if getattr(d, "_shield", None) is None:
            d.prepare_sweep_fields()
        act = np.nonzero(g.using)[0]
        n_mol = g.n0 * d.X[self.i_spe] * self.cfg.abundance_factor
        Tg = np.maximum(d.Tgas, 2.73)
        cs = np.sqrt(c.kBoltzmann_CGS * Tg / (c.mProton_CGS * 1.4 * 2.0))
        coh = cs / d.velo_grad
        cont_J = self.cont_J_at(self.mol.lam_A)        # [n, nr]
        # continuum extinction at the line wavelengths: dust only
        kext = np.zeros((g.n_cells, len(self.mol.Aul)))
        for di, ke in enumerate(_kext(d, self.mol.lam_A)):
            kext += d.rho_dust[di][:, None] * ke[None, :]
        # partner densities by name
        X = d.X
        idx = d.net.idx
        nH2 = g.n0 * X[idx["H2"]]
        dens_map = {
            "H2": nH2, "o-H2": 0.75 * nH2, "p-H2": 0.25 * nH2,
            "H": g.n0 * X[idx["H"]],
            "H+": g.n0 * X[idx["H+"]] if idx.get("H+", -1) >= 0
            else 0 * nH2,
            "e": g.n0 * X[idx["E-"]],
        }
        dp = np.stack([dens_map.get(nm, np.zeros(g.n_cells))
                       for nm in self.tab.partner_names])
        Ncol = d._shield.Ncol_toISM.cpu().numpy()

        def t(a):
            return d._t(a, torch.float64)
        return act, stateq.CellExcEnv(
            Tkin=t(Tg[act]), dv=t(cs[act]),
            length_scale=t(np.minimum(coh[act], np.maximum(
                Ncol[act] / np.maximum(g.n0[act], 1e-30), 1e10))),
            density_mol=t(n_mol[act]), dens_partner=t(dp[:, act].T),
            cont_alpha=t(kext[act]), cont_J=t(cont_J[act]))

    def excitation(self, stats=None):
        """Level populations [n_level, n_cells] (host float64) for every
        using cell, LTE or one NLTE batch on the disk's device.  stats,
        when given, receives the NLTE solve's cells, Newton steps per cell
        (iters), batched steps (steps) and residual norms (err)."""
        d = self.disk
        g = d.grid
        act = np.nonzero(g.using)[0]
        fpop = np.zeros((self.mol.n_level, g.n_cells))
        if self.cfg.useLTE:
            Tg = np.maximum(d.Tgas, 2.73)
            fpop[:, act] = stateq.boltzmann(
                self.tab, d._t(Tg[act], torch.float64)).cpu().numpy().T
        else:
            act, envs = self.exc_envs()
            st = {}
            fs, errs = stateq.solve_stateq_batch(self.tab, envs, stats=st)
            fpop[:, act] = fs.cpu().numpy().T
            if stats is not None:
                stats.update(cells=len(act), err=errs.cpu().numpy(),
                             iters=st["iters"].cpu().numpy(),
                             steps=st["steps"])
        self.fpop = fpop
        self.n_mol = g.n0 * d.X[self.i_spe] * self.cfg.abundance_factor
        return fpop

    # ------------------------------------------------------------------
    def rt_model(self, itr, freqs=None):
        d = self.disk
        mol = self.mol
        iu, il = int(mol.iup[itr]), int(mol.ilow[itr])
        Tg = np.maximum(d.Tgas, 2.73)
        dv = np.sqrt(c.kBoltzmann_CGS * Tg
                     / (c.mProton_CGS * mol.weight))
        # dust opacity evaluated at each channel's wavelength (the
        # reference interpolates per frequency, ray_tracing.f90:338-364)
        if freqs is None:
            lam_ch = np.full(self.cfg.nf, mol.lam_A[itr])
        else:
            lam_ch = c.SpeedOfLight_CGS / (np.asarray(freqs)
                                           * c.Angstrom2cm)
        cells = _rt_cells(d, self.n_mol, self.fpop[iu], self.fpop[il], dv)
        return raytrace.RtModel(
            gi=d.gi, cells=cells,
            kext_dust=d._t(_kext(d, lam_ch), torch.float64),
            star_mass=d.cfg.star_mass, f0=float(mol.freq[itr]),
            Aul=float(mol.Aul[itr]), Bul=float(mol.Bul[itr]),
            Blu=float(mol.Blu[itr]))

    def cube_axes(self, itr):
        """(channel frequencies [nf], their spacing, xs [nx], ys [ny])
        of transition itr's cube."""
        cfg = self.cfg
        f0 = float(self.mol.freq[itr])
        dfreq = f0 * cfg.vel_half_width / c.SpeedOfLight_CGS * 2 / cfg.nf
        freqs = f0 + (np.arange(cfg.nf) - cfg.nf / 2) * dfreq
        half = self.disk.grid.rmax.max() * 1.05
        return (freqs, dfreq, np.linspace(-half, half, cfg.nx),
                np.linspace(-half, half, cfg.ny))

    def make_cube(self, itr, theta, out_fits=None):
        """The line cube of transition itr at inclination theta (deg):
        (I [nx, ny, nf], tau, N_up, N_low [nx, ny], flux spectrum [nf] in
        Jy), host float64; written to out_fits when given."""
        cfg = self.cfg
        if self.fpop is None:
            self.excitation()
        f0 = float(self.mol.freq[itr])
        freqs, dfreq, xs, ys = self.cube_axes(itr)
        model = self.rt_model(itr, freqs=freqs)
        I, tau, Nu, Nl = raytrace.make_cube(model, theta, xs, ys, freqs,
                                            is_line=True)
        # flux spectrum in jansky at dist_pc (summed over the image)
        pix_sr = ((xs[1] - xs[0]) * (ys[1] - ys[0]) * c.AU2cm ** 2
                  / (cfg.dist_pc * c.pc2cm) ** 2)
        spec = I.sum(axis=(0, 1)) * pix_sr / c.jansky2CGS
        int_map = (I - 0.5 * (I[:, :, :1] + I[:, :, -1:])).sum(-1) * dfreq
        if out_fits:
            # line metadata cards the reference records in every cube
            # (ray_tracing.f90:730-753)
            mol = self.mol
            iu, il = int(mol.iup[itr]), int(mol.ilow[itr])
            jansky2SI = 1e-26
            base = np.linspace(spec[0], spec[-1], len(spec))
            df = abs(dfreq)
            fitsio.write_cube_fits(
                out_fits, I, freqs=freqs, tau_map=tau, int_map=int_map,
                ncol_up=Nu, ncol_low=Nl, spectrum=spec,
                header={"EXTNAME": "LineCube",
                        "LINE": mol.name.strip()[:18],
                        "MOL-DB": mol.name.strip()[:18],
                        "RESTFRQ": f0, "F0": f0,
                        "LAM0": float(mol.lam_A[itr]),
                        "EUP": float(mol.Eup_K[itr]),
                        "ELOW": float(mol.energy_K[il]),
                        "AUL": float(mol.Aul[itr]),
                        "BUL": float(mol.Bul[itr]),
                        "BLU": float(mol.Blu[itr]),
                        "QNUM": f"{iu}->{il}",
                        "MAXFLUX": float(np.max(spec)),
                        "MAXTAU": float(np.max(tau)),
                        "INTFLUX": float(np.sum(spec) * jansky2SI * df),
                        "INTFLUXL": float(np.sum(spec - base)
                                          * jansky2SI * df),
                        "THETA": float(theta),
                        "DIST": cfg.dist_pc,
                        "PIXSR": float(pix_sr),
                        "CDELT1": float(xs[1] - xs[0]),
                        "CDELT2": float(ys[1] - ys[0])})
        return I, tau, Nu, Nl, spec


def continuum_model(disk, lam_A):
    """The RtModel of the dust continuum at wavelengths lam_A."""
    n = disk.grid.n_cells
    kext = _kext(disk, np.atleast_1d(np.asarray(lam_A, dtype=float)))
    cells = _rt_cells(disk, np.zeros(n), np.zeros(n), np.zeros(n),
                      np.ones(n))
    return raytrace.RtModel(
        gi=disk.gi, cells=cells, kext_dust=disk._t(kext, torch.float64),
        star_mass=disk.cfg.star_mass, f0=0.0, Aul=0.0, Bul=0.0, Blu=0.0)


def make_continuum_cube(disk, lam_A, theta, nx=201, ny=201,
                        dist_pc=100.0, out_fits=None):
    """Dust continuum image at wavelengths lam_A (reference
    make_cubes_continuum, ray_tracing.f90:39-126): (I [nx, ny, n_lam],
    tau [nx, ny], flux spectrum [n_lam] in Jy), host float64."""
    g = disk.grid
    lam_A = np.atleast_1d(np.asarray(lam_A, dtype=float))
    freqs = c.SpeedOfLight_CGS / (lam_A * c.Angstrom2cm)
    model = continuum_model(disk, lam_A)
    half = g.rmax.max() * 1.05
    xs = np.linspace(-half, half, nx)
    ys = np.linspace(-half, half, ny)
    I, tau, _, _ = raytrace.make_cube(model, theta, xs, ys, freqs,
                                      is_line=False)
    pix_sr = ((xs[1] - xs[0]) * (ys[1] - ys[0]) * c.AU2cm ** 2
              / (dist_pc * c.pc2cm) ** 2)
    spec = I.sum(axis=(0, 1)) * pix_sr / c.jansky2CGS
    if out_fits:
        fitsio.write_cube_fits(out_fits, I, freqs=freqs, tau_map=tau,
                               spectrum=spec,
                               header={"THETA": float(theta),
                                       "DIST": dist_pc,
                                       "PIXSR": float(pix_sr),
                                       "CDELT1": float(xs[1] - xs[0]),
                                       "CDELT2": float(ys[1] - ys[0])})
    return I, tau, spec
