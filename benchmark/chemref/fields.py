"""The fields that feed one cell's chemistry, worked out by the reference
from the grid, the MC stage's fields and the initial abundances.

Columns: the reference's rule (disk.f90:2577-2616, as the port traces
it): a ray from the corner of the cell nearest the target (the star at
the origin, or (r_mid, 2 max zmax) for the ISM), inset by 1e-6 of the
cell, straight to the target in the (r, z) half-plane; it gathers the
active cells it crosses until it first leaves the grid.  Here each
crossing is the exact overlap of the segment with each cell's rectangle,
in float64 numpy, not a march.  Then the self-shielding factors (H2 by
Draine & Bertoldi 1996, CO by Visser et al. 2009, H2O and OH by their
Ly-alpha cross sections), Av to the ISM from the dust column, and the
cell's rate and thermal environments, as the port's DiskModel assembles
them (prepare_sweep_fields, assemble_envs).  The grid is the
reference's own (grid.py); the MC stage's fields are the program's.
"""

import numpy as np
import torch

from . import constants as c
from .oracle import SHIELDED
from .tables import VisserCOShielding

SF = 1e-6        # the start corner's inset, a fraction of the cell
GAP = 1e-9       # AU: overlaps closer than this are contiguous


def mrn_moments(rmin, rmax, n):
    """<r>, <r^2>, <r^3> (micron) of dn/dr ~ r^-n on [rmin, rmax]."""
    rmax = max(rmax, rmin * 1.0001)
    t1, t2 = rmin ** (1.0 - n), rmax ** (1.0 - n)
    norm = np.log(rmax / rmin) if abs(n - 1.0) <= 1e-6 \
        else (t2 - t1) / (1.0 - n)

    def mom(k):
        if abs(n - (k + 1.0)) <= 1e-6:
            return np.log(rmax / rmin) / norm
        return (t2 * rmax ** k - t1 * rmin ** k) / ((k + 1.0 - n) * norm)

    return mom(1), mom(2), mom(3)


def start_point(g, i, tx, tz):
    x0, x1, y0, y1 = g["rmin"][i], g["rmax"][i], g["zmin"][i], g["zmax"][i]
    dx, dy = x1 - x0, y1 - y0
    cand = [(x0 + dx * SF, y0 + dy * SF), (x0 + dx * SF, y1 - dy * SF),
            (x1 - dx * SF, y0 + dy * SF), (x1 - dx * SF, y1 - dy * SF),
            (0.5 * (x0 + x1), 0.5 * (y0 + y1))]
    d2 = [(tx - a) ** 2 + (tz - b) ** 2 for a, b in cand]
    return cand[int(np.argmin(d2))]


def ray_weights(g, i, tx, tz):
    """Path length (cm) through each cell of the ray from cell i toward
    (tx, tz), up to where it first leaves the grid; active cells only."""
    px, pz = start_point(g, i, tx, tz)
    vx, vz = tx - px, tz - pz
    L = np.hypot(vx, vz)

    def slab(p, v, lo, hi):
        with np.errstate(divide="ignore", invalid="ignore"):
            a, b = (lo - p) / v, (hi - p) / v
        inside = (lo <= p) & (p <= hi)
        s0 = np.where(v != 0.0, np.minimum(a, b), np.where(inside, -np.inf,
                                                           np.inf))
        s1 = np.where(v != 0.0, np.maximum(a, b), np.where(inside, np.inf,
                                                           -np.inf))
        return s0, s1

    sx0, sx1 = slab(px, vx, g["rmin"], g["rmax"])
    sz0, sz1 = slab(pz, vz, g["zmin"], g["zmax"])
    s0 = np.maximum(np.maximum(sx0, sz0), 0.0)
    s1 = np.minimum(np.minimum(sx1, sz1), 1.0)
    hit = np.nonzero(s1 > s0)[0]
    order = hit[np.argsort(s0[hit], kind="stable")]
    w = np.zeros(len(g["rmin"]))
    reach = 0.0
    for j in order:
        if s0[j] * L > reach + GAP:
            break                       # the ray left the grid
        w[j] = (s1[j] - s0[j]) * L * c.AU2cm
        reach = max(reach, s1[j] * L)
    return np.where(g["using"], w, 0.0)


def h2_self_shielding(N_H2, dv_turb):
    x = N_H2 / 5e14
    b5 = dv_turb / 1e5
    t = np.sqrt(1.0 + x)
    return np.minimum(0.965 / (1.0 + x / b5) ** 2
                      + 0.035 / t * np.exp(-8.5e-4 * t), 1.0)


class Fields:
    """The reference's view of the disk: its own grid (grid.py), the MC
    stage's fields (the program's), the dust from the configuration, the
    initial abundances from the network's file."""

    def __init__(self, grid, mc, cfg, net, y0):
        self.g = grid
        self.mc = mc
        self.net = net
        self.y0 = y0
        g = self.g
        rav, r2av, r3av = mrn_moments(cfg["dust_mrn_rmin"],
                                      cfg["dust_mrn_rmax"], cfg["dust_mrn_n"])
        self.pmass = 4.0 * np.pi / 3.0 * r3av * c.micron2cm ** 3 \
            * cfg["dust_rho_material"]
        self.sig_dust = np.pi * r2av * c.micron2cm ** 2
        self.grain_a = np.sqrt(r2av) * c.micron2cm
        rho_gas = g["n0"] * 1.4 * c.mProton_CGS
        self.n_dust = rho_gas * cfg["dust_d2g_mass"] / self.pmass
        self.d2h = self.n_dust / np.maximum(g["n0"], 1e-300)
        self.vol = np.pi * (g["rmax"] ** 2 - g["rmin"] ** 2) \
            * (g["zmax"] - g["zmin"]) * c.AU2cm ** 3
        self.star_mass = cfg["star_mass"]
        self.visser = VisserCOShielding("cpu")

    def envs(self, i, Tgas):
        """(env, tenv): the fields of cell i at the initial gas
        temperature Tgas that the rates and the heating and cooling read,
        as dicts of floats (the self-shielding factors as lists in the
        order [none, H2, CO, H2O, OH] and by species name)."""
        g, mc, net = self.g, self.mc, self.net
        rc = 0.5 * (g["rmin"][i] + g["rmax"][i])
        zfar = 2.0 * g["zmax"].max()
        w_s = ray_weights(g, i, 0.0, 0.0)
        w_i = ray_weights(g, i, rc, zfar)
        # at the sweep every cell holds the initial abundances
        col = {(s, d): float(w @ (g["n0"] * self.y0[net.idx[s]]))
               for s in ("H2", "CO", "H2O", "OH")
               for d, w in (("s", w_s), ("i", w_i))}
        Ntot_s, Ntot_i = float(w_s @ g["n0"]), float(w_i @ g["n0"])
        dv = np.sqrt(c.kBoltzmann_CGS * max(Tgas, 10.0)
                     / (c.mProton_CGS * 1.4 * 2.0))

        def factors(d):
            co = self.visser.shielding(
                torch.tensor([col["H2", d]], dtype=torch.float64),
                torch.tensor([col["CO", d]], dtype=torch.float64))
            return [1.0, float(h2_self_shielding(col["H2", d], dv)),
                    float(torch.clamp(co, 0.0, 1.0)[0]),
                    min(np.exp(-col["H2O", d] * c.LyAlpha_cross_H2O), 1.0),
                    min(np.exp(-col["OH", d] * c.LyAlpha_cross_OH), 1.0)]

        Av_ism = 1.086 * float(w_i @ self.n_dust) * np.pi \
            * self.grain_a ** 2 * 2.0
        a = self.grain_a
        env = dict(
            Tgas=Tgas, Tdust=mc["Tdust"][i], n_gas=g["n0"][i],
            zeta_cosmicray_H2=1.36e-17, zeta_Xray_H2=mc["zeta_Xray"][i],
            Ncol_toISM=Ntot_i, Av_toISM=Av_ism, Av_toStar=mc["Av_toStar"][i],
            G0_UV_toISM=1.0, G0_UV_toStar=mc["G0_UV_toStar"][i],
            G0_UV_H2phd=mc["G0_UV_H2phd"][i],
            G0_UV_toStar_photoDesorb=mc["G0_UV_toStar_photoDesorb"][i],
            phflux_Lya=mc["phflux_Lya"][i], omega_albedo=0.5,
            f_selfshielding_toISM=factors("i"),
            f_selfshielding_toStar=factors("s"),
            GrainRadius_CGS=a, sigdust_ave=self.sig_dust,
            ndust_tot=self.n_dust[i], ratioDust2HnucNum=self.d2h[i],
            SitesPerGrain=4.0 * np.pi * a ** 2 * c.SitesDensity_CGS)
        G = c.GravitationConst_CGS * self.star_mass * c.Msun_CGS
        r_cm = rc * c.AU2cm
        velo_grad = 0.5 * np.sqrt(G / r_cm) / r_cm
        cs = np.sqrt(c.kBoltzmann_CGS * max(Tgas, 1.0)
                     / (c.mProton_CGS * 1.4 * 2.0))

        def pad4(v):
            return [v, 0.0, 0.0, 0.0]

        tenv = dict(
            PAH_abundance=c.PAH_abundance_0, MeanMolWeight=1.4,
            alpha_viscosity=0.01, omega_Kepler=np.sqrt(G / r_cm ** 3),
            velo_width_turb=cs, coherent_length=cs / velo_grad,
            Ncol_toStar=Ntot_s, Neufeld_G=1.0,
            Neufeld_dv_dz=velo_grad * 1e-5,
            n_dusts=pad4(self.n_dust[i]), sig_dusts=pad4(self.sig_dust),
            Tdusts=pad4(mc["Tdusts"][0, i]),
            en_gains=[mc["en_gain"][0, i], np.inf, np.inf, np.inf],
            mdusts_cell=pad4(self.n_dust[i] * self.vol[i] * self.pmass),
            volume=self.vol[i] / c.AU2cm ** 3)

        env["fss_ism"] = dict(zip(SHIELDED, env["f_selfshielding_toISM"][1:]))
        env["fss_star"] = dict(zip(SHIELDED,
                                   env["f_selfshielding_toStar"][1:]))
        return env, tenv
