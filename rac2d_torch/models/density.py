"""Analytic disk density structures (Andrews 2009, Hayashi 1981).

Rebuild of the reference's analytic density options
(reference: src/grid.f90:1716-1818 ``Andrews_dens`` /
``density_analytic_Hayashi``; parameter struct src/data_struct.f90:451-477).
Host-side numpy (a copy of the JAX package's ``models/density.py``): the
grid is built on the host.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from .. import constants as c


@dataclasses.dataclass
class AndrewsDisk:
    """Self-similar viscous disk profile (Andrews et al. 2009 eq 1-2)."""
    useNumDens: bool = True
    particlemass: float = 1.4 * c.mProton_CGS
    Md: float = 0.0          # disk mass, Msun
    rin: float = 0.5         # AU
    rout: float = 200.0
    rc: float = 200.0
    hc: float = 50.0         # scale height at rc, AU
    gam: float = 1.0         # surface-density power index
    psi: float = 1.0         # flaring index
    # inner exponential taper
    r0_in_exp: float = 0.0
    rs_in_exp: float = 1e5
    p_in_exp: float = 1.0
    f_in_exp: float = 1.0
    # outer exponential taper
    r0_out_exp: float = 1e5
    rs_out_exp: float = 1e5
    p_out_exp: float = 1.0
    f_out_exp: float = 1.0
    # scale-height bumps
    r0_in_change: float = 0.0
    f_in_change: float = 1.0
    r0_out_change: float = 1e5
    f_out_change: float = 1.0
    r_in_flatten: float = 0.0

    def density(self, r, z, xp=np):
        """Number density [cm^-3] at (r, z) in AU.  Vectorized."""
        a = self
        r = xp.asarray(r, dtype=float)
        z = xp.asarray(z, dtype=float)
        t3 = math.exp(-(a.rin / a.rc) ** (2.0 - a.gam))
        t4 = math.exp(-(a.rout / a.rc) ** (2.0 - a.gam))
        sigma_c = (2.0 - a.gam) * a.Md / (c.two_pi * a.rc ** 2) / (t3 - t4)

        rrc = xp.where(r <= a.r_in_flatten, a.r_in_flatten / a.rc, r / a.rc)
        rrc = xp.maximum(rrc, 1e-300)
        rlog = xp.log(rrc)
        t1 = xp.exp(-a.gam * rlog)
        t2 = rrc * rrc * t1

        ftaper_in = xp.where(
            r < a.r0_in_exp,
            xp.exp(-xp.clip(((a.r0_in_exp - r) / a.rs_in_exp) ** a.p_in_exp,
                            0.0, c.max_exp)) * a.f_in_exp,
            1.0)
        ftaper_out = xp.where(
            r > a.r0_out_exp,
            xp.exp(-xp.clip(
                (xp.abs(r - a.r0_out_exp) / a.rs_out_exp) ** a.p_out_exp,
                0.0, c.max_exp)) * a.f_out_exp,
            1.0)
        sigma = sigma_c * t1 * xp.exp(-t2) * ftaper_in * ftaper_out

        h = a.hc * xp.exp(a.psi * rlog)
        h = xp.where(r < a.r0_in_change, h * a.f_in_change,
                     xp.where(r > a.r0_out_change, h * a.f_out_change, h))

        zh2 = 0.5 * (z / h) ** 2
        dens = sigma / (c.sqrt_2pi * h) * xp.exp(
            -xp.minimum(zh2, c.max_exp)) * c.Msun_CGS / (c.AU2cm ** 3)
        if a.useNumDens:
            dens = dens / a.particlemass
        ok = (r >= a.rin) & (r <= a.rout) & (zh2 < c.max_exp)
        return xp.where(ok, dens, 0.0)
