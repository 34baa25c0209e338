"""Image synthesis: formal solution of the transfer equation along rays.

Counterpart of the JAX package's ``ops/raytrace.py`` (reference:
src/ray_tracing.f90:258-334 ``make_a_cube``, :367-564
``integerate_a_ray``, :569-662 the per-cell Doppler-substepped line
integration and ``integrate_one_step``; dust emissivity :338-364).

The pixel rays of a cube advance together, a chunk of them at a time:
each step of the march is one cell crossing for every live ray of the
chunk (``geometry.ray_cell_exit_mirror``, then ``geometry.locate`` on its
full-precision path), with all nf channels and the NSUB Doppler
sub-segments of the crossing as tensor operations.  A ray leaves the
batch when its next cell is -1, or after ``max_cross`` crossings; the
live count is read back to the host once per crossing.  A chunk holds as
many rays as keep one [rays, NSUB + 1, nf] float64 temporary of the line
crossing at CHUNK_ELEMS elements (about a dozen are live at once), so
that the memory does not grow with the pixel count.

Precision: float64 throughout, as the JAX package's ray tracer runs
(there x64 is on and every input is a float64 numpy array).  The
package's "imaging in float32" policy does not describe this module.
This is plain PyTorch; no kernel is written for it.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .. import constants as c
from ..utils.planck import B_nu
from . import geometry

# Doppler sub-segments per cell crossing.  The reference adaptively
# splits the path whenever the local line frequency crosses the channel
# (ray_tracing.f90:569-621) and evaluates the profile pointwise per
# sub-segment; here each sub-segment uses the erf-integrated mean
# Gaussian profile, exact for a linearly varying Doppler shift, so a few
# segments (capturing the curvature of v(l)) replace the reference's many.
NSUB = 32
MAX_CROSS = 10_000
# elements of one [rays, NSUB + 1, nf] temporary of a chunk (256 MiB)
CHUNK_ELEMS = 1 << 25


class RtCells(NamedTuple):
    """Per-cell state for imaging (float64 tensors on one device)."""
    rmin: torch.Tensor
    rmax: torch.Tensor
    zmin: torch.Tensor
    zmax: torch.Tensor
    using: torch.Tensor
    Tdusts: torch.Tensor       # [n_dust, n]
    rho_dust: torch.Tensor     # [n_dust, n]
    n_mol: torch.Tensor        # [n] number density of the imaged molecule
    f_up: torch.Tensor         # [n] upper-level population fraction
    f_low: torch.Tensor        # [n]
    dv: torch.Tensor           # [n] local line width (cm/s)


class RtModel(NamedTuple):
    gi: geometry.GridIndex
    cells: RtCells
    # dust opacity interpolated per channel: [n_dust, nf]
    kext_dust: torch.Tensor
    star_mass: float
    # line parameters (scalars; zeros for continuum-only)
    f0: float
    Aul: float
    Bul: float
    Blu: float


def _doppler_nu(star_mass, nu0, x, y, z, vx, vy):
    rr = x * x + y * y
    r3 = torch.sqrt(rr + z * z)
    v = torch.sqrt((c.GravitationConst_CGS * c.Msun_CGS / c.AU2cm)
                   * star_mass / torch.clamp_min(r3, 1e-30))
    vd = (-y * vx + x * vy) * v / torch.sqrt(torch.clamp_min(rr, 1e-30))
    return nu0 * (1.0 - vd / c.SpeedOfLight_CGS)


def _slab(jnu, knu, dl):
    """One uniform-slab update as (a, b, tau) with I_new = a I + b
    (reference integrate_one_step, ray_tracing.f90:642-662): the thin
    form below tau 1e-4, the source function above tau 50."""
    S = jnu / (knu + 1e-100)
    tau = knu * dl
    t1 = torch.exp(-torch.clamp(tau, -200.0, 200.0))
    gen = (tau >= 1e-4) | (tau < 0.0)
    thick = tau >= 50.0
    a = torch.where(thick, 0.0, torch.where(gen, t1, 1.0 - tau))
    b = torch.where(thick, S, torch.where(gen, S * (1.0 - t1), jnu * dl))
    return a, b, tau


def _step_I(Inu, jnu, knu, dl):
    """One uniform slab: (the new intensity, its tau)."""
    a, b, tau = _slab(jnu, knu, dl)
    return a * Inu + b, tau


def _line_crossing(model, x, y, z, v, length, dl_cm, cl, freqs, Inu, jc,
                   kc):
    """The NSUB sub-segments of one crossing for every live ray and every
    channel: (Inu [R, nf], the crossing's tau [R, nf]).  The profile, the
    emissivity and the opacity of all sub-segments are computed at once
    ([R, NSUB, nf]); only the slab recurrence I <- a I + b runs through
    the sub-segments in turn."""
    cells = model.cells
    vx, vy, vz = (a[:, None, None] for a in v)
    yup = cells.f_up[cl]
    ylow = cells.f_low[cl]
    nmol = cells.n_mol[cl]
    width_nu = model.f0 * cells.dv[cl] / c.SpeedOfLight_CGS
    t1 = c.hPlanck_CGS * model.f0 / (4.0 * math.pi) * nmol \
        / (c.sqrt_2pi * width_nu)
    line_k = (t1 * (ylow * model.Blu - yup * model.Bul))[:, None, None]
    line_j = (t1 * yup * model.Aul)[:, None, None]
    # positions at the sub-segment edges, then the Doppler-shifted
    # offset of every channel there: [R, NSUB + 1, nf]
    lm = (torch.arange(NSUB + 1, device=x.device)
          * (length / NSUB)[:, None])[:, :, None]
    nu_loc = _doppler_nu(model.star_mass, freqs, x[:, None, None] + vx * lm,
                         y[:, None, None] + vy * lm,
                         z[:, None, None] + vz * lm, vx, vy)
    xe = (nu_loc - model.f0) / width_nu[:, None, None]
    erf = torch.special.erf(xe * math.sqrt(0.5))
    x0a, x1a = xe[:, :-1], xe[:, 1:]
    dx = x1a - x0a
    wide = torch.abs(dx) > 1e-6
    # mean of exp(-x^2/2) over [x0, x1]: erf-integrated (exact for a
    # linear nu(l)); the midpoint value when the shift is negligible
    mean_erf = math.sqrt(math.pi / 2.0) * (erf[:, 1:] - erf[:, :-1]) \
        / torch.where(wide, dx, 1.0)
    xm = 0.5 * (x0a + x1a)
    mean_mid = torch.exp(-0.5 * torch.clamp(xm * xm, 0.0, 400.0))
    prof = torch.clamp(torch.where(wide, mean_erf, mean_mid), 0.0, 1.0)
    jnu = prof * line_j + jc[:, None, :]
    knu = prof * line_k + kc[:, None, :]
    a, b, tau = _slab(jnu, knu, (dl_cm / NSUB)[:, None, None])
    I = Inu
    for k in range(NSUB):
        I = a[:, k] * I + b[:, k]
    return I, tau.sum(1)


def _crossing(model, st, v, freqs, is_line):
    """One cell crossing of every ray in st: the new state."""
    cells = model.cells
    x, y, z, cell, Inu, taus, Nup, Nlow = st
    vx, vy, vz = v
    n_cells = cells.rmin.shape[0]
    cl = torch.clamp(cell, 0, n_cells - 1).to(torch.int64)
    length, eps, _, found = geometry.ray_cell_exit_mirror(
        x, y, z, vx, vy, vz, cells.rmin[cl], cells.rmax[cl],
        cells.zmin[cl], cells.zmax[cl])
    use = cells.using[cl] & found
    dl_cm = length * c.AU2cm

    # continuum emissivity/extinction per channel
    jc = torch.zeros_like(Inu)
    kc = torch.zeros_like(Inu)
    for d in range(cells.rho_dust.shape[0]):
        Td = cells.Tdusts[d, cl][:, None]
        kext = model.kext_dust[d][None, :] * cells.rho_dust[d, cl][:, None]
        Bd = B_nu(torch.clamp_min(Td, 1e-10), freqs[None, :])
        on = Td > 0.0
        jc = jc + torch.where(on, Bd * kext, 0.0)
        kc = kc + torch.where(on, kext, 0.0)

    if is_line:
        Inu2, dtau = _line_crossing(model, x, y, z, v, length, dl_cm, cl,
                                    freqs, Inu, jc, kc)
        nl = cells.n_mol[cl] * length * c.AU2cm
        Nup = torch.where(use, Nup + nl * cells.f_up[cl], Nup)
        Nlow = torch.where(use, Nlow + nl * cells.f_low[cl], Nlow)
    else:
        Inu2, dtau = _step_I(Inu, jc, kc, dl_cm[:, None])
    u = use[:, None]
    Inu = torch.where(u, Inu2, Inu)
    taus = torch.where(u, taus + dtau, taus)

    step = length + eps
    x = x + vx * step
    y = y + vy * step
    z = z + vz * step
    new_cell = geometry.locate(model.gi, x * x + y * y, torch.abs(z))
    new_cell = torch.where(found, new_cell, -1)
    return x, y, z, new_cell, Inu, taus, Nup, Nlow


def integrate_rays(model: RtModel, x0, y0, z0, vx, vy, vz, freqs, Inu0,
                   is_line: bool = True, max_cross: int = MAX_CROSS):
    """Formal solution along R parallel rays for all nf channels.

    x0, y0, z0: [R] ray origins (AU); vx, vy, vz: the common direction;
    freqs, Inu0: [nf].  Returns (Inu [R, nf], tau_line [R], Nup [R],
    Nlow [R]), float64 on the model's device."""
    gi = model.gi
    dev = freqs.device
    f64 = torch.float64
    x0, y0, z0 = (torch.as_tensor(a, dtype=f64, device=dev)
                  for a in (x0, y0, z0))
    R, nf = x0.shape[0], freqs.shape[0]
    v = tuple(torch.full((R,), float(a), dtype=f64, device=dev)
              for a in (vx, vy, vz))

    # enter the domain
    dom = (torch.full((R,), a, dtype=f64, device=dev)
           for a in (gi.rmin_dom, gi.rmax_dom, 0.0, gi.zmax_dom))
    length, eps, _, _ = geometry.ray_cell_exit_mirror(x0, y0, z0, *v, *dom)
    x = x0 + v[0] * (length + eps)
    y = y0 + v[1] * (length + eps)
    z = z0 + v[2] * (length + eps)
    cell = geometry.locate(gi, x * x + y * y, torch.abs(z))

    out_I = Inu0[None, :].expand(R, nf).clone()
    out_tau = torch.zeros(R, nf, dtype=f64, device=dev)
    out_Nu = torch.zeros(R, dtype=f64, device=dev)
    out_Nl = torch.zeros(R, dtype=f64, device=dev)
    # the live rays, compacted: their state and their index in the cube
    live = torch.nonzero(cell >= 0)[:, 0]
    st = (x[live], y[live], z[live], cell[live], out_I[live],
          out_tau[live], out_Nu[live], out_Nl[live])
    for _ in range(max_cross):
        if live.numel() == 0:
            break
        vl = tuple(a[:live.numel()] for a in v)
        st = _crossing(model, st, vl, freqs, is_line)
        # the rays whose next cell is -1 leave: a stable partition puts
        # the live ones first, so that the count is the only host read
        dead = st[3] < 0
        order = torch.argsort(dead.to(torch.int8), stable=True)
        n_alive = live.numel() - int(dead.sum())
        if n_alive < live.numel():
            gone, keep = order[n_alive:], order[:n_alive]
            idx = live[gone]
            for out, a in zip((out_I, out_tau, out_Nu, out_Nl), st[4:]):
                out.index_copy_(0, idx, a[gone])
            st = tuple(a[keep] for a in st)
            live = live[keep]
    if live.numel():                        # stopped at max_cross
        out_I[live], out_tau[live] = st[4], st[5]
        out_Nu[live], out_Nl[live] = st[6], st[7]
    # channels 0, 1, -2, -1, clamped into range as JAX clamps them (one
    # channel: all four are channel 0)
    e = [min(max(k, 0), nf - 1) for k in (0, 1, nf - 2, nf - 1)]
    tau_line = out_tau.amax(-1) - 0.25 * (
        out_tau[:, e[0]] + out_tau[:, e[1]] + out_tau[:, e[2]]
        + out_tau[:, e[3]])
    return out_I, tau_line, out_Nu, out_Nl


def cube_rays(model: RtModel, view_theta_deg, xs, ys):
    """The origins (px, py, pz [n_pix], AU, host float64) and the common
    direction (vx, vy, vz) of a cube's rays, pixel (i, j) at i * ny + j.
    The ray direction and origin rotation follow reference make_a_cube
    (ray_tracing.f90:277-315)."""
    th = np.deg2rad(view_theta_deg)
    ct, st = np.cos(th), np.sin(th)
    zfar = -float(model.gi.rmax_dom) * 5.0
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    px = X.ravel()
    py = Y.ravel() * ct - zfar * st
    pz = Y.ravel() * st + zfar * ct
    return (px, py, pz), (0.0, -st, ct)


def cmb(freqs):
    """The background intensity every ray starts from: B_nu(T_CMB)."""
    return B_nu(torch.tensor(c.CMB_T, dtype=torch.float64,
                             device=freqs.device), freqs)


def make_cube(model: RtModel, view_theta_deg, xs, ys, freqs, is_line=True):
    """Position-position-frequency cube [nx, ny, nf] plus tau/Ncol maps,
    as float64 numpy arrays; xs, ys: image-plane coordinates (AU).  The
    rays are traced as many pixels at a time as CHUNK_ELEMS allows at nf
    channels."""
    (px, py, pz), v = cube_rays(model, view_theta_deg, xs, ys)
    dev = model.cells.rmin.device
    fr = torch.as_tensor(np.asarray(freqs, dtype=np.float64), device=dev)
    Inu0 = cmb(fr)
    nx, ny, nf = len(xs), len(ys), len(freqs)
    chunk = max(CHUNK_ELEMS // ((NSUB + 1) * nf), 1)
    out = [np.zeros((nx * ny, nf)), np.zeros(nx * ny), np.zeros(nx * ny),
           np.zeros(nx * ny)]
    for lo in range(0, nx * ny, chunk):
        sl = slice(lo, lo + chunk)
        res = integrate_rays(model, px[sl], py[sl], pz[sl], *v, fr, Inu0,
                             is_line=is_line)
        for o, r in zip(out, res):
            o[sl] = r.cpu().numpy()
    I, tau, Nu, Nl = out
    return (I.reshape(nx, ny, nf), tau.reshape(nx, ny), Nu.reshape(nx, ny),
            Nl.reshape(nx, ny))
