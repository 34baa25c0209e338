"""NLTE level populations: LVG / escape-probability statistical equilibrium.

Counterpart of the JAX package's ``ops/stateq.py`` (reference
src/statistic_equilibrium.f90): the rate system ydot(f) with escape
probability beta(tau) = (1-exp(-3 tau))/(3 tau) (negative-tau guard
:327-340), source-function coupling to the local continuum
(get_cont_alpha :210-250, J_ave = S (1-beta) + J_cont beta), and
collisional terms interpolated on the partner temperature grids.

The solver is one damped Newton over all cells at once, on
[ydot[:-1]; sum(f) - 1] (the normalization closure row, reference
stat_equili_fcn :256-280), starting from LTE.  A per-cell done mask
reproduces the JAX package's ``while_loop`` under ``vmap``: a cell whose
residual norm fell to ``tol``, or that took ``n_newton`` steps, keeps its
state while the others iterate; each step works on the cells still
iterating only.  The Jacobian is written out analytically (``jacobian``,
held to ``jax.jacfwd``'s numbers by the tests; forward-mode AD in torch
goes through Python decompositions whose first use costs seconds), and
the step comes from ``linalg.mp_linsolve``.  Every function takes cells
along leading dimensions (f [..., n_level]); float64 throughout but the
f32 factor.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import constants as c
from ..io.lamda import Molecule
from .linalg import mp_linsolve

# damping factors tried at every Newton step; the best residual wins
LAMBDAS = (1.0, 0.5, 0.25, 0.1)


class MolTables(NamedTuple):
    """Tensors for one molecule on one device."""
    energy_K: torch.Tensor
    g: torch.Tensor
    iup: torch.Tensor
    ilow: torch.Tensor
    Aul: torch.Tensor
    Bul: torch.Tensor
    Blu: torch.Tensor
    freq: torch.Tensor
    lam_A: torch.Tensor
    # collision data, one entry per partner, on its own T grid
    p_iup: tuple
    p_ilow: tuple
    p_T: tuple
    p_Cul: tuple
    partner_names: tuple


def build_mol_tables(mol: Molecule, device) -> MolTables:
    def f(a):
        return torch.as_tensor(a, dtype=torch.float64, device=device)

    def i(a):
        return torch.as_tensor(a, dtype=torch.int64, device=device)

    return MolTables(
        energy_K=f(mol.energy_K), g=f(mol.g), iup=i(mol.iup),
        ilow=i(mol.ilow), Aul=f(mol.Aul), Bul=f(mol.Bul), Blu=f(mol.Blu),
        freq=f(mol.freq), lam_A=f(mol.lam_A),
        p_iup=tuple(i(p.iup) for p in mol.partners),
        p_ilow=tuple(i(p.ilow) for p in mol.partners),
        p_T=tuple(f(p.T_coll) for p in mol.partners),
        p_Cul=tuple(f(p.Cul) for p in mol.partners),
        partner_names=tuple(p.name for p in mol.partners))


class CellExcEnv(NamedTuple):
    """Per-cell conditions for the excitation solve (leading cell dims)."""
    Tkin: torch.Tensor
    dv: torch.Tensor              # line width, cm/s
    length_scale: torch.Tensor    # cm
    density_mol: torch.Tensor     # cm^-3
    dens_partner: torch.Tensor    # [..., n_partner]
    cont_alpha: torch.Tensor      # [..., n_rad] continuum extinction
    cont_J: torch.Tensor          # [..., n_rad] continuum mean intensity


def boltzmann(tab: MolTables, Tkin):
    f = tab.g * torch.exp(-tab.energy_K
                          / torch.clamp_min(Tkin, 1e-30)[..., None])
    return f / f.sum(-1, keepdim=True)


def _beta_of_tau(tau):
    small = torch.abs(tau) <= 1e-6
    big = tau >= 100.0
    neg = tau < 0.0
    tau_s = torch.where(small | (tau == 0.0), 1.0, tau)
    general = (1.0 - torch.exp(-3.0 * torch.clamp_max(tau_s, 200.0))) \
        / (3.0 * tau_s)
    return torch.where(small, 1.0,
                       torch.where(big, 1.0 / (3.0 * tau_s),
                                   torch.where(neg, 1.0 - 1.5 * tau,
                                               general)))


def _collision_rates(tab: MolTables, Tkin):
    """Interpolated Cul and detailed-balance Clu per partner, each
    [..., n_tr]."""
    out = []
    Tk = Tkin[..., None]
    for pi in range(len(tab.p_T)):
        Tc = tab.p_T[pi]
        nT = Tc.shape[0]
        j = torch.clamp(torch.searchsorted(Tc, Tkin.reshape(-1)),
                        1, nT - 1).reshape(Tkin.shape)
        TL, TR = Tc[j - 1][..., None], Tc[j][..., None]
        w = torch.clamp((Tk - TL) / torch.clamp_min(TR - TL, 1e-300),
                        0.0, 1.0)
        Cul = tab.p_Cul[pi][j - 1] * (1.0 - w) + tab.p_Cul[pi][j] * w
        iu, il = tab.p_iup[pi], tab.p_ilow[pi]
        dE = tab.energy_K[iu] - tab.energy_K[il]
        Clu = Cul * torch.exp(-dE / torch.clamp_min(Tk, 1e-30)) \
            * tab.g[iu] / tab.g[il]
        out.append((Cul, Clu))
    return out


def _rhs(tab: MolTables, env: CellExcEnv, f, coll):
    """ydot and (beta, J_ave) from the collision rates coll."""
    def s(a):                  # per-cell scalar against transitions
        return a[..., None]
    yu = f[..., tab.iup]
    yl = f[..., tab.ilow]
    del_nu = tab.freq * s(env.dv) / c.SpeedOfLight_CGS
    t1 = c.hPlanck_CGS * tab.freq / (4.0 * torch.pi) * s(env.density_mol) \
        / del_nu
    jnu = yu * tab.Aul
    knu = yl * tab.Blu - yu * tab.Bul
    alpha = t1 * knu + env.cont_alpha
    tau = alpha * s(env.length_scale)
    beta = _beta_of_tau(tau)
    safe = torch.abs(knu) > 1e-30
    S = torch.where(safe, jnu / torch.where(safe, knu, 1.0),
                    jnu * s(env.length_scale) * t1)
    J_ave = S * (1.0 - beta) + env.cont_J * beta
    r = tab.Aul * yu + tab.Bul * J_ave * yu - tab.Blu * J_ave * yl
    ydot = torch.zeros_like(f).index_add(-1, tab.iup, -r) \
        .index_add(-1, tab.ilow, r)
    for pi, (Cul, Clu) in enumerate(coll):
        rc = (Cul * f[..., tab.p_iup[pi]] - Clu * f[..., tab.p_ilow[pi]]) \
            * env.dens_partner[..., pi:pi + 1]
        ydot = ydot.index_add(-1, tab.p_iup[pi], -rc) \
            .index_add(-1, tab.p_ilow[pi], rc)
    return ydot, (beta, J_ave)


def stateq_rhs(tab: MolTables, env: CellExcEnv, f):
    """ydot for the level populations (reference stat_equili_ode_f)."""
    return _rhs(tab, env, f, _collision_rates(tab, env.Tkin))


def cooling_rate(tab: MolTables, env: CellExcEnv, f):
    """Total line cooling [erg cm^-3 s^-1] (reference calc_cooling_rate,
    statistic_equilibrium.f90:56-78)."""
    _, (beta, J_ave) = stateq_rhs(tab, env, f)
    per_tr = beta * c.hPlanck_CGS * tab.freq * env.density_mol[..., None] * (
        (tab.Aul + tab.Bul * J_ave) * f[..., tab.iup]
        - tab.Blu * J_ave * f[..., tab.ilow])
    return per_tr.sum(-1)


def _resid(tab, env, f, coll):
    ydot, _ = _rhs(tab, env, f, coll)
    return torch.cat([ydot[..., :-1], f.sum(-1, keepdim=True) - 1.0], -1)


def _dbeta_dtau(tau):
    """d beta / d tau, branch by branch as _beta_of_tau selects them."""
    small = torch.abs(tau) <= 1e-6
    big = tau >= 100.0
    neg = tau < 0.0
    tau_s = torch.where(small | (tau == 0.0), 1.0, tau)
    e = torch.exp(-3.0 * torch.clamp_max(tau_s, 200.0))
    general = e / tau_s - (1.0 - e) / (3.0 * tau_s * tau_s)
    return torch.where(small, 0.0,
                       torch.where(big, -1.0 / (3.0 * tau_s * tau_s),
                                   torch.where(neg, -1.5, general)))


def _pair_entries(n, up, low, d_up, d_low):
    """Flat Jacobian indices and values of transitions moving population
    from level up to level low at a rate r with dr/df_up = d_up and
    dr/df_low = d_low: ydot[low] += r, ydot[up] -= r."""
    idx = torch.cat([low * n + up, low * n + low, up * n + up, up * n + low])
    val = torch.cat([d_up, d_low, -d_up, -d_low], -1)
    return idx, val


def jacobian(tab: MolTables, env: CellExcEnv, f, coll=None):
    """d [ydot[:-1]; sum(f) - 1] / d f, [B, n, n] for f [B, n]: the
    radiative rates through J_ave (the source function and the escape
    probability of each line), the collisional rates linear in f."""
    if coll is None:
        coll = _collision_rates(tab, env.Tkin)
    B, n = f.shape

    def s(a):
        return a[..., None]
    yu = f[..., tab.iup]
    yl = f[..., tab.ilow]
    L = s(env.length_scale)
    t1 = c.hPlanck_CGS * tab.freq / (4.0 * torch.pi) * s(env.density_mol) \
        / (tab.freq * s(env.dv) / c.SpeedOfLight_CGS)
    jnu = yu * tab.Aul
    knu = yl * tab.Blu - yu * tab.Bul
    tau = (t1 * knu + env.cont_alpha) * L
    beta = _beta_of_tau(tau)
    safe = torch.abs(knu) > 1e-30
    kq = torch.where(safe, knu, 1.0)
    S = torch.where(safe, jnu / kq, jnu * L * t1)
    J_ave = S * (1.0 - beta) + env.cont_J * beta
    dS_up = torch.where(safe, tab.Aul / kq + jnu * tab.Bul / (kq * kq),
                        tab.Aul * L * t1)
    dS_low = torch.where(safe, -jnu * tab.Blu / (kq * kq), 0.0)
    db = _dbeta_dtau(tau)
    dJ_up = dS_up * (1.0 - beta) + (env.cont_J - S) * db * (-t1 * L * tab.Bul)
    dJ_low = dS_low * (1.0 - beta) + (env.cont_J - S) * db * (t1 * L * tab.Blu)
    # r = Aul yu + (Bul yu - Blu yl) J_ave
    idx, val = _pair_entries(n, tab.iup, tab.ilow,
                             tab.Aul + tab.Bul * J_ave - knu * dJ_up,
                             -tab.Blu * J_ave - knu * dJ_low)
    idxs, vals = [idx], [val]
    for pi, (Cul, Clu) in enumerate(coll):
        dp = env.dens_partner[..., pi:pi + 1]
        idx, val = _pair_entries(n, tab.p_iup[pi], tab.p_ilow[pi],
                                 Cul * dp, -Clu * dp)
        idxs.append(idx)
        vals.append(val)
    Jf = torch.zeros(B, n * n, dtype=f.dtype, device=f.device).index_add(
        1, torch.cat(idxs), torch.cat(vals, -1)).view(B, n, n)
    return torch.cat([Jf[:, :-1], torch.ones_like(Jf[:, :1])], 1)


def _take(env, coll, idx):
    return (CellExcEnv(*(a[idx] for a in env)),
            [(a[idx], b[idx]) for a, b in coll])


def solve_stateq_batch(tab: MolTables, envs: CellExcEnv, n_newton: int = 30,
                       tol: float = 1e-10, stats: dict | None = None):
    """Damped Newton for every cell of envs (fields [B, ...]) from LTE.

    Returns (f [B, n_level] clipped at 0 and normalized, the residual
    norm err [B]).  A cell has converged when err <= tol.  stats, when
    given, receives "iters" (Newton steps per cell, [B]) and "steps"
    (batched steps taken, one host read each)."""
    coll_all = _collision_rates(tab, envs.Tkin)
    f = boltzmann(tab, envs.Tkin)
    B = f.shape[0]
    dev = f.device
    it = torch.zeros(B, dtype=torch.int64, device=dev)
    err = torch.full((B,), torch.inf, dtype=torch.float64, device=dev)

    steps = 0
    while True:
        idx = torch.nonzero((it < n_newton) & (err > tol))[:, 0]
        if idx.numel() == 0:           # one host read per step
            break
        steps += 1
        fa = f[idx]
        ea, ca = _take(envs, coll_all, idx)
        F = _resid(tab, ea, fa, ca)
        dx = mp_linsolve(jacobian(tab, ea, fa, ca), -F)
        err0 = torch.linalg.vector_norm(F, dim=-1)
        fs = torch.stack([fa + lam * dx for lam in LAMBDAS])   # [4, b, n]
        errs = torch.linalg.vector_norm(
            _resid(tab, CellExcEnv(*(a[None] for a in ea)), fs,
                   [(a[None], b[None]) for a, b in ca]), dim=-1)
        ib = torch.argmin(errs, dim=0)                         # [b]
        ar = torch.arange(len(idx), device=dev)
        fn, en = fs[ib, ar], errs[ib, ar]
        improved = en < err0
        f[idx] = torch.where(improved[:, None], fn, fa)
        err[idx] = torch.where(improved, en, err0 * 0.999999)
        it[idx] += 1
    if stats is not None:
        stats["iters"] = it
        stats["steps"] = steps
    f = torch.clamp_min(f, 0.0)
    return f / f.sum(-1, keepdim=True), err


def solve_stateq(tab: MolTables, env: CellExcEnv, n_newton: int = 30,
                 tol: float = 1e-10):
    """One cell (0-d env fields but the per-partner/transition vectors)."""
    fs, errs = solve_stateq_batch(
        tab, CellExcEnv(*(torch.as_tensor(a)[None] for a in env)),
        n_newton, tol)
    return fs[0], errs[0]
