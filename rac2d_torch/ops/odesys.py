"""The coupled chemistry(+temperature) ODE system, batch-native.

Counterpart of the JAX package's ``ops/odesys.py`` (reference
``chem_evol_solve``, src/chemistry.f90:391-588, with the ODE callbacks
``chem_ode_f``/``chem_ode_jac``, src/disk.f90:4569-4903).  The closures
here take a window of lanes at once: y[B, NEQ] with y[:, :n_species]
fractional abundances and y[:, n_species] = Tgas (evolved only when a
ThermalBalance is given and evolT is set, mirroring NEQ = nSpecies + 1 in
the reference, src/chemistry.f90:1861).
"""

from __future__ import annotations

import numpy as np
import torch

from ..io.umist import ChemNet
from ..utils.tree import tree_map
from . import bdf as bdfmod
from .network import Incidence, build_incidence, jac_species, rhs_species
from .rates import CellEnv, RateTables, build_rate_tables, compute_rates

F64 = torch.float64


class ChemicalODE:
    """Static description of the chemical ODE for a network, on one
    device."""

    def __init__(self, net: ChemNet, h2_form_use_moeq: bool = False,
                 diff2des: float = 0.5, thermal=None, device="cuda"):
        self.device = torch.device(device)
        if thermal is not None and thermal.device != self.device:
            raise ValueError(f"thermal balance on {thermal.device}, "
                             f"ODE on {self.device}")
        self.net = net
        self.n_species = net.n_species
        self.neq = net.n_species + 1
        self.h2_form_use_moeq = h2_form_use_moeq
        self.diff2des = diff2des
        self.tab: RateTables = build_rate_tables(net, self.device)
        self.inc: Incidence = build_incidence(net, h2_form_use_moeq,
                                              self.device)
        # ThermalBalance instance (ops.thermal); None = frozen temperature
        self.thermal = thermal
        self.key_idx = [int(i) for i in net.key_species_idx]

    def _batch_fns(self, evolT: bool):
        """(f_b, jac_b, sanity_b) for the batch solver.  args = (envs,
        tenvs, kb): for evolT=False the rate vectors kb[B, nR] are
        computed once per solve (T fixed -> k fixed); for evolT=True kb is
        None and rates are evaluated at the live T."""
        def f_b(yb, args):
            envs, tenvs, kb = args
            return self.make_f(envs, evolT, tenvs, k=kb)(yb)

        def jac_b(yb, args):
            envs, tenvs, kb = args
            return self.make_jac(envs, evolT, tenvs, k=kb)(yb)

        return f_b, jac_b, self._sanity(evolT)

    def _rates(self, env, T):
        return compute_rates(self.tab, env, T, self.diff2des,
                             self.h2_form_use_moeq)

    # ---- closures -------------------------------------------------------
    def make_f(self, env: CellEnv, evolT: bool, tenv=None, k=None):
        """f(y[B, NEQ]) -> ydot[B, NEQ] for the lanes of env."""
        nS = self.n_species
        k_pre = k

        def f(y):
            T = y[:, nS] if evolT else env.Tgas
            k = self._rates(env, T) if k_pre is None else k_pre
            ydot_s = rhs_species(self.inc, k, y[:, :nS],
                                 env.ratioDust2HnucNum, env.SitesPerGrain)
            if evolT and self.thermal is not None:
                Tdot = self.thermal.dTdt(y, T, env, tenv, k)
            else:
                Tdot = torch.zeros_like(y[:, nS])
            return torch.cat([ydot_s, Tdot[:, None]], dim=1)

        return f

    def make_jac(self, env: CellEnv, evolT: bool, tenv=None, k=None):
        """Dense Jacobian closure J(y[B, NEQ]) -> [B, NEQ, NEQ].

        The species block is the analytic COO assembly.  The temperature
        row/column use finite differences with exactly the reference's
        perturbation sizes (src/disk.f90:4755-4761, 4878-4899): the T
        column through the full RHS (rates recomputed), the T row as the
        FD of dT/dt with respect to the 10 key species at fixed k, zero
        for species currently negative.
        """
        nS = self.n_species
        k_pre = k

        def jac(y):
            B = y.shape[0]
            T = y[:, nS] if evolT else env.Tgas
            k = self._rates(env, T) if k_pre is None else k_pre
            J = torch.zeros(B, self.neq, self.neq, dtype=F64,
                            device=y.device)
            J[:, :nS, :nS] = jac_species(self.inc, k, y[:, :nS],
                                         env.ratioDust2HnucNum,
                                         env.SitesPerGrain)
            if evolT and self.thermal is not None:
                # both FDs batch their perturbed states along the lane
                # axis (lane-wise identical arithmetic, one evaluation of
                # the RHS / thermal stack instead of 2 / 10)
                def rep(t, r):
                    return tree_map(
                        lambda a: a.repeat((r,) + (1,) * (a.dim() - 1)), t)

                dT = 1e-2 * T + 1.0
                yT = y.clone()
                yT[:, nS] = T + dT
                f2 = self.make_f(rep(env, 2), True, rep(tenv, 2))(
                    torch.cat([y, yT]))
                f0 = f2[:B]
                col = (f2[B:] - f0) / dT[:, None]
                d2h = env.ratioDust2HnucNum
                nk = len(self.key_idx)
                ki = torch.as_tensor(self.key_idx, device=y.device)
                yi = y[:, ki].T                               # [nk, B]
                dy = yi * 1e-2 + d2h * 1e-6
                yp = y.repeat(nk, 1, 1)                       # [nk, B, NEQ]
                yp[torch.arange(nk), :, ki] = yi + dy
                td = self.thermal.dTdt(yp.reshape(nk * B, -1), T.repeat(nk),
                                       rep(env, nk), rep(tenv, nk),
                                       k.repeat(nk, 1)).reshape(nk, B)
                J[:, nS, ki] = torch.where(yi >= 0.0,
                                           (td - f0[:, nS]) / dy, 0.0).T
                J[:, :, nS] = col
            return J

        return jac

    def _sanity(self, evolT):
        """Insane-state detector (reference src/chemistry.f90:520-530):
        bad(y[B, NEQ]) -> [B] bool."""
        nS = self.n_species
        ids = [self.net.idx.get(s, -1) for s in ("gH2", "gH2O", "gH")]
        i_HI = self.net.idx.get("H", -1)
        i_E = self.net.idx.get("E-", -1)

        def bad(y):
            # any species past 2 x the maximum physical abundance is
            # insane; species-specific caps keep the reference's tighter
            # limits for the key ones
            b = torch.amax(torch.abs(y[:, :nS]), dim=1) > 2.0
            for i in ids:
                if i >= 0:
                    b = b | (torch.abs(y[:, i]) > 1.0)
            if i_HI >= 0:
                b = b | (torch.abs(y[:, i_HI]) > 2.0)
            if i_E >= 0:
                b = b | (torch.abs(y[:, i_E]) > 1.0)
            if evolT:
                b = b | torch.isnan(y[:, nS]) | (y[:, nS] <= 0.0)
            return b

        return bad

    def retry_ladder(self, levels: int, rtol0: float, atol0: float,
                     ratioDust2HnucNum: float):
        """(rtol_row, atol_row) [NEQ] tensors for ladder levels
        2..levels+1 — the per-lane retry ladder of solve_pool, mirroring
        the reference's relaxed re-solves (src/chemistry.f90:272-387 with
        flags from chem_set_solver_flags_alt)."""
        return [tolerance_ladder(self.net, lv, rtol0, atol0,
                                 ratioDust2HnucNum, self.device)
                for lv in range(2, 2 + levels)]

    # ---- solve ----------------------------------------------------------
    def _y0(self, y0_species, Tgas0):
        """[y0_species, Tgas0] as the solver's f64 state on this device."""
        def t(a):
            return torch.as_tensor(a, dtype=F64, device=self.device)
        return torch.cat([t(y0_species), t(Tgas0)[..., None]], dim=-1)

    def _rows(self, tol, N):
        """A tolerance [NEQ] row (shared) or [N, NEQ] as [N, NEQ]."""
        tol = torch.as_tensor(tol, dtype=F64, device=self.device)
        return tol.expand(N, -1).contiguous() if tol.dim() == 1 else tol

    def solve(self, env: CellEnv, y0_species, Tgas0, touts, rtol, atol,
              first_step=1e-8, evolT: bool = False, tenv=None,
              max_steps_per_interval: int = 2000) -> bdfmod.BDFResult:
        """Integrate one cell with the single-system solver (bdf.bdf_solve:
        its own refresh policy and the pivoted mixed-precision factor of
        ops/linalg.py).  env/tenv: one cell's environments (0-d fields,
        [4] per dust component) on this device; rtol/atol: [NEQ].  The
        right-hand side and Jacobian are the batched ones at one lane;
        with evolT=False the rate vector is computed once."""
        def one(a):
            return a[None]
        env1, tenv1 = tree_map(one, env), tree_map(one, tenv)
        k = None if evolT else self._rates(env1, env1.Tgas)
        f_b, jac_b, bad = self._batch_fns(evolT)
        args = (env1, tenv1, k)
        return bdfmod.bdf_solve(
            lambda y: f_b(y[None], args)[0],
            lambda y: jac_b(y[None], args)[0],
            self._y0(y0_species, Tgas0), 0.0, touts,
            torch.as_tensor(rtol, dtype=F64, device=self.device),
            torch.as_tensor(atol, dtype=F64, device=self.device),
            first_step, max_steps_per_interval,
            sanity_fn=lambda y: bool(bad(y[None])[0]))

    def solve_batched(self, envs: CellEnv, y0_species, Tgas0, touts, rtol,
                      atol, first_step=1e-8, evolT: bool = False,
                      tenvs=None, max_steps_per_interval: int = 2000,
                      n_refine: int = 1, host_loop: bool = False,
                      continuous: bool = False,
                      max_wall_s: float | None = None, progress_cb=None,
                      rounds_per_call: int = 256, retry_tols=None,
                      compact_min: int = 0,
                      lu_backend: str = "kernel") -> bdfmod.BDFResult:
        """Batch-native solve of B cells recording at `touts`: envs/tenvs
        fields, y0_species [B, nS] and Tgas0 [B] on this device; rtol/atol
        [NEQ] rows or [B, NEQ].  continuous=True: per-lane recording with
        no barrier at the output times (bdf.bdf_solve_batch_cont, with
        rounds_per_call, retry_tols and compact_min); host_loop=True: one
        record call per output time with the wall guard max_wall_s and
        progress_cb(i, state) after each (bdf.bdf_solve_batch_host, the
        chunked sweep's driver); neither: bdf.bdf_solve_batch.  With
        evolT=False the rate vectors are computed once per lane.
        lu_backend as for solve_pool."""
        f_b, jac_b, sanity_b = self._batch_fns(evolT)
        kb = None if evolT else self._rates(envs, envs.Tgas)
        args = (envs, tenvs, kb)
        y0 = self._y0(y0_species, Tgas0)
        B = y0.shape[0]
        rtol, atol = self._rows(rtol, B), self._rows(atol, B)
        kw = dict(max_steps_per_interval=max_steps_per_interval,
                  sanity_b=sanity_b, n_refine=n_refine, args=args,
                  lu_backend=lu_backend)
        if continuous:
            return bdfmod.bdf_solve_batch_cont(
                f_b, jac_b, y0, 0.0, touts, rtol, atol, first_step,
                max_wall_s=max_wall_s, progress_cb=progress_cb,
                rounds_per_call=rounds_per_call, retry_tols=retry_tols,
                compact_min=compact_min, **kw)
        if host_loop:
            return bdfmod.bdf_solve_batch_host(
                f_b, jac_b, y0, 0.0, touts, rtol, atol, first_step,
                max_wall_s=max_wall_s, progress_cb=progress_cb, **kw)
        return bdfmod.bdf_solve_batch(f_b, jac_b, y0, 0.0, touts, rtol,
                                      atol, first_step, **kw)

    def solve_pool(self, envs: CellEnv, y0_species, Tgas0, touts, rtol,
                   atol, width: int, first_step=1e-8,
                   evolT: bool = False, tenvs=None,
                   max_steps_per_interval: int = 2000,
                   n_refine: int = 1, retry_tols=None,
                   max_wall_s: float | None = None,
                   progress_cb=None,
                   rounds_per_call: int = 256,
                   lu_backend: str = "kernel") -> bdfmod.BDFResult:
        """Pool-refill sweep: N >> width lanes stream through ONE
        constant-width window (bdf.bdf_solve_batch_pool).  envs/tenvs
        fields, y0_species [N, nS] and Tgas0 [N] live on this ODE's
        device; rtol/atol may be [NEQ] rows (shared) or [N, NEQ].
        Returns a BDFResult over the full pool (on the CPU) with ys =
        final state only ([N, 1, NEQ]).

        lu_backend="kernel" factors and solves through the CUDA kernels
        on a CUDA device (their plain versions on the CPU);
        lu_backend="block" runs the plain versions on any device, for
        comparison.
        """
        f_b, jac_b, sanity_b = self._batch_fns(evolT)
        kb = None if evolT else self._rates(envs, envs.Tgas)
        args_pool = (envs, tenvs, kb)
        y0 = self._y0(y0_species, Tgas0)
        N = y0.shape[0]
        rtol, atol = self._rows(rtol, N), self._rows(atol, N)
        return bdfmod.bdf_solve_batch_pool(
            f_b, jac_b, y0, 0.0, touts, rtol, atol, first_step,
            width=width, max_steps_per_interval=max_steps_per_interval,
            sanity_b=sanity_b, n_refine=n_refine, max_wall_s=max_wall_s,
            progress_cb=progress_cb, args_pool=args_pool,
            rounds_per_call=rounds_per_call, retry_tols=retry_tols,
            lu_backend=lu_backend)


def tolerance_ladder(net: ChemNet, level: int, rtol0: float, atol0: float,
                     ratioDust2HnucNum: float, device="cuda"):
    """Per-equation RTOL/ATOL [NEQ] tensors, relaxation level 1..4+.

    Reproduces the reference's retry ladder ``chem_set_solver_flags_alt``
    (src/chemistry.f90:205-268): progressively looser tolerances for
    generic species, pinned tolerances for the 10 key species, special
    handling of Grain0/+/- and of grain-surface species.
    """
    nS = net.n_species
    neq = nS + 1
    if level == 1:
        r, a, rT, aT = rtol0, atol0, 1e-3, 1e-1
    elif level == 2:
        r, a, rT, aT = min(rtol0 * 1e1, 1e-4), min(atol0 * 1e5, 1e-25), 1e-2, 1e-1
    elif level == 3:
        r, a, rT, aT = min(rtol0 * 1e2, 1e-4), min(atol0 * 1e10, 1e-20), 1e-3, 1e0
    elif level == 4:
        r, a, rT, aT = min(rtol0 * 1e2, 1e-4), min(atol0 * 1e10, 1e-18), 1e-3, 1e0
    else:
        r = min(rtol0 * 2.0 ** level, 1e-3)
        a = min(atol0 * 1e2 ** level, 1e-15)
        rT, aT = 1e-2, 1e0
    rtol = np.full(neq, r)
    atol = np.full(neq, a)
    rtol[nS] = rT
    atol[nS] = aT
    # key heating/cooling species
    rtol[net.key_species_idx] = max(rtol0, 1e-4)
    atol[net.key_species_idx] = max(atol0, 1e-30)
    # grain charge states
    for name in ("Grain0", "Grain-", "Grain+"):
        i = net.idx.get(name, -1)
        if i >= 0:
            rtol[i] = 1e-4
            atol[i] = max(ratioDust2HnucNum * 1e-6, 1e-30)
    # grain-surface species
    if len(net.grain_species_idx):
        rtol[net.grain_species_idx] = max(rtol0, 1e-3)
        atol[net.grain_species_idx] = max(atol0, ratioDust2HnucNum * 1e-8)
    return (torch.as_tensor(rtol, dtype=F64, device=device),
            torch.as_tensor(atol, dtype=F64, device=device))
