"""Batched adaptive variable-order BDF integrator for stiff ODEs.

Counterpart of the pool path of the JAX package's ``ops/bdf.py``: a
variable-order (1..5) BDF in backward-difference form with the NDF
"kappa" terms (Shampine & Reichelt's formulation, as in
scipy.integrate.BDF), run over a window of B lanes at once.  It takes the
role of the DLSODES solver of the reference (src/opkdmain.f:1757, driven
by src/chemistry.f90:391-588).

Every per-lane branch of the JAX version (accept/reject, Newton failure,
order change) stays a masked, branch-free tensor update over the batch,
so each lane follows the same step control as in JAX.  The batch-global
decisions (refresh the Jacobian or the factorization, continue the Newton
loop, continue the round loop) are real Python branches on
``bool(tensor.any())``: each is one host synchronisation, where the JAX
version compiled them into ``lax.cond``/``while_loop``.

The Newton matrix is factored in f32 by the blocked no-pivot LU: the hand
kernels K1/K2 on a CUDA tensor (``ops/kernels.py``), their plain versions
(``ops/blocklu.py``) on a CPU tensor or when ``lu_backend="block"`` is
asked for.  One f64 iterative-refinement step per solve (``n_refine``)
recovers f64-level Newton corrections.

Ported here: the step helpers, the single-system solver (``_newton``,
``_step``, ``bdf_solve``: one cell on [NEQ] tensors with its own refresh
policy and the mixed-precision pivoted factorization of ``ops/linalg.py``),
the batch state, ``_bfac``/``_bsolve``, ``_batch_init``, the round body,
the record drivers (``bdf_solve_batch``, ``bdf_solve_batch_host``: every
lane paused at each output time until the slowest arrives), the per-lane
continuous-recording advance loop with its driver
(``bdf_solve_batch_cont``, with the tolerance ladder and the straggler
compaction), the tolerance-ladder rollback and the pool-refill driver.

Departures from the JAX package: the record driver has no first-interval
wall-clock exemption (it exists there for a freshly jitted record's
compile; torch compiles nothing), and the debug escape hatches
``RAC2D_BDF_NOFAIL`` and ``RAC2D_BDF_TRACE`` (for TPU backends without
host callbacks) are not ported.
"""

from __future__ import annotations

import math
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from . import blocklu, kernels
from .linalg import MPFactor, mp_factor, mp_solve
from ..utils.tree import tree_map

F64 = torch.float64
F32 = torch.float32

MAX_ORDER = 5
NEWTON_MAXITER = 4
MIN_FACTOR = 0.2
MAX_FACTOR = 10.0
# keep the Newton factorization while c = h/alpha(order) is within this
# relative distance of the factorized value (DVODE's gamma test)
DELTA_C_REFACTOR = 0.3
# batch path: looser (any lane's drift refactors the whole batch)
DELTA_C_BATCH = 0.6
# suppress step-size increases below this factor (VODE's eta hysteresis)
# so routine adaptations do not churn the factorization
H_GROW_MIN = 1.5
_EPS = float(np.finfo(np.float64).eps)

# NDF constants (order 0 slot unused), computed in f64 on the host
_KAPPA_NP = np.array([0.0, -0.1850, -1.0 / 9.0, -0.0823, -0.0415, 0.0])
_GAMMA_NP = np.concatenate(
    [np.zeros(1), np.cumsum(1.0 / np.arange(1, MAX_ORDER + 1))])
_ALPHA_NP = (1.0 - _KAPPA_NP) * _GAMMA_NP
# error constants kappa*gamma + 1/(k+1), padded so [order+1] is valid at
# order = MAX_ORDER
_ERR_CONST_NP = np.concatenate([
    _KAPPA_NP * _GAMMA_NP + 1.0 / (np.arange(MAX_ORDER + 1) + 1.0),
    [1.0 / (MAX_ORDER + 2.0)]])

_NROWS = MAX_ORDER + 3  # rows of the difference array D

_consts: dict = {}


def _c(device):
    """(GAMMA padded to _NROWS, ALPHA, ERR_CONST) on `device`."""
    key = str(device)
    if key not in _consts:
        def t(a):
            return torch.as_tensor(a, dtype=F64, device=device)
        _consts[key] = (
            t(np.concatenate([_GAMMA_NP, np.zeros(_NROWS - MAX_ORDER - 1)])),
            t(_ALPHA_NP), t(_ERR_CONST_NP))
    return _consts[key]


def _rms_norm(x):
    """Per-lane RMS over the last axis."""
    return torch.sqrt(torch.mean(x * x, dim=-1))


def _adapt_factors(norms, expo):
    """norms ** expo for the order-selection test: non-finite norms give
    factor 0 (never chosen) and zero norms the ideal-step sentinel."""
    finite_pos = torch.isfinite(norms) & (norms > 0.0)
    safe = torch.where(finite_pos, norms, 1.0)
    return torch.where(finite_pos, safe ** expo,
                       torch.where(norms > 0.0, 0.0, MAX_FACTOR * 2))


def _rej_factor(safety, error_norm, order):
    """Step-rejection shrink factor, safe against inf/NaN error norms."""
    en = torch.where(torch.isfinite(error_norm), error_norm, 1e16)
    return torch.clamp_min(safety * en ** (-1.0 / (order + 1.0)), MIN_FACTOR)


def _compute_R(order, factor):
    """Change-of-step-size matrices R[B, 6, 6] for the difference arrays.

    Rows/cols beyond each lane's order act as the identity so one
    fixed-shape matrix serves every lane's current order."""
    n = MAX_ORDER + 1
    dev = order.device
    i = torch.arange(n, dtype=F64, device=dev)[:, None]
    j = torch.arange(n, dtype=F64, device=dev)[None, :]
    o = order.to(F64)[:, None, None]
    f = torch.as_tensor(factor, dtype=F64, device=dev)
    f = f[:, None, None] if f.dim() else f
    i_safe = torch.clamp_min(i, 1.0)
    M = (i - 1.0 - f * j) / i_safe
    M = torch.where(i >= 1.0, M, 1.0)
    valid = (i <= o) & (j <= o) & (i >= 1)
    Mm = torch.where(valid | (i == 0), M, 1.0)
    Rc = torch.cumprod(Mm, dim=1)
    sel = (i <= o) & (j <= o)
    eye = torch.where(i == j, 1.0, 0.0).to(F64)
    return torch.where(sel, Rc, eye)


def _change_D(D, order, factor):
    """Rescale each lane's difference array D[B, _NROWS, NEQ] by its step
    factor."""
    R = _compute_R(order, factor)
    U = _compute_R(order, 1.0)
    RU = torch.matmul(R, U)
    head = torch.matmul(RU.transpose(1, 2), D[:, :MAX_ORDER + 1])
    return torch.cat([head, D[:, MAX_ORDER + 1:]], dim=1)


def _predict(D, order):
    row = torch.arange(_NROWS, device=D.device)[None, :, None]
    return torch.sum(torch.where(row <= order[:, None, None], D, 0.0), dim=1)


def _psi(D, order):
    gamma_pad, alpha, _ = _c(D.device)
    row = torch.arange(_NROWS, device=D.device)[None, :]
    g = torch.where((row >= 1) & (row <= order[:, None]), gamma_pad[row], 0.0)
    return (g[:, :, None] * D).sum(dim=1) / alpha[order][:, None]


def _update_D(D, order, d):
    """Difference-array update after an accepted step (all lanes)."""
    B = D.shape[0]
    ar = torch.arange(B, device=D.device)
    D = D.clone()
    D_old_qp1 = D[ar, order + 1]
    D[ar, order + 2] = d - D_old_qp1
    D[ar, order + 1] = d
    row = torch.arange(_NROWS, device=D.device)[None, :, None]
    W = torch.where(row <= (order + 1)[:, None, None], D, 0.0)
    S = torch.flip(torch.cumsum(torch.flip(W, [1]), dim=1), [1])
    return torch.where(row <= order[:, None, None], S, D)


def interpolate(D, order, t_cur, h, t):
    """Evaluate each lane's BDF interpolating polynomial at t <= t_cur."""
    m = torch.arange(MAX_ORDER + 1, dtype=F64, device=D.device)
    x = (t[:, None] - (t_cur[:, None] - m * h[:, None])) \
        / ((m + 1.0) * h[:, None])
    p = torch.cumprod(x, dim=1)
    jrow = torch.arange(1, MAX_ORDER + 2, device=D.device)
    w = torch.where(jrow <= order[:, None], p, 0.0)
    return D[:, 0] + (w[:, :, None] * D[:, 1:MAX_ORDER + 2]).sum(dim=1)


class BDFResult(NamedTuple):
    ts: torch.Tensor        # [B, n_out] times recorded
    ys: torch.Tensor        # [B, n_out, NEQ]
    t_final: torch.Tensor
    fail: torch.Tensor
    n_steps: torch.Tensor
    n_feval: torch.Tensor
    n_jeval: torch.Tensor
    n_lu: torch.Tensor
    # per-lane tolerance-relaxation level reached by the retry ladder
    # (0 = solved at the requested tolerances)
    retry_level: torch.Tensor | None = None
    # batched BDF rounds the pool driver ran, over all advance calls
    n_rounds: int | None = None


def log_output_times(t_start, t_end, ratio=1.1, n_max=None):
    """Log-spaced record times like the reference's ratio_tstep ladder
    (reference src/chemistry.f90:440-568)."""
    ts = []
    t = t_start
    while t < t_end and (n_max is None or len(ts) < n_max - 1):
        ts.append(t)
        t *= ratio
    ts.append(t_end)
    return np.array(ts)


# ==========================================================================
# Single-system solver
# ==========================================================================

class BDFState(NamedTuple):
    """One system's solver state: host scalars for the step control, the
    difference array, Jacobian and factorization on the system's device."""
    t: float
    h: float
    order: int
    D: torch.Tensor             # [_NROWS, NEQ]
    n_equal_steps: int
    J: torch.Tensor             # [NEQ, NEQ]
    fac: MPFactor | None        # mixed-precision factorization of I - c J
    c_lu: float                 # c value baked into the factorization
    need_lu: bool
    jac_fresh: bool
    fail: bool
    n_steps: int                # accepted steps
    n_feval: int
    n_jeval: int
    n_lu: int


def _one(fn, D, order, *a):
    """A batched difference-array helper on one system's D [_NROWS, NEQ]."""
    o = torch.tensor([order], device=D.device)
    return fn(D[None], o, *a)[0]


def _rms1(x):
    return float(_rms_norm(x))


def _newton(f, fac: MPFactor, c, psi, y_pred, scale, tol):
    """Damped simplified-Newton solve of the BDF algebraic system: d such
    that d = c * f(y_pred + d) - psi, with the frozen factorization of
    I - c J.  Returns (converged, iterations, y, d, f evaluations)."""
    y = y_pred
    d = torch.zeros_like(y_pred)
    dy_norm_old = 0.0
    converged = diverged = False
    k = 0
    while k < NEWTON_MAXITER and not converged and not diverged:
        rhs = c * f(y) - psi - d
        dy = mp_solve(fac, rhs)
        dy_norm = _rms1(dy / scale)
        with_old = dy_norm_old > 0.0
        rate = dy_norm / max(dy_norm_old, 1e-300) if with_old else 0.0
        bad = with_old and (
            rate >= 1.0
            or rate ** (NEWTON_MAXITER - k) / max(1.0 - rate, 1e-10)
            * dy_norm > tol)
        diverged = bad or not math.isfinite(dy_norm)
        if not diverged:
            y = y + dy
            d = d + dy
        converged = not diverged and (
            dy_norm == 0.0
            or (with_old and rate / max(1.0 - rate, 1e-10) * dy_norm < tol))
        dy_norm_old = dy_norm
        k += 1
    return converged, k, y, d, k


def _step(f, jac, state: BDFState, t_bound, rtol, atol, newton_tol):
    """Attempt steps until one is accepted (or the system fails), then
    update the difference array and adapt the order and step size."""
    _, alpha, err_const = _c(state.D.device)
    NEQ = state.D.shape[1]
    eye = torch.eye(NEQ, dtype=F64, device=state.D.device)
    order = state.order
    accepted = False
    error_norm, safety = math.inf, 0.9
    d = None
    while not accepted and not state.fail:
        # clamp the step to the integration bound (reference ITASK=4)
        h = state.h
        t_new = state.t + h
        D = state.D
        if t_new > t_bound:
            factor = (t_bound - state.t) / h
            D = _one(_change_D, D, order, factor)
            h = h * factor
            t_new = t_bound
        hmin = 10.0 * _EPS * max(abs(state.t), abs(t_new))
        too_small = h < hmin

        y_pred = _one(_predict, D, order)
        scale = atol + rtol * torch.abs(y_pred)
        psi = _one(_psi, D, order)
        c = h / float(_ALPHA_NP[order])

        fac, c_lu, n_lu = state.fac, state.c_lu, state.n_lu
        if state.need_lu or math.isnan(c_lu) \
                or abs(c / c_lu - 1.0) > DELTA_C_REFACTOR:
            fac = mp_factor(eye - c * state.J, col_scale=scale)
            c_lu, n_lu = c, n_lu + 1

        converged, n_iter, y_new, d, nfe = _newton(
            f, fac, c, psi, y_pred, scale, newton_tol)
        safety = 0.9 * (2.0 * NEWTON_MAXITER + 1.0) / (
            2.0 * NEWTON_MAXITER + n_iter)

        # Newton failed with a stale Jacobian: refresh it, retry at the
        # same h; with a fresh one: halve the step
        refresh_jac = not converged and not state.jac_fresh
        J = jac(y_pred) if refresh_jac else state.J
        halve = not converged and state.jac_fresh
        error_norm = _rms1(err_const[order] * d
                           / (atol + rtol * torch.abs(y_new))) \
            if converged else math.inf
        reject = converged and error_norm > 1.0
        accept = converged and not reject
        if halve or reject:
            factor = 0.5 if halve else float(_rej_factor(
                torch.tensor(safety, dtype=F64),
                torch.tensor(error_norm, dtype=F64), order))
            D = _one(_change_D, D, order, factor)
            h = h * factor
        state = BDFState(
            t=t_new if accept else state.t, h=h, order=order, D=D,
            n_equal_steps=0 if (halve or reject) else state.n_equal_steps,
            J=J, fac=fac, c_lu=c_lu, need_lu=refresh_jac,
            jac_fresh=refresh_jac or state.jac_fresh,
            fail=state.fail or (too_small and not accept)
            or not math.isfinite(h),
            n_steps=state.n_steps + accept, n_feval=state.n_feval + nfe,
            n_jeval=state.n_jeval + refresh_jac, n_lu=n_lu)
        accepted = accept

    if not accepted:
        return state
    # --- post-accept: difference update + order/step-size adaptation ---
    D = _one(_update_D, state.D, order, d[None])
    n_eq = state.n_equal_steps + 1
    h = state.h
    if n_eq >= order + 1:
        scale = atol + rtol * torch.abs(D[0])
        em = _rms1(err_const[order - 1] * D[order] / scale) \
            if order > 1 else math.inf
        ep = _rms1(err_const[order + 1] * D[order + 2] / scale) \
            if order < MAX_ORDER else math.inf
        factors = _adapt_factors(
            torch.tensor([em, error_norm, ep], dtype=F64),
            -1.0 / (order + torch.arange(3, dtype=F64)))
        best = int(torch.argmax(factors))
        order = min(max(order + best - 1, 1), MAX_ORDER)
        factor = max(min(MAX_FACTOR, safety * float(factors[best])),
                     MIN_FACTOR)
        D = _one(_change_D, D, order, factor)
        h = h * factor
        n_eq = 0
    return state._replace(D=D, order=order, h=h, n_equal_steps=n_eq,
                          jac_fresh=False)


def bdf_solve(f: Callable, jac: Callable, y0, t0, touts, rtol, atol,
              first_step, max_steps_per_interval: int = 2000,
              sanity_fn: Callable | None = None) -> BDFResult:
    """Integrate y' = f(y) from t0, recording at `touts` (one system).

    f(y[NEQ]) -> ydot[NEQ], jac(y) -> J[NEQ, NEQ] are autonomous; rtol and
    atol are [NEQ] tensors on y0's device; sanity_fn(y) -> bool marks an
    insane state (the system fails).  The loops run on the host.  A system
    that spends max_steps_per_interval steps without reaching a record
    time fails (reference "Premature finish", chemistry.f90:480-491).
    Returns a BDFResult without a batch axis: ts [n_out], ys [n_out, NEQ]
    on y0's device, the rest 0-d."""
    y0 = y0.to(F64)
    dev = y0.device
    touts = [float(t) for t in np.asarray(touts, dtype=np.float64)]
    D = torch.zeros(_NROWS, y0.shape[0], dtype=F64, device=dev)
    D[0] = y0
    D[1] = first_step * f(y0)
    state = BDFState(
        t=float(t0), h=float(first_step), order=1, D=D, n_equal_steps=0,
        J=jac(y0), fac=None, c_lu=math.nan, need_lu=True, jac_fresh=True,
        fail=False, n_steps=0, n_feval=1, n_jeval=1, n_lu=0)
    newton_tol = _newton_tol_of(rtol)
    t_bound = touts[-1]
    ts, ys = [], []
    for tout in touts:
        n = 0
        while state.t < tout and not state.fail \
                and n < max_steps_per_interval:
            state = _step(f, jac, state, t_bound, rtol, atol, newton_tol)
            if sanity_fn is not None and sanity_fn(state.D[0]):
                state = state._replace(fail=True)
            n += 1
        if state.t < tout:
            state = state._replace(fail=True)
        t_rec = min(tout, state.t)
        ts.append(t_rec)
        o = torch.tensor([state.order], device=dev)
        ys.append(interpolate(state.D[None], o,
                              torch.tensor([state.t], dtype=F64, device=dev),
                              torch.tensor([state.h], dtype=F64, device=dev),
                              torch.tensor([t_rec], dtype=F64,
                                           device=dev))[0])

    def t(v, dtype=None):
        return torch.tensor(v, dtype=dtype, device=dev)

    return BDFResult(ts=t(ts, F64), ys=torch.stack(ys),
                     t_final=t(state.t, F64),
                     fail=t(state.fail), n_steps=t(state.n_steps),
                     n_feval=t(state.n_feval), n_jeval=t(state.n_jeval),
                     n_lu=t(state.n_lu))


# ==========================================================================
# Batch-native solver
# ==========================================================================

class BDFBatchState(NamedTuple):
    t: torch.Tensor          # [B]
    h: torch.Tensor          # [B]
    order: torch.Tensor      # [B] int64
    D: torch.Tensor          # [B, _NROWS, NEQ]
    n_equal: torch.Tensor    # [B] int64
    fail: torch.Tensor       # [B] bool
    n_steps: torch.Tensor    # [B]
    n_feval: torch.Tensor    # [B]
    n_jeval: torch.Tensor    # [B]
    n_lu: torch.Tensor       # [B]
    # cached Newton linearization (refreshed on a batch-global branch);
    # None until the first refresh
    J: torch.Tensor | None   # [B, NEQ, NEQ] f64 Jacobian at last refresh
    fac: tuple | None        # (row scales, col scales, BlockLU) from _bfac
    c_lu: torch.Tensor       # [B] c baked into fac (nan: none yet)
    jfresh: torch.Tensor     # [B] bool: J evaluated at this lane's current
    #                          base state (no accepted step since)
    need_j: torch.Tensor     # [B] bool: lane's Newton failed on stale J


def _bfac(J, c, col_scale, lu_backend="kernel"):
    """Batched row/col-equilibrated f32 factorization of I - c J.

    The equilibration is f64 torch; the factorization is kernel K1 (or
    its plain version for lu_backend="block" or CPU tensors)."""
    B, NEQ, _ = J.shape
    eye = torch.eye(NEQ, dtype=J.dtype, device=J.device)
    A = eye[None] - c[:, None, None] * J
    Ac = A * col_scale[:, None, :]
    amax = torch.amax(torch.abs(Ac), dim=2)
    rs = torch.where(amax > 0.0, 1.0 / amax, 1.0)
    As = (Ac * rs[:, :, None]).to(F32)
    if lu_backend == "block":
        return rs, col_scale, blocklu.block_lu(As)
    if lu_backend != "kernel":
        raise ValueError(f"unknown lu_backend {lu_backend!r}")
    return rs, col_scale, kernels.block_lu_factor(As)


def _bsolve(J, c_lu, fac, b, n_refine=1, lu_backend="kernel"):
    """Batched mixed-precision solve of (I - c_lu J) x = b: f32 solves
    through the factorization (kernel K2, or its plain version) with
    n_refine steps of iterative refinement against the f64 residual."""
    rs, cs, fac32 = fac
    raw_solve = blocklu.block_lu_solve if lu_backend == "block" \
        else kernels.block_lu_solve

    def f32_solve(r):
        rsb = (r * rs).to(F32)
        return raw_solve(fac32, rsb).to(F64) * cs

    def matvec(x):
        return x - c_lu[:, None] * torch.einsum("bij,bj->bi", J, x)

    x = f32_solve(b)
    for _ in range(n_refine):
        x = x + f32_solve(b - matvec(x))
    return x


def _batch_init(f_b, y0, t0, first_step, args) -> BDFBatchState:
    B, NEQ = y0.shape
    dev = y0.device
    f0 = f_b(y0, args)
    D = torch.zeros(B, _NROWS, NEQ, dtype=F64, device=dev)
    D[:, 0] = y0
    D[:, 1] = first_step * f0
    z = torch.zeros(B, dtype=torch.int64, device=dev)
    return BDFBatchState(
        t=torch.full((B,), float(t0), dtype=F64, device=dev),
        h=torch.full((B,), float(first_step), dtype=F64, device=dev),
        order=torch.ones(B, dtype=torch.int64, device=dev), D=D,
        n_equal=z, fail=torch.zeros(B, dtype=torch.bool, device=dev),
        n_steps=z, n_feval=torch.ones_like(z), n_jeval=z, n_lu=z,
        # no factorization yet: c_lu = nan and need_j force a refresh in
        # the first round in which a lane is active
        J=None, fac=None,
        c_lu=torch.full((B,), float("nan"), dtype=F64, device=dev),
        jfresh=torch.zeros(B, dtype=torch.bool, device=dev),
        need_j=torch.ones(B, dtype=torch.bool, device=dev))


def _newton_tol_of(rtol):
    rtol_min = float(torch.min(rtol))
    return max(10 * _EPS / max(rtol_min, 1e-15), min(0.03, math.sqrt(rtol_min)))


def _make_round_body(f_b: Callable, jac_b: Callable,
                     sanity_b: Callable | None, n_refine: int,
                     lu_backend: str = "kernel"):
    """One batched BDF round (predict -> refresh? -> Newton -> error test
    -> adapt) as round_body(state, tout, t_bound, rtol, atol, newton_tol,
    args)."""

    def round_body(state: BDFBatchState, tout, t_bound, rtol, atol,
                   newton_tol, args):
        B = state.t.shape[0]
        _, alpha, err_const = _c(state.t.device)
        order = state.order
        active = (state.t < tout) & ~state.fail

        h = state.h
        t_new_raw = state.t + h
        over = active & (t_new_raw > t_bound)
        factor_clamp = torch.where(over, (t_bound - state.t)
                                   / torch.clamp_min(h, 1e-300), 1.0)
        D = _change_D(state.D, order, factor_clamp)
        h = h * factor_clamp
        t_new = torch.where(over, t_bound, t_new_raw)
        hmin = 10.0 * _EPS * torch.maximum(torch.abs(state.t),
                                           torch.abs(t_new))
        too_small = h < hmin

        y_pred = _predict(D, order)
        scale = atol + rtol * torch.abs(y_pred)
        psi = _psi(D, order)
        c = h / alpha[order]

        # --- conditional refresh (batch-global branch): Jacobian when an
        # active lane's Newton failed on a stale J; factorization also when
        # an active lane's c drifted beyond DELTA_C_BATCH from c_lu ---
        drift = torch.abs(c / state.c_lu - 1.0) > DELTA_C_BATCH
        drift = drift | ~torch.isfinite(state.c_lu)
        refresh_j = bool(torch.any(active & state.need_j))
        refresh_lu = refresh_j or bool(torch.any(active & drift))
        if refresh_j:
            J = jac_b(y_pred, args)
            jfresh = torch.ones(B, dtype=torch.bool, device=D.device)
        else:
            J, jfresh = state.J, state.jfresh
        if refresh_lu:
            fac = _bfac(J, c, scale, lu_backend)
            c_lu = c
        else:
            fac, c_lu = state.fac, state.c_lu
        n_jeval = state.n_jeval + (active & refresh_j)
        n_lu = state.n_lu + (active & refresh_lu)

        # --- Newton over masked lanes; the rhs uses the current c, the
        # solve matrix is the cached (I - c_lu J): simplified Newton ---
        y = y_pred
        d = torch.zeros_like(y_pred)
        dy_norm_old = torch.zeros(B, dtype=F64, device=D.device)
        converged = torch.zeros(B, dtype=torch.bool, device=D.device)
        diverged = torch.zeros_like(converged)
        nfe = state.n_feval
        it = 0
        while it < NEWTON_MAXITER:
            going = active & ~converged & ~diverged
            if not bool(torch.any(going)):
                break
            fy = f_b(y, args)
            nfe = nfe + going
            rhs = c[:, None] * fy - psi - d
            dy = _bsolve(J, c_lu, fac, rhs, n_refine, lu_backend)
            dy_norm = _rms_norm(dy / scale)
            with_old = dy_norm_old > 0.0
            rate = torch.where(
                with_old, dy_norm / torch.clamp_min(dy_norm_old, 1e-300), 0.0)
            bad = with_old & (
                (rate >= 1.0)
                | (rate ** (NEWTON_MAXITER - it)
                   / torch.clamp_min(1.0 - rate, 1e-10) * dy_norm
                   > newton_tol))
            bad = bad | ~torch.isfinite(dy_norm)
            step_ok = going & ~bad
            y = torch.where(step_ok[:, None], y + dy, y)
            d = torch.where(step_ok[:, None], d + dy, d)
            conv_now = step_ok & (
                (dy_norm == 0.0)
                | (with_old & (rate / torch.clamp_min(1.0 - rate, 1e-10)
                               * dy_norm < newton_tol)))
            converged = converged | conv_now
            diverged = diverged | (going & bad)
            dy_norm_old = torch.where(going, dy_norm, dy_norm_old)
            it += 1
        safety = torch.full((B,), 0.9 * (2.0 * NEWTON_MAXITER + 1.0)
                            / (2.0 * NEWTON_MAXITER + NEWTON_MAXITER),
                            dtype=F64, device=D.device)

        # --- outcome: Newton failure on a fresh Jacobian halves the step;
        # on a stale one the lane flags need_j and retries at the same h
        # after the next round's batch-global refresh ---
        halve = active & ~converged & jfresh
        need_j_new = active & ~converged & ~jfresh
        scale_new = atol + rtol * torch.abs(y)
        err = _rms_norm(err_const[order][:, None] * d / scale_new)
        error_norm = torch.where(converged, err, float("inf"))
        reject = active & converged & (error_norm > 1.0)
        factor_rej = _rej_factor(safety, error_norm, order)
        accept = active & converged & ~reject

        factor = torch.where(halve, 0.5, torch.where(reject, factor_rej, 1.0))
        do_rescale = halve | reject
        D = _change_D(D, order, torch.where(do_rescale, factor, 1.0))
        h_next = torch.where(do_rescale, h * factor, h)
        fail = state.fail | (active & too_small & ~accept) \
            | ~torch.isfinite(h_next)
        if sanity_b is not None:
            fail = fail | (accept & sanity_b(y))

        # --- post-accept: difference update + order/step adaptation ---
        D_acc = _update_D(D, order, d)
        D = torch.where(accept[:, None, None], D_acc, D)
        n_eq = torch.where(accept, state.n_equal + 1,
                           torch.where(do_rescale, 0, state.n_equal))

        adapt = accept & (n_eq >= order + 1)
        ar = torch.arange(B, device=D.device)
        scale_a = atol + rtol * torch.abs(D[:, 0])
        em = _rms_norm(err_const[order - 1][:, None] * D[ar, order]
                       / scale_a)
        ep = _rms_norm(err_const[order + 1][:, None] * D[ar, order + 2]
                       / scale_a)
        em = torch.where(order > 1, em, float("inf"))
        ep = torch.where(order < MAX_ORDER, ep, float("inf"))
        norms = torch.stack([em, error_norm, ep], dim=1)      # [B, 3]
        expo = -1.0 / (order[:, None]
                       + torch.arange(3, dtype=F64, device=D.device)[None, :])
        factors = _adapt_factors(norms, expo)
        best = torch.argmax(factors, dim=1)
        new_order = torch.clamp(order + best - 1, 1, MAX_ORDER)
        fac_adapt = torch.clamp(
            safety * torch.gather(factors, 1, best[:, None])[:, 0],
            MIN_FACTOR, MAX_FACTOR)
        # a non-finite rescale factor must never reach the difference array
        fac_adapt = torch.where(torch.isfinite(fac_adapt), fac_adapt, 1.0)
        order2 = torch.where(adapt, new_order, order)
        # hysteresis: shrinks always, growth only when it clears H_GROW_MIN
        fac_eff = torch.where(adapt & ((fac_adapt < 1.0)
                                       | (fac_adapt >= H_GROW_MIN)),
                              fac_adapt, 1.0)
        D = _change_D(D, order2, fac_eff)
        h_next = h_next * fac_eff
        n_eq = torch.where(adapt, 0, n_eq)

        return BDFBatchState(
            t=torch.where(accept, t_new, state.t), h=h_next, order=order2,
            D=D, n_equal=n_eq, fail=fail,
            n_steps=state.n_steps + accept, n_feval=nfe, n_jeval=n_jeval,
            n_lu=n_lu, J=J, fac=fac, c_lu=c_lu,
            jfresh=jfresh & ~accept, need_j=need_j_new)

    return round_body


def make_record(f_b: Callable, jac_b: Callable,
                max_steps_per_interval: int = 2000,
                sanity_b: Callable | None = None, n_refine: int = 1,
                lu_backend: str = "kernel"):
    """record(state, tout, t_bound, rtol, atol, args) -> (state, (t_rec,
    y_rec)): BDF rounds until every lane is at tout, has failed, or the
    interval's round budget max_steps_per_interval is spent; a lane short
    of tout then fails.  Each lane's record is its dense output at
    min(tout, t).  The record drivers call it once per output time, so
    every lane waits at each tout for the slowest (JAX
    ``_make_batch_record``; ``record.rounds`` counts the rounds run)."""
    round_body = _make_round_body(f_b, jac_b, sanity_b, n_refine,
                                  lu_backend)

    def record(state, tout, t_bound, rtol, atol, args):
        newton_tol = _newton_tol_of(rtol)
        k = 0
        while k < max_steps_per_interval \
                and bool(torch.any((state.t < tout) & ~state.fail)):
            state = round_body(state, tout, t_bound, rtol, atol, newton_tol,
                               args)
            k += 1
        record.rounds += k
        state = state._replace(fail=state.fail | (state.t < tout))
        t_rec = torch.clamp_max(state.t, tout)
        return state, (t_rec, interpolate(state.D, state.order, state.t,
                                          state.h, t_rec))

    record.rounds = 0
    return record


# the JAX package's name for it (one compile per batch shape there)
make_record_jit = make_record


def bdf_solve_batch_host(f_b: Callable, jac_b: Callable, y0, t0, touts,
                         rtol, atol, first_step,
                         max_steps_per_interval: int = 2000,
                         sanity_b: Callable | None = None,
                         n_refine: int = 1, max_wall_s: float | None = None,
                         progress_cb: Callable | None = None,
                         args=None, record_fn=None,
                         lu_backend: str = "kernel") -> BDFResult:
    """Batched BDF integration with a barrier at every output time: one
    record call per tout (make_record), driven from the host.  y0, rtol,
    atol: [B, NEQ]; f_b(y, args) / jac_b(y, args) as for the pool.

    With max_wall_s, the reference's wall-clock guard (max_runtime_allowed,
    src/chemistry.f90:480-491): once the run has taken longer, or one
    interval more than max(10 x the previous one, 0.5 x max_wall_s), the
    remaining intervals are not integrated and the lanes short of
    touts[-1] fail ("Premature finish"); their later records repeat the
    last one.  The budget counts from the first call (the JAX package
    exempts a freshly jitted record's first interval, for its compile).
    Returns ts [B, n_out], ys [B, n_out, NEQ] on y0's device, and
    n_rounds, the BDF rounds run."""
    y0 = y0.to(F64)
    touts = [float(t) for t in np.asarray(touts, dtype=np.float64)]
    t_bound = touts[-1]
    state = _batch_init(f_b, y0, t0, first_step, args)
    record = record_fn if record_fn is not None else make_record(
        f_b, jac_b, max_steps_per_interval, sanity_b, n_refine, lu_backend)
    rounds0 = record.rounds
    t_start = time.time()
    t_prev = None
    ts_l, ys_l = [], []
    aborted = False
    for i, tout in enumerate(touts):
        if aborted:
            ts_l.append(torch.clamp_max(state.t, tout))
            ys_l.append(ys_l[-1])
            continue
        t_iv0 = time.time()
        state, (t_rec, y_rec) = record(state, tout, t_bound, rtol, atol,
                                       args)
        if max_wall_s is not None:
            # the record loop's conditions read the device every round,
            # so the clock below measures its compute
            now = time.time()
            dt_iv = now - t_iv0
            if now - t_start > max_wall_s:
                aborted = True
            elif t_prev is not None \
                    and dt_iv > max(10.0 * t_prev, 0.5 * max_wall_s):
                # single-interval blow-up guard (chemistry.f90:482-487)
                aborted = True
            t_prev = dt_iv
        ts_l.append(t_rec)
        ys_l.append(y_rec)
        if progress_cb is not None:
            progress_cb(i, state)
    if aborted:
        state = state._replace(fail=state.fail | (state.t < t_bound))
    return BDFResult(ts=torch.stack(ts_l, dim=1), ys=torch.stack(ys_l, dim=1),
                     t_final=state.t, fail=state.fail,
                     n_steps=state.n_steps, n_feval=state.n_feval,
                     n_jeval=state.n_jeval, n_lu=state.n_lu,
                     n_rounds=record.rounds - rounds0)


def bdf_solve_batch(f_b: Callable, jac_b: Callable, y0, t0, touts, rtol,
                    atol, first_step, max_steps_per_interval: int = 2000,
                    sanity_b: Callable | None = None, n_refine: int = 1,
                    args=None, lu_backend: str = "kernel") -> BDFResult:
    """Batched BDF integration recording at `touts`: the JAX package's
    scan over record intervals becomes the host loop of
    bdf_solve_batch_host, without a wall guard (the two give the same
    numbers)."""
    return bdf_solve_batch_host(
        f_b, jac_b, y0, t0, touts, rtol, atol, first_step,
        max_steps_per_interval, sanity_b, n_refine, args=args,
        lu_backend=lu_backend)


class ContState(NamedTuple):
    """Carry of the continuous-recording batch driver."""
    st: BDFBatchState
    irec: torch.Tensor    # [B] index of each lane's NEXT tout
    since: torch.Tensor   # [B] rounds since the lane last recorded
    ts: torch.Tensor      # [B, n_out] recorded times
    ys: torch.Tensor      # [B, n_out, NEQ] recorded states


def make_advance(f_b: Callable, jac_b: Callable,
                 max_steps_per_interval: int = 2000,
                 sanity_b: Callable | None = None, n_refine: int = 1,
                 lu_backend: str = "kernel"):
    """advance(cst, touts, t_bound, rtol, atol, args, max_rounds) ->
    ContState: up to max_rounds BDF rounds in which every lane steps
    toward t_bound and records its own touts by dense output when it
    crosses them (per-lane continuous recording; the only barrier is the
    end of the integration).  A lane fails when it spends more than
    max_steps_per_interval rounds without reaching its next tout.

    The loop is driven from the host; each round costs a few host
    synchronisations (the loop conditions below and in the round body).
    Records are written into cst.ys/cst.ts in place.
    """
    round_body = _make_round_body(f_b, jac_b, sanity_b, n_refine,
                                  lu_backend)

    def advance(cst: ContState, touts, t_bound, rtol, atol, args,
                max_rounds):
        n_out = touts.shape[0]
        newton_tol = _newton_tol_of(rtol)
        st, irec, since, ts, ys = cst
        ar = torch.arange(st.t.shape[0], device=st.t.device)
        k = 0
        while k < max_rounds and bool(torch.any(~st.fail & (irec < n_out))):
            was_active = (st.t < t_bound) & ~st.fail
            st = round_body(st, t_bound, t_bound, rtol, atol, newton_tol,
                            args)
            since = since + was_active
            while True:
                ir = torch.clamp(irec, 0, n_out - 1)
                tnext = touts[ir]
                m = (irec < n_out) & (st.t >= tnext) & ~st.fail
                if not bool(torch.any(m)):
                    break
                yi = interpolate(st.D, st.order, st.t, st.h, tnext)
                ys[ar, ir] = torch.where(m[:, None], yi, ys[ar, ir])
                ts[ar, ir] = torch.where(m, tnext, ts[ar, ir])
                irec = irec + m
                since = torch.where(m, 0, since)
            # runaway guard (also catches lanes stalled at t_bound with
            # records outstanding)
            st = st._replace(fail=st.fail | ((irec < n_out)
                                             & (since > max_steps_per_interval)))
            k += 1
        advance.rounds += k
        return ContState(st, irec, since, ts, ys)

    advance.rounds = 0        # rounds run over all calls
    return advance


def _ladder_rollback(cst: ContState, mask, touts, y0_cur, t0, first_step):
    """Roll the masked (failed) lanes back to their LAST RECORDED state
    and reset their solver state for a relaxed-tolerance retry: order 1,
    cleared difference history, small h, forced Jacobian refresh (the
    per-lane analogue of the reference's tolerance-ladder restart,
    src/chemistry.f90:272-387)."""
    st = cst.st
    B = st.t.shape[0]
    dev = st.t.device
    n_out = touts.shape[0]
    m = torch.as_tensor(mask, device=dev)
    prev = cst.irec - 1
    has_prev = prev >= 0
    prev_c = torch.clamp(prev, 0, n_out - 1)
    t_back = torch.where(has_prev, touts[prev_c],
                         torch.full((B,), float(t0), dtype=F64, device=dev))
    y_back = torch.where(has_prev[:, None],
                         cst.ys[torch.arange(B, device=dev), prev_c], y0_cur)
    h_back = torch.clamp_min(1e-8 * torch.abs(t_back), float(first_step))
    D_back = torch.zeros_like(st.D)
    D_back[:, 0, :] = y_back
    st2 = st._replace(
        t=torch.where(m, t_back, st.t), h=torch.where(m, h_back, st.h),
        order=torch.where(m, 1, st.order),
        D=torch.where(m[:, None, None], D_back, st.D),
        n_equal=torch.where(m, 0, st.n_equal),
        fail=st.fail & ~m,
        jfresh=st.jfresh & ~m,
        need_j=st.need_j | m)
    return cst._replace(st=st2, since=torch.where(m, 0, cst.since))


def _set_rows(x, idx, v):
    """Copy of x with x[idx] = v."""
    x = x.clone()
    x[idx] = v
    return x


def _gather_cont(cst: ContState, rtol, atol, args, y0, idx):
    """Lanes `idx` of every leading-batch tensor (state, tolerance rows,
    problem args) for the straggler-compaction ladder."""
    def g(a):
        return a[idx]
    return (tree_map(g, cst), rtol[idx], atol[idx], tree_map(g, args),
            y0[idx])


def bdf_solve_batch_cont(f_b: Callable, jac_b: Callable, y0, t0, touts,
                         rtol, atol, first_step,
                         max_steps_per_interval: int = 2000,
                         sanity_b: Callable | None = None,
                         n_refine: int = 1,
                         max_wall_s: float | None = None,
                         progress_cb: Callable | None = None,
                         args=None, rounds_per_call: int = 256,
                         retry_tols=None, compact_min: int = 0,
                         lu_backend: str = "kernel") -> BDFResult:
    """Continuous-recording batch solve (make_advance): advance calls of
    rounds_per_call BDF rounds, no barrier at the output times; the same
    result shapes as bdf_solve_batch_host, on the CPU.

    retry_tols: (rtol_row, atol_row) [NEQ] tensors, the per-lane
    tolerance ladder: a failed lane rolls back to its last record at the
    next level, and fails only once the ladder is exhausted.

    compact_min: if > 0, after a call the live lanes are gathered into a
    window of half the width while they fit (never below compact_min; the
    last slots repeat the first live lane and count for nothing), so that
    the stragglers' rounds cost their live width.  It decides which lanes
    share a window, and so their Newton refreshes.

    With max_wall_s, once the calls after the first have taken longer,
    the lanes short of touts[-1] fail (as in the pool driver, the first
    call is not counted).  Unrecorded entries of a failed lane repeat its
    last record (y0 if none) at min(t_final, tout)."""
    dev = y0.device
    y0 = y0.to(F64)
    touts = torch.as_tensor(touts, dtype=F64, device=dev)
    n_out = touts.shape[0]
    t_bound = float(touts[-1])
    B, NEQ = y0.shape
    cst = ContState(
        st=_batch_init(f_b, y0, t0, first_step, args),
        irec=torch.zeros(B, dtype=torch.int64, device=dev),
        since=torch.zeros(B, dtype=torch.int64, device=dev),
        ts=torch.zeros(B, n_out, dtype=F64, device=dev),
        ys=torch.zeros(B, n_out, NEQ, dtype=F64, device=dev))
    advance = make_advance(f_b, jac_b, max_steps_per_interval, sanity_b,
                           n_refine, lu_backend)
    # the current positions' original lanes (the identity until the first
    # compaction), which of them are real, and their ladder levels
    orig = np.arange(B)
    real = np.ones(B, bool)
    level = np.zeros(B, np.int32)
    n_levels = len(retry_tols) if retry_tols else 0
    rtol_cur, atol_cur, args_cur, y0_cur = rtol, atol, args, y0
    res = dict(ts=np.zeros((B, n_out)), ys=np.zeros((B, n_out, NEQ)),
               t_final=np.zeros(B), fail=np.ones(B, bool),
               n_steps=np.zeros(B, np.int64), n_feval=np.zeros(B, np.int64),
               n_jeval=np.zeros(B, np.int64), n_lu=np.zeros(B, np.int64),
               irec=np.zeros(B, np.int64), level=np.zeros(B, np.int32))

    def flush(cst, lvl):
        """Write the real positions' results into the full buffers."""
        w = orig[real]
        st = cst.st
        for name, v in (("ts", cst.ts), ("ys", cst.ys), ("t_final", st.t),
                        ("fail", st.fail), ("n_steps", st.n_steps),
                        ("n_feval", st.n_feval), ("n_jeval", st.n_jeval),
                        ("n_lu", st.n_lu), ("irec", cst.irec)):
            res[name][w] = v.cpu().numpy()[real]
        res["level"][w] = lvl[real]

    t_start = None
    k = 0
    while True:
        cst = advance(cst, touts, t_bound, rtol_cur, atol_cur, args_cur,
                      rounds_per_call)
        irec = cst.irec.cpu().numpy()
        fail = cst.st.fail.cpu().numpy()
        now = time.time()
        if t_start is None:
            t_start = now
        if progress_cb is not None:
            progress_cb(k, cst.st)
        k += 1
        wall_hit = max_wall_s is not None and now - t_start > max_wall_s
        retryable = fail & (level < n_levels) & real
        if retryable.any() and not wall_hit:
            level[retryable] += 1
            for lv in np.unique(level[retryable]):
                rows = torch.as_tensor(
                    np.nonzero(retryable & (level == lv))[0], device=dev)
                r_row, a_row = retry_tols[lv - 1]
                rtol_cur = _set_rows(rtol_cur, rows, r_row)
                atol_cur = _set_rows(atol_cur, rows, a_row)
            cst = _ladder_rollback(cst, retryable, touts, y0_cur, t0,
                                   first_step)
            fail = cst.st.fail.cpu().numpy()
        done = (irec >= n_out) | fail
        if bool(done.all()) or wall_hit:
            if wall_hit:
                st = cst.st
                cst = cst._replace(st=st._replace(
                    fail=st.fail | (cst.irec < n_out)))
            break
        # straggler compaction (pow2 halving)
        W = len(orig)
        if compact_min and W > compact_min:
            live = ~done & real
            n_live = int(live.sum())
            W_new = W
            while W_new // 2 >= max(compact_min, n_live, 1):
                W_new //= 2
            if W_new < W:
                flush(cst, level)
                sel = np.nonzero(live)[0]
                sel_p = np.concatenate(
                    [sel, np.full(W_new - len(sel), sel[0])])
                cst, rtol_cur, atol_cur, args_cur, y0_cur = _gather_cont(
                    cst, rtol_cur, atol_cur, args_cur, y0_cur,
                    torch.as_tensor(sel_p, device=dev))
                orig = orig[sel_p]
                real = np.concatenate([real[sel],
                                       np.zeros(W_new - len(sel), bool)])
                level = level[sel_p]
    flush(cst, level)
    # unrecorded entries of failed or aborted lanes: their last record
    irec = res["irec"]
    open_m = np.arange(n_out)[None, :] >= irec[:, None]       # [B, n_out]
    last = np.clip(irec - 1, 0, n_out - 1)
    y_last = np.where((irec > 0)[:, None], res["ys"][np.arange(B), last],
                      y0.cpu().numpy())
    ys = np.where(open_m[:, :, None], y_last[:, None, :], res["ys"])
    ts = np.where(open_m, np.minimum(res["t_final"][:, None],
                                     touts.cpu().numpy()[None, :]),
                  res["ts"])
    t = torch.as_tensor
    return BDFResult(
        ts=t(ts), ys=t(ys), t_final=t(res["t_final"]),
        fail=t(res["fail"] | (irec < n_out)), n_steps=t(res["n_steps"]),
        n_feval=t(res["n_feval"]), n_jeval=t(res["n_jeval"]),
        n_lu=t(res["n_lu"]), retry_level=t(res["level"]),
        n_rounds=advance.rounds)


def bdf_solve_batch_pool(f_b: Callable, jac_b: Callable, y0_pool, t0,
                         touts, rtol_pool, atol_pool, first_step,
                         width: int,
                         max_steps_per_interval: int = 2000,
                         sanity_b: Callable | None = None,
                         n_refine: int = 1,
                         max_wall_s: float | None = None,
                         progress_cb: Callable | None = None,
                         args_pool=None, rounds_per_call: int = 256,
                         retry_tols=None,
                         lu_backend: str = "kernel") -> BDFResult:
    """Pool-refill batch solve: integrate N >> width lanes through a
    constant-width window.  After each advance call of rounds_per_call
    rounds, finished lanes retire (final state flushed to host buffers)
    and their slots are refilled with the next pool entries.  The
    per-lane tolerance ladder (retry_tols: list of (rtol_row, atol_row)
    [NEQ] tensors) rolls a failed lane back to its last record at the
    next level; it counts as failed only once the ladder is exhausted.

    f_b(y, args) -> [B, NEQ] and jac_b(y, args) -> [B, NEQ, NEQ] take the
    window's problem data `args` (any tuple/NamedTuple tree of tensors
    with a leading lane axis, sliced from args_pool).

    Returns a BDFResult over the full pool on the CPU, with ts/ys holding
    only each lane's final record ([N, 1], [N, 1, NEQ]).
    """
    dev = y0_pool.device
    y0_pool = y0_pool.to(F64)
    N, NEQ = y0_pool.shape
    W = min(width, N)
    touts = torch.as_tensor(touts, dtype=F64, device=dev)
    n_out = touts.shape[0]
    t_bound = float(touts[-1])
    n_levels = len(retry_tols) if retry_tols else 0

    take = torch.arange(W, device=dev)
    args_cur = tree_map(lambda a: a[take], args_pool)
    rtol_cur = rtol_pool[take]
    atol_cur = atol_pool[take]
    y0_cur = y0_pool[take]
    cst = ContState(
        st=_batch_init(f_b, y0_cur, t0, first_step, args_cur),
        irec=torch.zeros(W, dtype=torch.int64, device=dev),
        since=torch.zeros(W, dtype=torch.int64, device=dev),
        ts=torch.zeros(W, n_out, dtype=F64, device=dev),
        ys=torch.zeros(W, n_out, NEQ, dtype=F64, device=dev))
    orig = np.arange(W)
    level = np.zeros(W, np.int32)
    next_i = W

    res = dict(ts=np.zeros(N), ys=np.zeros((N, NEQ)),
               t_final=np.zeros(N), fail=np.ones(N, bool),
               n_steps=np.zeros(N, np.int64), n_feval=np.zeros(N, np.int64),
               n_jeval=np.zeros(N, np.int64), n_lu=np.zeros(N, np.int64),
               level=np.zeros(N, np.int32))

    advance = make_advance(f_b, jac_b, max_steps_per_interval, sanity_b,
                           n_refine, lu_backend)

    def flush(slots):
        """Write finished window slots' final states to the pool buffers."""
        if not len(slots):
            return
        w = orig[slots]
        st = cst.st
        irec_np = cst.irec.cpu().numpy()
        last = np.clip(irec_np[slots] - 1, 0, n_out - 1)
        sl = torch.as_tensor(slots, device=dev)
        la = torch.as_tensor(last, device=dev)
        res["ys"][w] = cst.ys[sl, la].cpu().numpy()
        res["ts"][w] = cst.ts[sl, la].cpu().numpy()
        res["t_final"][w] = st.t.cpu().numpy()[slots]
        res["fail"][w] = st.fail.cpu().numpy()[slots] \
            | (irec_np[slots] < n_out)
        res["n_steps"][w] = st.n_steps.cpu().numpy()[slots]
        res["n_feval"][w] = st.n_feval.cpu().numpy()[slots]
        res["n_jeval"][w] = st.n_jeval.cpu().numpy()[slots]
        res["n_lu"][w] = st.n_lu.cpu().numpy()[slots]
        res["level"][w] = level[slots]

    def refill(slots, pool_idx):
        """Reset window slots to fresh pool lanes (the same fields the JAX
        driver resets; the cached J / factorization / c_lu stay, and
        need_j forces their refresh)."""
        nonlocal cst, args_cur, rtol_cur, atol_cur, y0_cur
        sl = torch.as_tensor(slots, device=dev)
        pi = torch.as_tensor(pool_idx, device=dev)
        st = cst.st
        y_new = y0_pool[pi]
        D = _set_rows(st.D, sl, 0.0)
        D[sl, 0, :] = y_new
        st2 = st._replace(
            t=_set_rows(st.t, sl, float(t0)),
            h=_set_rows(st.h, sl, float(first_step)),
            order=_set_rows(st.order, sl, 1),
            D=D,
            n_equal=_set_rows(st.n_equal, sl, 0),
            fail=_set_rows(st.fail, sl, False),
            n_steps=_set_rows(st.n_steps, sl, 0),
            n_feval=_set_rows(st.n_feval, sl, 1),
            n_jeval=_set_rows(st.n_jeval, sl, 0),
            n_lu=_set_rows(st.n_lu, sl, 0),
            jfresh=_set_rows(st.jfresh, sl, False),
            need_j=_set_rows(st.need_j, sl, True))
        cst = cst._replace(
            st=st2,
            irec=_set_rows(cst.irec, sl, 0),
            since=_set_rows(cst.since, sl, 0),
            ts=_set_rows(cst.ts, sl, 0.0),
            ys=_set_rows(cst.ys, sl, 0.0))
        args_cur = tree_map(lambda cur, pool: _set_rows(cur, sl, pool[pi]),
                            args_cur, args_pool)
        rtol_cur = _set_rows(rtol_cur, sl, rtol_pool[pi])
        atol_cur = _set_rows(atol_cur, sl, atol_pool[pi])
        y0_cur = _set_rows(y0_cur, sl, y_new)

    t_start = None
    k = 0
    while True:
        cst = advance(cst, touts, t_bound, rtol_cur, atol_cur, args_cur,
                      rounds_per_call)
        irec = cst.irec.cpu().numpy()
        fail = cst.st.fail.cpu().numpy()
        now = time.time()
        if t_start is None:
            t_start = now
        if progress_cb is not None:
            progress_cb(k, cst.st)
        k += 1
        wall_hit = max_wall_s is not None and now - t_start > max_wall_s
        retryable = fail & (level < n_levels)
        if retryable.any() and not wall_hit:
            level[retryable] += 1
            for lv in np.unique(level[retryable]):
                rows = torch.as_tensor(
                    np.nonzero(retryable & (level == lv))[0], device=dev)
                r_row, a_row = retry_tols[lv - 1]
                rtol_cur = _set_rows(rtol_cur, rows, r_row)
                atol_cur = _set_rows(atol_cur, rows, a_row)
            cst = _ladder_rollback(cst, retryable, touts, y0_cur, t0,
                                   first_step)
            fail = cst.st.fail.cpu().numpy()
        done = (irec >= n_out) | fail
        if wall_hit:
            flush(np.arange(W))
            break
        n_take = min(int(done.sum()), N - next_i)
        if n_take > 0:
            slots = np.nonzero(done)[0][:n_take]
            flush(slots)
            refill(slots, np.arange(next_i, next_i + n_take))
            orig[slots] = np.arange(next_i, next_i + n_take)
            level[slots] = 0
            next_i += n_take
            continue
        if bool(done.all()):
            flush(np.arange(W))
            break
    # wall-aborted: pool entries never started stay failed with y0
    if next_i < N:
        rest = np.arange(next_i, N)
        res["ys"][rest] = y0_pool.cpu().numpy()[rest]
    t = torch.as_tensor
    return BDFResult(
        ts=t(res["ts"])[:, None], ys=t(res["ys"])[:, None, :],
        t_final=t(res["t_final"]), fail=t(res["fail"]),
        n_steps=t(res["n_steps"]), n_feval=t(res["n_feval"]),
        n_jeval=t(res["n_jeval"]), n_lu=t(res["n_lu"]),
        retry_level=t(res["level"]), n_rounds=advance.rounds)
