"""Chemical ODE right-hand side and Jacobian, batch-native.

Counterpart of the JAX package's ``ops/network.py`` (reference
src/disk.f90:4569-4659 ``chem_ode_f`` and :4746-4903 ``chem_ode_jac``).
The per-reaction fluxes are one vector formula selected by a static
category code, and both ydot and the dense Jacobian are single
``index_add_`` scatters over COO incidence entries built on the host in
:func:`build_incidence`.  Inputs carry a leading lane axis: y[B, nS],
k[B, nR], and per-lane ratioDust2HnucNum / SitesPerGrain [B].

Scatter order: on the CPU ``index_add_`` adds the entries in the order
given (sorted by target), as XLA's sorted segment-sum does; on CUDA it
uses atomics, so sums of several entries into one row or one Jacobian
element may round differently from run to run (f64 roundoff, ~1e-16
relative to the largest term).

Deliberate reference semantics preserved: the negative-abundance sign
flips (disk.f90:4586-4589, 4636-4638), the top-layer desorption
saturation 1-exp(-y/Nlayer) (disk.f90:4592-4615), and the
moment-equation H2-formation pathway (disk.f90:4624-4632).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..io.umist import ChemNet

# rate-law category codes
CAT_NONE = 0      # inactive itypes (9, 53, 67, 123): no flux
CAT_LIN = 1       # r = k y1          (itype 1,2,3,13,20,61,0)
CAT_BILIN = 2     # r = k y1 y2       (itype 5,6,21,64)
CAT_DES = 3       # r = k sat(y1/Nl)  (itype 62)
CAT_PDES = 4      # r = k sat(y1/(Nl C)) (itype 75)
CAT_SURF2 = 5     # r = k y1 yp       (itype 63; yp = y1 or gas counterpart)

_CAT_OF_ITYPE = {1: CAT_LIN, 2: CAT_LIN, 3: CAT_LIN, 13: CAT_LIN,
                 20: CAT_LIN, 61: CAT_LIN, 0: CAT_LIN,
                 5: CAT_BILIN, 6: CAT_BILIN, 21: CAT_BILIN, 64: CAT_BILIN,
                 62: CAT_DES, 75: CAT_PDES, 63: CAT_SURF2}


class Incidence(NamedTuple):
    """Static incidence/COO structure for RHS + Jacobian (tensors)."""
    n_species: int
    cat: torch.Tensor        # [nR] category code
    reac1: torch.Tensor      # [nR] clipped species idx
    reac2: torch.Tensor      # [nR]
    partner: torch.Tensor    # [nR] second factor for CAT_SURF2
    abc3: torch.Tensor       # [nR] ABC(3) (for itype 75 saturation)
    moeq_mask: torch.Tensor  # [nR] bool: CAT_SURF2 with moment-eq. extras
    gas_counter: torch.Tensor  # [nR] gas counterpart idx (moeq rows), else 0
    # RHS entries (sorted by target)
    e_reac: torch.Tensor     # [nE]
    e_sign: torch.Tensor     # [nE] +-1
    e_target: torch.Tensor   # [nE] species row
    # Jacobian entries (sorted by flat index)
    je_reac: torch.Tensor    # [nJ]
    je_slot: torch.Tensor    # [nJ] 0: d/d y_reac1(col a), 1: d/d y_b
    je_sign: torch.Tensor    # [nJ]
    je_flat: torch.Tensor    # [nJ] row * n_species + col
    # moment-equation extra entries use the unflipped flux/derivatives
    me_reac: torch.Tensor    # [nEm] RHS extras
    me_sign: torch.Tensor
    me_target: torch.Tensor
    mj_reac: torch.Tensor    # [nJm] Jacobian extras
    mj_slot: torch.Tensor
    mj_sign: torch.Tensor
    mj_flat: torch.Tensor


def build_incidence(net: ChemNet, h2_form_use_moeq: bool,
                    device) -> Incidence:
    nR = net.n_reactions
    nS = net.n_species
    cat = np.array([_CAT_OF_ITYPE.get(int(t), CAT_NONE) for t in net.itype],
                   dtype=np.int64)
    r1 = np.clip(net.reac[:, 0], 0, None)
    r2 = np.clip(net.reac[:, 1], 0, None)

    i_gH = net.idx.get("gH", -1)
    moeq_mask = np.zeros(nR, dtype=bool)
    partner = r1.copy()          # CAT_SURF2 default: y1 * y1
    gas_counter = np.zeros(nR, dtype=np.int64)
    if h2_form_use_moeq and i_gH >= 0:
        i1 = int(net.gasgrain_counterpart[i_gH])
        for i in range(nR):
            if net.itype[i] == 63 and net.reac[i, 0] == i_gH and i1 >= 0:
                moeq_mask[i] = True
                partner[i] = i1
                gas_counter[i] = i1

    # --- RHS entries ---
    e = []
    for i in range(nR):
        if cat[i] == CAT_NONE:
            continue
        for kslot in range(net.n_reac[i]):
            e.append((i, -1, net.reac[i, kslot]))
        for kslot in range(net.n_prod[i]):
            e.append((i, +1, net.prod[i, kslot]))
    e.sort(key=lambda t: t[2])

    # --- Jacobian entries: slot0 = d/d col_a, slot1 = d/d col_b ---
    # col_a = reac1 always; col_b = reac2 (bilinear) or partner (surf2)
    j = []
    for i in range(nR):
        if cat[i] == CAT_NONE:
            continue
        cols = [(0, r1[i])]
        if cat[i] == CAT_BILIN:
            cols.append((1, r2[i]))
        elif cat[i] == CAT_SURF2:
            cols.append((1, partner[i]))
        targets = [(-1, net.reac[i, kk]) for kk in range(net.n_reac[i])] + \
                  [(+1, net.prod[i, kk]) for kk in range(net.n_prod[i])]
        for slot, col in cols:
            for sgn, row in targets:
                j.append((i, slot, sgn, row * nS + col))
    j.sort(key=lambda t: t[3])

    # --- moment-equation extras (unflipped values; the reference applies
    # the extra +-rtmp to the gas counterpart and gH before the flip) ---
    me, mj = [], []
    for i in np.nonzero(moeq_mask)[0]:
        i1 = int(gas_counter[i])
        me.append((i, -1, i1))
        me.append((i, +1, i_gH))
        for slot in (0, 1):
            mj.append((i, slot, -1, i1))
            mj.append((i, slot, +1, i_gH))
    # columns for jac extras: slot0 -> gH, slot1 -> i1
    mj_col = np.array([i_gH if t[1] == 0 else gas_counter[t[0]] for t in mj],
                      dtype=np.int64)

    def ints(rows, k):
        return torch.as_tensor(np.array([t[k] for t in rows], dtype=np.int64),
                               device=device)

    def signs(rows, k):
        return torch.as_tensor(np.array([t[k] for t in rows],
                                        dtype=np.float64), device=device)

    def f(a):
        return torch.as_tensor(np.asarray(a), device=device)

    mj_flat = np.array([t[3] for t in mj], dtype=np.int64) * nS + mj_col
    return Incidence(
        n_species=nS, cat=f(cat), reac1=f(r1), reac2=f(r2),
        partner=f(partner), abc3=f(net.abc[:, 2].astype(np.float64)),
        moeq_mask=f(moeq_mask), gas_counter=f(gas_counter),
        e_reac=ints(e, 0), e_sign=signs(e, 1), e_target=ints(e, 2),
        je_reac=ints(j, 0), je_slot=ints(j, 1), je_sign=signs(j, 2),
        je_flat=ints(j, 3),
        me_reac=ints(me, 0), me_sign=signs(me, 1), me_target=ints(me, 2),
        mj_reac=ints(mj, 0), mj_slot=ints(mj, 1), mj_sign=signs(mj, 2),
        mj_flat=f(mj_flat),
    )


def _saturation(x):
    """1 - exp(-x), linearized below 1e-4 (reference disk.f90:4597-4602)."""
    return torch.where(x <= 1e-4, x, -torch.expm1(-torch.clamp_max(x, 200.0)))


def _dsaturation(x):
    """d/dy of the saturation term divided by 1/Nlayer."""
    return torch.where(x <= 1e-4, 1.0, torch.exp(-torch.clamp_max(x, 200.0)))


def _select(cat, choices):
    """jnp.select over the category codes CAT_LIN..CAT_SURF2 (first match
    wins; the codes are exclusive), default 0."""
    out = torch.zeros_like(choices[0])
    for code in range(len(choices), 0, -1):
        out = torch.where(cat == code, choices[code - 1], out)
    return out


def _fluxes(inc: Incidence, k, y, n_layer_tot, n_layer_pd):
    """Per-reaction fluxes r[B, nR], flipped and unflipped variants."""
    y1 = y[:, inc.reac1]
    y2 = y[:, inc.reac2]
    yp = y[:, inc.partner]
    nl_tot = n_layer_tot[:, None]
    nl_pd = n_layer_pd[:, None]

    r_lin = k * y1
    flip2 = (y1 < 0.0) & (y2 < 0.0)
    r_bil = torch.where(flip2, -k * y1 * y2, k * y1 * y2)
    x_des = y1 / nl_tot
    r_des = torch.where(nl_tot > 0.0, k * _saturation(x_des), k)
    x_pd = y1 / (nl_pd * torch.where(inc.abc3 != 0.0, inc.abc3, 1.0))
    r_pd = torch.where(nl_pd * inc.abc3 > 0.0, k * _saturation(x_pd), k)
    r_s2_u = k * yp * y1                      # unflipped (moeq extras)
    r_s2 = torch.where(y1 < 0.0, -r_s2_u, r_s2_u)

    r = _select(inc.cat, [r_lin, r_bil, r_des, r_pd, r_s2])
    return r, r_s2_u


def rhs_species(inc: Incidence, k, y, ratioDust2HnucNum, SitesPerGrain):
    """ydot[B, n_species]; y is [B, n_species(+1)] (T column ignored)."""
    nl = ratioDust2HnucNum * SitesPerGrain
    r, r_u = _fluxes(inc, k, y, nl, nl)
    vals = r[:, inc.e_reac] * inc.e_sign
    ydot = torch.zeros(y.shape[0], inc.n_species, dtype=y.dtype,
                       device=y.device).index_add_(1, inc.e_target, vals)
    if inc.me_reac.shape[0] > 0:
        mvals = r_u[:, inc.me_reac] * inc.me_sign
        ydot = ydot.index_add_(1, inc.me_target, mvals)
    return ydot


def jac_species(inc: Incidence, k, y, ratioDust2HnucNum, SitesPerGrain):
    """Dense species-block Jacobians [B, n_species, n_species]."""
    nS = inc.n_species
    B = y.shape[0]
    y1 = y[:, inc.reac1]
    y2 = y[:, inc.reac2]
    yp = y[:, inc.partner]
    nl = (ratioDust2HnucNum * SitesPerGrain)[:, None]

    # slot derivative values per category, [B, nR, 2]
    flip2 = torch.where((y1 < 0.0) & (y2 < 0.0), -1.0, 1.0)
    flip1 = torch.where(y1 < 0.0, -1.0, 1.0)
    zero = torch.zeros_like(k)
    d_lin = torch.stack([k, zero], dim=-1)
    d_bil = torch.stack([flip2 * k * y2, flip2 * k * y1], dim=-1)
    x_des = y1 / nl
    dd = torch.where(nl > 0.0, k / torch.where(nl > 0.0, nl, 1.0)
                     * _dsaturation(x_des), 0.0)
    d_des = torch.stack([dd, zero], dim=-1)
    nl_pd = nl * inc.abc3
    x_pd = y1 / torch.where(nl_pd > 0.0, nl_pd, 1.0)
    dpd = torch.where(nl_pd > 0.0,
                      k / torch.where(nl_pd > 0.0, nl_pd, 1.0)
                      * _dsaturation(x_pd), 0.0)
    d_pd = torch.stack([dpd, zero], dim=-1)
    d_s2_u = torch.stack([k * yp, k * y1], dim=-1)
    d_s2 = flip1[:, :, None] * d_s2_u

    dvals = _select(inc.cat[:, None], [d_lin, d_bil, d_des, d_pd, d_s2])

    vals = dvals[:, inc.je_reac, inc.je_slot] * inc.je_sign
    Jflat = torch.zeros(B, nS * nS, dtype=y.dtype,
                        device=y.device).index_add_(1, inc.je_flat, vals)
    if inc.mj_reac.shape[0] > 0:
        mvals = d_s2_u[:, inc.mj_reac, inc.mj_slot] * inc.mj_sign
        Jflat = Jflat.index_add_(1, inc.mj_flat, mvals)
    return Jflat.reshape(B, nS, nS)
