"""HITRAN 2012 line-list reader producing a level/transition set.

Counterpart of the JAX package's ``io/hitran.py``, copied (numpy).

Rebuild of reference src/hitran.f90:63-343 ``load_hitran_mol``: parses the
160-character 2012-format records (Rothman et al. 2012, Table 1), builds a
pseudo level set from the unique lower/upper energies, and derives the
Einstein B coefficients.  HITRAN carries no collision rates, so molecules
loaded this way are used in LTE (reference behavior, SURVEY.md L4).

Optional filters mirror the reference: wavelength window (micron),
lower-energy window (K), and ortho/para selection for H2O-like molecules
(reference get_ortho_para, hitran.f90:293-318: parity of ka+kc+v3).
"""

from __future__ import annotations

import numpy as np

from .. import constants as c
from .lamda import Molecule


def _parse_record(line):
    return dict(
        imol=int(line[0:2]), iiso=int(line[2:3]),
        wavnum=float(line[3:15]), inten=float(line[15:25]),
        A=float(line[25:35]), Elow=float(line[45:55]),
        q_up_gl=line[67:82], q_lo_gl=line[82:97],
        q_up_loc=line[97:112], q_lo_loc=line[112:127],
        g_up=float(line[146:153]), g_lo=float(line[153:160]))


def _ortho_para(q_gl, q_loc):
    try:
        v3 = int(q_gl[13:15])
        ka = int(q_loc[3:6])
        kc = int(q_loc[6:9])
    except ValueError:
        return -1
    return 1 if (ka + kc + v3) % 2 == 1 else 0


def load_hitran(path: str, lam_range_um=None, Elow_range_K=None,
                orthopara="all", name="hitran-mol",
                weight=18.0) -> Molecule:
    recs = []
    with open(path) as f:
        for line in f:
            if len(line) < 160:
                continue
            r = _parse_record(line)
            lam_um = 1e4 / max(r["wavnum"], 1e-30)
            Elow_K = r["Elow"] * c.cm_1_2K
            if lam_range_um and not (lam_range_um[0] <= lam_um
                                     <= lam_range_um[1]):
                continue
            if Elow_range_K and not (Elow_range_K[0] <= Elow_K
                                     <= Elow_range_K[1]):
                continue
            if orthopara in ("ortho", "para"):
                op = _ortho_para(r["q_lo_gl"], r["q_lo_loc"])
                if (orthopara == "ortho") != (op == 1):
                    continue
            recs.append(r)
    if not recs:
        raise ValueError(f"no HITRAN records kept from {path}")

    # unique level set keyed by (energy, g); energies in cm^-1
    Elow = np.array([r["Elow"] for r in recs])
    Eup = Elow + np.array([r["wavnum"] for r in recs])
    g_lo = np.array([r["g_lo"] for r in recs])
    g_up = np.array([r["g_up"] for r in recs])
    E_all = np.concatenate([Elow, Eup])
    g_all = np.concatenate([g_lo, g_up])
    order = np.argsort(E_all)
    uniq_E, uniq_g = [], []
    for idx in order:
        if uniq_E and abs(E_all[idx] - uniq_E[-1]) < 1e-4:
            continue
        uniq_E.append(E_all[idx])
        uniq_g.append(g_all[idx])
    uniq_E = np.array(uniq_E)
    uniq_g = np.array(uniq_g)

    def level_of(E):
        i = np.searchsorted(uniq_E, E)
        i = np.clip(i, 0, len(uniq_E) - 1)
        i = np.where((i > 0)
                     & (np.abs(uniq_E[i - 1] - E) < np.abs(uniq_E[i] - E)),
                     i - 1, i)
        return i

    ilow = level_of(Elow)
    iup = level_of(Eup)
    Aul = np.array([r["A"] for r in recs])
    freq = c.SpeedOfLight_CGS * (uniq_E[iup] - uniq_E[ilow])
    ok = freq > 0
    iup, ilow, Aul, freq = iup[ok], ilow[ok], Aul[ok], freq[ok]
    lam_A = 299792458.0 / freq * 1e10
    Bul = Aul / ((2.0 * c.hPlanck_CGS / c.SpeedOfLight_CGS ** 2) * freq ** 3)
    Blu = Bul * uniq_g[iup] / uniq_g[ilow]
    return Molecule(
        name=name, weight=weight, energy_K=uniq_E * c.cm_1_2K,
        g=uniq_g, iup=iup, ilow=ilow, Aul=Aul, freq=freq, lam_A=lam_A,
        Bul=Bul, Blu=Blu, Eup_K=uniq_E[iup] * c.cm_1_2K, partners=[])
