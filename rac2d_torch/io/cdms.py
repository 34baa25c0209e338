"""CDMS/JPL catalog line-list reader.

Counterpart of the JAX package's ``io/cdms.py``, copied (numpy).

Rebuild of reference src/cdms.f90:21-236 ``load_cdms_mol`` /
``read_a_line_cdms`` / ``load_cdms_partition``: fixed-column catalog rows
(freq MHz, log10 intensity at 300 K, Elow cm^-1, gup, tag, quantum
numbers), pseudo level set from the unique quantum-number tuples, and the
Pickett et al. (1998) eq 9 intensity -> Einstein A conversion
(cdms.f90:333-340).  The catalog has no collision rates, so CDMS/JPL
molecules are used in LTE.
"""

from __future__ import annotations

import numpy as np

from .. import constants as c
from .lamda import Molecule

# temperature ladder of the catalog partition-function files
PARTITION_T = np.array([300.0, 225.0, 150.0, 75.0, 37.5, 18.75, 9.375,
                        5.0, 2.725])


def _int0(s):
    s = s.strip()
    return int(s) if s else 0


def _parse_row(line):
    return dict(
        freq=float(line[0:13]) * 1e6,          # MHz -> Hz
        intens=float(line[21:29]),             # log10 I(300 K)
        Elow=max(float(line[31:41]), 0.0),     # cm^-1
        gup=int(line[41:44]),
        tag=_int0(line[44:51]),
        cquan=_int0(line[51:55]),
        qup=tuple(_int0(line[55 + 2 * k:57 + 2 * k]) for k in range(6)),
        qlo=tuple(_int0(line[67 + 2 * k:69 + 2 * k]) for k in range(6)))


def _g_of(cquan, q):
    """Statistical weight from quantum numbers (reference
    calc_statistical_weight_cdms, cdms.f90:210-236)."""
    Q = cquan // 100
    H = (cquan - Q * 100) // 10
    if Q == 12:
        if H == 0:
            return 2 * q[0] + 1
        if H == 3:
            return 2 * q[3]
    elif Q == 14:
        if sum(q[1:3]) % 2 == 0:
            return 2 * q[0] + 1
        return (2 * q[0] + 1) * 3
    elif Q == 1:
        if H == 2:
            return 2 * q[2] + 1
    return -1


def load_cdms(path: str, partition_file: str | None = None,
              name="cdms-mol", weight=18.0) -> Molecule:
    rows = []
    with open(path) as f:
        for line in f:
            if len(line.rstrip()) >= 55:
                try:
                    rows.append(_parse_row(line))
                except ValueError:
                    continue
    if not rows:
        raise ValueError(f"no CDMS rows parsed from {path}")

    # partition function at 300 K
    tag = abs(rows[0]["tag"])
    lg10Q = None
    if partition_file:
        with open(partition_file) as f:
            for line in f:
                try:
                    if int(line[:7]) == tag:
                        vals = line[38:].split()
                        lg10Q = np.array([float(v) if v.lower() != "nan"
                                          else np.nan
                                          for v in vals[:len(PARTITION_T)]])
                        break
                except ValueError:
                    continue
    # levels from unique quantum-number keys (reference packs them into a
    # base-100 scalar, cdms.f90:85-95)
    def key(q):
        return sum(qi * 100 ** (5 - k) for k, qi in enumerate(q))

    levels = {}
    for r in rows:
        Eup = r["Elow"] + r["freq"] / c.SpeedOfLight_CGS
        glo = _g_of(r["cquan"], r["qlo"])
        if glo < 0:
            glo = r["gup"]
        for kq, E, g in ((key(r["qlo"]), r["Elow"], glo),
                         (key(r["qup"]), Eup, r["gup"])):
            if kq not in levels:
                levels[kq] = (E, g)
    keys = sorted(levels, key=lambda kq: levels[kq][0])
    kidx = {kq: i for i, kq in enumerate(keys)}
    energy_cm1 = np.array([levels[kq][0] for kq in keys])
    g = np.array([levels[kq][1] for kq in keys], dtype=float)

    iup = np.array([kidx[key(r["qup"])] for r in rows])
    ilow = np.array([kidx[key(r["qlo"])] for r in rows])
    freq = c.SpeedOfLight_CGS * (energy_cm1[iup] - energy_cm1[ilow])

    # partition function Q(300 K) for the intensity -> A conversion
    if lg10Q is not None and np.isfinite(lg10Q[0]):
        Q300 = 10.0 ** lg10Q[0]
    else:
        Q300 = float((g * np.exp(-energy_cm1 * c.cm_1_2K / 300.0)).sum())
    T0 = 300.0
    Elow_K = energy_cm1[ilow] * c.cm_1_2K
    Eup_K = energy_cm1[iup] * c.cm_1_2K
    inten = 10.0 ** np.array([r["intens"] for r in rows])
    Aul = inten * (freq * 1e-6) ** 2 * Q300 / g[iup] \
        / (np.exp(-Elow_K / T0) - np.exp(-Eup_K / T0)) * 2.7964e-16

    ok = freq > 0
    iup, ilow, Aul, freq = iup[ok], ilow[ok], Aul[ok], freq[ok]
    lam_A = 299792458.0 / freq * 1e10
    Bul = Aul / ((2.0 * c.hPlanck_CGS / c.SpeedOfLight_CGS ** 2) * freq ** 3)
    Blu = Bul * g[iup] / g[ilow]
    return Molecule(
        name=name, weight=weight, energy_K=energy_cm1 * c.cm_1_2K, g=g,
        iup=iup, ilow=ilow, Aul=Aul, freq=freq, lam_A=lam_A, Bul=Bul,
        Blu=Blu, Eup_K=energy_cm1[iup] * c.cm_1_2K, partners=[])
