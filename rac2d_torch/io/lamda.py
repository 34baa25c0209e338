"""LAMDA molecular data reader (levels, radiative + collisional rates).

Counterpart of the JAX package's ``io/lamda.py``, copied (numpy).

Rebuild of reference src/lamda.f90:11-197 ``load_moldata_LAMDA``: level
energies converted cm^-1 -> K, transition frequencies recomputed from the
level energies (the database values can be imprecise, lamda.f90:78-86),
Einstein B coefficients derived from A (lamda.f90:102-110), collision
partner tables kept on their native temperature grids.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import constants as c


@dataclasses.dataclass
class CollisionPartner:
    name: str
    T_coll: np.ndarray      # [nT]
    iup: np.ndarray         # [n_tr] 0-based
    ilow: np.ndarray
    Cul: np.ndarray         # [nT, n_tr] cm^3 s^-1


@dataclasses.dataclass
class Molecule:
    name: str
    weight: float
    energy_K: np.ndarray    # [n_level] level energy in K
    g: np.ndarray           # [n_level]
    iup: np.ndarray         # [n_rad] 0-based
    ilow: np.ndarray
    Aul: np.ndarray
    freq: np.ndarray        # Hz (recomputed)
    lam_A: np.ndarray       # angstrom
    Bul: np.ndarray
    Blu: np.ndarray
    Eup_K: np.ndarray
    partners: list[CollisionPartner]

    @property
    def n_level(self):
        return len(self.energy_K)


def load_lamda(path: str) -> Molecule:
    with open(path) as f:
        lines = [ln.rstrip("\n") for ln in f]
    i = 0

    def next_data():
        nonlocal i
        while i < len(lines):
            ln = lines[i]
            i += 1
            if ln.strip() and not ln.lstrip().startswith("!"):
                return ln
        raise EOFError(path)

    name = next_data().strip()
    weight = float(next_data().split()[0])
    n_level = int(next_data().split()[0])
    lv = np.array([next_data().split()[:3] for _ in range(n_level)],
                  dtype=float)
    energy_cm1 = lv[:, 1]
    g = lv[:, 2]
    n_rad = int(next_data().split()[0])
    tr = np.array([next_data().split()[:4] for _ in range(n_rad)],
                  dtype=float)
    iup = tr[:, 1].astype(int) - 1
    ilow = tr[:, 2].astype(int) - 1
    Aul = tr[:, 3]
    freq = c.SpeedOfLight_CGS * (energy_cm1[iup] - energy_cm1[ilow])
    lam_A = 299792458.0 / freq * 1e10
    Bul = Aul / ((2.0 * c.hPlanck_CGS / c.SpeedOfLight_CGS ** 2) * freq ** 3)
    Blu = Bul * g[iup] / g[ilow]
    energy_K = energy_cm1 * c.cm_1_2K
    Eup_K = energy_K[iup]

    n_partner = int(next_data().split()[0])
    partners = []
    for _ in range(n_partner):
        header = next_data()
        # partner name: LAMDA convention "i MOL-PARTNER ..." or free text
        toks = header.replace("-", " ").split()
        pname = "?"
        for t in toks[1:]:
            if t in ("H2", "o-H2", "p-H2", "oH2", "pH2", "H", "H+", "e",
                     "e-", "He", "ortho-H2", "para-H2"):
                pname = t
                break
        pname = {"oH2": "o-H2", "pH2": "p-H2", "ortho": "o-H2",
                 "ortho-H2": "o-H2", "para-H2": "p-H2",
                 "e-": "e"}.get(pname, pname)
        n_tr = int(next_data().split()[0])
        nT = int(next_data().split()[0])
        T_coll = np.array(next_data().split()[:nT], dtype=float)
        block = np.array([next_data().split()[:3 + nT]
                          for _ in range(n_tr)], dtype=float)
        partners.append(CollisionPartner(
            name=pname, T_coll=T_coll,
            iup=block[:, 1].astype(int) - 1,
            ilow=block[:, 2].astype(int) - 1,
            Cul=block[:, 3:].T.copy()))
    return Molecule(name=name, weight=weight, energy_K=energy_K, g=g,
                    iup=iup, ilow=ilow, Aul=Aul, freq=freq, lam_A=lam_A,
                    Bul=Bul, Blu=Blu, Eup_K=Eup_K, partners=partners)
