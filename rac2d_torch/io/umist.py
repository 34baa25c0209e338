"""UMIST-format chemical network parser (host side).

Reads the fixed-column reaction files used by the reference
(reference: src/chemistry.f90:1364-1529 ``chem_load_reactions`` /
``chem_parse_reactions`` / ``getElements``; record layout
``(7(A12), 3F9.0, 2F6.0, I3, X, A1, X, A2)``) and produces a
structure-of-arrays :class:`ChemNet` of numpy arrays ready to be frozen as
device constants.  Everything dynamic in the reference (species discovery,
element decomposition, duplicate-reaction groups, grain-surface parameters)
is precomputed here once, so the on-device rate/RHS/Jacobian kernels are
pure gather/scatter over static index arrays.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np

from .. import constants as c

# Element bookkeeping mirrors reference src/chemistry.f90:20-34: slot 0 is
# charge, slot 1 the electron, slot 2 the grain pseudo-element; mass numbers
# likewise.
ELEMENTS = ["+-", "E", "Grain", "H", "D", "He", "C", "N", "O", "Si", "S",
            "Fe", "Na", "Mg", "Cl", "P", "F", "Ne", "Ar", "K"]
ELEMENT_MASS = np.array(
    [0.0, 5.45e-4, 0.0, 1.0, 2.0, 4.0, 12.0, 14.0, 16.0, 28.0, 32.0,
     56.0, 23.0, 24.0, 35.5, 31.0, 19.0, 20.18, 39.95, 39.1])
N_ELEMENT = len(ELEMENTS)

N_REAC_MAX = 3
N_PROD_MAX = 4
PSEUDO_REACTANTS = {"PHOTON", "CRPHOT", "CRP"}
PSEUDO_PRODUCTS = {"PHOTON"}
GRAIN_PREFIX = "g"

COSMICRAY_INTENSITY_0 = 1.36e-17     # reference src/chemistry.f90:179
COSMIC_DESORP_PREFACTOR = 3.16e-19   # :180
COSMIC_DESORP_GRAIN_T = 70.0         # :181

# Species tracked with tightened tolerances and used by thermal balance
# (reference src/chemistry.f90:45-47).
KEY_SPECIES = ["H2", "H", "E-", "C", "C+", "O", "O2", "CO", "H2O", "OH"]

_REAL_ELEMENTS = [(i, e) for i, e in enumerate(ELEMENTS) if e not in ("+-",)]
# Longest-first so He matches before H, Cl before C, Grain before anything.
_REAL_ELEMENTS.sort(key=lambda t: -len(t[1]))


def get_elements(name: str) -> np.ndarray:
    """Element-count vector of a species name.

    Equivalent to reference ``getElements`` (src/chemistry.f90:1458-1529):
    longest element symbol wins at each position, a following 1-2 digit
    number multiplies the last matched element, '+'/'-' set the charge.
    Unrecognized characters (like the grain prefix 'g') are skipped.
    """
    counts = np.zeros(N_ELEMENT, dtype=np.int64)
    i = 0
    last_ele = -1
    while i < len(name):
        ch = name[i]
        matched = False
        for idx, ele in _REAL_ELEMENTS:
            if name.startswith(ele, i):
                counts[idx] += 1
                last_ele = idx
                i += len(ele)
                matched = True
                break
        if matched:
            continue
        if ch == "+":
            counts[0] = 1
            i += 1
        elif ch == "-":
            counts[0] = -1
            i += 1
        elif ch.isdigit() and last_ele >= 0:
            m = re.match(r"\d{1,2}", name[i:])
            n = int(m.group(0))
            if n > 0:  # a literal 0 (as in Grain0) is not a multiplier
                counts[last_ele] += n - 1
            i += len(m.group(0))
        else:
            i += 1
    return counts


def vib_freq(mass_num, Edesorb):
    """Harmonic oscillator frequency of an adsorbed species [s^-1].

    Reference src/chemistry.f90:1532-1539 (``getVibFreq``).
    """
    return np.sqrt(2.0 * c.SitesDensity_CGS * c.kBoltzmann_CGS * Edesorb
                   / (c.pi ** 2) / (c.mProton_CGS * mass_num))


@dataclasses.dataclass
class ChemNet:
    """Structure-of-arrays chemical network (all numpy, host side)."""

    species: list[str]
    elements: np.ndarray          # [n_species, N_ELEMENT] int
    mass_num: np.ndarray          # [n_species]
    n_species: int

    # reactions
    n_reactions: int
    reac: np.ndarray              # [nR, N_REAC_MAX] species idx, -1 pad
    prod: np.ndarray              # [nR, N_PROD_MAX]
    n_reac: np.ndarray            # [nR]
    n_prod: np.ndarray            # [nR]
    abc: np.ndarray               # [nR, 3]
    T_range: np.ndarray           # [nR, 2]
    itype: np.ndarray             # [nR]
    ctype: list[str]
    reliability: list[str]

    # duplicate groups: group id per reaction (-1 = not duplicated)
    dupli_group: np.ndarray       # [nR]

    # grain-surface data (NaN where undefined)
    vib_freq: np.ndarray          # [n_species]
    Edesorb: np.ndarray           # [n_species]
    gasgrain_counterpart: np.ndarray  # [n_species] idx or -1
    grain_species_idx: np.ndarray     # [n_grain]

    # special species indices (-1 if absent)
    idx: dict[str, int] = dataclasses.field(default_factory=dict)
    key_species_idx: np.ndarray = None   # [10]

    # thermochemistry
    enthalpies: np.ndarray = None    # [n_species], erg; NaN where unknown
    has_enthalpy: np.ndarray = None  # [n_species] bool
    reac_heat: np.ndarray = None     # [nR], erg (0 where undefined)
    has_heat: np.ndarray = None      # [nR] bool

    @property
    def neq(self):
        return self.n_species + 1


def _parse_line(line: str):
    names = [line[k * 12:(k + 1) * 12].strip() for k in range(7)]

    def ffloat(s):
        # Fortran-style floats may use D exponents (e.g. 1.4D-11).
        s = s.strip().replace("D", "e").replace("d", "e")
        return float(s) if s else 0.0

    abc = [ffloat(line[84 + 9 * k:84 + 9 * (k + 1)]) for k in range(3)]
    trange = [ffloat(line[111 + 6 * k:111 + 6 * (k + 1)]) for k in range(2)]
    s_itype = line[123:126].strip()
    itype = int(s_itype) if s_itype else 0
    reliability = line[127:128].strip()
    ctype = line[129:131].strip()
    return names, abc, trange, itype, reliability, ctype


def load_network(path: str, enthalpy_path: str | None = None) -> ChemNet:
    """Parse a UMIST-format network file into a :class:`ChemNet`."""
    rows = []
    with open(path) as f:
        for line in f:
            # reference skips blank lines and lines starting with '!' or ' '
            if not line.rstrip("\n") or line[0] in ("!", " "):
                continue
            rows.append(_parse_line(line.rstrip("\n")))

    n_r = len(rows)
    species: list[str] = []
    sp_index: dict[str, int] = {}

    def get_idx(name):
        if name not in sp_index:
            sp_index[name] = len(species)
            species.append(name)
        return sp_index[name]

    reac = -np.ones((n_r, N_REAC_MAX), dtype=np.int64)
    prod = -np.ones((n_r, N_PROD_MAX), dtype=np.int64)
    n_reac = np.zeros(n_r, dtype=np.int64)
    n_prod = np.zeros(n_r, dtype=np.int64)
    abc = np.zeros((n_r, 3))
    T_range = np.zeros((n_r, 2))
    itype = np.zeros(n_r, dtype=np.int64)
    ctype: list[str] = []
    reliability: list[str] = []

    for i, (names, iabc, itr, ity, rel, cty) in enumerate(rows):
        rnames = [n for n in names[:N_REAC_MAX] if n and n not in PSEUDO_REACTANTS]
        pnames = [n for n in names[N_REAC_MAX:] if n and n not in PSEUDO_PRODUCTS]
        n_reac[i] = len(rnames)
        n_prod[i] = len(pnames)
        for k, n in enumerate(rnames):
            reac[i, k] = get_idx(n)
        for k, n in enumerate(pnames):
            prod[i, k] = get_idx(n)
        abc[i] = iabc
        T_range[i] = itr
        itype[i] = ity
        ctype.append(cty)
        reliability.append(rel)

    n_s = len(species)
    elements = np.stack([get_elements(s) for s in species])
    mass_num = elements.astype(float) @ ELEMENT_MASS

    # duplicate groups (reference chem_get_dupli_reactions, :1188-1217):
    # same ctype, itype, reactant and product index arrays.
    groups: dict[tuple, list[int]] = {}
    for i in range(n_r):
        key = (ctype[i], int(itype[i]), tuple(reac[i]), tuple(prod[i]))
        groups.setdefault(key, []).append(i)
    dupli_group = -np.ones(n_r, dtype=np.int64)
    gid = 0
    for key, members in groups.items():
        if len(members) > 1:
            dupli_group[members] = gid
            gid += 1

    # grain-surface parameters from desorption (itype 62) reactions
    # (reference src/chemistry.f90:1321-1334).
    vfreq = np.full(n_s, np.nan)
    Edes = np.full(n_s, np.nan)
    counterpart = -np.ones(n_s, dtype=np.int64)
    for i in range(n_r):
        if itype[i] == 62:
            s = reac[i, 0]
            Edes[s] = abc[i, 2]
            vfreq[s] = vib_freq(mass_num[s], abc[i, 2])
            p = prod[i, 0]
            counterpart[p] = s
            counterpart[s] = p

    grain_species_idx = np.array(
        [i for i, s in enumerate(species) if s.startswith(GRAIN_PREFIX)],
        dtype=np.int64)

    idx = {}
    for name in ["H2", "H", "E-", "C", "C+", "O", "O2", "CO", "H2O", "OH",
                 "H+", "He+", "gH", "gH2", "Grain0", "Grain-", "Grain+",
                 "gH2O", "gCO", "gCO2", "gN2", "N+", "Si+", "Fe+", "N"]:
        idx[name] = sp_index.get(name, -1)
    key_species_idx = np.array([sp_index[s] for s in KEY_SPECIES], dtype=np.int64)

    net = ChemNet(
        species=species, elements=elements, mass_num=mass_num, n_species=n_s,
        n_reactions=n_r, reac=reac, prod=prod, n_reac=n_reac, n_prod=n_prod,
        abc=abc, T_range=T_range, itype=itype, ctype=ctype,
        reliability=reliability, dupli_group=dupli_group,
        vib_freq=vfreq, Edesorb=Edes, gasgrain_counterpart=counterpart,
        grain_species_idx=grain_species_idx, idx=idx,
        key_species_idx=key_species_idx,
    )
    if enthalpy_path:
        load_enthalpies(net, enthalpy_path)
    return net


def load_enthalpies(net: ChemNet, path: str) -> None:
    """Attach species enthalpies [erg] and per-reaction heats.

    Reference src/chemistry.f90:2027-2151 (``chem_load_species_enthalpies``
    / ``chem_get_reaction_heat``): file values are kJ/mol; reaction heat is
    defined only for itype-5 reactions that are not radiative
    association/recombination (ctype RA/RR) and whose every participant has
    an enthalpy.
    """
    ent = np.full(net.n_species, np.nan)
    has = np.zeros(net.n_species, dtype=bool)
    sp_index = {s: i for i, s in enumerate(net.species)}
    with open(path) as f:
        for line in f:
            if not line.strip() or line[0] in ("!", " "):
                continue
            name = line[:12].strip()
            if name in sp_index:
                val = float(line[12:21])
                i = sp_index[name]
                # kJ/mol -> K -> erg
                ent[i] = val * 1e3 / c.IdealGasConst_SI * c.kBoltzmann_CGS
                has[i] = True
    heat = np.zeros(net.n_reactions)
    has_heat = np.zeros(net.n_reactions, dtype=bool)
    for i in range(net.n_reactions):
        if net.itype[i] != 5 or net.ctype[i] in ("RA", "RR"):
            continue
        h = 0.0
        ok = True
        for k in range(net.n_reac[i]):
            s = net.reac[i, k]
            if not has[s]:
                ok = False
                break
            h += ent[s]
        if ok:
            for k in range(net.n_prod[i]):
                s = net.prod[i, k]
                if not has[s]:
                    ok = False
                    break
                h -= ent[s]
        if ok and abs(h) > 1e-50:
            heat[i] = h
            has_heat[i] = True
    net.enthalpies = ent
    net.has_enthalpy = has
    net.reac_heat = heat
    net.has_heat = has_heat


def load_initial_abundances(net: ChemNet, path: str) -> np.ndarray:
    """Initial fractional abundances, charge-neutralized, renormalized to H=1.

    Reference src/chemistry.f90:1978-2024.
    """
    y = np.zeros(net.n_species)
    sp_index = {s: i for i, s in enumerate(net.species)}
    with open(path) as f:
        for line in f:
            name = line[:12].strip()
            if name in sp_index and len(line) > 12:
                try:
                    y[sp_index[name]] = float(line[12:].split()[0])
                except (ValueError, IndexError):
                    pass
    # neutralize with electrons
    i_e = net.idx["E-"]
    y[i_e] += float(y @ net.elements[:, 0])
    if y[i_e] < 0:
        raise ValueError("cannot neutralize initial abundances")
    # renormalize total H to 1
    totH = float(y @ net.elements[:, 3])
    y /= totH
    return y


def elemental_abundances(net: ChemNet, y) -> np.ndarray:
    """Total abundance per element: eleAb[e] = sum_s y_s * elements[s, e]."""
    return np.asarray(y) @ net.elements.astype(float)
