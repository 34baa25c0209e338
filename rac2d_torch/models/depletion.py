"""Ad-hoc oxygen/carbon(/nitrogen) depletion of initial abundances.

Counterpart of the JAX package's ``models/depletion.py`` (plain numpy,
copied).  Rebuild of reference src/disk.f90:2150-2420
``deplete_oxygen_carbon_adhoc`` and its helper profiles (``depl_f``/
``depl_g``/``depl_h``/``depl_vfac``/``depl_vfac_tanh``): science-driven
modifiers that deplete volatile O and C reservoirs as functions of radius
and height before each cell's chemical evolution.  Vectorized over all
cells.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ElementDepletion:
    """Per-element knobs (reference a_disk_iter_params%*_O / *_C)."""
    r0: float = 100.0        # AU, radial pivot
    a: float = 1.0           # depl_f inner value
    b: float = 1.0           # depl_f outer value
    gam: float = 2.0
    vfac: float = 1.0        # vscale exponent factor
    k: float = 0.0
    p: float = 2.0
    gval: float = 0.0        # ground value added to the vscale factor
    tanh_r: float = 100.0
    tanh_scale: float = 10.0
    tanh_minval: float = 0.0
    tanh_maxval: float = 1.0
    rin: float = 0.0         # extra scaling inside/outside these radii
    fin: float = 1.0
    rout: float = 1e99
    fout: float = 1.0
    enhance_max: float = 1e99
    # 'vertical' method timescales
    tads: float = 1e2
    tsed: float = 1e5


@dataclasses.dataclass
class DepletionConfig:
    method: str = "none"     # none|radial|vscale|vertical|C/O-ratio|uniform
    o: ElementDepletion = dataclasses.field(default_factory=ElementDepletion)
    c: ElementDepletion = dataclasses.field(default_factory=ElementDepletion)
    vscale_profile: str = "power"   # power | tanh  (for 'vscale')
    f_depl_O: float = 1.0           # for 'uniform'
    f_depl_C: float = 1.0
    C_to_O_ratio: float = 1.0
    O_to_C_ISM: float = 457.0 / 288.0
    dep_zscale: float = 0.0
    deplete_nitrogen: bool = False
    deplete_nitrogen_as_carbon: bool = False
    mode: str = "redistribute"      # redistribute | scale


def _depl_f(x, a, b, gam):
    return (x ** gam * a + b) / (x ** gam + 1.0)


def _depl_vfac_power(x, p):
    return 1.0 / (1.0 + x ** p)


def _depl_vfac_tanh(r, e: ElementDepletion):
    t = np.tanh((r - e.tanh_r) / e.tanh_scale)
    return e.tanh_minval + (e.tanh_maxval - e.tanh_minval) * 0.5 * (t + 1.0)


def _vscale_factor(grid, n_gas):
    """n_gas / n_gas(column bottom) per cell (reference depl_h)."""
    out = np.ones(grid.n_cells)
    for icol in range(grid.n_columns):
        members = grid.col_cells[grid.col_ptr[icol]:grid.col_ptr[icol + 1]]
        used = members[grid.using[members]]
        if not len(used):
            continue
        bott = used[np.argmin(grid.zmin[used])]
        out[members] = n_gas[members] / max(n_gas[bott], 1e-300)
    return out


def depletion_factors(grid, n_gas, Tgas, cfg: DepletionConfig,
                      star_mass=1.0, t_evol=1e6):
    """(dep_O, dep_C, dep_N) arrays over all cells."""
    r = 0.5 * (grid.rmin + grid.rmax)
    n = grid.n_cells
    if cfg.method in ("none",):
        one = np.ones(n)
        return one, one.copy(), one.copy()

    def per_element(e: ElementDepletion):
        x = r / e.r0
        if cfg.method == "radial":
            d = _depl_f(x, e.a, e.b, e.gam)
        elif cfg.method == "vscale":
            if cfg.vscale_profile == "tanh":
                vfac = _depl_vfac_tanh(r, e)
            else:
                vfac = e.vfac * _depl_vfac_power(x, e.p) + e.k
            vs = _vscale_factor(grid, n_gas)
            d = vs ** vfac + e.gval
        elif cfg.method == "vertical":
            tmp = np.sqrt(np.maximum(Tgas, 1.0) / 1e2) * (n_gas / 1e7)
            t_ads = e.tads / np.maximum(tmp, 1e-300)
            t_sed = e.tsed * (r / 1e2) ** 3 / star_mass * tmp
            d = e.gval + 1.0 / (e.k + x ** e.p) \
                * np.exp(-t_evol / (t_ads + t_sed))
        elif cfg.method == "uniform":
            d = np.full(n, np.nan)     # handled below
        else:
            d = np.ones(n)
        return d

    if cfg.method == "uniform":
        dep_O = np.full(n, cfg.f_depl_O)
        dep_C = np.full(n, cfg.f_depl_C)
    elif cfg.method == "C/O-ratio":
        e = cfg.o
        x = r / e.r0
        vs = _vscale_factor(grid, n_gas)
        vfac = e.vfac * _depl_vfac_power(x, e.p) + e.k
        dep_O = vs ** vfac + e.gval
        if abs(cfg.dep_zscale) >= 1e-10:
            dep_C = np.minimum(
                1.0, dep_O * (1.0 + cfg.O_to_C_ISM
                              * grid.zmin / cfg.dep_zscale))
        else:
            dep_C = np.minimum(
                1.0, cfg.C_to_O_ratio * dep_O * cfg.O_to_C_ISM)
    else:
        dep_O = per_element(cfg.o)
        dep_C = per_element(cfg.c)

    for e, d in ((cfg.o, dep_O), (cfg.c, dep_C)):
        d[r <= e.rin] *= e.fin
        d[r >= e.rout] *= e.fout
        np.minimum(d, e.enhance_max, out=d)

    dep_N = dep_C.copy() if (cfg.deplete_nitrogen
                             and cfg.deplete_nitrogen_as_carbon) \
        else np.ones(n)
    return dep_O, dep_C, dep_N


def apply_depletion(net, X, grid, n_gas, Tgas, cfg: DepletionConfig,
                    star_mass=1.0, t_evol=1e6):
    """Modify abundances X[n_species, n_cells] in place.

    mode 'redistribute' (reference default path, disk.f90:2283-2295):
    pool O among (gH2O, H2O, O, CO) and C among (CO, C, C+), then
    redistribute with the depletion factors; mode 'scale' (flag=1 path)
    multiplies each volatile carrier.
    """
    dep_O, dep_C, dep_N = depletion_factors(grid, n_gas, Tgas, cfg,
                                            star_mass, t_evol)
    if cfg.method == "none":
        return X
    i = net.idx
    if cfg.mode == "redistribute":
        X_O0 = X[i["gH2O"]] + X[i["H2O"]] + X[i["O"]] + X[i["CO"]]
        X_C0 = X[i["CO"]] + X[i["C"]] + X[i["C+"]]
        X_N0 = X[i["N"]]
        X[i["gH2O"]] = X_O0 * dep_O / 3.0
        X[i["H2O"]] = X_O0 * dep_O / 3.0
        X[i["CO"]] = np.minimum(X_O0 * dep_O / 3.0, X_C0 * dep_C)
        X[i["C"]] = np.maximum(0.0, X_C0 * dep_C - X[i["CO"]])
        X[i["N"]] = X_N0 * dep_N
    else:
        for s in ("gH2O", "H2O", "O"):
            X[i[s]] *= dep_O
        for s in ("gCO", "CO", "gCO2", "C", "C+"):
            if i.get(s, -1) >= 0:
                X[i[s]] *= dep_C
    return X
