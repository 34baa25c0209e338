"""Per-iteration results table: the framework's primary data product.

Counterpart of the JAX package's ``models/output.py`` (reference:
src/disk.f90:2745-3074 ``write_header``/``disk_save_results_write``: one
row per cell with ~150 physics columns followed by every species
abundance).  The same keys and dtypes; the model's device tensors (its
fields, columns and tallies) come to the host as numpy arrays.  Two
formats:

  - ``save_iter_npz``: compressed arrays (fast, lossless; what
    downstream tooling should use),
  - ``save_iter_ascii``: a human-readable table with the same column
    naming convention as the reference for eyeball parity.
"""

from __future__ import annotations

import numpy as np
import torch

PHYS_COLUMNS = [
    "cvg", "qual", "ab_count", "sc_count", "ab_en_W",
    "scc_HI", "abc_dus", "t_final", "rmin", "rmax", "zmin", "zmax",
    "Tgas", "Tdust", "n_gas", "Ncol_toISM", "Ncol_toStar",
    "Av_toISM", "Av_toStar", "G0_UV_toStar", "G0_UV_H2phd",
    "zeta_X", "flux_UV", "flux_Lya", "flux_Vis", "flux_NIR",
    "flux_MIR", "flux_FIR", "phflux_Lya", "vol",
]


def host(a):
    """A tensor (on any device) or array as a numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def iter_table(model):
    """Collect the per-cell state of a DiskModel into a dict of arrays."""
    g = model.grid
    f = model.fields
    out = {
        "rmin": g.rmin, "rmax": g.rmax, "zmin": g.zmin, "zmax": g.zmax,
        "using": g.using, "n_gas": g.n0, "Tgas": model.Tgas,
        "Tdust": model.Tdust, "Tdusts": model.Tdusts,
        "quality": model.quality, "vol": model.vol,
        "abundances": model.X,
        "species": np.array(model.net.species),
    }
    if f is not None:
        for k in ("flux_UV", "flux_Lya", "flux_Vis", "flux_NIR",
                  "flux_MIR", "flux_FIR", "phflux_Lya", "Av_toStar",
                  "G0_UV_toStar", "G0_UV_H2phd"):
            out[k] = host(getattr(f, k))
        out["zeta_X"] = host(f.zeta_Xray)
    if getattr(model, "_shield", None) is not None:
        out["Ncol_toISM"] = host(model._shield.Ncol_toISM)
        out["Ncol_toStar"] = host(model._shield.Ncol_toStar)
    return out


def save_iter_npz(path, model, iiter=0):
    data = iter_table(model)
    data["iiter"] = np.array(iiter)
    # per-iteration SED collector persistence (reference
    # save_collected_photons_iter, montecarlo.f90:2084-2097): mu x lam
    # escaped-energy bins plus the image-plane (mu, r, phi, lam) sub-bins
    if getattr(model, "tallies", None) is not None:
        data["collector"] = host(model.tallies.collector)
        data["collector_img"] = host(model.tallies.collector_img)
        data["collector_lam"] = host(model.tab.lam)
    np.savez_compressed(path, **data)


def load_iter_npz(path):
    with np.load(path, allow_pickle=False) as d:
        return {k: d[k] for k in d.files}


def save_iter_ascii(path, model, iiter=0, species=None):
    """ASCII table, one row per cell (subset of abundance columns unless
    `species` lists names or is "all")."""
    t = iter_table(model)
    names = list(t["species"])
    if species is None:
        species = ["H2", "H", "E-", "C", "C+", "O", "CO", "H2O", "OH",
                   "gH2O", "gCO"]
    elif species == "all":
        species = names
    cols = ["rmin", "rmax", "zmin", "zmax", "n_gas", "Tgas", "Tdust",
            "quality"]
    cols = [cc for cc in cols if cc in t]
    extra = [cc for cc in ("Av_toStar", "G0_UV_toStar", "phflux_Lya",
                           "zeta_X", "Ncol_toISM", "Ncol_toStar")
             if cc in t]
    header = "! iter %d\n!%15s" % (iiter, cols[0])
    for cc in cols[1:] + extra + species:
        header += "%16s" % cc
    flat = {cc: np.asarray(t[cc]).reshape(-1) for cc in cols + extra}
    X = t["abundances"]
    sidx = [names.index(s) for s in species]
    with open(path, "w") as fh:
        fh.write(header + "\n")
        for i in range(len(t["rmin"])):
            row = "".join("%16.6e" % float(flat[cc][i]) for cc in cols + extra)
            row += "".join("%16.6e" % X[j, i] for j in sidx)
            fh.write(row + "\n")
