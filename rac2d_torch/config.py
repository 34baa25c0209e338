"""Single-file model configuration.

Counterpart of the JAX package's ``config.py``: the same TOML sections and
keys, each landing in the field of the same name of this package's
DiskConfig with the JAX package's default; unknown keys raise KeyError.
Data-file names resolve against the config file's directory, the working
directory and the shipped data directory, read in place.

Role of the reference's Fortran-namelist configure.dat (reference:
src/configure.f90:20-94 ``config_do`` reading 10 namelist groups;
annotated example in the reference README).  Here the configuration is a
single TOML file with one table per subsystem; unknown keys raise, like
Fortran namelists would.

Example:

    [star]
    mass = 0.6
    T = 4000.0
    spectrum_file = "tw_hya_spec_combined.dat"

    [disk]
    Md = 0.05
    rin = 1.0
    rout = 200.0

    [grid]
    ncol = 120

    [[dust]]
    opti_files = ["silicate_draine.opti"]
    weights = [1.0]
    d2g_mass = 0.01

    [chemistry]
    t_max = 1e6

    [montecarlo]
    nph = 1000000

    [iteration]
    n_iter = 8
"""

from __future__ import annotations

import dataclasses
import pathlib
import tomllib

from . import defaults
from .models import driver
from .models.density import AndrewsDisk
from .models.grid import GridConfig
from .ops.optics import McConfig


def _apply(obj, table: dict, name: str):
    fields = {f.name for f in dataclasses.fields(obj)}
    for k, v in table.items():
        if k not in fields:
            raise KeyError(f"unknown key [{name}] {k}")
        setattr(obj, k, v)
    return obj


def resolve_path(name, base: pathlib.Path | None = None):
    """Resolve a data-file name: absolute / relative to the config file /
    relative to the shipped data dir (searched recursively)."""
    if not name:
        return name
    p = pathlib.Path(name)
    if p.is_absolute() and p.exists():
        return str(p)
    if base is not None and (base / p).exists():
        return str(base / p)
    if p.exists():
        return str(p)
    hits = sorted(pathlib.Path(defaults.DATA).rglob(p.name))
    if hits:
        return str(hits[0])
    raise FileNotFoundError(
        f"data file {name!r} not found (looked in {base}, cwd, and "
        f"{defaults.DATA})")


def load_config(path: str) -> driver.DiskConfig:
    with open(path, "rb") as f:
        t = tomllib.load(f)
    base = pathlib.Path(path).resolve().parent

    cfg = driver.DiskConfig()
    star = t.get("star", {})
    cfg.star_mass = star.get("mass", cfg.star_mass)
    cfg.star_radius = star.get("radius", cfg.star_radius)
    cfg.star_T = star.get("T", cfg.star_T)
    cfg.star_spectrum_file = resolve_path(star.get("spectrum_file"), base)
    cfg.lumi_Xray = star.get("lumi_Xray", 0.0)
    cfg.T_Xray = star.get("T_Xray", 1e7)

    cfg.andrews = _apply(AndrewsDisk(), t.get("disk", {}), "disk")
    cfg.grid = _apply(GridConfig(), t.get("grid", {}), "grid")
    cfg.dust = [
        _apply(driver.DustComponent(opti_files=[], weights=[]), d, "dust")
        for d in t.get("dust", [])]
    for d in cfg.dust:
        d.opti_files = [resolve_path(f, base) for f in d.opti_files]

    chem = t.get("chemistry", {})
    cfg.network_file = resolve_path(
        chem.get("network_file", cfg.network_file), base) \
        or defaults.NETWORK
    cfg.enthalpy_file = resolve_path(
        chem.get("enthalpy_file", cfg.enthalpy_file), base) \
        or defaults.ENTHALPIES
    cfg.init_abundances_file = resolve_path(
        chem.get("init_abundances_file", cfg.init_abundances_file), base) \
        or defaults.INIT_ABUNDANCES
    cfg.h2o_cross_file = resolve_path(chem.get("h2o_cross_file"), base) \
        or defaults.H2O_PHOTOXS
    for k in ("t_max", "dt_first", "ratio_tstep", "rtol_chem", "atol_chem",
              "evolT", "nlocal_iter", "chem_chunk",
              "max_steps_per_interval", "chunk_wall_s"):
        if k in chem:
            setattr(cfg, k, chem[k])

    mc = dict(t.get("montecarlo", {}))
    for k in ("n_mc_passes", "maxw"):
        if k in mc:
            setattr(cfg, k, mc.pop(k))
    cfg.mc = _apply(McConfig(), mc, "montecarlo")
    cfg.nph_per_pass = cfg.mc.nph

    it = t.get("iteration", {})
    for k in ("n_iter", "rtol_abun", "atol_abun", "converged_fraction",
              "UV_G0_background", "zeta_cosmicray_H2", "base_alpha",
              "minimum_Tdust", "dust_depletion",
              "do_vertical_with_Tdust", "n_vert_iter_tdust",
              "do_vertical_every", "disk_gas_mass_preset", "vertical_moving",
              "calc_zetaXray_from_Ncol", "shard_chemistry", "chem_stream",
              "do_refine", "do_merge", "refine_watch_species",
              "refine_watch_file", "refine_threshold", "merge_tol"):
        if k in it:
            setattr(cfg, k, it[k])

    if "depletion" in t:
        from .models.depletion import DepletionConfig, ElementDepletion
        d = dict(t["depletion"])
        dep = DepletionConfig()
        for ele in ("o", "c"):
            if ele in d:
                setattr(dep, ele, _apply(ElementDepletion(), d.pop(ele),
                                         f"depletion.{ele}"))
        _apply(dep, d, "depletion")
        cfg.depletion = dep

    if "heating_cooling" in t:
        from .ops.thermal import HcConfig
        hc = t["heating_cooling"]
        fields = {f.name for f in dataclasses.fields(HcConfig)}
        bad = set(hc) - fields
        if bad:
            raise KeyError(f"unknown key [heating_cooling] {bad}")
        cfg.hc = HcConfig(**hc)
    return cfg


def load_extras(path: str) -> dict:
    """Non-DiskConfig sections: [output], [continuum], [[lines]] — the
    imaging/output stages of the reference's second invocation
    (src/main.f90:66-105)."""
    with open(path, "rb") as f:
        t = tomllib.load(f)
    base = pathlib.Path(path).resolve().parent
    out = dict(t.get("output", {}))
    if "continuum" in t:
        out["continuum"] = t["continuum"]
    if "lines" in t:
        out["lines"] = t["lines"]
        for ln in out["lines"]:
            if "mol_file" in ln:
                ln["mol_file"] = resolve_path(ln["mol_file"], base)
    if "analysis" in t:
        out["analysis"] = t["analysis"]
    return out
