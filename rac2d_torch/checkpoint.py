"""Checkpoint / resume of the disk-model state.

Counterpart of the JAX package's ``checkpoint.py`` (reference:
src/data_dump.f90 — dumps of grid tree, optical, chemical and physical
per-cell data, with ``use_backup_*`` switches letting a later run resume
a stage).  The state goes into a compressed npz archive with the same
keys as the JAX package's, so that a checkpoint written by either package
loads in the other.  A consistency check (a hash of the cell bounds)
replaces the reference's check_consistency_of_loaded_data_phy
(data_dump.f90:763).

Not ported: adopting a checkpoint's embedded AMR-refined grid
(``restore_grid=True`` on a grid that differs; AMR is not ported), and
the JAX package's orbax checkpoints for multi-host state.
"""

from __future__ import annotations

import hashlib

import numpy as np

from .models.output import host


def _grid_hash(grid):
    h = hashlib.sha256()
    for a in (grid.rmin, grid.rmax, grid.zmin, grid.zmax):
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


_GRID_FIELDS = ("rmin", "rmax", "zmin", "zmax", "using", "n0", "col_id",
                "col_ptr", "col_cells", "nb_above_ptr", "nb_above",
                "nb_below_ptr", "nb_below", "nb_inner_ptr", "nb_inner",
                "nb_outer_ptr", "nb_outer", "surf_cells", "bott_cells")


def save_grid(path, grid):
    np.savez_compressed(path, **{k: getattr(grid, k) for k in _GRID_FIELDS})


def load_grid(path):
    from .models.grid import Grid
    with np.load(path) as d:
        return Grid(**{k: d[k] for k in d.files})


def save_state(path, model, iiter=0):
    """Dump the evolving state of a models.driver.DiskModel, with its grid
    embedded (grid_* keys)."""
    data = dict(
        grid_hash=np.frombuffer(
            bytes.fromhex(_grid_hash(model.grid)), dtype=np.uint8),
        iiter=np.array(iiter),
        X=model.X, Tgas=model.Tgas, Tdust=model.Tdust,
        Tdusts=model.Tdusts, quality=model.quality,
        n0=model.grid.n0, rho_dust=model.rho_dust)
    data.update({f"grid_{k}": getattr(model.grid, k)
                 for k in _GRID_FIELDS})
    if model.fields is not None:
        data.update({k: host(getattr(model.fields, k)) for k in (
            "flux", "zeta_Xray", "Av_toStar", "G0_UV_toStar",
            "phflux_Lya")})
    if hasattr(model, "tallies"):
        data.update(en_gain=host(model.tallies.en_gain),
                    collector=host(model.tallies.collector))
    np.savez_compressed(path, **data)


def load_state(path, model, check_consistency=True, restore_grid=True):
    """Restore a dumped state (X, Tgas, Tdust, Tdusts, quality) into a
    prepared DiskModel; returns the iteration it was saved at.

    A checkpoint of another grid raises ValueError with restore_grid=False
    (the reference's consistency check, data_dump.f90:763), and
    NotImplementedError with restore_grid=True when the file embeds its
    grid: adopting it is AMR's restore, not ported yet."""
    with np.load(path) as d:
        want = _grid_hash(model.grid)
        got = bytes(d["grid_hash"].tobytes()).hex()
        if got != want:
            if restore_grid and "grid_rmin" in d.files:
                raise NotImplementedError(
                    f"checkpoint grid hash {got} != current grid {want}: "
                    "adopting the checkpoint's grid (AMR, queue item 9c) "
                    "is not ported yet")
            if check_consistency:
                raise ValueError(
                    f"checkpoint grid hash {got} != current grid "
                    f"{want}; refusing to restore onto a different grid")
        model.X = d["X"]
        model.Tgas = d["Tgas"]
        model.Tdust = d["Tdust"]
        model.Tdusts = d["Tdusts"]
        model.quality = d["quality"]
        return int(d["iiter"])
