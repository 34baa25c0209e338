"""Checkpoint / resume of the disk-model state.

Counterpart of the JAX package's ``checkpoint.py`` (reference:
src/data_dump.f90 — dumps of grid tree, optical, chemical and physical
per-cell data, with ``use_backup_*`` switches letting a later run resume
a stage).  The state goes into a compressed npz archive with the same
keys as the JAX package's, so that a checkpoint written by either package
loads in the other.  A consistency check (a hash of the cell bounds)
replaces the reference's check_consistency_of_loaded_data_phy
(data_dump.f90:763).  A checkpoint of another grid (an AMR-refined one)
is adopted with the grid it embeds.

For several processes, ``save_state_dist``/``load_state_dist`` take the
place of the JAX package's orbax pair (``save_state_orbax``/
``load_state_orbax``): the same keys, written with
``torch.distributed.checkpoint`` (which ships with torch) by every rank of
the process group together, or by one process alone.
"""

from __future__ import annotations

import hashlib
import pathlib

import numpy as np
import torch

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
    """Restore a dumped state (X, Tgas, Tdust, Tdusts, quality, and the
    grid's densities) into a prepared DiskModel; returns the iteration it
    was saved at.

    restore_grid=True (default): where the checkpoint's grid differs from
    the model's (the run was AMR-refined) and the file embeds it, adopt
    the stored grid and rho_dust through model.adopt_grid, rebuilding the
    geometry (the reference's use_backup_grid_data restore).  With
    restore_grid=False a differing grid raises ValueError (the reference's
    consistency check, data_dump.f90:763).

    Departure from the JAX package, in the port only: on the same grid,
    the file's grid_n0, grid_using and rho_dust are restored too, and the
    per-cell quantities derived from them rebuilt.  The grid hash covers
    the cell bounds only, so a fixed-grid vertical re-balance
    (vertical.pressure_gravity_balance), which changes n0, using and
    rho_dust, leaves it as it was; the JAX package's load_state then goes
    on from the initial densities without a word.  The file format is the
    same in both packages."""
    with np.load(path) as d:
        want = _grid_hash(model.grid)
        got = bytes(d["grid_hash"].tobytes()).hex()
        if got != want:
            if restore_grid and "grid_rmin" in d.files:
                from .models.grid import Grid
                model.adopt_grid(
                    Grid(**{k: d[f"grid_{k}"] for k in _GRID_FIELDS}),
                    rho_dust=d["rho_dust"] if "rho_dust" in d.files
                    else None)
            elif check_consistency:
                raise ValueError(
                    f"checkpoint grid hash {got} != current grid "
                    f"{want}; refusing to restore onto a different grid")
        elif {"grid_n0", "grid_using", "rho_dust"} <= set(d.files):
            n0, using, rho_dust = d["grid_n0"], d["grid_using"], d["rho_dust"]
            # the derived state (and the shielding cache) goes stale only
            # where the densities differ
            if not (np.array_equal(n0, model.grid.n0)
                    and np.array_equal(using, model.grid.using)
                    and np.array_equal(rho_dust, model.rho_dust)):
                model.grid.n0 = n0
                model.grid.using = using
                model.rho_dust = rho_dust
                model._derive_cell_state()
        model.X = d["X"]
        model.Tgas = d["Tgas"]
        model.Tdust = d["Tdust"]
        model.Tdusts = d["Tdusts"]
        model.quality = d["quality"]
        return int(d["iiter"])


def _dist_state(model, iiter):
    """The state of save_state_dist: the orbax pair's keys and the grid's
    `using` (load_state_dist restores the densities as load_state does),
    as CPU tensors."""
    a = dict(grid_hash=np.frombuffer(bytes.fromhex(_grid_hash(model.grid)),
                                     dtype=np.uint8),
             iiter=np.array(iiter, dtype=np.int64),
             X=model.X, Tgas=model.Tgas, Tdust=model.Tdust,
             Tdusts=model.Tdusts, quality=model.quality, n0=model.grid.n0,
             rho_dust=model.rho_dust, using=model.grid.using)
    return {k: torch.from_numpy(np.array(v)) for k, v in a.items()}


def save_state_dist(path, model, iiter=0):
    """Write the state dict of save_state_orbax (grid_hash, iiter, X,
    Tgas, Tdust, Tdusts, quality, n0, rho_dust) and the grid's `using`
    into the directory `path` with torch.distributed.checkpoint.  In a
    process group every rank calls it with the same (replicated) state,
    and each tensor is written once; without one, the process writes
    alone."""
    import torch.distributed.checkpoint as dcp
    dcp.save(_dist_state(model, iiter),
             checkpoint_id=str(pathlib.Path(path).resolve()))


def load_state_dist(path, model, check_consistency=True):
    """Restore a save_state_dist directory into a prepared DiskModel, as
    load_state restores a checkpoint of the same grid (X, Tgas, Tdust,
    Tdusts, quality, and the grid's n0 and using with rho_dust, rebuilding
    the derived state where they differ); returns the iteration it was
    saved at.  A checkpoint of another grid raises ValueError (as
    load_state_orbax; a refined grid is restored from save_state's npz)."""
    import torch.distributed.checkpoint as dcp
    path = str(pathlib.Path(path).resolve())
    meta = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    want = _grid_hash(model.grid)
    head = {"grid_hash": torch.zeros(tuple(meta["grid_hash"].size),
                                     dtype=torch.uint8)}
    dcp.load(head, checkpoint_id=path)
    got = bytes(head["grid_hash"].numpy().tobytes()).hex()
    if got != want and check_consistency:
        raise ValueError(f"checkpoint grid hash {got} != current grid "
                         f"{want}; refusing to restore onto a different grid")
    sd = {k: torch.empty(tuple(meta[k].size), dtype=t.dtype)
          for k, t in _dist_state(model, 0).items() if k != "grid_hash"}
    dcp.load(sd, checkpoint_id=path)
    d = {k: v.numpy() for k, v in sd.items()}
    if not (np.array_equal(d["n0"], model.grid.n0)
            and np.array_equal(d["using"], model.grid.using)
            and np.array_equal(d["rho_dust"], model.rho_dust)):
        model.grid.n0 = d["n0"]
        model.grid.using = d["using"]
        model.rho_dust = d["rho_dust"]
        model._derive_cell_state()
    for k in ("X", "Tgas", "Tdust", "Tdusts", "quality"):
        setattr(model, k, d[k])
    return int(d["iiter"])
