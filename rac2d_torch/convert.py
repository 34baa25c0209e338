"""Carry built state from the JAX package into this one.

Every function takes the JAX package's objects as they are (their arrays
are read through ``numpy.asarray``, so nothing here imports JAX) and
returns this package's counterpart on ``device``.  The parity tests use
them to feed both packages identical tables and environments.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .io.umist import ChemNet
from .ops import columns, fields, geometry, mcrt, optics
from .ops.network import Incidence
from .ops.rates import CellEnv, RateTables
from .ops.thermal import HcConfig, ThermalBalance, ThermalEnv


def _tensor(v, device):
    a = np.array(v)      # a writable host copy
    if a.dtype.kind == "f":
        a = a.astype(np.float64)
    return torch.as_tensor(a, device=device)


def _namedtuple(src, cls, device):
    """cls(...) with every array field of src as a tensor on device; int
    fields (static metadata) stay ints."""
    out = {}
    for f in cls._fields:
        v = getattr(src, f)
        out[f] = int(v) if isinstance(v, (int, np.integer)) \
            else _tensor(v, device)
    return cls(**out)


def chem_net(net) -> ChemNet:
    """The JAX package's ChemNet (numpy arrays) as this package's."""
    return ChemNet(**{f.name: getattr(net, f.name)
                      for f in dataclasses.fields(ChemNet)})


def rate_tables(tab, device="cuda") -> RateTables:
    return _namedtuple(tab, RateTables, device)


def incidence(inc, device="cuda") -> Incidence:
    return _namedtuple(inc, Incidence, device)


def cell_env(env, device="cuda") -> CellEnv:
    """A CellEnv with any leading lane axes (0-d fields for one cell)."""
    return _namedtuple(env, CellEnv, device)


def thermal_env(tenv, device="cuda") -> ThermalEnv:
    return _namedtuple(tenv, ThermalEnv, device)


def thermal_balance(tb, device="cuda") -> ThermalBalance:
    """A ThermalBalance with the JAX object's configuration and its
    lookup tables and reaction-heat arrays (copied, not reloaded)."""
    cfg = HcConfig(**dataclasses.asdict(tb.cfg))
    out = ThermalBalance(chem_net(tb.net), cfg, device=device)

    def t(v):
        return _tensor(v, device)

    for name in ("logT", "L0", "L_LTE", "n12", "alpha"):
        setattr(out.neufeld_h2, name, t(getattr(tb.neufeld_h2, name)))
    out.neufeld_h2o.d = {k: t(v) for k, v in tb.neufeld_h2o.d.items()}
    out.neufeld_co.d = {k: t(v) for k, v in tb.neufeld_co.d.items()}
    for lut in ("lut_NII", "lut_SiII", "lut_FeII"):
        for name in ("log_ne", "log_T", "val"):
            setattr(getattr(out, lut), name,
                    t(getattr(getattr(tb, lut), name)))
    for name in ("heat_idx", "heat_reac1", "heat_reac2", "heat_val",
                 "pos_charge"):
        if hasattr(tb, name):
            setattr(out, name, t(getattr(tb, name)))
    out.i_gH63 = int(tb.i_gH63)
    return out


def mc_tables(tab) -> optics.McTables:
    """The JAX package's McTables (host numpy) as this package's."""
    seg = optics.LamSeg(*(np.array(v) if np.ndim(v) else v
                          for v in tab.lam_seg))
    return optics.McTables(*(np.array(v) for v in tab[:-1]), lam_seg=seg)


def grid_index(gi, device="cuda") -> geometry.GridIndex:
    """GridIndex with the same tables (f32 packed ones stay f32)."""
    out = {}
    for f in geometry.GridIndex._fields:
        v = getattr(gi, f)
        if v is None or isinstance(v, (int, float)):
            out[f] = v
        else:
            a = np.array(v)
            out[f] = torch.as_tensor(a, device=device)
    return geometry.GridIndex(**out)


def mc_cells(cells, device="cuda") -> mcrt.McCells:
    return _namedtuple(cells, mcrt.McCells, device)


def packets(pk, device="cuda") -> mcrt.Packets:
    """Packets with float32/int32 arrays; the uint32 RNG words keep
    their bits as int32."""
    out = {}
    for f in mcrt.Packets._fields:
        a = np.array(getattr(pk, f))
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        out[f] = torch.as_tensor(a, device=device)
    return mcrt.Packets(**out)


def mc_tallies(t, device="cuda") -> mcrt.McTallies:
    """McTallies in the dtype the JAX object has (f32 during a pass)."""
    return mcrt.McTallies(*(torch.as_tensor(np.array(v), device=device)
                            for v in t))


def path_matrix(W, device="cuda") -> columns.PathMatrix:
    """A PathMatrix with the same COO entries (int64 rows/cols, float64
    w, in the same order)."""
    return columns.PathMatrix(
        rows=torch.as_tensor(np.array(W.rows, dtype=np.int64), device=device),
        cols=torch.as_tensor(np.array(W.cols, dtype=np.int64), device=device),
        w=torch.as_tensor(np.array(W.w, dtype=np.float64), device=device),
        n_cells=int(W.n_cells))


def model_grid(jmodel, model):
    """Carry a JAX DiskModel's grid (every array the checkpoint embeds) and
    rho_dust into a prepared DiskModel of this package, in place, through
    its adopt_grid: the geometry (grid index, path matrices) is rebuilt on
    the model's device, so that both packages go on from the same
    rebalanced or refined grid.  The evolving state follows with
    model_state.  Returns the model."""
    from .checkpoint import _GRID_FIELDS
    from .models.grid import Grid
    model.adopt_grid(
        Grid(**{k: np.array(getattr(jmodel.grid, k)) for k in _GRID_FIELDS}),
        rho_dust=np.array(jmodel.rho_dust, dtype=np.float64))
    return model


def model_state(jmodel, model):
    """Carry a prepared JAX DiskModel's evolving state into a prepared
    DiskModel of this package on the same grid, in place: X, Tgas,
    Tdust, Tdusts and quality (host arrays), and the MC tallies and
    radiation fields (on the model's device).  Returns the model."""
    if jmodel.grid.n_cells != model.grid.n_cells:
        raise ValueError(f"grids differ: {jmodel.grid.n_cells} cells, "
                         f"{model.grid.n_cells} here")
    for name in ("X", "Tgas", "Tdust", "Tdusts"):
        setattr(model, name, np.array(getattr(jmodel, name),
                                      dtype=np.float64))
    model.quality = np.array(jmodel.quality, dtype=np.int64)
    model.tallies = mc_tallies(jmodel.tallies, model.device)
    model.fields = _namedtuple(jmodel.fields, fields.RadiationFields,
                               model.device)
    model.mc_counts = dict(jmodel.mc_counts)
    return model
