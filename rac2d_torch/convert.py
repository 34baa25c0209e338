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


def rate_tables(tab, device="cpu") -> RateTables:
    return _namedtuple(tab, RateTables, device)


def incidence(inc, device="cpu") -> Incidence:
    return _namedtuple(inc, Incidence, device)


def cell_env(env, device="cpu") -> CellEnv:
    """A CellEnv with any leading lane axes (0-d fields for one cell)."""
    return _namedtuple(env, CellEnv, device)


def thermal_env(tenv, device="cpu") -> ThermalEnv:
    return _namedtuple(tenv, ThermalEnv, device)


def thermal_balance(tb, device="cpu") -> ThermalBalance:
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
