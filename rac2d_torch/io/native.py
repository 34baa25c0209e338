"""ctypes binding of the native host-side path tracer.

Counterpart of the JAX package's ``io/native.py``.  The source is the
repository's ``native/pathtrace.cpp``; it is built with ``g++ -O3 -shared
-fPIC`` (the JAX package's flags) into ``build/rac2d_torch/``, once per
hash of source and flags, and loaded with ctypes.  A missing compiler or a
failed build raises with the compiler's output: the pure-Python trace in
``ops/columns.py`` runs only when the caller asks for it
(``use_native=False``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent.parent
SRC = ROOT / "native" / "pathtrace.cpp"
BUILD_DIR = ROOT / "build" / "rac2d_torch"
# no -march=native: FMA contraction could change the last bits of w
# against the JAX package's library
FLAGS = ["-O3", "-shared", "-fPIC"]

_lib = None


def get_lib():
    """Build (once per hash of source and flags) and load the library."""
    global _lib
    if _lib is not None:
        return _lib
    h = hashlib.sha1(" ".join(FLAGS).encode())
    h.update(SRC.read_bytes())
    so = BUILD_DIR / f"libpathtrace_{h.hexdigest()[:12]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(
            f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = ["g++", *FLAGS, str(SRC), "-o", str(tmp)]
        try:
            out = subprocess.run(cmd, capture_output=True, text=True)
        except FileNotFoundError as e:
            raise RuntimeError(
                "g++ not found: the native path tracer cannot be built "
                "(use_native=False runs the Python trace)") from e
        if out.returncode != 0:
            raise RuntimeError(f"g++ failed (exit {out.returncode}):\n"
                               f"{' '.join(cmd)}\n{out.stdout}{out.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.trace_path_matrix.restype = ctypes.c_int64
    _lib = lib
    return lib


def _host(a, dtype):
    """A contiguous host numpy copy of a tensor or array."""
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    return np.ascontiguousarray(np.asarray(a), dtype=dtype)


def _p(a, t):
    return a.ctypes.data_as(ctypes.POINTER(t))


def trace_path_matrix(grid, gi, to_ism: bool, max_entries=None):
    """COO (rows, cols, w_AU) of per-cell rays toward the star or the ISM.

    gi: a GridIndex (tensors on any device, or host arrays)."""
    lib = get_lib()
    n = grid.n_cells
    if max_entries is None:
        max_entries = 64 * n + 100000
    f64 = np.float64
    r_edges = _host(gi.r_edges, f64)
    z_edges = _host(gi.z_edges, f64)
    cell_of = _host(gi.cell_of, np.int32)
    rmin, rmax = _host(grid.rmin, f64), _host(grid.rmax, f64)
    zmin, zmax = _host(grid.zmin, f64), _host(grid.zmax, f64)
    um = _host(grid.using, np.uint8)
    rows = np.empty(max_entries, dtype=np.int64)
    cols = np.empty(max_entries, dtype=np.int64)
    w = np.empty(max_entries, dtype=np.float64)
    dbl = ctypes.c_double
    n_out = lib.trace_path_matrix(
        ctypes.c_int64(n),
        _p(rmin, dbl), _p(rmax, dbl), _p(zmin, dbl), _p(zmax, dbl),
        _p(um, ctypes.c_uint8),
        _p(r_edges, dbl), _p(z_edges, dbl), _p(cell_of, ctypes.c_int32),
        ctypes.c_int64(z_edges.shape[0]), ctypes.c_int64(cell_of.shape[1]),
        dbl(float(gi.rmin_dom)), dbl(float(gi.rmax_dom)),
        dbl(float(gi.zmax_dom)), dbl(0.0), dbl(0.0),
        ctypes.c_int32(1 if to_ism else 0), ctypes.c_int64(max_entries),
        _p(rows, ctypes.c_int64), _p(cols, ctypes.c_int64), _p(w, dbl))
    if n_out < 0:
        return trace_path_matrix(grid, gi, to_ism, max_entries * 4)
    return rows[:n_out], cols[:n_out], w[:n_out]
