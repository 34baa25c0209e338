"""Hand-written CUDA kernels: build, load, check arguments, launch.

The kernels live in ``rac2d_torch/csrc/*.cu`` with a plain C interface.
At first use on a CUDA tensor they are compiled with ``nvcc`` for sm_90a
into ``build/rac2d_torch/`` at the repository root (the file name carries
a hash of the sources and flags, so an edit rebuilds) and loaded with
ctypes.  Pointers come from ``data_ptr()`` and the stream from
``torch.cuda.current_stream().cuda_stream``.

Each wrapper dispatches on the device of the tensor it is given:

- a CPU tensor runs the kernel's plain PyTorch version
  (``ops/blocklu.py``), so the CPU tests exercise the same algorithm;
- a CUDA tensor launches the kernel, or raises: a failed build, a
  refused launch (non-zero ``cudaGetLastError()``) or an argument the
  kernel does not take is an error, never a fallback.

Each wrapper counts its kernel launches in ``<wrapper>.launches``, a plain
integer that a run resets and reads to show that the main path went
through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

from . import blocklu
from .blocklu import BK, BlockLU

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build" / "rac2d_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
# compiler output of the build done by this process ("" if the library
# was already built); -Xptxas -v puts each kernel's registers, shared
# memory and spills here
build_log = ""


def _nvcc() -> str:
    cands = [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for cand in cands:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def load():
    """Build (once per source hash) and load the kernel library."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    srcs = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.read_bytes())
    so = BUILD_DIR / f"librac2d_kernels_{h.hexdigest()[:12]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {proc.returncode}):\n{' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
        build_log = proc.stdout + proc.stderr
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rac2d_blocklu_factor.argtypes = [p, p, p, p, i, i, i, p]
    lib.rac2d_blocklu_factor.restype = i
    lib.rac2d_blocklu_solve.argtypes = [p, p, p, p, p, i, i, i, p]
    lib.rac2d_blocklu_solve.restype = i
    lib.rac2d_cuda_error_string.argtypes = [i]
    lib.rac2d_cuda_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def _check(name, t, shape, device):
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: dtype {t.dtype}, the kernel takes float32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the kernel takes contiguous tensors")


def _launch(fn, *args):
    rc = fn(*args)
    if rc != 0:
        msg = _lib.rac2d_cuda_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel launch failed: {msg} ({rc})")


def _on_cuda(t, what):
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{what}: no kernel or plain version for {t.device}")


def block_lu_factor(A) -> BlockLU:
    """K1: batched blocked no-pivot LU of A[B, n, n] (float32).

    Returns BlockLU(lu[B, N, N], linv[B, K, 64, 64], uinv[B, K, 64, 64])
    with N = 64 * ceil(n / 64) (identity padding).  On a CPU tensor this is
    ``blocklu.block_lu``.
    """
    if not _on_cuda(A, "block_lu_factor"):
        return blocklu.block_lu(A)
    if A.dim() != 3 or A.shape[1] != A.shape[2] or A.shape[0] < 1:
        raise ValueError(f"block_lu_factor: A must be [B, n, n], got "
                         f"{tuple(A.shape)}")
    B, n, _ = A.shape
    N = blocklu.padded_size(n)
    K = N // BK
    _check("A", A, (B, n, n), A.device)
    lib = load()
    lu = torch.empty(B, N, N, dtype=torch.float32, device=A.device)
    linv = torch.empty(B, K, BK, BK, dtype=torch.float32, device=A.device)
    uinv = torch.empty_like(linv)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream().cuda_stream
        _launch(lib.rac2d_blocklu_factor, A.data_ptr(), lu.data_ptr(),
                linv.data_ptr(), uinv.data_ptr(), B, n, N, stream)
    block_lu_factor.launches += 1
    return BlockLU(lu=lu, linv=linv, uinv=uinv)


block_lu_factor.launches = 0


def block_lu_solve(fac: BlockLU, b):
    """K2: solve A x = b[B, n] (float32) with K1's factorization.  On a
    CPU tensor this is ``blocklu.block_lu_solve``."""
    if not _on_cuda(b, "block_lu_solve"):
        return blocklu.block_lu_solve(fac, b)
    if b.dim() != 2:
        raise ValueError(f"block_lu_solve: b must be [B, n], got "
                         f"{tuple(b.shape)}")
    B, n = b.shape
    N = fac.lu.shape[-1]
    K = N // BK
    if N != blocklu.padded_size(n):
        raise ValueError(f"block_lu_solve: n={n} does not match N={N}")
    _check("b", b, (B, n), b.device)
    _check("lu", fac.lu, (B, N, N), b.device)
    _check("linv", fac.linv, (B, K, BK, BK), b.device)
    _check("uinv", fac.uinv, (B, K, BK, BK), b.device)
    lib = load()
    x = torch.empty(B, n, dtype=torch.float32, device=b.device)
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream().cuda_stream
        _launch(lib.rac2d_blocklu_solve, fac.lu.data_ptr(),
                fac.linv.data_ptr(), fac.uinv.data_ptr(), b.data_ptr(),
                x.data_ptr(), B, n, N, stream)
    block_lu_solve.launches += 1
    return x


block_lu_solve.launches = 0


def reset_launches():
    """Set every kernel's launch count to 0."""
    block_lu_factor.launches = 0
    block_lu_solve.launches = 0
