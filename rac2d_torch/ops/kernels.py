"""Hand-written CUDA kernels: build, load, check arguments, launch.

The kernels live in ``rac2d_torch/csrc/*.cu`` with a plain C interface:
K1/K2 (blocked LU factor and solve) in ``blocklu.cu``, K3/K4 (the Monte
Carlo packet walk and the terminal tally fold) in ``mcwalk.cu``.  At
first use on a CUDA tensor each source is compiled with ``nvcc`` for
sm_90a into its own library in ``build/rac2d_torch/`` at the repository
root (the file name carries a hash of the source and flags, so an edit
rebuilds; the nvcc runs go in parallel) and loaded with ctypes.  Pointers come from ``data_ptr()`` and the stream from
``torch.cuda.current_stream().cuda_stream``.

Each wrapper dispatches on the device of the tensor it is given:

- a CPU tensor runs the kernel's plain PyTorch version
  (``ops/blocklu.py``, ``ops/mcrt.py``), so the CPU tests exercise the
  same algorithm;
- a CUDA tensor launches the kernel, or raises: a failed build, a
  refused launch (non-zero ``cudaGetLastError()``) or an argument the
  kernel does not take is an error, never a fallback.

Each wrapper counts its kernel launches in ``<wrapper>.launches``, a plain
integer that a run resets and reads to show that the main path went
through the kernel.

K3 and K4 run many times a Monte Carlo pass on tables and tallies that do
not change within it, so each has a launch object built once a pass
(``WalkLaunch``, ``FoldLaunch``: the static checks and the ctypes struct)
that a call only patches with the packets' pointers before it launches;
``mc_walk`` and ``fold_terminal`` build one for a single call.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
import types

import torch

from . import blocklu
from .blocklu import BK, BlockLU

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build" / "rac2d_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# per-source additions: the walk keeps every f32 product and sum
# separately rounded, as the plain version's elementwise ops do (no FMA
# contraction), so the two draw the same decisions on nearly every lane
EXTRA_FLAGS = {"mcwalk.cu": ["--fmad=false"]}

_lib = None
# compiler output of the builds done by this process ("" if the libraries
# were already built); -Xptxas -v puts each kernel's registers, shared
# memory and spills here
build_log = ""

_P, _I = ctypes.c_void_p, ctypes.c_int
# exported C functions: (argtypes, restype)
_FUNCS = {
    "rac2d_blocklu_factor": ([_P, _P, _P, _P, _I, _I, _I, _P], _I),
    "rac2d_blocklu_solve": ([_P, _P, _P, _P, _P, _I, _I, _I, _P], _I),
    "rac2d_cuda_error_string": ([_I], ctypes.c_char_p),
    "rac2d_mc_walk": ([_P, _P], _I),
    "rac2d_mc_walk_plan": ([_P, _P], _I),
    "rac2d_fold_terminal": ([_P, _P], _I),
    "rac2d_fold_terminal_plan": ([_P, _P], _I),
}


def _nvcc() -> str:
    cands = [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for cand in cands:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _build(sources, defines=()):
    """Compile each source (once per hash of source and flags) into its
    own library in BUILD_DIR, all nvcc runs started together.  Returns
    (library paths, compiler output of the builds done here)."""
    jobs = []
    for src in sources:
        flags = NVCC_FLAGS + EXTRA_FLAGS.get(src.name, []) \
            + [f"-D{d}" for d in defines]
        h = hashlib.sha1(" ".join(flags).encode())
        h.update(src.read_bytes())
        so = BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:12]}.so"
        proc = tmp = cmd = None
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(
                f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
            cmd = [_nvcc(), *flags, "-o", str(tmp), str(src)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
        jobs.append((so, tmp, cmd, proc))
    logs, failed = [], []
    for so, tmp, cmd, proc in jobs:
        if proc is None:
            continue
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed (exit {proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{out}")
        else:
            os.replace(tmp, so)
            logs.append(out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return [so for so, *_ in jobs], "".join(logs)


def _bind(paths):
    """The exported functions of _FUNCS found in the libraries."""
    funcs = {}
    for so in paths:
        dll = ctypes.CDLL(str(so))
        for name, (argtypes, restype) in _FUNCS.items():
            fn = getattr(dll, name, None)
            if fn is not None:
                fn.argtypes = argtypes
                fn.restype = restype
                funcs[name] = fn
    return types.SimpleNamespace(**funcs)


def load():
    """Build (once per source hash) and load the kernel libraries: one
    shared library per source, all nvcc runs started together."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    paths, build_log = _build(sorted(CSRC.glob("*.cu")))
    lib = _bind(paths)
    missing = set(_FUNCS) - set(vars(lib))
    if missing:
        raise RuntimeError(f"kernel libraries lack {sorted(missing)}")
    _lib = lib
    return _lib


def load_stage_timers():
    """mcwalk.cu built with -DRAC2D_K3_STAGES (K3 with clock() timers
    around each stage of its step) into a library of its own.  Returns
    (its functions, the path of the library, the compiler output)."""
    load()          # the error-string helper and the plain build
    paths, log = _build([CSRC / "mcwalk.cu"], ["RAC2D_K3_STAGES"])
    return _bind(paths), paths[0], log


def _check(name, t, shape, device, dtype=torch.float32):
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, the kernel takes {dtype}")
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


# --------------------------------------------------------------------
# K3/K4: the Monte Carlo walk and terminal fold (csrc/mcwalk.cu).  The C
# structs WalkArgs/FoldArgs there list the same fields in the same order.

MAX_DUST = 4      # dust components the walk kernel keeps in registers
# the stages of K3's step that a build with RAC2D_K3_STAGES times with
# clock() (csrc/mcwalk.cu StageClock), in the order of the step
K3_STAGE_NAMES = ("draws", "cell row", "exit", "optics+Lya", "event",
                  "direction+wavelength", "locate", "tallies", "MRW+update",
                  "lane in/out", "idle")
K3_STAGES = len(K3_STAGE_NAMES)


def _struct(name, fields):
    ctype = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float,
             "d": ctypes.c_double, "i3": ctypes.c_int * 3,
             "f3": ctypes.c_float * 3, "d3": ctypes.c_double * 3}
    return type(name, (ctypes.Structure,), {"_fields_": [
        (n, ctype[t]) for t, names in fields for n in names.split()]})


_WalkArgs = _struct("WalkArgs", [
    ("p", "x y z vx vy vz lam en tau cell status e_count rs0 rs1 rs2 rs3 "
          "cellmat tabmat lya_pair reemit_lam mrw_lnx r_lut_pack zc_pack "
          "flux mrw_path phc en_gain_abso cr_count dir_flux counters "
          "stage_clk"),
    ("i", "B max_steps n_cells nlam n_dust C K nT n_quantile n_mrw n_tlya "
          "n_lut ncol max_nz nmax_encounter use_mrw save_counts save_dir"),
    ("i3", "seg_i0 seg_n"),
    ("i", "lya_i0 lya_n2"),
    ("f", "lam_lo lam_hi xr_lo xr_hi lnT0 inv_dlnT td_cold lnT_lo_lya "
          "inv_dlnT_lya mrw_gamma mrw_lam_min star_k r_lut_log0 r_lut_inv_d "
          "rmin_dom rmax_dom zmax_dom"),
    ("f3", "seg_log0 seg_inv_d"),
    ("f", "b_mid b_lya b_high lya_a lya_inv_d lya_K lam0 lya_xmin"),
])

_FoldArgs = _struct("FoldArgs", [
    ("p", "x y z vx vy vz lam en cell status collector collector_img "
          "ab_en_water fates"),
    ("d3", "seg_log0 seg_inv_d"),
    ("d", "b_mid b_lya b_high"),
    ("i", "B nlam n_mu n_r n_phi n_cells"),
    ("i3", "seg_i0 seg_n"),
    ("i", "lya_i0 lya_n2"),
    ("f", "lya_a lya_inv_d lya_K lam0 lya_xmin r0 log_ratio"),
])

_PK_F32 = ("x", "y", "z", "vx", "vy", "vz", "lam", "en", "tau")
_PK_I32 = ("cell", "status", "e_count", "rs0", "rs1", "rs2", "rs3")
_FOLD_PK = ("x", "y", "z", "vx", "vy", "vz", "lam", "en", "cell", "status")
FOLD_V = 2        # lanes a K4 thread takes at a time (csrc/mcwalk.cu)
_WALK_TALLIES = ("flux", "mrw_path", "phc", "en_gain_abso", "cr_count",
                 "dir_flux")
_FOLD_TALLIES = ("collector", "collector_img", "ab_en_water")


_PK_DTYPE = {f: torch.float32 for f in _PK_F32}
_PK_DTYPE.update({f: torch.int32 for f in _PK_I32})


def _check_packets(pk, device, fields=_PK_F32 + _PK_I32):
    """B, after checking the fields' device, dtype, shape [B] and
    contiguity (a quick test first; _check words the error)."""
    B = pk.x.shape[0]
    shape = (B,)
    for f in fields:
        t = getattr(pk, f)
        if t.dtype is not _PK_DTYPE[f] or t.shape != shape \
                or not t.is_contiguous() or t.device != device:
            _check(f"packets.{f}", t, shape, device, _PK_DTYPE[f])
    return B


def _seg_fields(seg, cast):
    """The lambda-segment constants shared by WalkArgs and FoldArgs;
    cast is float32 rounding for the walk and float for the fold."""
    from .optics import f32
    return dict(
        seg_log0=[cast(v) for v in seg.log0],
        seg_inv_d=[cast(v) for v in seg.inv_d],
        b_mid=cast(seg.b_mid), b_lya=cast(seg.b_lya),
        b_high=cast(seg.b_high),
        seg_i0=[int(v) for v in seg.i0], seg_n=[int(v) for v in seg.n],
        lya_i0=int(seg.lya_i0), lya_n2=int(seg.lya_n2),
        lya_a=f32(seg.lya_a), lya_inv_d=f32(seg.lya_inv_d),
        lya_K=f32(seg.lya_K), lam0=f32(seg.lam0),
        lya_xmin=f32(10.0 ** seg.lya_a))


def _fill(struct, values):
    out = struct()
    for k, v in values.items():
        if isinstance(v, torch.Tensor):
            v = v.data_ptr()
        if isinstance(v, list):
            getattr(out, k)[:] = v
        else:
            setattr(out, k, v)
    return out


class _Launch:
    """What K3's and K4's launch objects share: the device, the tallies
    the struct points at, the last packets (and fate counter) written
    into it, and the host seconds spent in calls."""

    def __init__(self, device, tallies, fields):
        self.device = torch.device(device)
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"{type(self).__name__}: no kernel or plain "
                             f"version for {self.device}")
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.tallies = tallies
        self._tally_fields = fields
        self._tally_ptrs = tuple(getattr(tallies, f).data_ptr()
                                 for f in fields)
        self._pk = None
        self.host_s = 0.0

    def _same_tallies(self, tallies):
        if tallies is self.tallies:
            return
        got = tuple(getattr(tallies, f).data_ptr()
                    for f in self._tally_fields)
        if got != self._tally_ptrs:
            bad = [f for f, a, b in zip(self._tally_fields, got,
                                        self._tally_ptrs) if a != b]
            raise ValueError(f"{type(self).__name__}: tallies {bad} are not "
                             f"the tensors it was built with")

    def _packets(self, pk, fields):
        """Check a new Packets object and write its pointers and B."""
        if pk is self._pk:
            return
        B = _check_packets(pk, self.device, fields)
        args = self.args
        for f in fields:
            setattr(args, f, getattr(pk, f).data_ptr())
        args.B = B
        self._pk = pk

    def _enqueue(self, fn):
        """Launch on the current stream of the object's device."""
        idx = self.device.index
        if torch.cuda.current_device() != idx:
            with torch.cuda.device(idx):
                return self._enqueue(fn)
        # the raw stream handle: torch.cuda.current_stream() builds a
        # Stream object, a few microseconds a call
        _launch(fn, self._addr, torch._C._cuda_getCurrentRawStream(idx))


class WalkLaunch(_Launch):
    """K3's launch for one pass: built once (every static check, the
    ctypes struct with the tables, the tallies and the constants, and the
    int32 counters the kernel writes, which rac2d_mc_walk zeroes on the
    stream before each launch), then called once a chunk as
    ``launch(pk, tallies, max_steps)``: it checks a Packets object the
    first time it sees it, writes its pointers, B and max_steps, and
    launches.  Returns the number of lanes still active, a 0-d view of the
    counters, valid until the next call.  `tallies` must hold the tensors
    the object was built with.  On CPU tensors a call is
    ``mcrt._walk_plain``.  stage_clk (int64 [K3_STAGES], optional)
    receives the clock cycles of each stage of the step from a build with
    RAC2D_K3_STAGES."""

    def __init__(self, ws, tallies, nmax_encounter=200_000, use_mrw=True,
                 mrw_gamma=4.0, mrw_lam_min=1e4, save_dir=False,
                 save_counts=True, stage_clk=None):
        from . import mcrt
        from .optics import f32
        super().__init__(ws.device, tallies, _WALK_TALLIES)
        dev = self.device
        self.ws = ws
        self.kw = dict(nmax_encounter=nmax_encounter, use_mrw=use_mrw,
                       mrw_gamma=mrw_gamma, mrw_lam_min=mrw_lam_min,
                       save_dir=save_dir, save_counts=save_counts)
        gi = ws.gi
        packed = gi.r_lut_pack is not None and gi.zc_pack is not None
        if dev.type == "cuda" and not packed:
            raise ValueError("mc_walk: the kernel takes the packed locate "
                             "tables (geometry.build_grid_index)")
        if dev.type == "cuda" and ws.n_dust > MAX_DUST:
            raise ValueError(f"mc_walk: {ws.n_dust} dust components, the "
                             f"kernel takes at most {MAX_DUST}")
        n, nlam, nd = ws.n_cells, ws.nlam, ws.n_dust
        C, K = ws.cellmat.shape[1], ws.tabmat.shape[1]
        n_lut = gi.r_lut_pack.shape[0] if packed else 0
        ncol = gi.zc_pack.shape[0] if packed else 0
        max_nz = (gi.zc_pack.shape[1] - 1) // 2 if packed else 0
        checks = [
            ("cellmat", ws.cellmat, (n, C)), ("tabmat", ws.tabmat, (nlam, K)),
            ("lya_pair", ws.lya_pair, (nlam * mcrt.N_TLYA, 2)),
            ("reemit_lam", ws.reemit_lam, (nd * ws.nT * ws.n_quantile,)),
            ("mrw_lnx", ws.mrw_lnx, (ws.n_mrw,)),
            ("flux", tallies.flux, (n, nlam)),
            ("mrw_path", tallies.mrw_path, (n,)),
            ("phc", tallies.phc, (n, nlam)),
            ("en_gain_abso", tallies.en_gain_abso, (nd, n)),
            ("cr_count", tallies.cr_count, (n,)),
            ("dir_flux", tallies.dir_flux, (n, 3))]
        if packed:
            checks += [("r_lut_pack", gi.r_lut_pack, (n_lut, 3)),
                       ("zc_pack", gi.zc_pack, (ncol, 2 * max_nz + 1))]
        for name, t, shape in checks:
            _check(name, t, shape, dev)
        if stage_clk is not None:
            _check("stage_clk", stage_clk, (K3_STAGES,), dev, torch.int64)
        self.counters = torch.zeros(2, dtype=torch.int32, device=dev)
        self._n_active = self.counters[0]
        vals = dict(
            cellmat=ws.cellmat, tabmat=ws.tabmat, lya_pair=ws.lya_pair,
            reemit_lam=ws.reemit_lam, mrw_lnx=ws.mrw_lnx,
            r_lut_pack=gi.r_lut_pack, zc_pack=gi.zc_pack, flux=tallies.flux,
            mrw_path=tallies.mrw_path, phc=tallies.phc,
            en_gain_abso=tallies.en_gain_abso, cr_count=tallies.cr_count,
            dir_flux=tallies.dir_flux, counters=self.counters,
            stage_clk=stage_clk,
            n_cells=n, nlam=nlam, n_dust=nd,
            C=C, K=K, nT=ws.nT, n_quantile=ws.n_quantile, n_mrw=ws.n_mrw,
            n_tlya=mcrt.N_TLYA, n_lut=n_lut, ncol=ncol, max_nz=max_nz,
            nmax_encounter=int(nmax_encounter), use_mrw=int(bool(use_mrw)),
            save_counts=int(bool(save_counts)), save_dir=int(bool(save_dir)),
            lam_lo=ws.lam_lo, lam_hi=ws.lam_hi, xr_lo=f32(ws.xr_lo),
            xr_hi=f32(ws.xr_hi), lnT0=ws.lnT0, inv_dlnT=ws.inv_dlnT,
            td_cold=ws.td_cold, lnT_lo_lya=ws.lnT_lo_lya,
            inv_dlnT_lya=ws.inv_dlnT_lya, mrw_gamma=f32(mrw_gamma),
            mrw_lam_min=f32(mrw_lam_min),
            star_k=f32(mcrt.DOPPLER_K * ws.star_mass),
            r_lut_log0=f32(gi.r_lut_log0), r_lut_inv_d=f32(gi.r_lut_inv_d),
            rmin_dom=f32(gi.rmin_dom), rmax_dom=f32(gi.rmax_dom),
            zmax_dom=f32(gi.zmax_dom))
        vals.update(_seg_fields(ws.seg, f32))
        self.args = _fill(_WalkArgs, vals)
        self._addr = ctypes.addressof(self.args)

    def prepare(self, pk, max_steps):
        """The struct for a launch on `pk` (checked if new), no launch."""
        if max_steps < 1:
            raise ValueError(f"mc_walk: max_steps={max_steps}, at least 1")
        self._packets(pk, _PK_F32 + _PK_I32)
        self.args.max_steps = int(max_steps)
        return self.args

    def __call__(self, pk, tallies, max_steps):
        t0 = time.perf_counter()
        self._same_tallies(tallies)
        if self.device.type == "cpu":
            from . import mcrt
            out = mcrt._walk_plain(self.ws, pk, tallies, max_steps, **self.kw)
        else:
            self.prepare(pk, max_steps)
            self._enqueue(load().rac2d_mc_walk)
            mc_walk.launches += 1
            out = self._n_active
        self.host_s += time.perf_counter() - t0
        return out

    def plan(self):
        """K3's launch for the packets last prepared: threads per CTA,
        CTAs per SM, grid, registers and local memory bytes a thread,
        shared memory bytes a CTA, SMs."""
        return _plan(load().rac2d_mc_walk_plan, self._addr, WALK_PLAN_FIELDS)


def mc_walk(ws, pk, tallies, max_steps, nmax_encounter=200_000,
            use_mrw=True, mrw_gamma=4.0, mrw_lam_min=1e4, save_dir=False,
            save_counts=True):
    """K3: advance every live packet by up to max_steps walk steps, in
    place, and add the step tallies (flux and mrw_path; phc, en_gain_abso
    and cr_count with save_counts; dir_flux with save_dir) into
    `tallies`.  Returns the number of lanes still active (0-d tensor).
    One call through a WalkLaunch built for it; on a CPU tensor this is
    ``mcrt._walk_plain``."""
    launch = WalkLaunch(ws, tallies, nmax_encounter=nmax_encounter,
                        use_mrw=use_mrw, mrw_gamma=mrw_gamma,
                        mrw_lam_min=mrw_lam_min, save_dir=save_dir,
                        save_counts=save_counts)
    return launch(pk, tallies, max_steps)


mc_walk.launches = 0

WALK_PLAN_FIELDS = ("threads", "blocks_per_sm", "grid", "regs",
                    "local_bytes", "smem", "sms")
FOLD_PLAN_FIELDS = ("threads", "blocks_per_sm", "grid", "regs", "sms")


def _plan(fn, addr, fields):
    out = (ctypes.c_int * len(fields))()
    _launch(fn, addr, ctypes.addressof(out))
    return dict(zip(fields, out))


class FoldLaunch(_Launch):
    """K4's launch for one pass: built once (the static checks, the
    ctypes struct with the tallies, the image-plane constants
    (mcrt.fold_bins) and the lambda segments), then called as
    ``fold(pk, tallies, fates=None)`` at each refill, compaction and at
    the end of the pass: it checks a Packets object (and a fate counter)
    the first time it sees it, writes its pointers and B, and launches.
    With `fates` (int64 [mcrt.N_CODES] on the device) the lanes of each
    status code 0-5 are added into it, padding included.  `tallies` must hold
    the tensors the object was built with.  On CPU tensors a call is
    ``mcrt._fold_terminal_plain``."""

    def __init__(self, model, tallies, n_mu):
        from . import mcrt
        super().__init__(tallies.collector.device, tallies, _FOLD_TALLIES)
        dev = self.device
        self.model, self.n_mu = model, n_mu
        n_mu_t, nlam = tallies.collector.shape
        _, n_r, n_phi, _ = tallies.collector_img.shape
        n = tallies.ab_en_water.shape[0]
        if n_mu_t != n_mu:
            raise ValueError(f"fold_terminal: collector has {n_mu_t} mu "
                             f"bins, n_mu={n_mu}")
        for name, t, shape in (
                ("collector", tallies.collector, (n_mu, nlam)),
                ("collector_img", tallies.collector_img,
                 (n_mu, n_r, n_phi, nlam)),
                ("ab_en_water", tallies.ab_en_water, (n,))):
            _check(name, t, shape, dev)
        fb = mcrt.fold_bins(model.gi)
        vals = dict(collector=tallies.collector,
                    collector_img=tallies.collector_img,
                    ab_en_water=tallies.ab_en_water, nlam=nlam, n_mu=n_mu,
                    n_r=n_r, n_phi=n_phi, n_cells=n, r0=fb.r0,
                    log_ratio=fb.log_ratio)
        vals.update(_seg_fields(model.tab.lam_seg, float))
        self.args = _fill(_FoldArgs, vals)
        self._addr = ctypes.addressof(self.args)
        self._fates = None
        self._n_codes = mcrt.N_CODES

    def prepare(self, pk, fates=None):
        """The struct for a launch on `pk` (checked if new), no launch."""
        self._packets(pk, _FOLD_PK)
        if fates is not self._fates:
            if fates is not None:
                _check("fates", fates, (self._n_codes,), self.device,
                       torch.int64)
            self.args.fates = None if fates is None else fates.data_ptr()
            self._fates = fates
        return self.args

    def __call__(self, pk, tallies, fates=None):
        t0 = time.perf_counter()
        self._same_tallies(tallies)
        if self.device.type == "cpu":
            from . import mcrt
            mcrt._fold_terminal_plain(self.model, pk, tallies, self.n_mu,
                                      fates)
        else:
            self.prepare(pk, fates)
            self._enqueue(load().rac2d_fold_terminal)
            fold_terminal.launches += 1
        self.host_s += time.perf_counter() - t0
        return tallies

    def plan(self):
        """K4's launch for the packets last prepared: threads per CTA,
        CTAs per SM, grid, registers a thread, SMs."""
        return _plan(load().rac2d_fold_terminal_plan, self._addr,
                     FOLD_PLAN_FIELDS)


def fold_terminal(model, pk, tallies, n_mu, fates=None):
    """K4: fold the terminated lanes of a batch into the escape collector
    ([n_mu, nlam]), the image-plane bins ([n_mu, n_r, n_phi, nlam]) and
    the water deposit ([n_cells]), in place, and add the lanes of each
    status code into `fates` (int64 [mcrt.N_CODES]) if given.  One call
    through a FoldLaunch built for it; on a CPU tensor this is
    ``mcrt._fold_terminal_plain``."""
    return FoldLaunch(model, tallies, n_mu)(pk, tallies, fates)


fold_terminal.launches = 0


def reset_launches():
    """Set every kernel's launch count to 0."""
    block_lu_factor.launches = 0
    block_lu_solve.launches = 0
    mc_walk.launches = 0
    fold_terminal.launches = 0


def launch_counts():
    """Every kernel's launch count since the last reset_launches."""
    return {"K1": block_lu_factor.launches, "K2": block_lu_solve.launches,
            "K3": mc_walk.launches, "K4": fold_terminal.launches}
