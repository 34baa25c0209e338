"""Physics lookup tables: Neufeld cooling, Visser CO shielding, ion LUTs.

Counterpart of the JAX package's ``io/tables.py``, over the same ``.npz``
and ``.bin`` files (read in place, see ``defaults.DATA``).  Accessors take
per-lane tensors of any shape.  The interpolation semantics are the
reference accessors':
  - linear / bilinear with *edge-segment extrapolation* (reference
    src/load_Neufeld_cooling_H2O.f90:203-455 index search pattern),
  - Neufeld L0/L_LTE stored as -log10(L) (tables hold positive numbers),
  - the reference's n_12 sign convention for H2O/CO (10^-v; the H2 table
    uses 10^+v) is preserved verbatim as semantics,
  - Visser 12CO shielding: bilinear in (logN_CO, logN_H2) of log f with
    index clamping (src/load_Visser_CO_selfshielding.f90:271-310).
The expressions hardened against the f32 exponent range of the TPU's f64
emulation are kept as the JAX package wrote them, so both packages
evaluate the same formulas.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import defaults

F64 = torch.float64


def _lin_extrap(x, xs, ys):
    """1D linear interpolation, extrapolating with the edge segments."""
    n = xs.shape[0]
    s = torch.clamp(torch.searchsorted(xs, x.contiguous()), 1, n - 1)
    t = (x - xs[s - 1]) / (xs[s] - xs[s - 1])
    return ys[s - 1] + t * (ys[s] - ys[s - 1])


def _bilin_extrap(x, y, xs, ys, Z):
    """Bilinear (with cross term) on Z[nx, ny]; extrapolates at the edges
    along x (temperature) but CLAMPS y (the log10 N~ column-density axis)
    to the table range: below-table N is the optically thin limit, and an
    unclamped y from a zero column density extrapolates to 10^(+-hundreds).
    """
    nx, ny = Z.shape
    y = torch.clamp(y, ys[0], ys[-1])
    i = torch.clamp(torch.searchsorted(xs, x.contiguous()), 1, nx - 1)
    j = torch.clamp(torch.searchsorted(ys, y.contiguous()), 1, ny - 1)
    tx = (x - xs[i - 1]) / (xs[i] - xs[i - 1])
    ty = (y - ys[j - 1]) / (ys[j] - ys[j - 1])
    z11 = Z[i - 1, j - 1]
    z12 = Z[i - 1, j]
    z21 = Z[i, j - 1]
    z22 = Z[i, j]
    return (z11 * (1 - tx) * (1 - ty) + z21 * tx * (1 - ty)
            + z12 * (1 - tx) * ty + z22 * tx * ty)


def _load(name, device):
    with np.load(defaults.DATA / f"{name}.npz") as d:
        return {k: torch.as_tensor(np.asarray(v, dtype=np.float64),
                                   device=device) for k, v in d.items()}


class NeufeldParams(NamedTuple):
    L0: torch.Tensor
    L_LTE: torch.Tensor
    n_12: torch.Tensor
    alpha: torch.Tensor


class NeufeldH2:
    """H2 rotational cooling table (22 log10 T points)."""

    def __init__(self, device="cpu"):
        d = _load("neufeld_h2", device)
        self.logT = d["log10_T_s"]
        self.L0 = d["log10_L0"]
        self.L_LTE = d["log10_L_LTE"]
        self.n12 = d["log10_n_12"]
        self.alpha = d["alpha_s"]

    def params_scaled(self, T):
        """(params WITHOUT the Boltzmann factor, boltz): the exp(-509/T)
        suppression (reference load_Neufeld_cooling_H2.f90:101,112) is
        returned separately so the caller can factor it out of the
        1/L0-style division chain."""
        Tpos = torch.clamp_min(T, 1e-30)
        lt = torch.log10(Tpos)
        boltz = torch.exp(-509.0 / Tpos)
        L0 = 10.0 ** (-_lin_extrap(lt, self.logT, self.L0))
        L_LTE = 10.0 ** (-_lin_extrap(lt, self.logT, self.L_LTE))
        n12 = 10.0 ** (_lin_extrap(lt, self.logT, self.n12))
        al = torch.clamp_min(_lin_extrap(lt, self.logT, self.alpha), 0.0)
        return NeufeldParams(L0, L_LTE, n12, al), boltz

    def params(self, T):
        p, boltz = self.params_scaled(T)
        return p._replace(L0=p.L0 * boltz, L_LTE=p.L_LTE * boltz)


class NeufeldH2O:
    def __init__(self, device="cpu"):
        self.d = _load("neufeld_h2o", device)
        self.ortho, self.para = 0.75, 0.25

    def params(self, T, log10N):
        d = self.d
        lnT = torch.log(torch.clamp_min(T, 1e-30))
        hi = T >= 100.0

        def mix1(lo_o, lo_p):
            vo = _lin_extrap(T, d["T_low_ortho"], d[lo_o])
            vp = _lin_extrap(T, d["T_low_para"], d[lo_p])
            return self.ortho * vo + self.para * vp

        def mix2(lo_o, lo_p):
            vo = _bilin_extrap(lnT, log10N, torch.log(d["T_low_ortho"]),
                               d["log10N_low_ortho"], d[lo_o])
            vp = _bilin_extrap(lnT, log10N, torch.log(d["T_low_para"]),
                               d["log10N_low_para"], d[lo_p])
            return self.ortho * vo + self.para * vp

        lTh = torch.log(d["T_high"])
        v_L0 = torch.where(
            hi, _lin_extrap(lnT, lTh, d["log10_L0_high"]),
            mix1("log10_L0_low_ortho", "log10_L0_low_para"))
        v_LTE = torch.where(
            hi, _bilin_extrap(lnT, log10N, lTh, d["log10N_high"],
                              d["log10_L_LTE_high"]),
            mix2("log10_L_LTE_low_ortho", "log10_L_LTE_low_para"))
        v_n12 = torch.where(
            hi, _bilin_extrap(lnT, log10N, lTh, d["log10N_high"],
                              d["log10_n_12_high"]),
            mix2("log10_n_12_low_ortho", "log10_n_12_low_para"))
        v_al = torch.where(
            hi, _bilin_extrap(lnT, log10N, lTh, d["log10N_high"],
                              d["alpha_high"]),
            mix2("alpha_low_ortho", "alpha_low_para"))
        # reference sign convention: L -> 10^-v, n12 -> 10^-v (sic)
        return NeufeldParams(10.0 ** (-v_L0), 10.0 ** (-v_LTE),
                             10.0 ** (-v_n12), v_al)

    def vib_params(self, T, log10N):
        d = self.d
        T = torch.clamp_min(T, 1e-30)
        L0 = 1.03e-26 * T * torch.exp(-47.5 * T ** (-1.0 / 3.0) - 2325.0 / T)
        v = _bilin_extrap(torch.log(T), log10N, torch.log(d["T_high_vib"]),
                          d["log10N_high_vib"], d["log10_X_L_LTE_high_vib"])
        L_LTE = 10.0 ** (-v) * torch.exp(-2325.0 / T)
        return L0, L_LTE


class NeufeldCO:
    def __init__(self, device="cpu"):
        self.d = _load("neufeld_co", device)

    def params(self, T, log10N):
        d = self.d
        lnT = torch.log(torch.clamp_min(T, 1e-30))
        hi = T >= 100.0
        lTh = torch.log(d["T_high"])
        lTl = torch.log(d["T_low"])
        v_L0 = torch.where(
            hi, _lin_extrap(lnT, lTh, d["log10_L0_high"]),
            _lin_extrap(T, d["T_low"], d["log10_L0_low"]))
        v_LTE = torch.where(
            hi, _bilin_extrap(lnT, log10N, lTh, d["log10N_high"],
                              d["log10_L_LTE_high"]),
            _bilin_extrap(lnT, log10N, lTl, d["log10N_low"],
                          d["log10_L_LTE_low"]))
        v_n12 = torch.where(
            hi, _bilin_extrap(lnT, log10N, lTh, d["log10N_high"],
                              d["log10_n_12_high"]),
            _bilin_extrap(lnT, log10N, lTl, d["log10N_low"],
                          d["log10_n_12_low"]))
        v_al = torch.where(
            hi, _bilin_extrap(lnT, log10N, lTh, d["log10N_high"],
                              d["alpha_high"]),
            _bilin_extrap(lnT, log10N, lTl, d["log10N_low"],
                          d["alpha_low"]))
        return NeufeldParams(10.0 ** (-v_L0), 10.0 ** (-v_LTE),
                             10.0 ** (-v_n12), v_al)

    def vib_params(self, T, log10N):
        d = self.d
        T = torch.clamp_min(T, 1e-30)
        L0 = 1.83e-26 * T * torch.exp(-68.0 * T ** (-1.0 / 3.0) - 3080.0 / T)
        v = _bilin_extrap(torch.log(T), log10N, torch.log(d["T_high_vib"]),
                          d["log10N_high_vib"], d["log10_X_L_LTE_high_vib"])
        L_LTE = 10.0 ** (-v) * torch.exp(-3080.0 / T)
        return L0, L_LTE


class VisserCOShielding:
    """Visser et al. 2009 12CO photodissociation shielding factor."""

    def __init__(self, device="cpu"):
        d = _load("visser_co_shielding", device)
        self.logN_H2 = d["logN_H2"]
        self.logN_CO = d["logN_12CO"]
        self.logf = torch.log(d["f_12CO"])  # [n_CO, n_H2]

    def shielding(self, N_H2, N_CO):
        x = torch.log10(torch.clamp_min(N_CO, 1.0))
        y = torch.log10(torch.clamp_min(N_H2, 1.0))
        return torch.exp(_bilin_extrap(x, y, self.logN_CO, self.logN_H2,
                                       self.logf))


class IonCoolingLUT:
    """NII / SiII / FeII cooling: binary 2D tables in (log10 ne, log10 T)
    -> log10 Lambda (reference src/binary_array_io.f90:19-60), presampled
    through the reference's cubic spline onto a REFINE-times denser grid
    at load time so the bilinear lookup stays within <1% of the spline
    (reference src/heating_cooling.f90:832-839)."""

    REFINE = 6

    def __init__(self, path, device="cpu"):
        raw = np.fromfile(path, dtype="<f8")
        ndim = int(raw[0])
        dims = raw[1:1 + ndim].astype(int)
        nx, ny = int(dims[0]), int(dims[1])
        o = 1 + ndim
        x = raw[o:o + nx]
        y = raw[o + nx:o + nx + ny]
        val = raw[o + nx + ny:o + nx + ny + nx * ny].reshape((ny, nx)).T
        if self.REFINE > 1:
            from scipy.interpolate import RectBivariateSpline
            sp = RectBivariateSpline(x, y, val, kx=3, ky=3)
            x = np.linspace(x[0], x[-1], nx * self.REFINE)
            y = np.linspace(y[0], y[-1], ny * self.REFINE)
            val = sp(x, y)
        self.log_ne = torch.as_tensor(x, dtype=F64, device=device)
        self.log_T = torch.as_tensor(y, dtype=F64, device=device)
        self.val = torch.as_tensor(val, dtype=F64, device=device)

    def cooling_per_ion(self, ne, T):
        """10**LUT(log10 ne, log10 T), clamped at the table edges."""
        x = torch.clamp(torch.log10(torch.clamp_min(ne, 1e-300)),
                        self.log_ne[0], self.log_ne[-1])
        y = torch.clamp(torch.log10(torch.clamp_min(T, 1e-300)),
                        self.log_T[0], self.log_T[-1])
        v = _bilin_extrap(x, y, self.log_ne, self.log_T, self.val)
        return 10.0 ** v
