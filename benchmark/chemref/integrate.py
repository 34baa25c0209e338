"""One cell's chemistry (and, with evolT, its gas temperature) integrated
by scipy's variable-order BDF, one cell at a time on the CPU.

The species' right-hand side and Jacobian are oracle.py's (the
arithmetic of the repository's independent oracle); with evolT, dT/dt
is the heating and cooling's (thermal.py), and the Jacobian's
temperature column and row are finite differences (the row over every
species); with evolT=False the rates are those of the initial gas
temperature.  None of the port's solver, factorization or kernels takes
part.

`prec` is the precision: "f64" (the reference), or a control: "f32"
(every evaluation in float32: the state rounded to it, the rates, the
fluxes and the thermal row) or "f32_rates" (the rates and the thermal
row in float32, the state and the fluxes in float64).
"""

import dataclasses

import numpy as np
import torch
from scipy.integrate import solve_ivp

from . import oracle, thermal as thermod, umist

PRECISIONS = ("f64", "f32", "f32_rates")


class Chemistry:
    """The network, its oracle and the thermal balance (float64, and
    float32 when a control asks for it) on the CPU."""

    def __init__(self, net_file, enthalpy_file):
        self.net = umist.load_network(net_file, enthalpy_file)
        self.nS = self.net.n_species
        self.oracle = oracle.Oracle(self.net)
        self._thermal = {torch.float64:
                         thermod.ThermalBalance(self.net, device="cpu")}

    def thermal(self, dtype):
        if dtype not in self._thermal:
            self._thermal[dtype] = cast(
                thermod.ThermalBalance(self.net, device="cpu"), dtype)
        return self._thermal[dtype]


def cast(obj, dtype, _seen=None):
    """obj with every float64 tensor it holds (in named tuples, lists,
    tuples, dicts and attributes, recursively) in `dtype`."""
    _seen = set() if _seen is None else _seen
    if isinstance(obj, torch.Tensor):
        return obj.to(dtype) if obj.dtype == torch.float64 else obj
    if id(obj) in _seen:
        return obj
    _seen.add(id(obj))
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(cast(v, dtype, _seen) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(cast(v, dtype, _seen) for v in obj)
    if isinstance(obj, dict):
        return {k: cast(v, dtype, _seen) for k, v in obj.items()}
    if hasattr(obj, "__dict__") and not isinstance(obj, type) \
            and not dataclasses.is_dataclass(obj):
        for k, v in vars(obj).items():
            setattr(obj, k, cast(v, dtype, _seen))
    return obj


def lane(d, cls, dtype):
    """One lane of the named tuple `cls` from the dict d."""
    return cls(**{k: torch.tensor(np.asarray(v, np.float64),
                                  dtype=dtype)[None]
                  for k, v in d.items() if k in cls._fields})


class Cell:
    """f(t, y) and jac(t, y) of one cell for scipy, y = [X, Tgas]; env
    and tenv are fields.Fields.envs' dicts."""

    def __init__(self, chem, env, tenv, evolT, prec="f64"):
        assert prec in PRECISIONS, prec
        self.chem, self.env, self.evolT = chem, env, evolT
        self.nS = chem.nS
        self.kdt = np.float64 if prec == "f64" else np.float32
        self.ydt = np.float32 if prec == "f32" else np.float64
        self.tdt = torch.float64 if prec == "f64" else torch.float32
        self.thermal = chem.thermal(self.tdt)
        self.env_t = lane(env, thermod.CellEnv, self.tdt)
        self.tenv_t = lane(tenv, thermod.ThermalEnv, self.tdt)
        self.d2h = env["ratioDust2HnucNum"]
        self.spg = env["SitesPerGrain"]
        self.k0 = None if evolT else self.rates(env["Tgas"])

    def rates(self, T):
        return self.chem.oracle.rates(self.env, T, dtype=self.kdt)

    def rates_t(self, T):
        """rates at each lane's T [B] as a tensor [B, nR]."""
        return torch.stack([torch.from_numpy(self.rates(float(t)))
                            for t in T]).to(self.tdt)

    def k_at(self, y):
        return self.rates(float(y[self.nS])) if self.evolT else self.k0

    def species(self, k, y):
        return k.astype(self.ydt), y[:self.nS].astype(self.ydt)

    def dTdt(self, Y, k):
        """dT/dt [K/yr] of the states Y [B, NEQ] at the rates k [nR]."""
        Yt = torch.from_numpy(np.asarray(Y, np.float64)).to(self.tdt)
        B = Yt.shape[0]
        kt = torch.from_numpy(np.asarray(k, np.float64)).to(self.tdt)
        env = type(self.env_t)(*(v.expand(B, *v.shape[1:])
                                 for v in self.env_t))
        tenv = type(self.tenv_t)(*(v.expand(B, *v.shape[1:])
                                   for v in self.tenv_t))
        return self.thermal.dTdt(Yt, Yt[:, self.nS], env, tenv,
                                 kt.expand(B, -1)).double().numpy()

    def f(self, t, y):
        k = self.k_at(y)
        ydot = np.zeros(self.nS + 1)
        ydot[:self.nS] = self.chem.oracle.rhs(*self.species(k, y),
                                              self.d2h, self.spg)
        if self.evolT:
            ydot[self.nS] = self.dTdt(y[None], k)[0]
        return ydot

    def jac(self, t, y):
        nS = self.nS
        k = self.k_at(y)
        J = np.zeros((nS + 1, nS + 1))
        J[:nS, :nS] = self.chem.oracle.jac(*self.species(k, y), self.d2h,
                                           self.spg)
        if self.evolT:
            dT = 1e-2 * float(y[nS]) + 1.0
            yT = y.copy()
            yT[nS] += dT
            J[:, nS] = (self.f(t, yT) - self.f(t, y)) / dT
            # the dT/dt row over every species, at the rates of this T;
            # the last row of the batch is the unperturbed state, so that
            # each difference is of one batch's arithmetic
            dy = np.abs(y[:nS]) * 1e-2 + self.d2h * 1e-6
            yp = np.repeat(y[None], nS + 1, axis=0)
            yp[np.arange(nS), np.arange(nS)] += dy
            td = self.dTdt(yp, k)
            J[nS, :nS] = (td[:nS] - td[nS]) / dy
        # subnormal entries (rates times abundances near 1e-300) slow the
        # LU factorization a hundredfold and do not change the Newton
        # iteration's result
        J[np.abs(J) < 1e-200] = 0.0
        return J

    def equilibrium_T(self, y, T0):
        """The evolT=False temperature: bisection of the net heating at
        the abundances y from max(T0, 2) K, as the program's driver takes
        it (T0 where no bracket is found)."""
        yt = torch.from_numpy(np.asarray(y[:self.nS], np.float64)) \
            .to(self.tdt)[None]
        T, brk = self.thermal.solve_equilibrium_T(
            yt, self.env_t, self.tenv_t,
            torch.tensor([max(T0, 2.0)], dtype=self.tdt), self.rates_t)
        return float(T[0]) if bool(brk[0]) else T0


def integrate(cell, y0, t_max, rtol, atol, first_step):
    """(final state [NEQ] float64, ok) at t_max (yr)."""
    sol = solve_ivp(cell.f, (0.0, t_max), y0, method="BDF", rtol=rtol,
                    atol=atol, jac=cell.jac, first_step=first_step,
                    t_eval=[t_max])
    Y = np.asarray(sol.y, dtype=np.float64).reshape(len(y0), -1)
    ok = sol.success and Y.shape[1] == 1 and bool(np.isfinite(Y).all())
    return (Y[:, -1] if ok else np.full(len(y0), np.nan)), ok
