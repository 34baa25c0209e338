"""Blackbody radiation and simple radiative helpers.

Counterpart of the JAX package's ``utils/planck.py``: ``B_nu`` and
``B_lambda`` on tensors (they keep the dtype they are given, float32 in
the Monte Carlo folds), ``B_lambda_np`` in float64 numpy for host-side
tables, and the escape probability used by the thermal balance.
"""

import numpy as np
import torch

from .. import constants as c


def B_nu(T, nu):
    """Planck function per unit frequency [erg s^-1 cm^-2 Hz^-1 sr^-1]."""
    x = c.hPlanck_CGS * nu / (c.kBoltzmann_CGS * torch.clamp(T, min=1e-100))
    x = torch.clamp(x, 0.0, c.max_exp)
    # expm1 keeps precision in the Rayleigh-Jeans tail.
    val = (2.0 * c.hPlanck_CGS * nu ** 3 / c.SpeedOfLight_CGS ** 2) \
        / torch.expm1(x)
    return torch.where(T > 0.0, val, 0.0)


def B_lambda(T, lam_cm):
    """Planck function per unit wavelength [erg s^-1 cm^-2 cm^-1 sr^-1]."""
    x = c.hPlanck_CGS * c.SpeedOfLight_CGS / (
        lam_cm * c.kBoltzmann_CGS * torch.clamp(T, min=1e-100))
    x = torch.clamp(x, 0.0, c.max_exp)
    val = (2.0 * c.hPlanck_CGS * c.SpeedOfLight_CGS ** 2 / lam_cm ** 5) \
        / torch.expm1(x)
    return torch.where(T > 0.0, val, 0.0)


def B_lambda_np(T, lam_cm):
    """B_lambda in float64 numpy, for host-side table building."""
    T = np.asarray(T, dtype=np.float64)
    lam_cm = np.asarray(lam_cm, dtype=np.float64)
    x = np.clip(c.hPlanck_CGS * c.SpeedOfLight_CGS
                / (lam_cm * c.kBoltzmann_CGS * np.maximum(T, 1e-100)),
                0.0, c.max_exp)
    val = (2.0 * c.hPlanck_CGS * c.SpeedOfLight_CGS ** 2
           / lam_cm ** 5) / np.expm1(x)
    return np.where(T > 0.0, val, 0.0)


def tau2beta(tau):
    """Escape probability beta(tau) = (1 - exp(-3 tau)) / (3 tau).

    Series expansion near tau=0 for numerical stability; clamps the
    exponent like the reference (src/sub_trivials.f90:1064).
    """
    t3 = 3.0 * tau
    small = torch.abs(t3) < 1e-4
    # 2-term Taylor: (1 - e^-x)/x = 1 - x/2 + x^2/6
    series = 1.0 - t3 / 2.0 + t3 * t3 / 6.0
    t3c = torch.clamp(t3, -c.max_exp, c.max_exp)
    full = -torch.expm1(-t3c) / torch.where(small, 1.0, t3c)
    return torch.where(small, series, full)
