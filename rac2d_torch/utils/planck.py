"""Radiative helpers on tensors.

Counterpart of the JAX package's ``utils/planck.py``.  Only the escape
probability used by the thermal balance is ported so far; the Planck
functions come with the Monte Carlo slice.
"""

import torch

from .. import constants as c


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
