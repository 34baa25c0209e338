"""Column densities and X-ray ionization.

Counterpart of the JAX package's ``ops/columns.py``.  Only the X-ray
ionization rate from the local Monte Carlo flux is ported so far
(``reduce_fields`` needs it); the path matrices, column densities and
self-shielding factors come with the columns slice.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as c
from ..io import bethell


def xray_ionization_rate(lam_A, flux_cell_lam, is_xray, dust_depletion,
                         d2h, grain_a):
    """zeta_X per H [s^-1] from the local MC flux (reference
    disk.f90:1969-2010; 37 eV per ion pair).  lam_A and is_xray are the
    host wavelength grid; the per-cell arguments are tensors."""
    lam_A = np.asarray(lam_A, dtype=np.float64)
    E = c.hPlanck_CGS * c.SpeedOfLight_CGS / (lam_A * 1e-8) / c.keV2erg
    dev = flux_cell_lam.device

    def t(a):
        return torch.as_tensor(a, dtype=torch.float64, device=dev)

    # per-cell sigma with blanketing
    sraw = t(bethell.sigma_dust_raw(E))[None, :] * dust_depletion[:, None]
    f = bethell.dust_blanketing(sraw, d2h[:, None], grain_a[:, None], torch)
    sig = t(bethell.sigma_gas(E))[None, :] + f * sraw
    en_erg = t(E * c.keV2erg)
    contrib = flux_cell_lam / en_erg[None, :] * sig \
        * (t(E)[None, :] * 1e3 / 37.0)
    mask = torch.as_tensor(np.asarray(is_xray), device=dev)
    return torch.where(mask[None, :], contrib, 0.0).sum(1)
