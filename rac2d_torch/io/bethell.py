"""X-ray absorption cross sections per H nucleus.

Piecewise-polynomial fits from Bethell & Bergin (2011), Table 2 — gas and
dust components, sigma(E) = 1e-24/E^3 * (c0 + c1 E + c2 E^2) cm^2/H with E
in keV (role of reference src/load_Bethell_Xray.f90).  The dust term gets
a self-blanketing correction f(tau) depending on grain size and
dust-to-gas ratio (:70-98).

Counterpart of the JAX package's ``io/bethell.py``.  The cross sections
depend on the wavelength grid only, so they are numpy (host tables);
``dust_blanketing`` takes numpy arrays or tensors (``xp=np`` or
``xp=torch``) because the walk evaluates it per cell and per step.
"""

import numpy as np
import torch

# energy bin edges [keV] and fit coefficients (Bethell & Bergin 2011, tab 2)
E_EDGES = np.array([0.030, 0.055, 0.100, 0.165, 0.284, 0.400, 0.532,
                    0.708, 0.867, 1.303, 1.840, 2.471, 3.210, 4.038,
                    7.111, 8.331, 10.00])

C_GAS = np.array([
    [14.2, 727.0, -4130.0], [22.0, 445.0, -1550.0], [31.0, 263.0, -614.0],
    [43.7, 112.0, -165.0], [49.0, 86.0, -103.0], [58.6, 36.9, -39.9],
    [48.0, 130.0, -82.2], [77.4, 46.3, -22.0], [80.1, 69.8, -28.3],
    [117.0, 7.43, -1.87], [107.0, 16.0, -3.75], [106.0, 13.6, -2.63],
    [138.0, -1.99, -0.179], [142.0, -4.7, 0.239], [138.0, -3.36, 0.133],
    [88.9, 8.15, -0.547]])

C_DUST = np.array([
    [0.0344, -1.62, 88.2], [-0.147, 4.19, 48.1], [-0.677, 14.9, 9.6],
    [-1.12, 23.6, -16.2], [0.188, 24.6, -1.09], [-3.57, 55.5, -37.9],
    [-8.24, 89.6, -48.1], [57.1, -49.9, 52.1], [9.11, 72.7, -20.8],
    [-8.71, 106.0, -25.7], [34.9, 72.4, -11.4], [23.6, 85.1, -11.3],
    [116.0, 28.2, -2.55], [191.0, -2.92, 1.09], [812.0, -74.7, 6.49],
    [-33.0, 137.0, -6.39]])


def _band(E):
    return np.clip(np.searchsorted(E_EDGES[1:-1], E, side="right"), 0,
                   len(C_GAS) - 1)


def sigma_gas(E):
    """Gas X-ray absorption cross section per H [cm^2]."""
    E = np.asarray(E, dtype=float)
    cg = C_GAS[_band(E)]
    return 1e-24 / (E ** 3) * (cg[..., 0] + (cg[..., 1] + cg[..., 2] * E)
                               * E)


def sigma_dust_raw(E):
    """Dust X-ray absorption per H before depletion/self-blanketing."""
    E = np.asarray(E, dtype=float)
    cd = C_DUST[_band(E)]
    return 1e-24 / (E ** 3) * (cd[..., 0] + (cd[..., 1] + cd[..., 2] * E)
                               * E)


def dust_blanketing(sigma_raw_eps, G, a, xp=np):
    """Self-blanketing factor f(tau) applied to the dust term
    (reference sigma_Xray_Bethell_dust): tau is the optical depth of one
    grain, G the dust/H number ratio, a the grain radius [cm].  The
    1e-300 floors round to 0 in float32, as they do in the JAX walk.

    f = 1.5/tau (1 - 2/tau^2 (1 - (1 + tau) e^-tau)) cancels for small
    tau: in float32 the bracket loses every digit below tau ~ 0.1 (the
    JAX walk's float32 evaluation returns values off by orders of
    magnitude, of either sign, for grains of tau ~ 1e-3).  float32
    input therefore takes the Taylor series
    1 - 3 tau/8 + tau^2/10 - tau^3/48 + tau^4/280 below tau = 0.3
    (truncation < 2e-6); float64 keeps the closed form, which holds
    about 9 digits down to tau ~ 1e-4, as in the JAX package."""
    tau = sigma_raw_eps / xp.clip(G, 1e-300, None) * (3.0 / (2.0 * np.pi)) \
        / xp.clip(a * a, 1e-300, None)
    tau = xp.clip(tau, 1e-8, None)
    f = 1.5 / tau * (1.0 - 2.0 / (tau * tau)
                     * (1.0 - (tau + 1.0) * xp.exp(-xp.clip(tau, None,
                                                             200.0))))
    if tau.dtype in (np.float32, torch.float32):
        series = 1.0 + tau * (-0.375 + tau * (0.1 + tau * (
            -1.0 / 48.0 + tau * (1.0 / 280.0))))
        f = xp.where(tau < 0.3, series, f)
    return xp.where(sigma_raw_eps > 0, f, 1.0)
