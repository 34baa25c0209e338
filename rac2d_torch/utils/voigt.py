"""Voigt profile on tensors.

Counterpart of the JAX package's ``utils/voigt.py`` (role of reference
src/voigt.f90): Humlicek's w4 rational approximation of the Faddeeva
function K(x, y) = Re[w(x + i y)], with ``where``-based region selection.
Complex arithmetic runs in complex64 for float32 input and complex128
for float64 input, as in the JAX package.
"""

import torch

SQRT_PI_INV = 0.5641895835477563  # 1/sqrt(pi)


def humlicek_w4(x, y):
    """Re[w(z)], z = x + i y, y >= 0.  Relative accuracy ~1e-4."""
    x = torch.as_tensor(x)
    if x.dtype != torch.float64:
        x = x.to(torch.float32)
    y = torch.as_tensor(y, dtype=x.dtype, device=x.device)
    x, y = torch.broadcast_tensors(x, y)
    s = torch.abs(x) + y
    t = torch.complex(y, -x)            # -i z
    # Region I: s >= 15 — 1-term continued fraction.
    wI = t * SQRT_PI_INV / (0.5 + t * t)
    # Region II: 5.5 <= s < 15 — 2-term.
    u = t * t
    wII = t * (1.410474 + u * SQRT_PI_INV) / (0.75 + u * (3.0 + u))
    # Region III: s < 5.5 and y >= 0.195|x| - 0.176.
    wIII = ((16.4955 + t * (20.20933 + t * (11.96482 + t * (
        3.778987 + t * 0.5642236))))
        / (16.4955 + t * (38.82363 + t * (39.27121 + t * (21.69274 + t * (
            6.699398 + t))))))
    # Region IV: remainder — 6-term rational in u = t^2 with exp correction.
    wIV = torch.exp(torch.complex(torch.clamp(u.real, -200.0, 200.0),
                                  u.imag)) - t * (
        36183.31 - u * (3321.9905 - u * (1540.787 - u * (219.0313 - u * (
            35.76683 - u * (1.320522 - u * 0.56419)))))) / (
        32066.6 - u * (24322.84 - u * (9022.228 - u * (2186.181 - u * (
            364.2191 - u * (61.57037 - u * (1.841439 - u)))))))
    w = torch.where(s >= 15.0, wI,
                    torch.where(s >= 5.5, wII,
                                torch.where(y >= 0.195 * torch.abs(x) - 0.176,
                                            wIII, wIV)))
    return w.real


def voigt(x, a):
    """Voigt function H(a, x) = a/pi * int exp(-t^2)/((x-t)^2+a^2) dt.

    Normalized so that int H(a,x) dx = sqrt(pi); H(0, x) = exp(-x^2).
    """
    return humlicek_w4(x, a)
