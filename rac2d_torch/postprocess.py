"""Post-processing and plotting helpers, in numpy on the host.

A copy of the JAX package's ``postprocess.py`` that reads the port's own
npz tables (``models/output.py``) and FITS cubes (``io/fits.py``) and
computes with the port's ``constants``; matplotlib is imported only
inside ``plot_mesh``.

Role of the reference's ``utils_python`` package (SURVEY.md L11:
``draw/long_function_definitions.py`` loads iter_NNNN.dat tables and
plots quantities on the cell mesh; fits_image.py works with the cubes).
Operates on the npz tables written by models/output.py and the FITS cubes
from models/imaging.py.
"""

from __future__ import annotations

import numpy as np


def load_iter(path):
    from .models.output import load_iter_npz
    return load_iter_npz(path)


def cell_quads(table):
    """Matplotlib PolyCollection vertices for the cell rectangles."""
    r0, r1 = table["rmin"], table["rmax"]
    z0, z1 = table["zmin"], table["zmax"]
    return np.stack([
        np.stack([r0, z0], -1), np.stack([r1, z0], -1),
        np.stack([r1, z1], -1), np.stack([r0, z1], -1)], axis=1)


def plot_mesh(table, values, ax=None, log=True, mirror=False, vmin=None,
              vmax=None, cmap="viridis", label=None):
    """Color the cell mesh by a per-cell quantity (like the reference's
    iter_NNNN.dat maps).  Returns the matplotlib axis."""
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    from matplotlib.collections import PolyCollection
    from matplotlib.colors import LogNorm, Normalize

    if ax is None:
        _, ax = plt.subplots(figsize=(7, 4))
    vals = np.asarray(values, dtype=float)
    use = table.get("using", np.ones(len(vals), bool)).astype(bool)
    quads = cell_quads(table)[use]
    v = vals[use]
    if log:
        v = np.maximum(v, np.nanmin(v[v > 0]) if (v > 0).any() else 1e-300)
        norm = LogNorm(vmin=vmin or np.nanmin(v), vmax=vmax or np.nanmax(v))
    else:
        norm = Normalize(vmin=vmin, vmax=vmax)
    pc = PolyCollection(quads, array=v, cmap=cmap, norm=norm,
                        edgecolor="none")
    ax.add_collection(pc)
    if mirror:
        m = quads.copy()
        m[:, :, 1] *= -1
        pc2 = PolyCollection(m, array=v, cmap=cmap, norm=norm,
                             edgecolor="none")
        ax.add_collection(pc2)
    ax.set_xlim(table["rmin"].min(), table["rmax"].max())
    zmax = table["zmax"].max()
    ax.set_ylim(-zmax if mirror else 0, zmax)
    ax.set_xlabel("r [AU]")
    ax.set_ylabel("z [AU]")
    plt.colorbar(pc, ax=ax, label=label)
    return ax


def abundance(table, species):
    names = list(table["species"])
    return table["abundances"][names.index(species)]


def radial_profile(table, values, z_over_r_max=0.1):
    """Midplane-ish radial profile: per column, average the cells with
    z/r below the cut."""
    r = 0.5 * (table["rmin"] + table["rmax"])
    z = 0.5 * (table["zmin"] + table["zmax"])
    sel = (z < z_over_r_max * r) & table["using"].astype(bool)
    order = np.argsort(r[sel])
    return r[sel][order], np.asarray(values)[sel][order]


def spectrum_from_fits(path):
    """(freq, flux) from a cube file written by models/imaging.py."""
    from .io.fits import read_fits_image
    data, hdr = read_fits_image(path)
    f0 = float(hdr.get("CRVAL3", 0))
    df = float(hdr.get("CDELT3", 1))
    nf = data.shape[0]
    freqs = f0 + df * np.arange(nf)
    return freqs, data.sum(axis=(1, 2))


def vertical_cut(table, values, r0):
    """(z, values) through the column nearest r0 (reference
    long_function_definitions vertical-profile plots)."""
    r = np.round(0.5 * (table["rmin"] + table["rmax"]), 9)
    z = 0.5 * (table["zmin"] + table["zmax"])
    use = table["using"].astype(bool)
    cols = np.unique(r[use])
    rc = cols[np.argmin(np.abs(cols - r0))]
    sel = use & (r == rc)
    order = np.argsort(z[sel])
    return z[sel][order], np.asarray(values)[sel][order]


def column_density(table, species, direction="vertical"):
    """N(species) per column [cm^-2] integrated vertically (one side)."""
    from . import constants as c
    X = abundance(table, species)
    n = table["n_gas"] * X
    dz = (table["zmax"] - table["zmin"]) * c.AU2cm
    r = 0.5 * (table["rmin"] + table["rmax"])
    use = table["using"].astype(bool)
    cols = {}
    for rr in np.unique(np.round(r[use], 6)):
        m = use & (np.round(r, 6) == rr)
        cols[rr] = (n[m] * dz[m]).sum()
    rs = np.array(sorted(cols))
    return rs, np.array([cols[rr] for rr in rs])


def iter_diff(table_a, table_b, species):
    """Relative abundance change between two iteration tables (the
    convergence visualization of the reference's notebook workflow)."""
    Xa = abundance(table_a, species)
    Xb = abundance(table_b, species)
    return np.abs(Xb - Xa) / np.maximum(np.abs(Xa) + np.abs(Xb), 1e-300)


# ---------------------------------------------------------------------------
# FITS cube tools (role of the reference's fits_handling.py/fits_image.py)

def load_cube(path):
    """(cube [nf, ny, nx], freqs, header) from a cube written by
    models/imaging.py."""
    from .io.fits import read_fits_image
    data, hdr = read_fits_image(path)
    f0 = float(hdr.get("CRVAL3", 0.0))
    df = float(hdr.get("CDELT3", 1.0))
    freqs = f0 + df * np.arange(data.shape[0])
    return data, freqs, hdr


def moment_maps(cube, freqs, restfreq=None, clip=0.0):
    """(mom0, mom1_velocity) maps.

    mom0: channel-integrated intensity; mom1: intensity-weighted mean
    LOS velocity [cm/s] relative to restfreq.
    """
    from . import constants as c
    f0 = restfreq or 0.5 * (freqs[0] + freqs[-1])
    v = (1.0 - freqs / f0) * c.SpeedOfLight_CGS
    w = np.maximum(cube - clip, 0.0)
    df = abs(freqs[1] - freqs[0]) if len(freqs) > 1 else 1.0
    mom0 = w.sum(axis=0) * df
    denom = np.maximum(w.sum(axis=0), 1e-300)
    mom1 = (w * v[:, None, None]).sum(axis=0) / denom
    return mom0, mom1


def pv_cut(cube, axis_index=None):
    """Position-velocity diagram along the image x-axis through the
    middle row (classic edge-on disk diagnostic)."""
    ny = cube.shape[1]
    row = axis_index if axis_index is not None else ny // 2
    return cube[:, row, :]


def convolve_beam(img, fwhm_pix):
    """Gaussian-beam convolution of a 2D map (or per-channel of a cube)
    via FFT — the reference convolves cubes with the observing beam in
    fits_image.py."""
    img = np.asarray(img)
    if img.ndim == 3:
        return np.stack([convolve_beam(ch, fwhm_pix) for ch in img])
    ny, nx = img.shape
    sig = fwhm_pix / 2.3548
    ky = np.fft.fftfreq(ny)
    kx = np.fft.fftfreq(nx)
    G = np.exp(-2.0 * (np.pi * sig) ** 2
               * (ky[:, None] ** 2 + kx[None, :] ** 2))
    return np.real(np.fft.ifft2(np.fft.fft2(img) * G))


def load_sed(path):
    """(lam_A, flam [n_mu, nlam]) from out/sed.json."""
    import json
    with open(path) as f:
        d = json.load(f)
    return np.asarray(d["lam_A"]), np.asarray(d["flam_per_mu_bin"])


def parse_contributions(path):
    """Parse an ana/ per-point file written by ops.analysis back into
    {"header": {...}, species: {"produce": [(rate, frac, rxn)],
    "destroy": [...]}} (role of the reference's parse_ana.py)."""
    out = {"header": {}}
    cur = None
    mode = None
    with open(path) as f:
        for line in f:
            line = line.rstrip()
            st = line.strip()
            if st.startswith("== ") and " X = " in st:
                cur = st.split()[1]
                out[cur] = {"produce": [], "destroy": []}
                mode = None
            elif st.startswith("production"):
                mode = "produce"
            elif st.startswith("destruction"):
                mode = "destroy"
            elif "=" in st and cur is None and not st.startswith("#"):
                k, _, v = st.partition("=")
                try:
                    out["header"][k.strip()] = float(v.split()[0])
                except (ValueError, IndexError):
                    pass
            elif cur and mode and st:
                parts = st.split(None, 2)
                try:
                    rate = float(parts[0])
                    frac = float(parts[1].rstrip("%")) / 100.0
                except (ValueError, IndexError):
                    continue
                rxn = parts[2] if len(parts) > 2 else ""
                out[cur][mode].append((rate, frac, rxn))
    return out


# ----------------------------------------------------------------------
# spectral-line product loader (role of the reference's
# utils_python/draw/fits_proc.py:7-189 ``specline``: one object per line
# cube carrying transition metadata + flux spectrum, the unit of the
# batch model-vs-observation comparisons)
# ----------------------------------------------------------------------

class SpecLine:
    """Load one line-cube FITS written by models/imaging.py and expose
    the transition metadata cards (ray_tracing.f90:730-753 card set) and
    the flux spectrum with velocity axis."""

    _FLOATS = {"F0": "f0", "LAM0": "lam0_A", "EUP": "E_up",
               "ELOW": "E_low", "AUL": "Aul", "BUL": "Bul", "BLU": "Blu",
               "INTFLUX": "intflux", "INTFLUXL": "intfluxl",
               "MAXFLUX": "maxflux", "MAXTAU": "maxtau",
               "THETA": "theta", "DIST": "dist", "RESTFRQ": "restfrq",
               "CRVAL3": "fmin", "CDELT3": "df"}

    def __init__(self, path):
        from .io.fits import read_fits_image
        data, hdr = read_fits_image(path)
        self.cube = np.transpose(data, (2, 1, 0))  # back to (nx, ny, nf)
        self.header = hdr
        for card, attr in self._FLOATS.items():
            v = hdr.get(card)
            setattr(self, attr, float(v) if v is not None else None)
        for card, attr in (("MOL-DB", "molname"), ("LINE", "molname"),
                           ("QNUM", "qnum")):
            v = hdr.get(card)
            if v is not None and getattr(self, attr, None) is None:
                setattr(self, attr, v.strip().strip("'").strip())
        self.qnum = getattr(self, "qnum", "")
        self.molname = getattr(self, "molname", "")
        nf = self.cube.shape[2]
        if self.fmin is not None and self.df is not None:
            self.f = self.fmin + np.arange(nf) * self.df
        else:
            self.f = np.arange(nf, dtype=float)
        f0 = self.f0 or self.restfrq
        if f0:
            self.v = (f0 - self.f) * (2.99792458e10 / f0)  # cm/s
        else:
            self.v = np.zeros(nf)
        # flux spectrum: prefer the recorded FLUXSPEC extension, else
        # rebuild from the cube (needs DIST) — cube is in CGS intensity
        from .io.fits import read_fits_extension
        spec = read_fits_extension(path, "FLUXSPEC")
        self.spec = None if spec is None else np.asarray(spec, float)
        if self.spec is None:
            # rebuild from the cube: needs the pixel solid angle, either
            # recorded directly (PIXSR) or derivable from DIST + the
            # spatial pixel scale (CDELT1/2, AU)
            pix_sr = hdr.get("PIXSR")
            if pix_sr is not None:
                pix_sr = float(pix_sr)
            elif self.dist and hdr.get("CDELT1") and hdr.get("CDELT2"):
                AU2cm, pc2cm = 1.495978707e13, 3.0856775814913674e18
                pix_sr = (abs(float(hdr["CDELT1"]))
                          * abs(float(hdr["CDELT2"])) * AU2cm ** 2
                          / (self.dist * pc2cm) ** 2)
            if pix_sr is not None:
                jansky2CGS = 1e-23
                self.spec = (self.cube.sum(axis=(0, 1)) * pix_sr
                             / jansky2CGS)

    def integrated_flux(self, remove_baseline=True):
        """Integral of the flux spectrum in W/m^2 (reference
        get_spec_sum * jansky2SI * df, ray_tracing.f90:1433-1450)."""
        if self.spec is None or self.df is None:
            raise ValueError("no FLUXSPEC extension / frequency axis")
        s = self.spec.astype(float)
        if remove_baseline:
            s = s - np.linspace(s[0], s[-1], len(s))
        return float(np.sum(s) * 1e-26 * abs(self.df))


# ----------------------------------------------------------------------
# structure diagnostics (reference utils_python/draw/scale_height.py)
# ----------------------------------------------------------------------

def scale_height(table):
    """Density-weighted rms z per radial column: H(r) such that
    <z^2>_n = H^2 for a Gaussian layer.  Returns (r_centers, H)."""
    r = 0.5 * (table["rmin"] + table["rmax"])
    z = 0.5 * (table["zmin"] + table["zmax"])
    n = table["n_gas"]
    use = table.get("using", np.ones(len(r), bool)).astype(bool)
    vol = table.get("vol", (table["rmax"] - table["rmin"])
                   * (table["zmax"] - table["zmin"]) * r)
    rc = np.unique(np.round(r[use], 10))
    H = np.empty(len(rc))
    for i, r0 in enumerate(rc):
        m = use & (np.abs(r - r0) <= 1e-9 + 1e-6 * r0)
        w = n[m] * vol[m]
        H[i] = np.sqrt(np.sum(w * z[m] ** 2) / max(np.sum(w), 1e-300))
    return rc, H


def stokes_number(table, mstar_gram, a0_grain_CGS, beta=-0.3,
                  rho_grain_CGS=2.0):
    """Grain Stokes number per cell (reference scale_height.py:26-29:
    St = w_Kep * a_grain * rho_grain / (c_sound * n_gas * m_p), with the
    grain size a power law in radius a = a0 * r^beta).  w_Kep and
    c_sound are derived from the saved columns rather than re-read."""
    G = 6.674e-8
    kB = 1.380649e-16
    mp = 1.67262192e-24
    AU = 1.495978707e13
    r = 0.5 * (table["rmin"] + table["rmax"])
    a_grain = a0_grain_CGS * r ** beta
    w_Kep = np.sqrt(G * mstar_gram / (r * AU) ** 3)
    c_sound = np.sqrt(kB * np.maximum(table["Tgas"], 1.0) / (2.3 * mp))
    return w_Kep * a_grain * rho_grain_CGS / (
        c_sound * np.maximum(table["n_gas"], 1e-300) * mp)


def settling_factor(stokes, alpha=0.01, alpha_scaling=1.0):
    """Dust settling scale-height factor (reference
    scale_height.py:31-32): H_dust/H_gas =
    sqrt(alpha / (min(St, 0.5) * (1 + St)))."""
    st = np.asarray(stokes, float)
    return np.sqrt(alpha_scaling * alpha
                   / (np.minimum(st, 0.5) * (1.0 + st)))


def tau_surface(table, kappa_per_H, tau0=1.0):
    """z of the tau = tau0 surface per column, integrating kappa_per_H
    [cm^2 per H nucleus] times n_gas downward from the top (the standard
    disk diagnostic the reference's mesh figures overlay).  Returns
    (r_centers, z_tau) with z_tau = 0 where the column never reaches
    tau0."""
    AU = 1.495978707e13
    r = 0.5 * (table["rmin"] + table["rmax"])
    use = table.get("using", np.ones(len(r), bool)).astype(bool)
    rc = np.unique(np.round(r[use], 10))
    z_tau = np.zeros(len(rc))
    for i, r0 in enumerate(rc):
        m = np.nonzero(use & (np.abs(r - r0) <= 1e-9 + 1e-6 * r0))[0]
        order = np.argsort(-table["zmax"][m])       # top down
        tau = 0.0
        for j in m[order]:
            dz = (table["zmax"][j] - table["zmin"][j]) * AU
            dtau = kappa_per_H * table["n_gas"][j] * dz
            if tau + dtau >= tau0:
                frac = (tau0 - tau) / max(dtau, 1e-300)
                z_tau[i] = table["zmax"][j] - frac * (
                    table["zmax"][j] - table["zmin"][j])
                break
            tau += dtau
    return rc, z_tau


# ----------------------------------------------------------------------
# spherical-grid export (reference utils_python/draw/misc.py:23-70
# ``to_spherical``: resample the cylindrical cell model onto an
# (r, theta, phi) grid, e.g. as RADMC-3D input) — vectorized
# ----------------------------------------------------------------------

def to_spherical(table, fields, r_grid, theta_grid, phi_grid=(0.0, 1.0)):
    """Sample per-cell quantities at the centers of a spherical grid.

    fields: {name: per-cell array}; r_grid [AU], theta_grid [rad,
    measured from the pole], phi_grid [rad] are BOUNDARY points.
    Returns {name: array [nphi-1, ntheta-1, nr-1]} in the reference's
    write order (phi slowest, r fastest); cells outside the cylindrical
    model get 0."""
    r_c = 0.5 * (np.asarray(r_grid)[:-1] + np.asarray(r_grid)[1:])
    t_c = 0.5 * (np.asarray(theta_grid)[:-1] + np.asarray(theta_grid)[1:])
    nphi = len(phi_grid) - 1
    rho = r_c[None, :] * np.sin(t_c)[:, None]       # [nt, nr] cyl radius
    zz = np.abs(r_c[None, :] * np.cos(t_c)[:, None])
    r0, r1 = table["rmin"], table["rmax"]
    z0, z1 = table["zmin"], table["zmax"]
    use = table.get("using", np.ones(len(r0), bool)).astype(bool)
    inside = ((rho[..., None] >= r0) & (rho[..., None] < r1)
              & (zz[..., None] >= z0) & (zz[..., None] < z1) & use)
    icell = np.argmax(inside, axis=-1)              # first hit
    hit = inside.any(axis=-1)
    out = {}
    for name, vals in fields.items():
        v = np.where(hit, np.asarray(vals, float)[icell], 0.0)
        out[name] = np.broadcast_to(v, (nphi,) + v.shape).copy()
    return out


def write_radmc_inp(path, arr):
    """Write a to_spherical field in the reference's flat one-value-per-
    line .inp format (misc.py:56-68 write order)."""
    with open(path, "w") as f:
        for val in np.asarray(arr).reshape(-1):
            f.write("{0:.6e}\n".format(val))


# ----------------------------------------------------------------------
# species-name group selectors (reference misc.py:201-238)
# ----------------------------------------------------------------------

_ELEM_RE = None


def _counts(name):
    """Element counts of a species name via a proper tokenizer: ONE
    alternation ordered two-letter symbols first, so 'He' is never
    counted as H, 'Cl' never as C, 'Ne' never as N (ADVICE r4: the old
    per-element findall double-counted every overlapping symbol)."""
    import re
    global _ELEM_RE
    if _ELEM_RE is None:
        _ELEM_RE = re.compile(
            r"(He|Ne|Si|Na|Mg|Fe|Cl|H|C|N|O|S|F|P)(\d*)")
    body = name.lstrip("g").rstrip("+-")
    out = {}
    for el, k in _ELEM_RE.findall(body):
        out[el] = out.get(el, 0) + (int(k) if k else 1)
    return out


def hydrocarbons(names):
    """Species made of C and H only (with C present), as the reference
    groups them for the C2H figure set (misc.py:201-214)."""
    import re
    out = []
    for nm in names:
        body = nm.lstrip("g").rstrip("+-")
        if re.fullmatch(r"(?:[CH]\d*)+", body) and "C" in body:
            out.append(nm)
    return out


def nitrogen_bearing(names):
    """Species containing elemental N — tokenized, so Na/Ne/Ni species
    are excluded (misc.py:215-222; ADVICE r4: the lookahead regex
    false-positived on neon)."""
    return [nm for nm in names if _counts(nm).get("N", 0) > 0]
