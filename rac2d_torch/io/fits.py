"""Minimal FITS writer (pure Python, no astropy/cfitsio dependency).

Counterpart of the JAX package's ``io/fits.py``, copied: pure numpy, the
same bytes for the same arrays and headers.

Replaces the reference's cfitsio-based cube output
(reference: src/ray_tracing.f90:667-971 ``save_cube_to_fits`` — primary
PPV cube + image extensions TauMap/IntMap/ColumnDensityUp/Low and
spectrum vector, with WCS-style headers).  Writes standard-conforming
FITS: 2880-byte logical records, 80-char header cards, big-endian data.
"""

from __future__ import annotations

import numpy as np

BLOCK = 2880


def _card(key, value=None, comment=None):
    if value is None:
        s = key.ljust(80)
    else:
        if isinstance(value, bool):
            v = "T" if value else "F"
            s = f"{key:<8}= {v:>20}"
        elif isinstance(value, (int, np.integer)):
            s = f"{key:<8}= {value:>20d}"
        elif isinstance(value, float):
            s = f"{key:<8}= {value:>20.13E}"
        else:
            s = f"{key:<8}= '{str(value):<8}'"
        if comment:
            s += f" / {comment}"
        s = s[:80].ljust(80)
    return s.encode("ascii")


def _pad(b):
    n = len(b) % BLOCK
    return b + (b"\x00" * (BLOCK - n) if n else b"")


def _header(cards):
    h = b"".join(cards) + _card("END")
    n = len(h) % BLOCK
    if n:
        h += b" " * (BLOCK - n)
    return h


def _image_hdu(data, extra_cards=(), primary=False, name=None):
    data = np.asarray(data, dtype=">f8")
    cards = []
    if primary:
        cards.append(_card("SIMPLE", True, "conforms to FITS standard"))
    else:
        cards.append(_card("XTENSION", "IMAGE", "image extension"))
    cards.append(_card("BITPIX", -64))
    cards.append(_card("NAXIS", data.ndim))
    # FITS axis order is reversed wrt numpy
    for i, nax in enumerate(reversed(data.shape)):
        cards.append(_card(f"NAXIS{i + 1}", int(nax)))
    if not primary:
        cards.append(_card("PCOUNT", 0))
        cards.append(_card("GCOUNT", 1))
    if name:
        cards.append(_card("EXTNAME", name))
    cards.extend(extra_cards)
    return _header(cards) + _pad(data.tobytes())


def write_cube_fits(path, cube, freqs=None, tau_map=None, int_map=None,
                    ncol_up=None, ncol_low=None, spectrum=None,
                    header: dict | None = None):
    """PPV cube (nx, ny, nf) -> primary HDU [nf, ny, nx] + extensions."""
    cube = np.asarray(cube)
    extra = []
    if header:
        for k, v in header.items():
            extra.append(_card(k[:8].upper(), v))
    if freqs is not None:
        freqs = np.asarray(freqs)
        extra.append(_card("CRVAL3", float(freqs[0]), "Hz"))
        if len(freqs) > 1:
            extra.append(_card("CDELT3", float(freqs[1] - freqs[0])))
        extra.append(_card("CRPIX3", 1))
        extra.append(_card("CTYPE3", "FREQ"))
    # FITS convention: axis 1 = x (fastest), axis 2 = y, axis 3 = freq
    buf = _image_hdu(np.transpose(cube, (2, 1, 0)), extra, primary=True)
    for name, arr in (("TAUMAP", tau_map), ("INTMAP", int_map),
                      ("COLDENUP", ncol_up), ("COLDENLO", ncol_low),
                      ("FLUXSPEC", spectrum)):
        if arr is not None:
            buf += _image_hdu(np.asarray(arr), name=name)
    with open(path, "wb") as f:
        f.write(buf)


def _card_value(body):
    """Card value with the trailing /comment stripped.  Quoted string
    values may themselves contain '/' (e.g. a QNUM like 'F=1/2-3/2'), so
    for those the comment separator is only looked for AFTER the closing
    quote (ADVICE r4)."""
    body = body.rstrip()
    st = body.lstrip()
    if st.startswith("'"):
        # FITS escapes ' inside strings as ''
        i = 1
        while i < len(st):
            j = st.find("'", i)
            if j < 0:
                return st.strip()
            if st[j + 1:j + 2] == "'":
                i = j + 2
                continue
            return st[:j + 1].strip()
        return st.strip()
    return body.split("/")[0].strip()


def read_fits_image(path):
    """Tiny reader for round-tripping our own files (tests)."""
    with open(path, "rb") as f:
        raw = f.read()
    # parse primary header
    hdrs = {}
    pos = 0
    cards = []
    while True:
        block = raw[pos:pos + BLOCK]
        pos += BLOCK
        for i in range(0, BLOCK, 80):
            card = block[i:i + 80].decode("ascii", "replace")
            cards.append(card)
            if card.startswith("END"):
                break
        if cards and cards[-1].startswith("END"):
            break
    for cd in cards:
        if "=" in cd:
            k = cd[:8].strip()
            hdrs[k] = _card_value(cd[10:])
    naxis = int(hdrs["NAXIS"])
    shape = tuple(int(hdrs[f"NAXIS{i + 1}"]) for i in range(naxis))[::-1]
    n = int(np.prod(shape))
    data = np.frombuffer(raw[pos:pos + n * 8], dtype=">f8").reshape(shape)
    return data, hdrs


def _parse_hdu(raw, pos):
    """Parse one HDU starting at byte pos; returns (hdrs, data, next_pos)
    or None at EOF."""
    if pos >= len(raw):
        return None
    hdrs = {}
    end = False
    while not end:
        block = raw[pos:pos + BLOCK]
        if len(block) < BLOCK:
            return None
        pos += BLOCK
        for i in range(0, BLOCK, 80):
            card = block[i:i + 80].decode("ascii", "replace")
            if card.startswith("END"):
                end = True
                break
            if "=" in card:
                hdrs[card[:8].strip()] = _card_value(card[10:])
    naxis = int(hdrs.get("NAXIS", 0))
    shape = tuple(int(hdrs[f"NAXIS{i + 1}"])
                  for i in range(naxis))[::-1]
    n = int(np.prod(shape)) if shape else 0
    data = np.frombuffer(raw[pos:pos + n * 8],
                         dtype=">f8").reshape(shape) if n else None
    nbytes = n * 8
    pos += nbytes + ((-nbytes) % BLOCK if nbytes else 0)
    return hdrs, data, pos


def read_fits_extension(path, name):
    """Data array of the extension whose EXTNAME matches (case-
    insensitive), or None."""
    with open(path, "rb") as f:
        raw = f.read()
    pos = 0
    while True:
        parsed = _parse_hdu(raw, pos)
        if parsed is None:
            return None
        hdrs, data, pos = parsed
        ext = hdrs.get("EXTNAME", "").strip().strip("'").strip()
        if ext.upper() == name.upper():
            return data
