"""Minimal FITS binary-table reader (no astropy dependency).

The framework only needs to read four FITS products at *setup* time:

* NIKA beam / transfer-function tables — simple one-row BINTABLEs with
  fixed-length array columns (read by the reference via
  ``astropy.io.fits`` at reference joxsz_funcs.py:22-23),
* OGIP RMF (``MATRIX`` + ``EBOUNDS`` HDUs, with variable-length array
  columns stored in the heap) and ARF (``SPECRESP``) — consumed only by the
  offline count-rate table generator (the reference hands these paths to
  XSPEC through mbproj2, reference joxsz_funcs.py:184-211).

This is a from-scratch parser of the FITS 4.0 binary-table layout: 2880-byte
blocks, 80-char ASCII cards, big-endian column data, and the ``P``-descriptor
heap convention for variable arrays.

FITS features the parser does NOT implement are rejected loudly with
:class:`UnsupportedFITSError` instead of being silently misread (astropy,
which the reference uses at reference joxsz_funcs.py:16-28, handles
all of these — a new instrument's file may legitimately carry them):

* scaled columns (``TSCALn``/``TZEROn`` with non-identity values, incl.
  the unsigned-integer convention TZERO=2^15/2^31),
* integer null sentinels (``TNULLn``) on a column being read,
* tile-compressed HDUs (``ZIMAGE``/``ZTABLE``) and random groups,
* column type codes with no reader (bit ``X``, complex ``C``/``M``,
  64-bit ``Q`` heap descriptors), and malformed/unknown ``TFORMn``,
* row layouts whose computed width disagrees with ``NAXIS1``.
"""

from __future__ import annotations

import re
import numpy as np

BLOCK = 2880
CARD = 80


class UnsupportedFITSError(ValueError):
    """The file uses a FITS feature this minimal parser does not
    implement; reading on would silently corrupt the data."""

_TFORM_RE = re.compile(r"^(\d*)([LXBIJKAEDCMP])(?:([A-Z])\((\d+)\))?")

_DTYPES = {
    "L": ("b", 1),
    "B": ("u1", 1),
    "I": (">i2", 2),
    "J": (">i4", 4),
    "K": (">i8", 8),
    "E": (">f4", 4),
    "D": (">f8", 8),
    "A": ("S1", 1),
}


class HDU:
    """One header-data unit: a dict-like header plus lazily parsed data."""

    def __init__(self, header: dict, raw_data: bytes, heap: bytes):
        self.header = header
        self._raw = raw_data
        self._heap = heap

    # -- binary table access -------------------------------------------------
    def columns(self) -> list[str]:
        n = int(self.header.get("TFIELDS", 0))
        return [str(self.header.get(f"TTYPE{i+1}", f"col{i+1}")).strip()
                for i in range(n)]

    def column(self, name: str) -> np.ndarray:
        """Return a table column as a numpy array (rows, [width])."""
        names = self.columns()
        idx = names.index(name)
        return self._read_column(idx)

    def _layout(self):
        n = int(self.header["TFIELDS"])
        offs, specs = [], []
        pos = 0
        for i in range(n):
            tform = str(self.header[f"TFORM{i+1}"]).strip()
            m = _TFORM_RE.match(tform)
            if not m:
                raise UnsupportedFITSError(
                    f"column {i+1}: unsupported TFORM {tform!r} (bit/"
                    "complex/Q-descriptor columns are not implemented)")
            rep = int(m.group(1)) if m.group(1) else 1
            code = m.group(2)
            if code == "P":  # variable-length array descriptor: 2 x int32
                sub = m.group(3)
                if sub not in _DTYPES:
                    raise UnsupportedFITSError(
                        f"column {i+1}: P-descriptor element type "
                        f"{sub!r} not implemented (TFORM {tform!r})")
                specs.append(("P", sub, rep))
                width = 8  # one (count, offset) int32 pair per row
            else:
                if code not in _DTYPES:
                    raise UnsupportedFITSError(
                        f"column {i+1}: column type {code!r} not "
                        f"implemented (TFORM {tform!r})")
                dt, size = _DTYPES[code]
                specs.append((code, dt, rep))
                width = size * rep
            offs.append(pos)
            pos += width
        if pos != int(self.header["NAXIS1"]):
            raise UnsupportedFITSError(
                f"computed row width {pos} != NAXIS1 "
                f"{self.header['NAXIS1']} — row layout uses a convention "
                "this parser does not implement")
        return offs, specs

    def _check_column_plain(self, idx: int):
        """Reject per-column scaling/null conventions we don't apply."""
        if self.header.get("ZIMAGE") is True or \
                self.header.get("ZTABLE") is True:
            raise UnsupportedFITSError(
                "tile-compressed HDU (ZIMAGE/ZTABLE): decompression is "
                "not implemented — raw stored bytes are not the data")
        for kw, ident in ((f"TSCAL{idx+1}", 1), (f"TZERO{idx+1}", 0)):
            v = self.header.get(kw)
            if v is not None and float(v) != ident:
                raise UnsupportedFITSError(
                    f"{kw}={v}: scaled columns are not implemented "
                    "(values would be returned unscaled)")
        if f"TNULL{idx+1}" in self.header:
            raise UnsupportedFITSError(
                f"TNULL{idx+1} present: integer null sentinels are not "
                "implemented (nulls would be returned as data)")

    def _read_column(self, idx: int) -> np.ndarray:
        self._check_column_plain(idx)
        nrows = int(self.header["NAXIS2"])
        rowlen = int(self.header["NAXIS1"])
        offs, specs = self._layout()
        off = offs[idx]
        code = specs[idx][0]
        table = np.frombuffer(self._raw[: nrows * rowlen], dtype="u1")
        table = table.reshape(nrows, rowlen)
        if code == "P":
            # descriptors: (count, byte offset into heap) as big-endian int32
            desc = table[:, off : off + 8].copy().view(">i4").reshape(nrows, 2)
            sub = specs[idx][1]
            dt, size = _DTYPES[sub]
            out = []
            for count, hoff in desc:
                buf = self._heap[hoff : hoff + count * size]
                out.append(np.frombuffer(buf, dtype=dt).astype(
                    np.dtype(dt).newbyteorder("=")))
            return out  # ragged: list of arrays
        dt = specs[idx][1]
        rep = specs[idx][2]
        size = np.dtype(dt).itemsize
        raw = table[:, off : off + rep * size].copy()
        arr = raw.view(dt).reshape(nrows, rep)
        arr = arr.astype(np.dtype(dt).newbyteorder("="))
        return arr[:, 0] if rep == 1 else arr


def _parse_header(buf: bytes, pos: int) -> tuple[dict, int]:
    header: dict = {}
    while True:
        block = buf[pos : pos + BLOCK]
        if len(block) < BLOCK:
            raise EOFError("truncated FITS header")
        pos += BLOCK
        done = False
        for i in range(0, BLOCK, CARD):
            card = block[i : i + CARD].decode("ascii", errors="replace")
            key = card[:8].strip()
            if key == "END":
                done = True
                break
            if card[8:10] != "= ":
                continue
            raw = card[10:]
            stripped = raw.lstrip()
            if stripped.startswith("'"):
                # quoted string: ends at the next single quote that is not
                # doubled ('' escapes a literal quote); the '/' comment
                # delimiter only applies OUTSIDE the quotes
                body = stripped[1:]
                out = []
                i = 0
                while i < len(body):
                    ch = body[i]
                    if ch == "'":
                        if i + 1 < len(body) and body[i + 1] == "'":
                            out.append("'")
                            i += 2
                            continue
                        break
                    out.append(ch)
                    i += 1
                header[key] = "".join(out).rstrip()
                continue
            val = raw.split("/")[0].strip()
            if val in ("T", "F"):
                header[key] = val == "T"
            else:
                try:
                    header[key] = int(val)
                except ValueError:
                    try:
                        header[key] = float(val)
                    except ValueError:
                        header[key] = val
        if done:
            return header, pos


def read_fits(path: str) -> list[HDU]:
    """Parse all HDUs of a FITS file."""
    with open(path, "rb") as f:
        buf = f.read()
    hdus = []
    pos = 0
    while pos < len(buf):
        header, pos = _parse_header(buf, pos)
        if header.get("GROUPS") is True:
            # random-groups sizing (NAXIS1=0, GCOUNT groups) would throw
            # off every subsequent HDU offset — refuse the whole file
            raise UnsupportedFITSError(
                f"{path}: random-groups FITS is not implemented")
        naxis = int(header.get("NAXIS", 0))
        dsize = 0
        if naxis:
            dsize = abs(int(header.get("BITPIX", 8))) // 8
            for i in range(naxis):
                dsize *= int(header[f"NAXIS{i+1}"])
        pcount = int(header.get("PCOUNT", 0))
        total = dsize + pcount
        raw = buf[pos : pos + dsize]
        # heap begins THEAP bytes after table start if THEAP given, else at
        # the end of the main table
        theap = int(header.get("THEAP", dsize) or dsize)
        heap = buf[pos + theap : pos + total]
        pos += (total + BLOCK - 1) // BLOCK * BLOCK
        hdus.append(HDU(header, raw, heap))
    return hdus


def find_hdu(hdus: list[HDU], extname: str | None = None) -> HDU:
    """Find a bintable HDU by EXTNAME; empty name matches the first
    BINTABLE with no/blank EXTNAME (cf. reference quirk of indexing by '' at
    reference joxsz_funcs.py:23)."""
    for h in hdus:
        if h.header.get("XTENSION", "").startswith("BINTABLE"):
            name = str(h.header.get("EXTNAME", "")).strip()
            if extname is None or name == extname or (extname == "" and not name):
                return h
    raise KeyError(f"no BINTABLE HDU named {extname!r}")
