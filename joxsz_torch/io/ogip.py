"""OGIP spectral-response parsing: RMF (MATRIX + EBOUNDS) and ARF.

The port's copy of ``joxsz_tpu/io/ogip.py`` on its own ``io/fitsio.py``.
Read only where a count-rate table is generated (``joxsz_torch.tablegen``,
and ``build.find_table`` for a cluster without a matching table); the
likelihood never touches response files.  The reference delegates this entirely to XSPEC via mbproj2
(reference joxsz_funcs.py:652-681); here we parse the OGIP formats
ourselves so the table can be built without HEASOFT.

The RMF ``MATRIX`` extension stores, per input energy bin, a compressed row
of the redistribution matrix: N_GRP channel groups, each with a first
channel (F_CHAN), a length (N_CHAN) and packed response values.  We expand
to a dense (n_energy, n_channel) matrix — 1070 x 1024 for the bundled
Chandra response, small enough that dense is the right call.
"""

from __future__ import annotations

import dataclasses
import numpy as np

from .fitsio import read_fits, find_hdu


@dataclasses.dataclass(frozen=True)
class Response:
    """Dense instrument response: R[e, c] = P(count in channel c | photon
    in energy bin e) x (effective area if ARF folded in)."""

    energ_lo: np.ndarray     # (nE,) keV
    energ_hi: np.ndarray     # (nE,) keV
    matrix: np.ndarray       # (nE, nC)
    chan_e_min: np.ndarray   # (nC,) keV
    chan_e_max: np.ndarray   # (nC,) keV
    specresp: np.ndarray     # (nE,) cm^2 (ones if no ARF folded)

    @property
    def energ_mid(self) -> np.ndarray:
        return 0.5 * (self.energ_lo + self.energ_hi)

    @property
    def energ_width(self) -> np.ndarray:
        return self.energ_hi - self.energ_lo

    def channel_mask(self, emin_keV: float, emax_keV: float) -> np.ndarray:
        """Channels whose nominal energy interval lies within the band
        (boundary-inclusive), the criterion used to sum band count rates."""
        return (self.chan_e_min >= emin_keV - 1e-9) & \
               (self.chan_e_max <= emax_keV + 1e-9)

    def folded(self) -> np.ndarray:
        """(nE, nC) response with the effective area folded in."""
        return self.matrix * self.specresp[:, None]


def _as_list_of_arrays(col, nrows):
    """Normalise a fixed/variable column to a list of 1-D arrays."""
    if isinstance(col, list):
        return col
    a = np.atleast_2d(col)
    if a.shape[0] != nrows:
        a = a.reshape(nrows, -1)
    return [a[i] for i in range(nrows)]


def read_rmf(path: str) -> Response:
    hdus = read_fits(path)
    mat_hdu = None
    for h in hdus:
        name = str(h.header.get("EXTNAME", "")).strip()
        if name in ("MATRIX", "SPECRESP MATRIX"):
            mat_hdu = h
            break
    if mat_hdu is None:
        raise ValueError(f"no MATRIX extension in {path}")
    eb_hdu = find_hdu(hdus, "EBOUNDS")

    nE = int(mat_hdu.header["NAXIS2"])
    energ_lo = np.asarray(mat_hdu.column("ENERG_LO"), dtype=float)
    energ_hi = np.asarray(mat_hdu.column("ENERG_HI"), dtype=float)
    n_grp = np.asarray(mat_hdu.column("N_GRP"), dtype=int)
    f_chan = _as_list_of_arrays(mat_hdu.column("F_CHAN"), nE)
    n_chan = _as_list_of_arrays(mat_hdu.column("N_CHAN"), nE)
    m_vals = _as_list_of_arrays(mat_hdu.column("MATRIX"), nE)

    channel = np.asarray(eb_hdu.column("CHANNEL"), dtype=int)
    e_min = np.asarray(eb_hdu.column("E_MIN"), dtype=float)
    e_max = np.asarray(eb_hdu.column("E_MAX"), dtype=float)
    nC = channel.size
    # F_CHAN's channel origin: per OGIP (CAL/GEN/92-002a) the F_CHAN
    # column's TLMIN declares it.  EBOUNDS CHANNEL[0] is only a
    # fallback — the two conventions CAN differ across missions (0-based
    # F_CHAN with 1-based EBOUNDS numbering), and using the wrong origin
    # silently shifts every response row by one channel (a -1 start
    # would even wrap values to the row's end).  The out-of-range guard
    # below keeps any residual mismatch loud, per this module's
    # "rejected loudly, never misread" contract.
    fchan_idx = None
    for i, cname in enumerate(mat_hdu.columns()):
        if cname == "F_CHAN":
            fchan_idx = i + 1
            break
    tlmin = (None if fchan_idx is None
             else mat_hdu.header.get(f"TLMIN{fchan_idx}"))
    first_chan = int(tlmin) if tlmin is not None else int(channel[0])

    dense = np.zeros((nE, nC))
    for e in range(nE):
        pos = 0
        row = np.asarray(m_vals[e], dtype=float)
        for g in range(int(n_grp[e])):
            start = int(np.atleast_1d(f_chan[e])[g]) - first_chan
            count = int(np.atleast_1d(n_chan[e])[g])
            if start < 0 or start + count > nC:
                raise ValueError(
                    f"{path}: MATRIX row {e} group {g} spans channels "
                    f"[{start}, {start + count}) outside [0, {nC}) "
                    f"after subtracting the F_CHAN origin {first_chan} "
                    f"(TLMIN{fchan_idx}={tlmin!r}, EBOUNDS first "
                    f"channel {int(channel[0])}) — inconsistent channel "
                    f"numbering conventions")
            dense[e, start : start + count] = row[pos : pos + count]
            pos += count
    return Response(
        energ_lo=energ_lo, energ_hi=energ_hi, matrix=dense,
        chan_e_min=e_min, chan_e_max=e_max,
        specresp=np.ones(nE),
    )


def read_arf(path: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(energ_lo, energ_hi, specresp) from a SPECRESP extension."""
    hdu = find_hdu(read_fits(path), "SPECRESP")
    return (
        np.asarray(hdu.column("ENERG_LO"), dtype=float),
        np.asarray(hdu.column("ENERG_HI"), dtype=float),
        np.asarray(hdu.column("SPECRESP"), dtype=float),
    )


def load_response(rmf_path: str, arf_path: str | None = None) -> Response:
    """RMF with the ARF effective area attached (grids must agree)."""
    resp = read_rmf(rmf_path)
    if arf_path is None:
        return resp
    lo, hi, area = read_arf(arf_path)
    if lo.size != resp.energ_lo.size or not np.allclose(lo, resp.energ_lo,
                                                        rtol=1e-5):
        raise ValueError("ARF energy grid does not match RMF")
    return dataclasses.replace(resp, specresp=area)
