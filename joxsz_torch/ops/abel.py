"""Forward Abel transform as a precomputed quadrature matrix.

The reference computes the line-of-sight projection of the pressure profile
with PyAbel's *direct* forward transform, Python backend, singularity
correction on (reference joxsz_funcs.py:457):

    F(y) = 2 * Int_y^R  f(r) * r / sqrt(r^2 - y^2) dr

evaluated on the fixed radial grid ``r_pp``.  The quadrature is a trapezoid
rule over the regular cells plus an analytic treatment of the singular cell
[y, r_{j+1}] assuming the integrand w(r) = 2 r f(r) is linear there:

    Int_y^{r1} (a + b (r - y)) / sqrt(r^2 - y^2) dr
        = a * acosh(r1 / y) + b * (sqrt(r1^2 - y^2) - y * acosh(r1 / y)).

Because both pieces are linear in the sampled values f(r_i), the whole
transform is one (n, n) matrix ``A`` with F = A @ f.  A batch of
profiles becomes a single matrix product; there is nothing left of the per-eval
O(n^2) Python loop the reference pays 4.7 ms for (SURVEY.md §6).
"""

from __future__ import annotations

import numpy as np


def forward_abel_matrix(r: np.ndarray, scheme: str = "pyabel") -> np.ndarray:
    """Quadrature matrix A (n, n): (A @ f)[j] = F(y=r[j]).

    Requires r strictly increasing and positive (r[0] > 0), as produced by
    the map geometry (r_pp starts at one kpc-step).

    scheme='pyabel': trapezoid over the regular cells + analytic singular
        cell — matches the reference's PyAbel direct/Python path.  Carries
        the scheme's intrinsic near-singularity trapezoid bias (~1e-3
        relative for slowly varying profiles), which the reference pays too.
    scheme='exact-linear': integrate the 1/sqrt(r^2-y^2) kernel against the
        piecewise-linear interpolant of w(r) = 2 r f(r) analytically on
        EVERY cell — uniformly O(h^2), no singular-cell bias.  Preferred
        when reference parity is not required.
    """
    r = np.asarray(r, dtype=np.float64)
    n = r.size
    if not (np.all(np.diff(r) > 0) and r[0] > 0):
        raise ValueError("r must be strictly increasing and positive")

    # weights acting on the integrand w_i = 2 r_i f_i
    W = np.zeros((n, n))
    rr2 = r * r

    if scheme == "pyabel":
        for j in range(n - 1):
            y2 = rr2[j]
            seg = np.arange(j + 1, n)
            g = 1.0 / np.sqrt(rr2[seg] - y2)
            # PyAbel integrates np.trapz over the WHOLE row against the
            # diagonal-zeroed kernel (which sneaks in a triangle
            # 0.5 h_j g_{j+1} w_{j+1} from the singular cell), then
            # subtracts HALF the trapezoid of the row masked to its
            # first two points.  On interior rows of a uniform grid
            # that recovers the plain trapezoid over [r_{j+1}, R]; on
            # the second-to-last row the masked trapezoid only sees one
            # adjacent cell, leaving a deliberate extra
            # 0.25 h g_{n-1} w_{n-1} — reproduced here for bit parity
            # (tests/pyabel_direct_transcription.py pins this).
            h = np.diff(r[j:])                      # h[0] = r_{j+1}-r_j
            tw = np.zeros(seg.size)
            tw += 0.5 * h                           # left-cell halves
            tw[:-1] += 0.5 * h[1:]                  # right-cell halves
            tw[0] -= 0.25 * (h[0] + (h[1] if seg.size > 1 else 0.0))
            W[j, seg] += tw * g
            # analytic singular cell [r_j, r_{j+1}], w linear on the cell
            y = r[j]
            r1 = r[j + 1]
            acosh = np.arccosh(r1 / y)
            sq = np.sqrt(r1 * r1 - y2)
            h0 = r1 - y
            # w(r) = w_j + (w_{j+1} - w_j) (r - y)/h0
            W[j, j] += acosh - (sq - y * acosh) / h0
            W[j, j + 1] += (sq - y * acosh) / h0
        # last row: no integration range -> zero
    elif scheme == "exact-linear":
        # For each target y_j and each cell [r_i, r_{i+1}] with i >= j:
        #   I0 = acosh(r/y)]        (integral of dr/sqrt(r^2-y^2))
        #   I1 = sqrt(r^2-y^2)]     (integral of r dr/sqrt(r^2-y^2))
        # and w(r) = w_i + (w_{i+1}-w_i)(r-r_i)/h gives cell weights
        #   on w_i:     I0 (1 + r_i/h) - I1/h
        #   on w_{i+1}: (I1 - r_i I0)/h
        for j in range(n - 1):
            y = r[j]
            y2 = rr2[j]
            i = np.arange(j, n - 1)
            a = r[i]
            b = r[i + 1]
            h = b - a
            sq_a = np.sqrt(np.maximum(rr2[i] - y2, 0.0))
            sq_b = np.sqrt(rr2[i + 1] - y2)
            ac_a = np.arccosh(np.maximum(a / y, 1.0))
            ac_b = np.arccosh(b / y)
            I0 = ac_b - ac_a
            I1 = sq_b - sq_a
            wa = I0 - (I1 - a * I0) / h
            wb = (I1 - a * I0) / h
            np.add.at(W[j], i, wa)
            np.add.at(W[j], i + 1, wb)
    else:
        raise ValueError(f"unknown Abel scheme {scheme!r}")

    # fold in the w = 2 r f change of integrand
    return W * (2.0 * r)[None, :]


def forward_abel(f: np.ndarray, r: np.ndarray,
                 scheme: str = "pyabel") -> np.ndarray:
    """Convenience direct evaluation (host-side)."""
    return forward_abel_matrix(r, scheme) @ np.asarray(f, dtype=np.float64)
