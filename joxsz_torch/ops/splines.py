"""Fixed-knot interpolation as precomputed dense matrices (numpy/scipy).

Every cubic ``scipy.interpolate.interp1d`` in the reference hot path has
*fixed knots and fixed query points* — only the knot values change per
likelihood evaluation (reference joxsz_funcs.py:460,470,476 and the
setup-time sites :61,:129).  Cubic-spline evaluation is linear in the knot
values, so each call site becomes a dense (n_query, n_knot) matrix built
once on the host *with scipy itself* (guaranteeing bit-level parity with the
reference's interpolant), and the runtime cost is one matrix product.

The only interpolations whose *query* points vary per evaluation are small
sorted-table lookups (Compton->mJy conversion, count-rate vs log T); the
port evaluates those in torch next to the likelihood (``lerp_lookup``
here, ``models.xray.uniform_hat_lerp``, ``ops.joint_kernel``).
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.interpolate import interp1d



def interp_matrix(
    knots: np.ndarray,
    queries: np.ndarray,
    kind: str = "cubic",
    fill_value="extrapolate",
    assume_sorted: bool = False,
) -> np.ndarray:
    """(n_query, n_knot) matrix M with M @ values == interp1d(...)(queries).

    For the cubic case the matrix factorises as M = D @ C where C maps knot
    values to the not-a-knot B-spline coefficients (a banded solve on the
    identity, the same system ``interp1d('cubic')`` solves internally) and D
    is the sparse B-spline design matrix at the query points — this is
    >10x faster than evaluating an identity-valued interpolant at scale and
    produces the same matrix to machine precision (covered by tests against
    ``interp1d`` directly).  Other kinds fall back to the generic identity
    push-through.
    """
    knots = np.asarray(knots, dtype=np.float64)
    queries = np.asarray(queries, dtype=np.float64).ravel()
    if not assume_sorted:
        order = np.argsort(knots, kind="stable")
        knots = knots[order]
    else:
        order = None

    if kind == "cubic" and knots.size >= 4:
        from scipy.interpolate import make_interp_spline, BSpline

        extrap = isinstance(fill_value, str) and fill_value == "extrapolate"
        if not extrap and _fill_pair(fill_value) != (0.0, 0.0):
            # a non-zero constant fill is affine, not linear, in the values;
            # no call site needs it as a matrix
            raise NotImplementedError(
                "constant fills other than 0 are not expressible as a "
                "value->output matrix")
        spl = make_interp_spline(knots, np.eye(knots.size), k=3, axis=0)
        inside = (queries >= knots[0]) & (queries <= knots[-1])
        q_eval = queries if extrap else np.clip(queries, knots[0], knots[-1])
        D = BSpline.design_matrix(q_eval, spl.t, 3, extrapolate=extrap)
        M = np.asarray(D @ spl.c)
        if not extrap:
            M[~inside] = 0.0
    else:
        # same affine-fill guard as the cubic fast path: pushing the
        # identity through interp1d turns a constant out-of-range fill c
        # into a row of c's, so M @ v returns c*sum(v) instead of c — a
        # silently wrong matrix for any non-zero fill
        extrap = isinstance(fill_value, str) and fill_value == "extrapolate"
        if not extrap and _fill_pair(fill_value) != (0.0, 0.0):
            raise NotImplementedError(
                "constant fills other than 0 are not expressible as a "
                "value->output matrix")
        eye = np.eye(knots.size)
        f = interp1d(
            knots,
            eye,
            kind=kind,
            axis=0,
            bounds_error=False,
            fill_value=fill_value,
            assume_sorted=True,
        )
        M = f(queries)

    if order is not None:
        inv = np.empty_like(order)
        inv[order] = np.arange(order.size)
        M = M[:, inv]
    return M


def _fill_pair(fill_value):
    if isinstance(fill_value, tuple):
        return fill_value
    return (fill_value, fill_value)


def mirrored_interp_matrix(
    r_pos: np.ndarray,
    queries: np.ndarray,
    kind: str = "cubic",
    fill_value=(0.0, 0.0),
) -> np.ndarray:
    """Matrix for the reference's mirrored-profile trick: a profile sampled
    at positive radii ``r_pos`` is reflected to the signed axis
    (knots = [-r..., r...], values = [v reversed, v]) before cubic
    interpolation (reference joxsz_funcs.py:460-462,470-471).

    Returns an (n_query, n_pos) matrix acting directly on the *unmirrored*
    profile values.
    """
    r_pos = np.asarray(r_pos, dtype=np.float64)
    knots = np.concatenate([-r_pos[::-1], r_pos])
    M = interp_matrix(knots, queries, kind=kind, fill_value=fill_value,
                      assume_sorted=True)
    n = r_pos.size
    # fold mirrored-knot columns back onto the positive-radius values
    return M[:, :n][:, ::-1] + M[:, n:]


def lerp_lookup(table_x: torch.Tensor, table_y: torch.Tensor,
                x: torch.Tensor, extrapolate: bool = True) -> torch.Tensor:
    """Piecewise-linear lookup into a small sorted table ``table_x``;
    ``table_y`` may carry leading axes (``table_y[..., idx]``).

    With ``extrapolate=True`` the end segments are extended linearly,
    matching scipy ``interp1d(..., 'linear', fill_value='extrapolate')``
    as used for the Compton->mJy conversion (reference
    joxsz_main.py:109); with ``extrapolate=False`` the value is clamped at
    the table's ends (``np.interp``)."""
    idx = torch.clamp(torch.searchsorted(table_x, x.contiguous(),
                                         right=True) - 1,
                      0, table_x.shape[0] - 2)
    x0 = table_x[idx]
    x1 = table_x[idx + 1]
    y0 = table_y[..., idx]
    y1 = table_y[..., idx + 1]
    t = (x - x0) / (x1 - x0)
    if not extrapolate:
        t = torch.clamp(t, 0.0, 1.0)
    return y0 + t * (y1 - y0)
