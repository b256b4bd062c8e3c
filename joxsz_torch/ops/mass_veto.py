"""The HSE-mass veto decided as the float64 model decides it, at float32
cost: the plain mirror of ``csrc/mass_veto.cuh``.

The reference verdict is the float64 model's ``np.gradient(M) > 0`` on
the pressure grid (``joxsz_tpu/models/joint.py::_mass_veto_ok``; for knot
pressure, the segment midpoints' masses increasing and the last one
positive).  The kernels compare the mass in float32 (the parent's product
form, or its signed logarithm where n_e^2 leaves float32's normal range),
which misorders two masses within float32's rounding of each other.  Each
pair is therefore decided in three tiers:

1. **product form** (or signed log), with an a-priori bound on its error:
   per walker, from the profiles at the two ends of the grid (every
   piece of the bound is monotone in r, so its largest value over the
   grid is at an end), ``t0`` (twice the largest relative error of one
   mass from roundings of its own radius) plus ``tc`` times the pair's
   ln(r_hi / r_lo) (the walker's float32 scalars, which shift both masses
   of a pair alike); a pair beyond the bound is decided here;
2. **difference form**: ln M_hi - ln M_lo = ln(r_hi / r_lo) + Delta ln P
   + Delta ln g - Delta q / 2, each difference formed without
   cancellation (log1p / expm1 of the lower radius' values and of a
   constant of the grid), with its own bound, a few float32 ulps of
   terms of order 0.01-0.3;
3. **float64**: the pair's two masses as the float64 model forms them
   (``models/mass.py``), for the pairs the difference form cannot decide.

A pair that tier 1 is not sure of is decided by tiers 2-3 unless the
walker is already vetoed by a sure pair or lies outside the prior box
(its log-posterior is -inf either way), so the verdict is the float64
model's and every decision the parent took on a sure pair is unchanged.
``T2_PAIRS`` counts the pairs tier 1 left to tiers 2-3 (``cand``) and
``F64_PAIRS`` those that reached tier 3, on the CPU (the kernels count
theirs on the card: ``ops.joint_kernel.tier2_pairs`` and ``f64_pairs``).

Bounds are first-order in u = 2^-24, in units of u, with float32
library errors of 2 ulp (expf, rsqrtf), 1 ulp (logf, log1pf, expm1f)
and 4 ulp (powf), and fl(x) = x (1 + d), |d| <= u, for the rest;
``gnfw_walker_bounds`` and ``knot_mass_bounds`` derive them.
``tests/test_torch_veto_ties.py`` holds each tier's value to float64
within its bound on every pair of production-box and cloud rows.
"""

from __future__ import annotations

import numpy as np
import torch

from .consts_layout import D_DOUBLE, gradient_pairs

U = 2.0 ** -24                 # float32's unit roundoff
LN10 = float(np.log(10.0))
# a walker whose pair tolerance would pass this takes tiers 2-3 for every
# pair (the product form's test folds T^2 into 1 % of T below it)
T_MAX = 0.005
# pairs tier 1 left to tiers 2-3 on the CPU (never reset), and pairs the
# float64 tier decided there since the last reset
T2_PAIRS = [0]
F64_PAIRS = [0]


def _f(x):
    return torch.as_tensor(x, dtype=torch.float32)


def _amax(x):
    """Largest |value| over the last axis (the grid's two ends)."""
    return x.abs().amax(dim=-1, keepdim=True)


def outer_start(n: int) -> int:
    """The first gradient pair of the grid's outer half, which takes its
    own tier-1 tolerance (``gnfw_walker_bounds``' t0o)."""
    return n // 2


def gnfw_walker_bounds(c, th, sc: dict) -> dict:
    """Per-walker tier-1 tolerances of the gNFW product form (and its
    signed log) from the rows ``th`` (B, D), the walker's gNFW scalars
    ``sc`` ((B, 1): a, bca, bmc, lnrp, P0, as the kernel forms them) and
    the grid: its ends, the lower radius of its outer half's first pair
    (``outer_start`` - 1) and the largest ln(r_hi / r_lo) of each half
    (DLR's last two entries).

    Relative error of one mass from its own radius' roundings, units u:
    ln x from the grid constant ln r and a subtraction, |lnr| + |lnx|;
    a ln x, dz = |a|(|lnr| + |lnx|) + |za|; ln(1 + x^a) <= f dz + 4 + s;
    ln P/P0, |c|(|lnr| + |lnx|) + |bca| (dz + 4 + s) + |c lnx| + |bca| s +
    |lnp|, and expf's 4; g = c + (b - c)(1 - expf(-s)), whose subtraction
    cancels where f is small: (1 - f)(dz + 16) + 4 |b - c| (1 - f) / g + 4
    (with c, b - c >= 0, a > 0: g >= (b - c) f, g >= c), which falls with
    r and is taken at a region's lowest radius, r[0] for t0 and the outer
    half's for t0o; q: |ec|(5 + 3 l1) + |es|(8 + 3 l2) + |q|; 1/n_e: q / 2
    + 6.5; five products.  Every other piece is monotone in r and is
    bounded at the grid's ends: s = ln(1 + x^a) <= max(za, 0) + ln 2, l1
    = ln(1 + x_c^2) <= max(2 ln x_c, 0) + ln 2 (and l2, l3 alike), |lnp|
    <= |c| |lnx| + |bca| s, |q| <= |ec| l1 + |es| l2.  The signed log form
    adds ln|g|'s and three sums' roundings.  The pair's share from the
    walker's float32 scalars (ln r_p, b - c, (b - c)/a, c, r_c, r_s, ec,
    es) is tc ln(r_hi / r_lo): their error times the change over the pair
    of the mass's sensitivity to them, taken at the half's largest ln(r_hi
    / r_lo) in t0, t0o and tl.

    Returns (B, 1) tensors t0, t0o (the product form's tolerance on the
    grid's inner and outer half), tl (the signed log's), tc, sgn (the
    masses' sign) and the bool masks unsafe (every pair to tiers 2-3: g
    may change sign) and unsafe_prod (the product form may leave
    float32's normal range)."""
    F, A, R = c.floats, c.arrays, c.roles
    LN2 = float(np.log(2.0))
    cg = _f(F["c_gnfw"])
    alpha, gamma = F["alpha"], F["gamma"]
    a, bca, bmc, lnrp = sc["a"], sc["bca"], sc["bmc"], sc["lnrp"]

    def col(role):
        return th[:, R[role]:R[role] + 1]

    ec = (3.0 * col(r"\beta") - alpha / 2.0).abs()
    es = (col(r"\epsilon") / gamma).abs()
    lnrci = -LN10 * col("log(r_c)")
    lnrsi = -LN10 * col("log(r_s)")
    lnn0sq = 2.0 * LN10 * col("log(n_0)")
    lnr = A["lnr"]
    n = lnr.shape[0]
    km = outer_start(n) - 1
    l0, lN = lnr[0], lnr[n - 1]
    lx0, lxN = l0 - lnrp, lN - lnrp
    za0, zaN = a * lx0, a * lxN
    aa, ab, abmc, acg = a.abs(), bca.abs(), bmc.abs(), cg.abs()
    Lr = torch.maximum(l0.abs(), lN.abs())
    Lx = torch.maximum(lx0.abs(), lxN.abs())
    Z = torch.maximum(za0.abs(), zaN.abs())
    S = torch.clamp(torch.maximum(za0, zaN), min=0.0) + LN2
    P = acg * Lx + ab * S
    dz = aa * (Lr + Lx) + Z
    drel = acg * (Lr + Lx) + ab * (dz + 4.0 + S) + acg * Lx + ab * S + P \
        + 4.0
    f0, cf0 = _sigmoid_pair(za0)
    fm, cfm = _sigmoid_pair(a * (lnr[km] - lnrp))
    fN, _ = _sigmoid_pair(zaN)
    g0, gm, gN = cg + bmc * f0, cg + bmc * fm, cg + bmc * fN
    dg = cf0 * (dz + 16.0) + 4.0 * abmc * cf0 / g0 + 4.0
    dg_out = cfm * (dz + 16.0) + 4.0 * abmc * cfm / gm + 4.0
    L1 = torch.clamp(2.0 * (lN + lnrci), min=0.0) + LN2
    L2 = torch.clamp(gamma * (lN + lnrsi), min=0.0) + LN2
    dt2 = 8.0 if gamma == 3.0 else 2.0 * abs(gamma) + 8.0
    Q = ec * L1 + es * L2
    dq = ec * (5.0 + 3.0 * L1) + es * (dt2 + 3.0 * L2)
    if alpha != 0.0:
        Lc = torch.maximum((l0 + lnrci).abs(), (lN + lnrci).abs())
        Q = Q + abs(alpha) * Lc
        dq = dq + abs(alpha) * (4.0 + 2.0 * Lc) + 10.0
    dq = dq + Q
    dqlog, dne2 = dq, dq + 5.0
    ag = abs(gamma)
    cq = 6.0 * ec + es * ag * (ag + 0.5) + abs(alpha)
    if c.ints["d_fam"] == D_DOUBLE:
        e2 = (3.0 * col(r"\beta_2")).abs()
        ln02 = 2.0 * LN10 * col("log(n_{02})")
        L3 = torch.clamp(2.0 * (lN - LN10 * col("log(r_{c2})")),
                         min=0.0) + LN2
        dln = (ln02 - lnn0sq).abs()
        Q2 = e2 * L3
        dq2 = e2 * (5.0 + 3.0 * L3) + Q2
        dne2 = torch.maximum(dne2, dq2 + 7.0) + 1.0
        Q = torch.maximum(Q, Q2 + dln) + LN2
        dqlog = torch.maximum(dq, dq2 + 3.0 * (ln02.abs() + lnn0sq.abs())
                              + 2.0 * dln) + 3.0 * Q + 2.0
        cq = cq + 6.0 * e2 + (2.0 * ec + ag * es + 2.0 * e2) * (
            ln02.abs() + lnn0sq.abs() + 2.0) * 0.5
    dinv = 0.5 * dne2 + 4.0
    Lg = torch.maximum(torch.log(g0).abs(), torch.log(gN).abs()) + 1e-3
    e_log = Lr + 2.0 * Lg + dg + drel + 0.5 * dqlog \
        + 3.0 * (Lr + Lg + P + 0.5 * Q) + 4.0
    tc = (U * 1.01) * (2.0 * lnrp.abs() * (abmc * aa * 0.25 + 2.0 * a * a)
                       + 2.0 * abmc + 2.0 * acg + 3.25 * aa + cq)
    L_in, L_out = A["DLR"][n], A["DLR"][n + 1]
    t0 = (2.0 * U * 1.01) * (drel + dg + dinv + 6.0) + 5.0 * U + tc * L_in
    t0o = (2.0 * U * 1.01) * (drel + dg_out + dinv + 6.0) + 5.0 * U \
        + tc * L_out
    tl = (2.0 * U * 1.01) * e_log + 5.0 * U + tc * torch.maximum(L_in, L_out)
    n0h = 0.5 * lnn0sq.abs()
    part_lo = -P + torch.minimum(l0, lN) + torch.log(g0)
    part_hi = P + torch.maximum(l0, lN) + torch.log(gN)
    unsafe = ~((cg >= 0.0) & (bmc >= 0.0) & (a > 0.0) & (g0 > 0.0)
               & (tl < T_MAX))
    unsafe_prod = ~((part_lo > -86.0) & (part_lo - n0h - 0.5 * Q > -86.0)
                    & (part_hi + n0h + 0.5 * Q < 86.0) & (t0 < T_MAX)
                    & (t0o < T_MAX))
    return dict(t0=t0, t0o=t0o, tl=tl, tc=tc, sgn=torch.sign(sc["P0"]),
                unsafe=unsafe, unsafe_prod=unsafe_prod)


def tier1_pairs(m, lo, hi, wb: dict, slow):
    """Tier 1 on every pair: (sure_bad, unsure) (B, n) masks.  Product
    form (rows not ``slow``): sure greater if m_hi > m_lo (1 + sgn T),
    sure not greater unless m_hi > m_lo (1 - sgn T), T = t0 on the inner
    half's pairs and t0o on the outer half's.  Signed log (``slow``
    rows): on d = m_hi - m_lo against tl + 3u (|m_hi| + |m_lo|).  Rows
    ``unsafe`` (and, on the product form, ``unsafe_prod``) are unsure on
    every pair."""
    mlo, mhi = m[:, lo], m[:, hi]
    outer = torch.arange(m.shape[1], device=m.device) >= outer_start(
        m.shape[1])
    sT = wb["sgn"] * torch.where(outer, wb["t0o"], wb["t0"])
    up = mlo + mlo * sT
    dn = mlo - mlo * sT
    bad_p = ~(mhi > dn)
    uns_p = (mhi > dn) & ~(mhi > up)
    d = mhi - mlo
    tol = wb["tl"] + (3.0 * U) * (mhi.abs() + mlo.abs())
    bad_l = ~(d > -tol)
    uns_l = (d > -tol) & ~(d > tol)
    bad = torch.where(slow, bad_l, bad_p)
    uns = torch.where(slow, uns_l, uns_p)
    every = wb["unsafe"] | (wb["unsafe_prod"] & ~slow)
    return bad & ~every, uns | every


def _sigmoid_pair(za):
    """(f, 1 - f) = (sigmoid(za), sigmoid(-za)) without cancellation."""
    e = torch.exp(-za.abs())
    f_pos = 1.0 / (1.0 + e)
    return (torch.where(za >= 0, f_pos, e * f_pos),
            torch.where(za >= 0, e * f_pos, f_pos))


def _dlog1p(t, em, x, dt):
    """ln(1 + t e^x) - ln(1 + t) = log1p(w em), w = t / (1 + t) (1 where t
    passes 1e30), em = expm1(x), and its bound (units u): t with relative
    error dt, x with u |x|.  The bound: w's error (1 - w) dt + 3; em's
    relative error u |x| (1 + em) / em <= u (1 + |x|), and 2 ulp; the
    product; log1p's argument error times v / (1 + v) <= log1p(v) for v
    >= 0, and 2 ulp."""
    w = torch.where(t > 1e30, torch.ones_like(t), t / (1.0 + t))
    E = torch.log1p(w * em)
    return E, ((1.0 - w) * dt + 9.0 + x.abs()) * E.abs()


def dq_tier2(c, sc: dict, r, L):
    """(Delta q, its bound in u) between radii r and r e^L, float32: q =
    ln(n_e^2 / n_0^2); single: -ec E1 - es E2 - alpha L with E1, E2 the
    log1p forms of ln(1 + x_c^2), ln(1 + x_s^gamma); double: log1p(w
    expm1(dq1) + (1 - w) expm1(dd2)), w the first term's weight at r."""
    F = c.floats
    alpha, gamma = F["alpha"], F["gamma"]
    ec, es = sc["ec"], sc["es"]
    xc = r * sc["rci"]
    xs = r * sc["rsi"]
    t1 = xc * xc
    t2 = xs * xs * xs if gamma == 3.0 else xs ** gamma
    em2 = torch.expm1(2.0 * L)
    dt2 = 32.0 if gamma == 3.0 else 10.0 * abs(gamma) + 8.0
    E1, b1 = _dlog1p(t1, em2, 2.0 * L, 21.0)
    E2, b2 = _dlog1p(t2, torch.expm1(gamma * L), gamma * L, dt2)
    dq1 = -ec * E1 - es * E2
    if alpha != 0.0:
        dq1 = dq1 - alpha * L
    b_dq1 = (ec.abs() * (b1 + 2.0 * E1.abs()) + es.abs() * (
        b2 + 2.0 * E2.abs()) + 3.0 * (alpha * L).abs() + 2.0 * dq1.abs())
    if c.ints["d_fam"] != D_DOUBLE:
        return dq1, b_dq1
    x2 = r * sc["rc2i"]
    t3 = x2 * x2
    e2 = sc["e2"]
    E3, b3 = _dlog1p(t3, em2, 2.0 * L, 21.0)
    dd2 = e2 * E3
    q1l = -ec * torch.log1p(t1) - es * torch.log1p(t2)
    if alpha != 0.0:
        q1l = q1l - alpha * torch.log(xc)
    d2l = (sc["ln02"] - sc["lnn0sq"]) + e2 * torch.log1p(t3)
    w, _ = _sigmoid_pair(q1l - d2l)
    X1, X2 = torch.expm1(dq1), torch.expm1(dd2)
    Y = w * X1 + (1.0 - w) * X2
    dq = torch.log1p(Y)
    b_dd2 = e2.abs() * (b3 + 2.0 * E3.abs())
    d_arg = 3.0 * (q1l.abs() + d2l.abs() + sc["ln02"].abs()
                   + sc["lnn0sq"].abs()) + 10.0
    bY = (w * ((1.0 + X1) * b_dq1 + 2.0 * X1.abs())
          + (1.0 - w) * ((1.0 + X2) * b_dd2 + 2.0 * X2.abs())
          + (X1 - X2).abs() * (w * (1.0 - w) * d_arg + 3.0)
          + 2.0 * (w * X1).abs() + 2.0 * ((1.0 - w) * X2).abs())
    return dq, bY / (1.0 + Y) + 2.0 * dq.abs()


def gnfw_tier2(c, sc: dict, r, lnr, L):
    """Tier 2 of gNFW pairs, float32, one value per gathered pair: (dlm,
    bound, decidable).  ``sc``: the pair's walker scalars (N,), with
    ``tc``; r, lnr: the lower radius' constants; L = ln(r_hi / r_lo).
    dlm = ln|M_hi| - ln|M_lo| = (1 - c) L - bca D1 + G1 - dq / 2: D1 =
    log1p(f em), em = expm1(a L), f = sigmoid(a ln x_lo); G1 = log1p(
    Delta g / g_lo), Delta g = (b - c) f em (1 - f) / (1 + f em); dq from
    ``dq_tier2``.  Bound (units u, then absolute), for a > 0 and c, b - c
    >= 0 (else not decidable here): ln x_lo's error dz = |a|(|lnr| +
    |lnx|) + |za| makes f's relative error (1 - f) dz + 7 and 1 - f's f
    dz + 7; em's u |aL| (1 + em) / em <= u (1 + |aL|) and 2 ulp, so y =
    f em within dy = (1 - f) dz + 2|aL| + 14; D1 = log1p(y) within (dy +
    4) D1 (y / (1 + y) <= D1); Delta g within 2 dy + f dz + 12, g_lo
    within (1 - f) dz + 8 (b - c) f / g_lo <= 1), so G1 within (2 dy + dz
    + 25) G1; three products of the sum and its four additions; plus tc
    L, the walker's float32 scalars' share (``gnfw_walker_bounds``)."""
    cg = _f(c.floats["c_gnfw"])
    a, bca, bmc = sc["a"], sc["bca"], sc["bmc"]
    ok = (a > 0.0) & (cg >= 0.0) & (bmc >= 0.0)
    lnx = lnr - sc["lnrp"]
    za = a * lnx
    f, cf = _sigmoid_pair(za)
    aL = a * L
    y = f * torch.expm1(aL)
    D1 = torch.log1p(y)
    g_lo = cg + bmc * f
    ok = ok & (g_lo > 0.0)
    dgap = bmc * y * cf / (1.0 + y)
    G1 = torch.log1p(dgap / g_lo)
    dq, b_dq = dq_tier2(c, sc, r, L)
    dlm = (L - cg * L) - bca * D1 + G1 - 0.5 * dq
    dz = a.abs() * (lnr.abs() + lnx.abs()) + za.abs()
    dy = cf * dz + 2.0 * aL.abs() + 14.0
    terms = (L.abs() + (cg * L).abs() + (bca * D1).abs() + G1.abs()
             + 0.5 * dq.abs())
    bound = (3.0 * L.abs() * (1.0 + cg.abs()) + bca.abs() * (dy + 4.0) * D1
             + (bca * D1).abs() + (2.0 * dy + dz + 25.0) * G1.abs()
             + 0.5 * b_dq + 4.0 * terms) * (1.01 * U) + sc["tc"] * L
    return dlm, bound, ok


def knot_tier2(c, sc: dict, v0, v1, v2, rm, lnrho, lndr):
    """Tier 2 of the knot pairs (midpoints j, j + 1 of segments j, j + 1,
    knot values v0, v1, v2), float32: (dlm, bound) with dlm = ln|M_j+1| -
    ln|M_j| = ln((v2 - v1) / (v1 - v0)) + ln(d_j / d_j+1) + ln(rm_j+1 /
    rm_j) + ln 10 (v2 - v0) / 2 - dq / 2 (dq from ``dq_tier2`` at rm_j);
    the slopes' ratio within 3 roundings and logf's ulp, the constants
    within theirs, four additions, plus tc ln(rm_j+1 / rm_j)."""
    lr = torch.log((v2 - v1) / (v1 - v0))
    tp = LN10 * (0.5 * (v2 - v0))
    dq, b_dq = dq_tier2(c, sc, rm, lnrho)
    dlm = lr + lndr + lnrho + tp - 0.5 * dq
    terms = (lr.abs() + lndr.abs() + lnrho.abs() + tp.abs()
             + 0.5 * dq.abs())
    bound = (3.0 + 2.0 * lr.abs() + lndr.abs() + lnrho.abs()
             + 3.0 * tp.abs() + 0.5 * b_dq + 4.0 * terms) * (1.01 * U) \
        + sc["tc"] * lnrho
    return dlm, bound


def knot_mass_bounds(c, sc: dict, v0, v1, sl, lnpm, lpn, dens: dict):
    """Per-mass tier-1 errors of the knot masses (B, NM), units u: the
    product form's relative error e (the slope v0 s0 + v1 s1 within
    (|v0| + |v1|) s1 / |sl| + 2, ln P within 4 |ln P| (the lerp, float32
    ln 10, the product), q within |ec|(5 + 3 l1) + |es|(8 + 3 l2) + |q|,
    expf's 4, three products), the signed log's absolute error el (two
    logf more and three sums), and the walker's tc per unit ln(rm_j+1 /
    rm_j) (the density scalars' share)."""
    F = c.floats
    alpha, gamma = F["alpha"], F["gamma"]
    ec, es = sc["ec"].abs(), sc["es"].abs()
    s1 = c.arrays["KV"][:, 4]
    e_sl = (v0.abs() + v1.abs()) * s1 / sl.abs() + 2.0
    dt2 = 8.0 if gamma == 3.0 else 2.0 * abs(gamma) + 8.0
    dq = ec * (5.0 + 3.0 * dens["l1"]) + es * (dt2 + 3.0 * dens["l2"]) \
        + dens["q1"].abs()
    cq = 6.0 * ec + es * abs(gamma) * (abs(gamma) + 0.5) + abs(alpha)
    if alpha != 0.0:
        dq = dq + abs(alpha) * (4.0 + 2.0 * dens["lnxc"].abs()) + 10.0
    if c.ints["d_fam"] == D_DOUBLE:
        e2 = sc["e2"].abs()
        dln = (sc["ln02"] - sc["lnn0sq"]).abs()
        dq2 = e2 * (5.0 + 3.0 * dens["l3"]) + (e2 * dens["l3"])
        dq = torch.maximum(dq, dq2 + 3.0 * (sc["ln02"].abs()
                                           + sc["lnn0sq"].abs())
                           + 2.0 * dln) + 3.0 * dens["q"].abs() + 2.0
        cq = cq + 6.0 * e2 + (2.0 * ec + abs(gamma) * es + 2.0 * e2) * (
            sc["ln02"].abs() + sc["lnn0sq"].abs() + 2.0) * 0.5
    dlpn = 4.0 * lnpm.abs() + 0.5 * dq + lpn.abs()
    e = e_sl + dlpn + 7.0
    lsl = torch.log(sl.abs())
    lrm = torch.log(c.arrays["KV"][:, 5])
    el = e + 2.0 * lsl.abs() + 2.0 * lrm.abs() + 3.0 * (
        lsl.abs() + lrm.abs() + lpn.abs())
    return e, el, (U * 1.01) * cq


def gnfw_mass64(c, th64: dict, r):
    """The float64 model's HSE mass (``models/mass.py``: -dP/dr r r /
    n_e, its constant dropped) of gathered rows at radii r (N,), formed
    as ``GNFWPressure.derivative`` and ``VikhlininDensity`` form it, the
    powers as exp(y ln x) (within ~1e-15 of pow's)."""
    F = c.floats
    cg = F["c_gnfw"] + F["c_lo"]
    P0, a, b, rp = th64["P_0"], th64["a"], th64["b"], th64["r_p"]
    lnx = torch.log(r / rp)
    z = a * lnx
    e = torch.exp(-z.abs())
    sp = torch.clamp(z, min=0.0) + torch.log1p(e)
    press = P0 * torch.exp(-cg * lnx - ((b - cg) / a) * sp)
    sig = torch.where(z >= 0, 1.0 / (1.0 + e), e / (1.0 + e))
    dpdr = -press / r * (cg + (b - cg) * sig)
    return -dpdr * r * r / ne64(c, th64, r)


def ne64(c, th64: dict, r):
    """The float64 model's n_e of gathered rows at radii r."""
    F = c.floats
    alpha = F["alpha"] + F["alpha_lo"]
    gamma = F["gamma"] + F["gamma_lo"]
    n0 = torch.exp(LN10 * th64["log(n_0)"])
    xc = r * torch.exp(-LN10 * th64["log(r_c)"])
    xs = r * torch.exp(-LN10 * th64["log(r_s)"])
    beta, eps = th64[r"\beta"], th64[r"\epsilon"]
    xsg = xs * xs * xs if gamma == 3.0 else torch.exp(gamma * torch.log(xs))
    ne2 = n0 * n0 * torch.exp(-(3.0 * beta - alpha / 2.0) * torch.log1p(
        xc * xc) - (eps / gamma) * torch.log1p(xsg))
    if alpha != 0.0:
        ne2 = ne2 * torch.exp(-alpha * torch.log(xc))
    if c.ints["d_fam"] == D_DOUBLE:
        n02 = torch.exp(LN10 * th64["log(n_{02})"])
        x2 = r * torch.exp(-LN10 * th64["log(r_{c2})"])
        ne2 = ne2 + n02 * n02 * torch.exp(-3.0 * th64[r"\beta_2"]
                                          * torch.log1p(x2 * x2))
    return torch.sqrt(ne2)


def knot_mass64(c, th64: dict, j, rm, v_lo, v_hi):
    """The float64 model's segment mass at midpoint j (``KnotPressure``:
    dP/dr = P slope / r, slope = (v_j+1 - v_j) / d_j), its constant
    dropped, of gathered rows: rm the midpoint radius, v the knot values
    of segment j."""
    KX = c.arrays["KX"].double()
    slope = (v_hi - v_lo) * (KX[j, 1] + KX[j, 2])
    press = torch.exp(LN10 * (0.5 * (v_lo + v_hi)))
    return -slope * press * rm / ne64(c, th64, rm)


def theta64(th: torch.Tensor, c) -> dict:
    """The rows' thawed parameters by role, float64 (exact: float32 in)."""
    t = th.double()
    return {r: t[:, i] for r, i in c.roles.items()}


def _rows(d: dict, rows):
    """The (N,) values of (B, 1) walker tensors at gathered rows."""
    return {k: v[rows, 0] for k, v in d.items()}


def gnfw_veto(th, c, m, slow, sc: dict, total,
              details: dict | None = None):
    """(B, 1) bool: the float64 model's np.gradient(M) > 0 verdict of each
    row, through the three tiers (module docstring).  ``m`` (B, n): the
    product form's masses, or the signed log on ``slow`` rows (B, 1);
    ``sc`` the walker scalars (B, 1); ``total`` (B, 1) the priors (rows at
    -inf skip tiers 2-3).  ``details``, if given, receives every pair's
    tier values (tier 2 then runs on every pair)."""
    A = c.arrays
    B, n = m.shape
    lo_np, hi_np = gradient_pairs(n)
    lo = torch.as_tensor(lo_np, device=m.device)
    hi = torch.as_tensor(hi_np, device=m.device)
    L = A["DLR"][:n]
    wb = gnfw_walker_bounds(c, th, sc)
    sure_bad, unsure = tier1_pairs(m, lo, hi, wb, slow)
    bad = sure_bad.any(dim=1, keepdim=True)
    cand = unsure & ~bad & torch.isfinite(total)
    T2_PAIRS[0] += int(cand.sum())
    if details is not None:
        details.update(wb=wb, sure_bad=sure_bad, unsure=unsure, cand=cand,
                       lo=lo, hi=hi)
        sel = torch.ones(B, n, dtype=torch.bool, device=m.device)
    else:
        sel = cand
    rows, ks = sel.nonzero(as_tuple=True)
    if rows.numel() == 0:
        if details is not None:
            details["mono"] = ~bad
        return ~bad
    scw = _rows({**sc, "tc": wb["tc"]}, rows)
    dlm, b2, ok = gnfw_tier2(c, scw, A["r"][lo[ks]], A["lnr"][lo[ks]],
                             L[ks])
    sgn = scw["P0"].sign()
    zero = sgn == 0
    sure2 = zero | (ok & (dlm.abs() > b2))
    greater = ~zero & (sgn * dlm > 0)
    if details is not None:
        details.update(dlm=dlm.reshape(B, n), b2=b2.reshape(B, n),
                       sure2=sure2.reshape(B, n), ok2=ok.reshape(B, n))
        keep = cand[rows, ks]
        rows, ks, greater, sure2 = rows[keep], ks[keep], greater[keep], \
            sure2[keep]
    need = ~sure2
    F64_PAIRS[0] += int(need.sum())
    if need.any():
        t64 = theta64(th[rows[need]], c)
        r64 = A["r"].double() + A["RLO"].double()
        kk = ks[need]
        greater[need] = (gnfw_mass64(c, t64, r64[hi[kk]])
                         > gnfw_mass64(c, t64, r64[lo[kk]]))
    vetoed = torch.zeros(B, dtype=torch.bool, device=m.device)
    vetoed[rows[~greater]] = True
    mono = ~(bad | vetoed[:, None])
    if details is not None:
        details["mono"] = mono
    return mono


def knot_veto(th, c, kc0: int, m, wide, e, el, cq, sc: dict, total,
              details: dict | None = None):
    """(B, 1) bool: the float64 model's knot verdict (midpoint masses
    strictly increasing, the last one positive) of each row.  The masses'
    signs are exact: M_j = -slope_j x (positive), slope_j's sign that of
    v_j+1 - v_j, float32 values compared exactly.  Pairs of one sign are
    compared on magnitudes: tier 1 on the product form ``m`` (relative
    tolerance (e_j + e_j+1) u + cq ln(rm_j+1 / rm_j) + 5u of the larger)
    or, on ``wide`` rows, the signed log (additive, el), then
    ``knot_tier2``, then ``knot_mass64``."""
    A = c.arrays
    KV, KX = A["KV"], A["KX"]
    B, NM = m.shape
    v = th[:, kc0:kc0 + NM + 1]
    dv = v[:, 1:] - v[:, :-1]                    # (B, NM): segment j
    sg = -torch.sign(dv)                         # the masses' signs
    last_ok = sg[:, -1:] > 0
    sa, sb = sg[:, :-1], sg[:, 1:]
    by_sign = (sa != sb) | (sa == 0)
    greater_sign = sb > sa
    ma, mb = m[:, :-1].abs(), m[:, 1:].abs()
    lnrho = KX[:-1, 3]
    T = (e[:, :-1] + e[:, 1:]) * (U * 1.01) + cq * lnrho + 5.0 * U
    d = sa * (mb - ma)
    scale = torch.maximum(ma, mb) * T
    tol_l = (el[:, :-1] + el[:, 1:]) * (U * 1.01) + cq * lnrho \
        + 3.0 * U * (ma + mb) + 4.0 * U
    tol = torch.where(wide, tol_l, scale)
    sure_g1 = d > tol
    sure_n1 = ~(d > -tol)
    bad = (~last_ok) | (by_sign & ~greater_sign).any(dim=1, keepdim=True) \
        | (~by_sign & sure_n1).any(dim=1, keepdim=True)
    unsure = ~by_sign & ~sure_g1 & ~sure_n1
    cand = unsure & ~bad & torch.isfinite(total)
    T2_PAIRS[0] += int(cand.sum())
    if details is not None:
        details.update(unsure=unsure, cand=cand)
        sel = ~by_sign
    else:
        sel = cand
    rows, jj = sel.nonzero(as_tuple=True)
    if rows.numel() == 0:
        if details is not None:
            details["mono"] = ~bad
        return ~bad
    scw = _rows({**sc, "tc": cq}, rows)
    dlm, b2 = knot_tier2(c, scw, v[rows, jj], v[rows, jj + 1],
                         v[rows, jj + 2], KV[jj, 5], lnrho[jj], KX[jj, 4])
    sgn = sa[rows, jj]
    sure2 = dlm.abs() > b2
    greater = sgn * dlm > 0
    if details is not None:
        full = torch.full((B, NM - 1), float("nan"), device=m.device)
        details.update(dlm=full.index_put((rows, jj), dlm),
                       b2=full.clone().index_put((rows, jj), b2))
        keep = cand[rows, jj]
        rows, jj, greater, sure2 = rows[keep], jj[keep], greater[keep], \
            sure2[keep]
    need = ~sure2
    F64_PAIRS[0] += int(need.sum())
    if need.any():
        t64 = theta64(th[rows[need]], c)
        rm64 = KV[:, 5].double() + KX[:, 0].double()
        v64 = th[rows[need], kc0:kc0 + NM + 1].double()
        q = jj[need]
        ar = torch.arange(q.numel(), device=m.device)
        m_a = knot_mass64(c, t64, q, rm64[q], v64[ar, q], v64[ar, q + 1])
        m_b = knot_mass64(c, t64, q + 1, rm64[q + 1], v64[ar, q + 1],
                          v64[ar, q + 2])
        greater[need] = m_b > m_a
    vetoed = torch.zeros(B, dtype=torch.bool, device=m.device)
    vetoed[rows[~greater]] = True
    mono = ~(bad | vetoed[:, None])
    if details is not None:
        details["mono"] = mono
    return mono


def near_tie_rows(model, kept, vetoed, targets=(1e-4, 1e-5, 1e-6, 1e-7),
                  ulps: int = 3):
    """Float32 rows on both sides of the mass veto's boundary, between a
    row ``kept`` whose float64 veto margin (``sampling.sbc.
    veto_margins``) is positive and a row ``vetoed`` whose margin is
    negative: by float64 bisection on the segment's parameter t, the
    boundary t* and the rows at margins +-target (each rounded to
    float32), then the float32 rows 1 .. ``ulps`` ulps either side of
    float32(theta(t*)) in the component that moves the margin most per
    ulp: the smallest margins float32 parameters reach there.  Returns
    (rows (n, D) float32, their float64 margins (n,))."""
    from ..sampling.sbc import veto_margins

    a = np.asarray(kept, np.float64)
    d = np.asarray(vetoed, np.float64) - a

    def margin(t):
        return veto_margins(model, a[None] + np.asarray(t)[:, None] * d[None])

    def bisect(lo, hi, level):
        """t in [lo, hi] where the margin crosses ``level`` (margin(lo) >
        level > margin(hi)), one per level."""
        lo, hi = np.array(lo, np.float64), np.array(hi, np.float64)
        for _ in range(60):
            mid = 0.5 * (lo + hi)
            above = margin(mid) > level
            lo, hi = np.where(above, mid, lo), np.where(above, hi, mid)
        return 0.5 * (lo + hi)

    if not (margin([0.0])[0] > 0 > margin([1.0])[0]):
        raise ValueError("kept must have a positive float64 veto margin "
                         "and vetoed a negative one")
    t_star = float(bisect([0.0], [1.0], np.zeros(1))[0])
    tg = np.asarray(targets, np.float64)
    n = tg.size
    t_pos = bisect(np.zeros(n), np.full(n, t_star), tg)
    t_neg = bisect(np.full(n, t_star), np.ones(n), -tg)
    rows = [(a + t * d).astype(np.float32) for t in np.r_[t_pos, t_neg]]
    mid = (a + t_star * d).astype(np.float32)
    base = veto_margins(model, mid[None].astype(np.float64))[0]
    steps = np.array([np.nextafter(v, np.float32(np.inf), dtype=np.float32)
                      - v for v in mid], np.float64)
    moved = veto_margins(model, mid[None].astype(np.float64)
                         + np.diag(steps))
    i = int(np.argmax(np.abs(moved - base)))
    for k in range(1, ulps + 1):
        for sgn in (1.0, -1.0):
            r = mid.copy()
            for _ in range(k):
                r[i] = np.nextafter(r[i], np.float32(sgn * np.inf),
                                    dtype=np.float32)
            rows.append(r)
    rows.append(mid)
    rows = np.stack(rows)
    return rows, veto_margins(model, rows.astype(np.float64))
