// The HSE-mass veto decided as the float64 model decides it, at float32
// cost: the tiers of joint_ll_tile's mass veto (included by joint_ll.cuh
// after the profile helpers; the plain mirror is ops/mass_veto.py, whose
// docstrings derive the bounds).
//
// The reference verdict is the float64 model's np.gradient(M) > 0 on the
// pressure grid (joxsz_tpu/models/joint.py::_mass_veto_ok; knots: the
// segment midpoints' masses increasing, the last positive).  The tile
// forms the mass in float32 (the product form, or the signed log for a
// walker with a radius where n_e^2 is not normal), which misorders two
// masses within float32's rounding of each other.  Each pair goes through
//   1. the float32 form against an a-priori bound of its error, per walker
//      and grid half (gnfw_walker_bounds, from the walker's scalars and
//      the grid's ends, before the veto phase); a pair beyond it is decided
//      in the veto loop, at one FFMA more than the bare compare;
//   2. the float32 difference form ln M_hi - ln M_lo from log1p / expm1
//      forms of the lower radius and a constant of the grid (DLR), with
//      its own bound (gnfw_tier2, knot_tier2);
//   3. the pair's two masses in float64 as the float64 model forms them
//      (gnfw_mass64, knot_mass64), counted in jt_f64_pairs.
// Tier 1's unsure pairs go into the tile's pair list (PAIR_CAP, filled by
// atomicAdd); the last warp decides them (tiers 2-3) while the other
// warps run the X-ray taps, emissivities and projection (before the
// combine in an SZ-only session); a walker one of whose pairs found the
// list full is flagged, and that warp decides every pair of it.  A
// walker already vetoed by a sure pair, or outside the prior box, skips
// tiers 2-3 (its log-posterior is -inf
// either way), so the pairs counted do not depend on the order in which
// pairs are decided.
//
// Flag bits of flags[2 w]: 1 vetoed by a sure pair, 2 the log form, 8
// vetoed by tiers 2-3, 32 every pair to tiers 2-3 (the list was full);
// of the walker's S_VFLAG slot: 4 every pair to tiers
// 2-3 (g may change sign), 16 every pair of the product form to tiers 2-3
// (it may leave float32's normal range).
#pragma once

#define VETO_U 5.9604644775390625e-08f      // 2^-24, float32's unit roundoff
#define VETO_T_MAX 0.005f
#define LN10D 2.302585092994045684

// pairs that reached the float64 tier (read_f64_pairs), and the pairs
// tier 1 was not sure of, of walkers in the prior box that no sure pair
// vetoes (read_t2_pairs: one atomic a tile, joint_ll_tile's pair list),
// over every launch of this library
__device__ unsigned long long jt_f64_pairs;
__device__ unsigned long long jt_t2_pairs;

extern "C" int read_f64_pairs(unsigned long long* out, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(out, jt_f64_pairs, sizeof(*out));
  if (e == cudaSuccess && reset) {
    const unsigned long long zero = 0;
    e = cudaMemcpyToSymbol(jt_f64_pairs, &zero, sizeof(zero));
  }
  return (int)e;
}

extern "C" int read_t2_pairs(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, jt_t2_pairs, sizeof(*out));
}

// (jt_t2_pairs, jt_f64_pairs) copied into dst[0], dst[1] on the device in
// the order of ``stream``: a snapshot between launches that does not wait
// for the card
extern "C" int snap_pair_counters(unsigned long long* dst, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemcpyFromSymbolAsync(dst, jt_t2_pairs, sizeof(*dst), 0,
                                            cudaMemcpyDeviceToDevice, s);
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbolAsync(dst + 1, jt_f64_pairs, sizeof(*dst), 0,
                                  cudaMemcpyDeviceToDevice, s);
  return (int)e;
}

__device__ __forceinline__ int grad_lo(int k) { return k == 0 ? 0 : k - 1; }
__device__ __forceinline__ int grad_hi(int k, int n) {
  return k == n - 1 ? n - 1 : k + 1;
}

// ---- tier 1 bounds ---------------------------------------------------------
// The first np.gradient pair of the grid's outer half, whose pairs take
// the tolerance t0o (ops/mass_veto.py::outer_start).
__device__ __forceinline__ int outer_start(int n) { return n / 2; }

// f = sigmoid(za) and 1 - f = sigmoid(-za) without cancellation
__device__ __forceinline__ void sigmoid_pair(float za, float* f, float* cf) {
  const float e = expf(-fabsf(za));
  const float fp = 1.0f / (1.0f + e);
  *f = za >= 0.0f ? fp : e * fp;
  *cf = za >= 0.0f ? e * fp : fp;
}

// sigmoid_pair with the fast intrinsics (the bounds' f: within ~1e-6 of
// it, which the bounds' 1% slack covers)
__device__ __forceinline__ void sigmoid_pair_fast(float za, float* f,
                                                  float* cf) {
  const float e = __expf(-fabsf(za));
  const float fp = __fdividef(1.0f, 1.0f + e);
  *f = za >= 0.0f ? fp : e * fp;
  *cf = za >= 0.0f ? e * fp : fp;
}

// The walker's tier-1 tolerances of the gNFW masses (ops/mass_veto.py::
// gnfw_walker_bounds, which derives them), from its parameter row t (its
// gNFW scalars formed as gnfw_scalars forms them), the grid's ends and
// the largest ln(r_hi / r_lo) of each half (the two floats after DLR's
// pairs): into its scalar slots S_VT0 / S_VT0O / S_VTL (the product
// form's tolerance on the inner and the outer half, the signed log's),
// S_VTC (per unit ln(r_hi / r_lo), tier 2's), S_VSGN (the masses' sign)
// and S_VFLAG (flag bits 4 / 16).  One thread per walker: the flagship's
// on the walker's last thread of the pressure grid, a family's on lane 5
// of the priors phase; the fast intrinsics where a quantity feeds only
// the bounds.
__device__ __forceinline__ void gnfw_walker_bounds(const LLConsts& c,
                                                   const float* st,
                                                   const float* t,
                                                   float* scw) {
  const float U = VETO_U, LN2 = 0.6931472f;
  const float a = t[c.cix[R_A]], p0 = t[c.cix[R_P0]];
  const float bmc = t[c.cix[R_B]] - c.c_gnfw;
  const float bca = (t[c.cix[R_B]] - c.c_gnfw) / a;
  const float lnrp = logf(t[c.cix[R_RP]]);
  const int NP = c.n_press, km = outer_start(NP) - 1;
  const float* lnr = st + c.off[A_LNR];
  const float* dlr = st + c.off[A_DLR];
  const float cg = c.c_gnfw, acg = fabsf(cg), aa = fabsf(a);
  const float ab = fabsf(bca), abmc = fabsf(bmc);
  const float ag = fabsf(c.gamma), aal = fabsf(c.alpha);
  const float ec = fabsf(3.0f * t[c.cix[R_BETA]] - c.alpha / 2.0f);
  const float es = fabsf(t[c.cix[R_EPS]] / c.gamma);
  const float lnrci = -LN10F * t[c.cix[R_LOGRC]];
  const float lnrsi = -LN10F * t[c.cix[R_LOGRS]];
  const float lnn0sq = 2.0f * LN10F * t[c.cix[R_LOGN0]];
  const float l0 = lnr[0], lN = lnr[NP - 1];
  const float lx0 = l0 - lnrp, lxN = lN - lnrp;
  const float za0 = a * lx0, zaN = a * lxN;
  const float Lr = fmaxf(fabsf(l0), fabsf(lN));
  const float Lx = fmaxf(fabsf(lx0), fabsf(lxN));
  const float Z = fmaxf(fabsf(za0), fabsf(zaN));
  const float S = fmaxf(fmaxf(za0, zaN), 0.0f) + LN2;
  const float P = acg * Lx + ab * S;
  const float dz = aa * (Lr + Lx) + Z;
  const float drel = acg * (Lr + Lx) + ab * (dz + 4.0f + S) + acg * Lx
                     + ab * S + P + 4.0f;
  float f0, cf0, fm, cfm, fN, cfN;
  sigmoid_pair_fast(za0, &f0, &cf0);
  sigmoid_pair_fast(a * (lnr[km] - lnrp), &fm, &cfm);
  sigmoid_pair_fast(zaN, &fN, &cfN);
  const float g0 = cg + bmc * f0, gm = cg + bmc * fm, gN = cg + bmc * fN;
  const float dg = cf0 * (dz + 16.0f) + __fdividef(4.0f * abmc * cf0, g0)
                   + 4.0f;
  const float dg_out = cfm * (dz + 16.0f)
                       + __fdividef(4.0f * abmc * cfm, gm) + 4.0f;
  const float L1 = fmaxf(2.0f * (lN + lnrci), 0.0f) + LN2;
  const float L2 = fmaxf(c.gamma * (lN + lnrsi), 0.0f) + LN2;
  const float dt2 = c.gamma == 3.0f ? 8.0f : 2.0f * ag + 8.0f;
  float Q = ec * L1 + es * L2;
  float dq = ec * (5.0f + 3.0f * L1) + es * (dt2 + 3.0f * L2);
  if (c.alpha != 0.0f) {
    const float Lc = fmaxf(fabsf(l0 + lnrci), fabsf(lN + lnrci));
    Q += aal * Lc;
    dq += aal * (4.0f + 2.0f * Lc) + 10.0f;
  }
  dq += Q;
  float dqlog = dq, dne2 = dq + 5.0f;
  float cq = 6.0f * ec + es * ag * (ag + 0.5f) + aal;
  if (c.d_fam == D_DOUBLE) {
    const float e2 = fabsf(3.0f * t[c.cix[R_BETA2]]);
    const float ln02 = 2.0f * LN10F * t[c.cix[R_LOGN02]];
    const float L3 = fmaxf(2.0f * (lN - LN10F * t[c.cix[R_LOGRC2]]), 0.0f)
                     + LN2;
    const float dln = fabsf(ln02 - lnn0sq);
    const float Q2 = e2 * L3;
    const float dq2 = e2 * (5.0f + 3.0f * L3) + Q2;
    dne2 = fmaxf(dne2, dq2 + 7.0f) + 1.0f;
    Q = fmaxf(Q, Q2 + dln) + LN2;
    dqlog = fmaxf(dq, dq2 + 3.0f * (fabsf(ln02) + fabsf(lnn0sq))
                          + 2.0f * dln) + 3.0f * Q + 2.0f;
    cq += 6.0f * e2 + (2.0f * ec + ag * es + 2.0f * e2)
                          * (fabsf(ln02) + fabsf(lnn0sq) + 2.0f) * 0.5f;
  }
  const float dinv = 0.5f * dne2 + 4.0f;
  const float lg0 = __logf(g0), lgN = __logf(gN);
  const float Lg = fmaxf(fabsf(lg0), fabsf(lgN)) + 1e-3f;
  const float e_log = Lr + 2.0f * Lg + dg + drel + 0.5f * dqlog
                      + 3.0f * (Lr + Lg + P + 0.5f * Q) + 4.0f;
  const float tc = (U * 1.01f)
                   * (2.0f * fabsf(lnrp) * (abmc * aa * 0.25f + 2.0f * a * a)
                      + 2.0f * abmc + 2.0f * acg + 3.25f * aa + cq);
  const float Lin = dlr[NP], Lout = dlr[NP + 1];
  const float t0 = (2.0f * U * 1.01f) * (drel + dg + dinv + 6.0f) + 5.0f * U
                   + tc * Lin;
  const float t0o = (2.0f * U * 1.01f) * (drel + dg_out + dinv + 6.0f)
                    + 5.0f * U + tc * Lout;
  const float tl = (2.0f * U * 1.01f) * e_log + 5.0f * U
                   + tc * fmaxf(Lin, Lout);
  const float n0h = 0.5f * fabsf(lnn0sq);
  const float part_lo = -P + fminf(l0, lN) + lg0;
  const float part_hi = P + fmaxf(l0, lN) + lgN;
  // (comparisons false for NaN: unsafe)
  const bool unsafe = !(cg >= 0.0f && bmc >= 0.0f && a > 0.0f && g0 > 0.0f
                        && tl < VETO_T_MAX);
  const bool unsafe_prod =
      !(part_lo > -86.0f && part_lo - n0h - 0.5f * Q > -86.0f
        && part_hi + n0h + 0.5f * Q < 86.0f && t0 < VETO_T_MAX
        && t0o < VETO_T_MAX);
  scw[S_VT0] = t0;
  scw[S_VT0O] = t0o;
  scw[S_VTL] = tl;
  scw[S_VTC] = tc;
  scw[S_VSGN] = (float)((p0 > 0.0f) - (p0 < 0.0f));
  scw[S_VFLAG] = (float)((unsafe ? 4 : 0) | (unsafe_prod ? 16 : 0));
}

// The knot masses' tier-1 errors at midpoint row `row` (ops/mass_veto.py::
// knot_mass_bounds): *e the product form's relative error, *el the signed
// log's absolute error, units u.
template <bool FAM>
__device__ __forceinline__ void knot_mass_bounds(
    const LLConsts& c, const Prof& s, const float* scw, const float* row,
    const float* kv, float sl, float lnpm, float lpn, const Dens& d,
    float* e, float* el) {
  const int i = (int)row[0];
  const float ec = fabsf(s.ec), es = fabsf(s.es), ag = fabsf(c.gamma);
  const float e_sl = (fabsf(kv[i]) + fabsf(kv[i + 1])) * row[4] / fabsf(sl)
                     + 2.0f;
  const float dt2 = c.gamma == 3.0f ? 8.0f : 2.0f * ag + 8.0f;
  float dq = ec * (5.0f + 3.0f * d.l1) + es * (dt2 + 3.0f * d.l2)
             + fabsf(d.q1);
  if (c.alpha != 0.0f)
    dq += fabsf(c.alpha) * (4.0f + 2.0f * fabsf(d.lnxc)) + 10.0f;
  if (FAM && c.d_fam == D_DOUBLE) {
    const float e2 = fabsf(scw[S_E2]);
    const float ln02 = logf(scw[S_N02SQ]);
    const float dq2 = e2 * (5.0f + 3.0f * d.l3) + e2 * d.l3;
    dq = fmaxf(dq, dq2 + 3.0f * (fabsf(ln02) + fabsf(s.lnn0sq))
                       + 2.0f * fabsf(ln02 - s.lnn0sq))
         + 3.0f * fabsf(d.q) + 2.0f;
  }
  const float dlpn = 4.0f * fabsf(lnpm) + 0.5f * dq + fabsf(lpn);
  *e = e_sl + dlpn + 7.0f;
  const float lsl = fabsf(logf(fabsf(sl))), lrm = fabsf(logf(row[5]));
  *el = *e + 2.0f * lsl + 2.0f * lrm + 3.0f * (lsl + lrm + fabsf(lpn));
}

// The knots' share of the walker's float32 density scalars, per unit
// ln(rm_j+1 / rm_j) (knot_mass_bounds' cq, times 1.01 u).
template <bool FAM>
__device__ __forceinline__ float knot_cq(const LLConsts& c, const Prof& s,
                                         const float* scw) {
  const float ec = fabsf(s.ec), es = fabsf(s.es), ag = fabsf(c.gamma);
  float cq = 6.0f * ec + es * ag * (ag + 0.5f) + fabsf(c.alpha);
  if (FAM && c.d_fam == D_DOUBLE) {
    const float e2 = fabsf(scw[S_E2]);
    const float ln02 = logf(scw[S_N02SQ]);
    cq += 6.0f * e2 + (2.0f * ec + ag * es + 2.0f * e2)
                          * (fabsf(ln02) + fabsf(s.lnn0sq) + 2.0f) * 0.5f;
  }
  return (VETO_U * 1.01f) * cq;
}

// ---- tier 2: the float32 difference form ---------------------------------
// expm1(x) and log1p(x), by their series below |x| = 2^-6 (truncation
// below 2e-12 of the value; rounding within 2 ulp, as the bounds take it)
__device__ __forceinline__ float expm1_s(float x) {
  if (fabsf(x) >= 0.015625f) return expm1f(x);
  return x * (1.0f + x * (0.5f + x * (0.16666667f + x * (0.041666668f
                                                         + x * 0.008333334f))));
}
__device__ __forceinline__ float log1p_s(float x) {
  if (fabsf(x) >= 0.015625f) return log1pf(x);
  return x * (1.0f + x * (-0.5f + x * (0.33333334f + x * (-0.25f
                                                          + x * (0.2f - x * 0.16666667f)))));
}

// ln(1 + t e^x) - ln(1 + t) = log1p(w em), w = t / (1 + t), em =
// expm1(x), and *bound its bound in u (t's relative error dt, x's u |x|)
__device__ __forceinline__ float dlog1p(float t, float em, float x, float dt,
                                        float* bound) {
  const float w = t > 1e30f ? 1.0f : t / (1.0f + t);
  const float E = log1p_s(w * em);
  *bound = ((1.0f - w) * dt + 9.0f + fabsf(x)) * fabsf(E);
  return E;
}

// Delta q between r and r e^L and its bound in u (ops/mass_veto.py::
// dq_tier2)
template <bool FAM>
__device__ float dq_tier2(const LLConsts& c, const Prof& s, const float* scw,
                          float r, float L, float* bound) {
  const float xc = r * s.rci, xs = r * s.rsi;
  const float t1 = xc * xc;
  const float t2 = (c.gamma == 3.0f) ? xs * xs * xs : powf(xs, c.gamma);
  const float em2 = expm1_s(2.0f * L);
  const float dt2 = c.gamma == 3.0f ? 32.0f : 10.0f * fabsf(c.gamma) + 8.0f;
  float b1, b2;
  const float E1 = dlog1p(t1, em2, 2.0f * L, 21.0f, &b1);
  const float E2 = dlog1p(t2, expm1_s(c.gamma * L), c.gamma * L, dt2, &b2);
  float dq1 = -s.ec * E1 - s.es * E2;
  if (c.alpha != 0.0f) dq1 = dq1 - c.alpha * L;
  const float b_dq1 = fabsf(s.ec) * (b1 + 2.0f * fabsf(E1))
                      + fabsf(s.es) * (b2 + 2.0f * fabsf(E2))
                      + 3.0f * fabsf(c.alpha * L) + 2.0f * fabsf(dq1);
  if (!(FAM && c.d_fam == D_DOUBLE)) {
    *bound = b_dq1;
    return dq1;
  }
  const float x2 = r * scw[S_RC2I];
  const float t3 = x2 * x2;
  const float e2 = scw[S_E2];
  float b3;
  const float E3 = dlog1p(t3, em2, 2.0f * L, 21.0f, &b3);
  const float dd2 = e2 * E3;
  float q1l = -s.ec * log1pf(t1) - s.es * log1pf(t2);
  if (c.alpha != 0.0f) q1l = q1l - c.alpha * logf(xc);
  const float ln02 = logf(scw[S_N02SQ]);
  const float d2l = (ln02 - s.lnn0sq) + e2 * log1pf(t3);
  float w, cw;
  sigmoid_pair(q1l - d2l, &w, &cw);
  const float X1 = expm1f(dq1), X2 = expm1f(dd2);
  const float Y = w * X1 + (1.0f - w) * X2;
  const float dq = log1pf(Y);
  const float b_dd2 = fabsf(e2) * (b3 + 2.0f * fabsf(E3));
  const float d_arg = 3.0f * (fabsf(q1l) + fabsf(d2l) + fabsf(ln02)
                              + fabsf(s.lnn0sq)) + 10.0f;
  const float bY = w * ((1.0f + X1) * b_dq1 + 2.0f * fabsf(X1))
                   + (1.0f - w) * ((1.0f + X2) * b_dd2 + 2.0f * fabsf(X2))
                   + fabsf(X1 - X2) * (w * (1.0f - w) * d_arg + 3.0f)
                   + 2.0f * fabsf(w * X1) + 2.0f * fabsf((1.0f - w) * X2);
  *bound = bY / (1.0f + Y) + 2.0f * fabsf(dq);
  return dq;
}

// Tier 2 of gNFW pair k: 1 greater, 0 not greater, -1 undecided
// (ops/mass_veto.py::gnfw_tier2 derives the bound)
template <bool FAM>
__device__ int gnfw_tier2(const LLConsts& c, const float* st, const Prof& s,
                          const float* scw, int k) {
  const float sgn = scw[S_VSGN];
  if (sgn == 0.0f) return 0;                   // P_0 = 0: every mass 0
  const float cg = c.c_gnfw, a = s.a, bca = s.bca, bmc = s.bmc;
  if (!(a > 0.0f && cg >= 0.0f && bmc >= 0.0f)) return -1;
  const int lo = grad_lo(k);
  const float r = st[c.off[A_R] + lo], lnr = st[c.off[A_LNR] + lo];
  const float L = st[c.off[A_DLR] + k];
  const float lnx = lnr - s.lnrp;
  const float za = a * lnx;
  float f, cf;
  sigmoid_pair(za, &f, &cf);
  const float aL = a * L;
  const float y = f * expm1_s(aL);
  const float D1 = log1p_s(y);
  const float g_lo = cg + bmc * f;
  if (!(g_lo > 0.0f)) return -1;
  const float dgap = bmc * y * cf / (1.0f + y);
  const float G1 = log1p_s(dgap / g_lo);
  float b_dq;
  const float dq = dq_tier2<FAM>(c, s, scw, r, L, &b_dq);
  const float dlm = (L - cg * L) - bca * D1 + G1 - 0.5f * dq;
  const float dz = fabsf(a) * (fabsf(lnr) + fabsf(lnx)) + fabsf(za);
  const float dy = cf * dz + 2.0f * fabsf(aL) + 14.0f;
  const float terms = fabsf(L) + fabsf(cg * L) + fabsf(bca * D1) + fabsf(G1)
                      + 0.5f * fabsf(dq);
  const float bound =
      (3.0f * fabsf(L) * (1.0f + fabsf(cg)) + fabsf(bca) * (dy + 4.0f) * D1
       + fabsf(bca * D1) + (2.0f * dy + dz + 25.0f) * fabsf(G1)
       + 0.5f * b_dq + 4.0f * terms) * (1.01f * VETO_U)
      + scw[S_VTC] * L;
  // (false for NaN: undecided)
  if (!(fabsf(dlm) > bound)) return -1;
  return sgn * dlm > 0.0f;
}

// Tier 2 of knot pair (j, j + 1), masses of one sign sg (ops/mass_veto.py::
// knot_tier2)
template <bool FAM>
__device__ int knot_tier2(const LLConsts& c, const float* st, const Prof& s,
                          const float* scw, const float* kv, int j,
                          float sg) {
  const float* KV = st + c.off[A_KV];
  const float* KX = st + c.off[A_KX];
  const float v0 = kv[j], v1 = kv[j + 1], v2 = kv[j + 2];
  const float lnrho = KX[KX_COLS * j + 3], lndr = KX[KX_COLS * j + 4];
  const float lr = logf((v2 - v1) / (v1 - v0));
  const float tp = LN10F * (0.5f * (v2 - v0));
  float b_dq;
  const float dq = dq_tier2<FAM>(c, s, scw, KV[6 * j + 5], lnrho, &b_dq);
  const float dlm = lr + lndr + lnrho + tp - 0.5f * dq;
  const float terms = fabsf(lr) + fabsf(lndr) + fabsf(lnrho) + fabsf(tp)
                      + 0.5f * fabsf(dq);
  const float bound = (3.0f + 2.0f * fabsf(lr) + fabsf(lndr) + fabsf(lnrho)
                       + 3.0f * fabsf(tp) + 0.5f * b_dq + 4.0f * terms)
                          * (1.01f * VETO_U)
                      + knot_cq<FAM>(c, s, scw) * lnrho;
  if (!(fabsf(dlm) > bound)) return -1;
  return sg * dlm > 0.0f;
}

// ---- tier 3: float64, as the float64 model forms the mass ----------------
// (its powers written as exp(y ln x), within ~1e-15 of pow's)
// n_e of the walker whose parameter row is t at r (VikhlininDensity)
template <bool FAM>
__device__ double ne64(const LLConsts& c, const float* t, double r) {
  const double alpha = (double)c.alpha + (double)c.alpha_lo;
  const double gamma = (double)c.gamma + (double)c.gamma_lo;
  const double n0 = exp(LN10D * (double)t[c.cix[R_LOGN0]]);
  const double xc = r * exp(-LN10D * (double)t[c.cix[R_LOGRC]]);
  const double xs = r * exp(-LN10D * (double)t[c.cix[R_LOGRS]]);
  const double beta = t[c.cix[R_BETA]], eps = t[c.cix[R_EPS]];
  const double xsg = gamma == 3.0 ? xs * xs * xs : exp(gamma * log(xs));
  double ne2 = n0 * n0
               * exp(-(3.0 * beta - alpha / 2.0) * log1p(xc * xc)
                     - (eps / gamma) * log1p(xsg));
  if (alpha != 0.0) ne2 = ne2 * exp(-alpha * log(xc));
  if (FAM && c.d_fam == D_DOUBLE) {
    const double n02 = exp(LN10D * (double)t[c.cix[R_LOGN02]]);
    const double x2 = r * exp(-LN10D * (double)t[c.cix[R_LOGRC2]]);
    ne2 = ne2 + n02 * n02 * exp(-3.0 * (double)t[c.cix[R_BETA2]]
                                * log1p(x2 * x2));
  }
  return sqrt(ne2);
}

// -dP/dr r r / n_e of the gNFW pressure (GNFWPressure.derivative), the
// mass's constant dropped
template <bool FAM>
__device__ double gnfw_mass64(const LLConsts& c, const float* t, double r) {
  const double cg = (double)c.c_gnfw + (double)c.c_lo;
  const double P0 = t[c.cix[R_P0]], a = t[c.cix[R_A]], b = t[c.cix[R_B]];
  const double lnx = log(r / (double)t[c.cix[R_RP]]);
  const double z = a * lnx;
  const double e = exp(-fabs(z));
  const double sp = fmax(z, 0.0) + log1p(e);
  const double press = P0 * exp(-cg * lnx - ((b - cg) / a) * sp);
  const double sig = z >= 0.0 ? 1.0 / (1.0 + e) : e / (1.0 + e);
  const double dpdr = -press / r * (cg + (b - cg) * sig);
  return -dpdr * r * r / ne64<FAM>(c, t, r);
}

// the knot mass at midpoint j (KnotPressure.derivative: P slope / r)
template <bool FAM>
__device__ double knot_mass64(const LLConsts& c, const float* st,
                              const float* t, const float* kv, int j) {
  const float* KV = st + c.off[A_KV];
  const float* KX = st + c.off[A_KX];
  const double rm = (double)KV[6 * j + 5] + (double)KX[KX_COLS * j];
  const double v0 = kv[j], v1 = kv[j + 1];
  const double slope = (v1 - v0) * ((double)KX[KX_COLS * j + 1]
                                    + (double)KX[KX_COLS * j + 2]);
  const double press = exp(LN10D * (0.5 * (v0 + v1)));
  return -slope * press * rm / ne64<FAM>(c, t, rm);
}

// ---- deciding a pair -------------------------------------------------------
// Pair `pk` of walker w (gNFW: np.gradient pair k; knots: midpoints pk,
// pk + 1) that tier 1 was not sure of: tiers 2-3, and bit 8 of the
// walker's flags when the pair is not increasing.  Skipped for a walker
// vetoed by a sure pair or outside the prior box.
template <bool FAM>
__device__ __forceinline__ void decide_pair(const LLConsts& c,
                                         const float* st, const float* th,
                                         const float* sc, int* flags, int w,
                                         int pk) {
  const float* scw = sc + w * SC_STRIDE;
  if ((flags[2 * w] & 1) || !(scw[S_TOTAL] > -__int_as_float(0x7f800000)))
    return;
  const float* t = th + w * MAX_D;
  const Prof s = load_prof(scw);
  int greater;
  if (FAM && c.p_fam == P_KNOTS) {
    const float* kv = t + c.cix[R_KC0];
    const float sg = (float)((kv[pk] > kv[pk + 1]) - (kv[pk] < kv[pk + 1]));
    greater = knot_tier2<FAM>(c, st, s, scw, kv, pk, sg);
    if (greater < 0) {
      atomicAdd(&jt_f64_pairs, 1ull);
      greater = knot_mass64<FAM>(c, st, t, kv, pk + 1)
                > knot_mass64<FAM>(c, st, t, kv, pk);
    }
  } else {
    greater = gnfw_tier2<FAM>(c, st, s, scw, pk);
    if (greater < 0) {
      atomicAdd(&jt_f64_pairs, 1ull);
      const float* r = st + c.off[A_R];
      const float* rlo = st + c.off[A_RLO];
      const int lo = grad_lo(pk), hi = grad_hi(pk, c.n_press);
      greater = gnfw_mass64<FAM>(c, t, (double)r[hi] + (double)rlo[hi])
                > gnfw_mass64<FAM>(c, t, (double)r[lo] + (double)rlo[lo]);
    }
  }
  if (!greater) atomicOr(flags + 2 * w, 8);
}

// Tier 1 over the gNFW pairs k = k0, k0 + dk, ... of a walker (mass row m,
// its scalar slots scw): sets *bad for a pair surely not increasing and
// calls unsure(k) for a pair that needs tiers 2-3.  The product form: sure
// greater if m_hi > m_lo (1 + sg T), the inner half's pairs at T = t0, the
// outer half's at t0o; else sure not greater unless m_hi > m_lo (1 - sg
// T).  The signed log: on d = m_hi - m_lo against T = tl + 3u (|m_hi| +
// |m_lo|).  Every pair is unsure where flag bit 4 is set, or bit 16 on the
// product form.  A NaN compares false and vetoes.
template <typename Unsure>
__device__ __forceinline__ void gnfw_tier1(const float* m, const float* scw,
                                           int fl, int k0, int dk, int n,
                                           bool* bad, Unsure unsure) {
  const int vf = (int)scw[S_VFLAG];
  const bool logs = fl & 2;
  if ((vf & 4) || (!logs && (vf & 16))) {
    for (int k = k0; k < n; k += dk) unsure(k);
  } else if (logs) {
    const float tl = scw[S_VTL];
    for (int k = k0; k < n; k += dk) {
      const float mh = m[grad_hi(k, n)], ml = m[grad_lo(k)];
      const float d = mh - ml;
      const float tol = tl + 3.0f * VETO_U * (fabsf(mh) + fabsf(ml));
      if (!(d > tol)) {
        if (d > -tol) unsure(k);
        else *bad = true;
      }
    }
  } else {
    const float sg = scw[S_VSGN];
    const int kmid = outer_start(n);
    float sT = sg * scw[S_VT0];
    int k = k0;
#pragma unroll 4
    for (; k < kmid; k += dk) {
      const float mh = m[grad_hi(k, n)], ml = m[grad_lo(k)];
      if (!(mh > fmaf(ml, sT, ml))) {
        if (mh > fmaf(-ml, sT, ml)) unsure(k);
        else *bad = true;
      }
    }
    sT = sg * scw[S_VT0O];
#pragma unroll 4
    for (; k < n; k += dk) {
      const float mh = m[grad_hi(k, n)], ml = m[grad_lo(k)];
      if (!(mh > fmaf(ml, sT, ml))) {
        if (mh > fmaf(-ml, sT, ml)) unsure(k);
        else *bad = true;
      }
    }
  }
}

// Tier 1 of knot pair (j, j + 1) of walker w: masses m (product form, or
// the signed log on a walker with flag bit 2), per-mass errors e / el (u)
// beside them, knot values kv; the signs are exact (M_j = -slope_j x a
// positive).  Sets *bad, returns whether the pair needs tiers 2-3.
__device__ __forceinline__ bool knot_tier1(const float* m, const float* e,
                                           const float* el, const float* kv,
                                           float lnrho, float cq, bool wide,
                                           int j, bool* bad) {
  const float sa = (float)((kv[j] > kv[j + 1]) - (kv[j] < kv[j + 1]));
  const float sb = (float)((kv[j + 1] > kv[j + 2]) - (kv[j + 1] < kv[j + 2]));
  if (sa != sb || sa == 0.0f) {
    *bad = *bad | !(sb > sa);
    return false;
  }
  const float ma = fabsf(m[j]), mb = fabsf(m[j + 1]);
  const float d = sa * (mb - ma);
  const float tol =
      wide ? (el[j] + el[j + 1]) * (VETO_U * 1.01f) + cq * lnrho
                 + 3.0f * VETO_U * (ma + mb) + 4.0f * VETO_U
           : fmaxf(ma, mb) * ((e[j] + e[j + 1]) * (VETO_U * 1.01f)
                              + cq * lnrho + 5.0f * VETO_U);
  const bool sure_bad = !(d > -tol);
  *bad = *bad | sure_bad;
  return !sure_bad && !(d > tol);
}
