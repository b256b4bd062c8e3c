// Shared device code of the joxsz_torch kernels: the joint log-posterior of
// a tile of walkers (kernel 1, and the proposals of the half-step kernel in
// its tempered and its cluster-grid form), the SZ chain on its own (the
// fused SZ core), Philox-4x32-10, and block reductions.
//
// Replaces the body ll_body of joxsz_tpu/ops/pallas_joint.py (specialised
// by _build_spec): gNFW pressure + single Vikhlinin density + UPP
// temperature, box/Gaussian priors, the HSE-mass monotonicity veto, the SZ
// chain and the X-ray chain.  Arithmetic follows ll_body step for step in
// float32 (the plain torch mirror is ops/joint_kernel.py::joint_ll_plain).
//
// Layout: one block of JT_THREADS threads evaluates TILE_WALKERS walkers.
// Profiles live in shared memory; the constants (L^T, G^T, tables) stay in
// global memory and are read through L1/L2, once per tile.  No tensor
// cores, no TF32.  Every reduction assigns work to threads by radius / data
// point / cell, never by the walker's slot in the tile, so a walker's value
// does not depend on which tile or slot it lands in: kernel 1 and kernel 2
// give bit-identical log-posteriors for the same parameters.
//
// Every array pointer is read as c.a[X] + coff: coff is 0 for one cluster
// and cluster * stride floats when the block works on one cluster of a
// stacked constants buffer (all clusters share offsets, sizes and scalars).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define TILE_WALKERS 4
#define JT_THREADS 128
#define JT_WARPS (JT_THREADS / 32)
#define MAX_D 16
#define N_ROLES 13
#define N_ARRAYS 25
#define N_INTS 11
#define N_FLOATS 7

// thawed-parameter roles (ops/consts_layout.py::ROLES)
enum Role { R_LOGN0, R_BETA, R_LOGRC, R_LOGRS, R_EPS, R_TRATIO, R_Z, R_P0,
            R_A, R_B, R_RP, R_BSCALE, R_CAL };
// packed arrays (ops/consts_layout.py::ARRAYS)
enum Arr { A_R, A_LNR, A_LT, A_GT, A_FLUX, A_WRES, A_WT0, A_WINT, A_MIDR,
           A_LNMID, A_LR0, A_LR1, A_VOLST, A_SIGF, A_BGF, A_CMF, A_CTF, A_LO,
           A_HI, A_WG, A_MU, A_CONVT, A_CONVV, A_CONVS, A_MUI };

struct LLConsts {
  const float* a[N_ARRAYS];
  int n_press, sep, n_pix, n_data, n_sh, n_ann, n_band, nT, n_conv, D,
      mass_veto;
  int cix[N_ROLES];
  float c_gnfw, alpha, gamma, mass_C, t0g, inv_dtg, pos_hi;
};

// iv: N_INTS ints, N_ROLES column indices, N_ARRAYS float offsets into buf;
// fv: N_FLOATS floats (ops/consts_layout.py::LaunchParams)
static inline LLConsts make_consts(const float* buf, const int* iv,
                                   const float* fv) {
  LLConsts c;
  int* ints[N_INTS] = {&c.n_press, &c.sep, &c.n_pix, &c.n_data, &c.n_sh,
                       &c.n_ann, &c.n_band, &c.nT, &c.n_conv, &c.D,
                       &c.mass_veto};
  for (int i = 0; i < N_INTS; ++i) *ints[i] = iv[i];
  for (int i = 0; i < N_ROLES; ++i) c.cix[i] = iv[N_INTS + i];
  for (int i = 0; i < N_ARRAYS; ++i) c.a[i] = buf + iv[N_INTS + N_ROLES + i];
  float* fl[N_FLOATS] = {&c.c_gnfw, &c.alpha, &c.gamma, &c.mass_C, &c.t0g,
                         &c.inv_dtg, &c.pos_hi};
  for (int i = 0; i < N_FLOATS; ++i) *fl[i] = fv[i];
  return c;
}

// shared-memory floats one tile needs (besides the caller's own)
static inline size_t tile_smem_floats(const LLConsts& c) {
  return (size_t)TILE_WALKERS * (3 * c.n_press + c.n_pix
                                 + 2 * c.n_band * c.n_sh + 24)
         + JT_WARPS * TILE_WALKERS * 2 + 4 * TILE_WALKERS;
}

// ---- Philox-4x32-10 (Salmon et al. 2011), counter (c0..c3), key (k0,k1)
__host__ __device__ inline void philox4x32_10(uint32_t c0, uint32_t c1,
                                              uint32_t c2, uint32_t c3,
                                              uint32_t k0, uint32_t k1,
                                              uint32_t out[4]) {
  const uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  const uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
  for (int r = 0; r < 10; ++r) {
    if (r > 0) { k0 += W0; k1 += W1; }
    uint64_t p0 = (uint64_t)M0 * c0, p1 = (uint64_t)M1 * c2;
    uint32_t hi0 = (uint32_t)(p0 >> 32), lo0 = (uint32_t)p0;
    uint32_t hi1 = (uint32_t)(p1 >> 32), lo1 = (uint32_t)p1;
    uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0; c1 = lo1; c2 = n2; c3 = lo0;
  }
  out[0] = c0; out[1] = c1; out[2] = c2; out[3] = c3;
}

// bits -> uniform on [0, 1): the top 24 bits (pallas_joint.py::_uniforms)
__device__ inline float bits_to_uniform(uint32_t b) {
  return (float)((b >> 8) & 0xFFFFFFu) * 5.9604644775390625e-08f;
}

__device__ inline float nanmax_f(float x, float v) {
  return isnan(x) ? x : fmaxf(x, v);
}

// Sum each thread's v[TILE_WALKERS] over the block and store the totals at
// out[w * stride].  Every thread calls it.  red: JT_WARPS*TILE_WALKERS floats.
__device__ inline void block_sum(float v[TILE_WALKERS], float* red,
                                 float* out, int stride) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int w = 0; w < TILE_WALKERS; ++w) {
    float s = v[w];
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    if (lane == 0) red[warp * TILE_WALKERS + w] = s;
  }
  __syncthreads();
  if (threadIdx.x < TILE_WALKERS) {
    float s = 0.f;
    for (int k = 0; k < JT_WARPS; ++k) s += red[k * TILE_WALKERS + threadIdx.x];
    out[threadIdx.x * stride] = s;
  }
  __syncthreads();
}

// Per-walker scalars, one slot each in the tile's scalar area.
enum Scal { S_P0, S_A, S_BCA, S_LNRP, S_BMC, S_N0SQ, S_RCI, S_RSI, S_EC,
            S_ES, S_TTX, S_Z, S_BSCALE, S_CAL, S_TOTAL, S_T0, S_INTEG,
            S_CHI2, S_CASH, N_SCAL };

__device__ inline float ne2_of(const LLConsts& c, const float* s, float r) {
  float xc = r * s[S_RCI];
  float xs = r * s[S_RSI];
  float xs_g = (c.gamma == 3.0f) ? xs * xs * xs : powf(xs, c.gamma);
  float ne2 = s[S_N0SQ] * expf(-s[S_EC] * log1pf(xc * xc)
                               - s[S_ES] * log1pf(xs_g));
  if (c.alpha != 0.0f) ne2 = ne2 * powf(xc, -c.alpha);
  return ne2;
}

__device__ inline float gnfw_press(const LLConsts& c, const float* s,
                                   float lnr, float* ln1xa_out) {
  float lnx = lnr - s[S_LNRP];
  float za = s[S_A] * lnx;
  float ln1xa = fmaxf(za, 0.0f) + log1pf(expf(-fabsf(za)));
  if (ln1xa_out) *ln1xa_out = ln1xa;
  return s[S_P0] * expf(-c.c_gnfw * lnx - s[S_BCA] * ln1xa);
}

// The SZ chain of a tile: raw = pp @ L^T, the temperature-dependent y->mJy
// lerp (segment index = number of interior knots <= t, so both end segments
// extrapolate) x calibration, model = prof @ G^T, and the sum over data
// points of ((flux - model) * w)^2 -> chi[w * chi_stride].  press: WT x
// n_press pressures in shared memory.  The temperature of walker w at map
// radius p is t0[w * t0_stride] for p == 0 and tp[w * tp_stride + p - 1]
// above; its calibration is cal[w * cal_stride].  prof: WT x n_pix floats of
// shared memory; red: JT_WARPS * WT.  All threads of the block call it.
__device__ inline void sz_chain_tile(const LLConsts& c, size_t coff,
                                     const float* press, const float* t0,
                                     int t0_stride, const float* tp,
                                     int tp_stride, const float* cal,
                                     int cal_stride, float* prof, float* red,
                                     float* chi, int chi_stride) {
  const int WT = TILE_WALKERS;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int NP = c.n_press, PIX = c.n_pix;
  {
    const float* LT = c.a[A_LT] + coff;
    const float* cT = c.a[A_CONVT] + coff;
    const float* cV = c.a[A_CONVV] + coff;
    const float* cS = c.a[A_CONVS] + coff;
    for (int p = tid; p < PIX; p += nth) {
      float raw[WT];
      for (int w = 0; w < WT; ++w) raw[w] = 0.f;
      for (int k = 0; k < NP; ++k) {
        float l = LT[k * PIX + p];
        for (int w = 0; w < WT; ++w) raw[w] += press[w * NP + k] * l;
      }
      for (int w = 0; w < WT; ++w) {
        float t = (p == 0) ? t0[w * t0_stride]
                  : (p <= c.sep ? tp[w * tp_stride + p - 1] : 1.0f);
        int ci = 0;
        for (int q = 1; q < c.n_conv - 1; ++q) ci += (t >= cT[q]) ? 1 : 0;
        float conv = cV[ci] + (t - cT[ci]) * cS[ci];
        prof[w * PIX + p] = raw[w] * conv * cal[w * cal_stride];
      }
    }
  }
  __syncthreads();
  {
    const float* GT = c.a[A_GT] + coff;
    const float* fl = c.a[A_FLUX] + coff;
    const float* wr = c.a[A_WRES] + coff;
    float chi2[WT];
    for (int w = 0; w < WT; ++w) chi2[w] = 0.f;
    for (int d = tid; d < c.n_data; d += nth) {
      float model[WT];
      for (int w = 0; w < WT; ++w) model[w] = 0.f;
      for (int p = 0; p < PIX; ++p) {
        float g = GT[p * c.n_data + d];
        for (int w = 0; w < WT; ++w) model[w] += prof[w * PIX + p] * g;
      }
      for (int w = 0; w < WT; ++w) {
        float res = (fl[d] - model[w]) * wr[d];
        chi2[w] += res * res;
      }
    }
    block_sum(chi2, red, chi, chi_stride);
  }
}

// Joint log-posterior of the TILE_WALKERS parameter rows in th (shared
// memory, row stride MAX_D) -> out[w] (shared memory).  All threads of the
// block must call it.  sm: tile_smem_floats(c) floats of shared memory.
__device__ void joint_ll_tile(const LLConsts& c, size_t coff, const float* th,
                              float* out, float* sm) {
  const int WT = TILE_WALKERS;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int NP = c.n_press, PIX = c.n_pix, NS = c.n_sh, NB = c.n_band;
  float* press = sm;
  float* tsz = press + WT * NP;
  float* mm = tsz + WT * NP;
  float* prof = mm + WT * NP;
  float* e0 = prof + WT * PIX;
  float* e1 = e0 + WT * NB * NS;
  float* sc = e1 + WT * NB * NS;          // WT x 24 scalars
  float* red = sc + WT * 24;              // JT_WARPS x WT (x2)
  int* flags = (int*)(red + 2 * JT_WARPS * WT);   // mass veto, x-ray veto
  const float INF = __int_as_float(0x7f800000);

  // ---- per-walker scalars, priors, r_c <= r_s veto ----------------------
  if (tid < WT) {
    const float* t = th + tid * MAX_D;
    float* s = sc + tid * 24;
    const float* lo = c.a[A_LO] + coff;
    const float* hi = c.a[A_HI] + coff;
    const float* wg = c.a[A_WG] + coff;
    const float* mu = c.a[A_MU] + coff;
    bool inside = true;
    float g = 0.f;
    for (int d = 0; d < c.D; ++d) {
      inside = inside && (t[d] >= lo[d]) && (t[d] <= hi[d]);
      float dr = t[d] - mu[d];
      g += wg[d] * dr * dr;
    }
    float total = inside ? -0.5f * g : -INF;
    float log_rc = t[c.cix[R_LOGRC]], log_rs = t[c.cix[R_LOGRS]];
    if (log_rc > log_rs) total = -INF;
    float a = t[c.cix[R_A]], b = t[c.cix[R_B]];
    s[S_P0] = t[c.cix[R_P0]];
    s[S_A] = a;
    s[S_BCA] = (b - c.c_gnfw) / a;
    s[S_BMC] = b - c.c_gnfw;
    s[S_LNRP] = logf(t[c.cix[R_RP]]);
    float n0 = powf(10.0f, t[c.cix[R_LOGN0]]);
    s[S_N0SQ] = n0 * n0;
    s[S_RCI] = powf(10.0f, -log_rc);
    s[S_RSI] = powf(10.0f, -log_rs);
    s[S_EC] = 3.0f * t[c.cix[R_BETA]] - c.alpha / 2.0f;
    s[S_ES] = t[c.cix[R_EPS]] / c.gamma;
    s[S_TTX] = powf(10.0f, t[c.cix[R_TRATIO]]);
    s[S_Z] = t[c.cix[R_Z]];
    s[S_BSCALE] = t[c.cix[R_BSCALE]];
    s[S_CAL] = t[c.cix[R_CAL]];
    s[S_TOTAL] = total;
    flags[2 * tid] = 0;
    flags[2 * tid + 1] = 0;
  }
  __syncthreads();

  // ---- pressure, T_SZ and HSE mass on the pressure grid -----------------
  const float* r = c.a[A_R] + coff;
  const float* lnr = c.a[A_LNR] + coff;
  for (int idx = tid; idx < WT * NP; idx += nth) {
    int w = idx / NP, k = idx - w * NP;
    const float* s = sc + w * 24;
    float ln1xa;
    float P = gnfw_press(c, s, lnr[k], &ln1xa);
    float sfrac = 1.0f - expf(-ln1xa);
    float ne_inv = rsqrtf(ne2_of(c, s, r[k]));
    press[idx] = P;
    tsz[idx] = P * ne_inv;
    mm[idx] = P * r[k] * (c.c_gnfw + s[S_BMC] * sfrac) * ne_inv * c.mass_C;
  }
  __syncthreads();

  // ---- mass veto, T(0) and integrated-Y partial sums --------------------
  {
    float t0p[WT], ip[WT];
    for (int w = 0; w < WT; ++w) { t0p[w] = 0.f; ip[w] = 0.f; }
    const float* wT0 = c.a[A_WT0] + coff;
    const float* wint = c.a[A_WINT] + coff;
    for (int k = tid; k < NP; k += nth) {
      for (int w = 0; w < WT; ++w) {
        const float* m = mm + w * NP;
        if (c.mass_veto) {
          // np.gradient(m) > 0: central differences inside, one-sided at
          // the edges; a NaN comparison is false and vetoes
          bool ok;
          if (k == 0) ok = m[1] > m[0];
          else if (k == NP - 1) ok = m[NP - 1] > m[NP - 2];
          else ok = m[k + 1] > m[k - 1];
          if (!ok) flags[2 * w] = 1;
        }
        if (k < c.sep) t0p[w] += tsz[w * NP + k] * wT0[k];
        ip[w] += press[w * NP + k] * wint[k];
      }
    }
    block_sum(t0p, red, sc + S_T0, 24);
    block_sum(ip, red, sc + S_INTEG, 24);
  }

  // ---- SZ: raw = pp @ L^T, lerp x calibration, model = prof @ G^T, chi^2 --
  sz_chain_tile(c, coff, press, sc + S_T0, 24, tsz, NP, sc + S_CAL, 24, prof,
                red, sc + S_CHI2, 24);

  // ---- X-ray: midpoint profiles, two-tap count-rate lookup ---------------
  {
    const float* midr = c.a[A_MIDR] + coff;
    const float* lnmid = c.a[A_LNMID] + coff;
    const float* LR0 = c.a[A_LR0] + coff;
    const float* LR1 = c.a[A_LR1] + coff;
    const float NaN = __int_as_float(0x7fc00000);
    for (int idx = tid; idx < WT * NS; idx += nth) {
      int w = idx / NS, j = idx - w * NS;
      const float* s = sc + w * 24;
      float pm = gnfw_press(c, s, lnmid[j], nullptr);
      float n2 = ne2_of(c, s, midr[j]);
      float Tm = pm * rsqrtf(n2) * s[S_TTX];
      float tl = logf(nanmax_f(Tm, 1e-30f));
      float pos = (tl - c.t0g) * c.inv_dtg;
      bool bad = isnan(pos);
      pos = bad ? 0.0f : fminf(fmaxf(pos, 0.0f), c.pos_hi);
      // hat weights max(0, 1 - |pos - k|) at k0 and k0 + 1; the tap past
      // the last grid point is zero
      float k0f = floorf(pos);
      int k0 = (int)k0f;
      float w0 = fmaxf(0.0f, 1.0f - fabsf(pos - k0f));
      float w1 = 0.0f;
      int k1 = k0;
      if (k0 + 1 < c.nT) {
        w1 = fmaxf(0.0f, 1.0f - fabsf(pos - (k0f + 1.0f)));
        k1 = k0 + 1;
      }
      float zm = 1.0f - s[S_Z];
      for (int b = 0; b < NB; ++b) {
        const float* t0r = LR0 + b * c.nT;
        const float* t1r = LR1 + b * c.nT;
        float l0 = w0 * t0r[k0] + w1 * t0r[k1];
        float l1 = w0 * t1r[k0] + w1 * t1r[k1];
        e0[(w * NB + b) * NS + j] = bad ? NaN : expf(l0) * zm * n2;
        e1[(w * NB + b) * NS + j] = expf(l1) * s[S_Z] * n2;
      }
    }
  }
  __syncthreads();

  // ---- X-ray: projection, prediction, positivity veto, Cash -------------
  {
    const float* V = c.a[A_VOLST] + coff;
    const float* sigf = c.a[A_SIGF] + coff;
    const float* bgf = c.a[A_BGF] + coff;
    const float* cmf = c.a[A_CMF] + coff;
    const float* ctf = c.a[A_CTF] + coff;
    const int NA = c.n_ann, cells = NB * NA;
    float cash[WT];
    for (int w = 0; w < WT; ++w) cash[w] = 0.f;
    for (int bi = tid; bi < cells; bi += nth) {
      int b = bi / NA, i = bi - b * NA;
      for (int w = 0; w < WT; ++w) {
        const float* E0 = e0 + (w * NB + b) * NS;
        const float* E1 = e1 + (w * NB + b) * NS;
        float p0 = 0.f, p1 = 0.f;
        for (int j = 0; j < NS; ++j) {
          float v = V[j * NA + i];
          p0 += E0[j] * v;
          p1 += E1[j] * v;
        }
        float pred = (p0 + p1) * sigf[bi]
                     + sc[w * 24 + S_BSCALE] * bgf[bi];
        if (!(pred > 0.0f) && cmf[bi] != 0.0f) flags[2 * w + 1] = 1;
        float safe = (pred > 0.0f) ? pred : 1.0f;
        cash[w] += cmf[bi] * (ctf[bi] * logf(safe) - safe);
      }
    }
    block_sum(cash, red, sc + S_CASH, 24);
  }

  // ---- combine ------------------------------------------------------------
  if (tid < WT) {
    const float* s = sc + tid * 24;
    float total = s[S_TOTAL];
    if (flags[2 * tid]) total = -INF;
    total = total - 0.5f * s[S_CHI2];
    float di = s[S_INTEG] - (c.a[A_MUI] + coff)[0];
    total = total - 0.5f * di * di;
    total = total + (flags[2 * tid + 1] ? -INF : s[S_CASH]);
    out[tid] = isnan(total) ? -INF : total;
  }
  __syncthreads();
}
