// Shared device code of the joxsz_torch kernels: the joint log-posterior of
// a tile of walkers (kernel 1, and the proposals of the step kernels), the
// SZ chain on its own (the fused SZ core), Philox-4x32-10, the staging of
// the constants in shared memory, and the launch helpers.
//
// Replaces the body ll_body of joxsz_tpu/ops/pallas_joint.py (specialised
// by _build_spec): box/Gaussian priors, the HSE-mass monotonicity veto, the
// SZ chain and the X-ray chain, for every model family ll_body has:
// pressure gNFW or knots, density single or double Vikhlinin, temperature
// UPP (T = P/ne), Vikhlinin or none (SZ-only, no X-ray block), and the
// line_scale nuisance.  The family is a set of ints in LLConsts, uniform
// over the launch, so every branch below is taken by the whole block
// (ops/consts_layout.py::detect_family resolves it).  The tile is a
// template on FAM as well as FIT: FAM = false compiles the flagship (gNFW +
// UPP + single density, X-ray, line_scale frozen, D <= 16) with no family
// branch at all, so its registers and time stay those of the flagship-only
// tile; FAM = true serves every family (is_flagship picks).  Knot pressure
// is a clamped lerp of the walker's knot values in log10 r: per radius a
// table row (segment i, weight of knot i, weight of knot i + 1) and two
// FP32 products, never a tensor-core product (a reduced-precision product
// there feeds exp and chi^2); its mass veto reads one point per segment.
// Arithmetic follows ll_body step for step in float32 (the plain torch
// mirror is ops/joint_kernel.py::joint_ll_plain), except where ll_body's
// float32 form leaves float32's range at the corners of the prior box:
//   * n_e: ln n_e^2 is formed beside n_e^2; where a factor of n_e^2 is not
//     a normal float (n_e < ~1e-19 cm^-3 at the outer radii), 1/n_e and
//     P/n_e come from ln n_e^2 (dens_of, over_ne);
//   * the mass veto compares the HSE mass scaled by n_0 / |P_0| (by n_0
//     for knot pressure) and rid of its constant factor, which keeps the
//     order of the masses: (P / P_0) r g n_0 / n_e as a product; for a
//     walker one of whose radii has n_e^2 not normal (knots: one of whose
//     masses the product takes past float32's range) as sgn ln(1 + |M|)
//     from ln |M| (signed_log_mass), which stays finite where ll_body's
//     mass passes 3.4e38.  Such a walker's radii run a second pass.  A
//     pair of masses that float32 cannot order for sure (within an
//     a-priori bound of its error) is decided by a float32 difference
//     form of ln M_hi - ln M_lo and, where that cannot either, in float64
//     as the float64 model forms the masses (mass_veto.cuh), so the veto
//     is the float64 model's.
//
// Layout: one block of JT_THREADS threads evaluates TILE_WALKERS walkers.
// The whole packed constants buffer (~128 KB at the CL J1226 shapes, L^T
// 108 KB of it) is copied into shared memory with cp.async once per block
// and cluster, the Hopper form of what the TPU kernel keeps in VMEM; the
// walkers' profiles (the tile's scratch) live in shared memory beside it.
// Where the two do not fit in a block's shared memory (more pressure or
// map radii: a cluster at lower redshift or a wider map), the launch plan
// (plan_launch) reads the constants in place from global memory, and if
// the scratch alone does not fit either, puts it in a global workspace of
// its own per block.  The tile runs the same code on either pointer; each
// kernel comes twice (FIT below), so that where everything fits the
// compiler sees shared-memory pointers.  Every phase spreads its work over
// the whole block:
//   * pp @ L^T, (walkers x n_press) x (n_press x n_pix): map radii in
//     passes of PIX_PASS; in each, the k axis in KSPLIT chunks, each taken
//     by WT / PPW warps, each warp a register tile of PPW walkers x
//     PIX_LANE map radii per lane (FP32 FMAs), then a fixed-order tree over
//     the chunks;
//   * prof @ G^T: one warp per (walker, GT_CHUNK data points), lanes over
//     the map radii, then a xor-butterfly per data point;
//   * the per-radius profiles, the priors, the X-ray taps: one thread per
//     (walker, radius / parameter / shell); T(0) and integrated Y summed
//     by the radius threads, then over lanes and warps in a fixed order;
//   * the X-ray projection: one thread per (walker, band), PROJ_CHUNK
//     annuli at a time, each a loop over the 15 shells; the Cash terms one
//     thread per (walker, band, annulus), their sum per walker one warp,
//     lanes strided, then a xor-butterfly.
// No thread runs a dependent chain much longer than 40 steps.  No tensor
// cores, no TF32.  Every reduction is assigned by radius / data point /
// cell and never by the walker's slot in the tile, and every walker runs
// the same instructions, so a walker's value does not depend on which tile
// or slot it lands in: kernel 1, the step kernel and kernel 6 give
// bit-identical log-posteriors for the same parameters.
// scripts/torch_tile_phases.py measures the phases on the card.
//
// A block works on the constants at buf + coff (coff is 0 for one cluster
// and cluster * stride floats for one cluster of a stacked constants
// buffer: all clusters share offsets, sizes and scalars), staged or in
// place (use_consts), and the tile reads array X at st + c.off[X].
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define TILE_WALKERS 16
#define JT_THREADS 512
#define JT_WARPS (JT_THREADS / 32)
#define MAX_D 32                       // parameters a tile row holds
#define N_ROLES 24
#define N_ARRAYS 31
#define N_INTS 17
#define N_FLOATS 9
#define PPW 8                          // walkers of one warp's register tile
#define KSPLIT (JT_WARPS * PPW / TILE_WALKERS)   // k chunks of pp @ L^T
#define PIX_LANE 3                     // map radii per lane: lane + 32 j
#define PIX_PASS (32 * PIX_LANE)       // map radii per pass of pp @ L^T
#define SC_STRIDE 35                   // scalar slots per walker (odd: banks)
#define XS_N 6                         // X-ray tap slots per (walker, shell)
#define GT_CHUNK 10                    // data points per pass of prof @ G^T
#define PROJ_CHUNK 8                   // annuli per pass of the projection
#define KX_COLS 5                      // floats of a knot row of KX
#define PAIR_CAP 64                    // mass-veto pairs a tile lists
// exp(x) is a normal float above this (ln FLT_MIN = -87.34)
#define LN_NORMAL (-87.0f)


// Phase clocks of the tile (scripts/torch_tile_phases.py builds with
// -DJT_PHASE_CLOCKS): thread 0 of block 0 records clock64() at each phase
// boundary of its last tile (slots 0-15); slots 16-19 add up, over block
// 0's tiles, the mass veto's deferred pairs (JT_ADD: the last warp's
// cycles on them, the pairs, the tiles with any, the tiles whose list
// overflowed), slot 20 the most cycles one tile's took;
// read_phase_clocks copies them out.
#define JT_N_CLOCKS 21
#ifdef JT_PHASE_CLOCKS
__device__ long long jt_clocks[JT_N_CLOCKS];
#define JT_MARK(i)                                         \
  do {                                                     \
    if (blockIdx.x == 0 && threadIdx.x == 0)               \
      jt_clocks[i] = clock64();                            \
  } while (0)
#define JT_ADD(i, v)                                                   \
  do {                                                                 \
    if (blockIdx.x == 0)                                               \
      atomicAdd((unsigned long long*)&jt_clocks[i],                    \
                (unsigned long long)(v));                              \
  } while (0)
extern "C" int read_phase_clocks(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, jt_clocks, sizeof(jt_clocks));
}
// Every block's tiles, in the order it runs them: the tile's SM cycles,
// its listed mass-veto pairs and the last warp's cycles on them (0 where
// none), JT_TILE_SLOTS tiles a block at most; read_tile_clocks copies
// them out and starts the count again.
#define JT_MAX_BLOCKS 256
#define JT_TILE_SLOTS 128
__device__ long long jt_tile_cyc[JT_MAX_BLOCKS * JT_TILE_SLOTS];
__device__ long long jt_tile_side[JT_MAX_BLOCKS * JT_TILE_SLOTS];
__device__ int jt_tile_pairs[JT_MAX_BLOCKS * JT_TILE_SLOTS];
__device__ int jt_tile_n[JT_MAX_BLOCKS];
__device__ __forceinline__ long long* jt_tile_slot(long long* a) {
  const int b = blockIdx.x, n = jt_tile_n[b < JT_MAX_BLOCKS ? b : 0];
  return b < JT_MAX_BLOCKS && n < JT_TILE_SLOTS ? a + b * JT_TILE_SLOTS + n
                                               : nullptr;
}
#define JT_TILE_BEGIN()                                    \
  long long jt_t0 = 0;                                     \
  if (threadIdx.x == 0) {                                  \
    jt_t0 = clock64();                                     \
    if (long long* p = jt_tile_slot(jt_tile_side)) *p = 0; \
  }
#define JT_TILE_SIDE(dt)                                   \
  do {                                                     \
    if (long long* p = jt_tile_slot(jt_tile_side)) *p = (dt); \
  } while (0)
#define JT_TILE_END(np)                                              \
  do {                                                               \
    if (threadIdx.x == 0 && blockIdx.x < JT_MAX_BLOCKS) {            \
      if (long long* p = jt_tile_slot(jt_tile_cyc)) {                \
        *p = clock64() - jt_t0;                                      \
        jt_tile_pairs[p - jt_tile_cyc] = (np);                       \
      }                                                              \
      jt_tile_n[blockIdx.x] += 1;                                    \
    }                                                                \
  } while (0)
extern "C" int read_tile_clocks(long long* cyc, long long* side,
                                int* pairs, int* n) {
  cudaError_t e = cudaMemcpyFromSymbol(cyc, jt_tile_cyc,
                                       sizeof(jt_tile_cyc));
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(side, jt_tile_side, sizeof(jt_tile_side));
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(pairs, jt_tile_pairs, sizeof(jt_tile_pairs));
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(n, jt_tile_n, sizeof(jt_tile_n));
  static const int zero[JT_MAX_BLOCKS] = {};
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(jt_tile_n, zero, sizeof(zero));
  return (int)e;
}
#else
#define JT_MARK(i)
#define JT_ADD(i, v)
#define JT_TILE_BEGIN()
#define JT_TILE_SIDE(dt)
#define JT_TILE_END(np)
#endif
static_assert(PPW % 4 == 0 && TILE_WALKERS % PPW == 0,
              "a register tile holds whole float4s of a tile's walkers");
static_assert(JT_THREADS == TILE_WALKERS * MAX_D,
              "the priors take one warp-sized group per walker");

// thawed-parameter roles (ops/consts_layout.py::ROLES); R_KC0 is the first
// knot value, the others follow it
enum Role { R_LOGN0, R_BETA, R_LOGRC, R_LOGRS, R_EPS, R_TRATIO, R_Z, R_P0,
            R_A, R_B, R_RP, R_BSCALE, R_CAL, R_T0, R_TMINR, R_RCOOL, R_ACOOL,
            R_RT, R_CT, R_LOGN02, R_BETA2, R_LOGRC2, R_LS, R_KC0 };
// packed arrays (ops/consts_layout.py::ARRAYS); KG, KM: knot table rows
// (segment, w0, w1) of the pressure radii and the shell midpoints; KV:
// rows (segment, w0, w1, s0, s1, r) of the mass-veto radii; DLR, RLO,
// KX: the mass veto's exact tiers (ln(r_hi / r_lo) of np.gradient's
// pairs, r - float32(r), the knots' rows of veto_knot_rows)
enum Arr { A_R, A_LNR, A_LT, A_GT, A_FLUX, A_WRES, A_WT0, A_WINT, A_MIDR,
           A_LNMID, A_LR0, A_LR1, A_VOLST, A_SIGF, A_BGF, A_CMF, A_CTF, A_LO,
           A_HI, A_WG, A_MU, A_CONVT, A_CONVV, A_CONVS, A_MUI, A_KG, A_KM,
           A_KV, A_DLR, A_RLO, A_KX };
// family codes (ops/consts_layout.py)
enum Fam { P_GNFW = 0, P_KNOTS = 1, T_UPP = 0, T_VIKH = 1, T_NONE = 2,
           D_SINGLE = 0, D_DOUBLE = 1 };
#define LN10F 2.30258512496948242f     // float32(ln 10), as ll_body's LN10

struct LLConsts {
  const float* buf;          // cluster 0's packed constants
  float* ws;                 // the tiles' scratch in global memory, or null
  size_t ws_stride;          // floats of ws per block
  int stage;                 // 1: the constants are staged in shared memory
  int off[N_ARRAYS];         // float offset of each array in buf
  int n_buf;                 // floats a block stages (all arrays, r4)
  int n_press, sep, n_pix, n_data, n_sh, n_ann, n_band, nT, n_conv, D,
      mass_veto, p_fam, t_fam, d_fam, n_knots, has_xray, has_ls;
  int cix[N_ROLES];
  float c_gnfw, alpha, gamma, t0g, inv_dtg, pos_hi;
  float c_lo, alpha_lo, gamma_lo;  // what float32 leaves of c, alpha, gamma
};

__host__ __device__ inline int r4(int n) { return (n + 3) & ~3; }
// row stride of a walker's map profile: whole passes of PIX_PASS radii
__host__ __device__ inline int pix_stride(int n_pix) {
  return (n_pix + PIX_PASS - 1) / PIX_PASS * PIX_PASS;
}
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// iv: N_INTS ints, N_ROLES column indices, N_ARRAYS float offsets into buf;
// fv: N_FLOATS floats (ops/consts_layout.py::LaunchParams).  The staged
// extent is the end of the last array, from the sizes the ints give (an
// array the buffer lacks has offset 0 and ends inside it).
static inline LLConsts make_consts(const float* buf, const int* iv,
                                   const float* fv) {
  LLConsts c;
  int* ints[N_INTS] = {&c.n_press, &c.sep, &c.n_pix, &c.n_data, &c.n_sh,
                       &c.n_ann, &c.n_band, &c.nT, &c.n_conv, &c.D,
                       &c.mass_veto, &c.p_fam, &c.t_fam, &c.d_fam,
                       &c.n_knots, &c.has_xray, &c.has_ls};
  for (int i = 0; i < N_INTS; ++i) *ints[i] = iv[i];
  for (int i = 0; i < N_ROLES; ++i) c.cix[i] = iv[N_INTS + i];
  for (int i = 0; i < N_ARRAYS; ++i) c.off[i] = iv[N_INTS + N_ROLES + i];
  float* fl[N_FLOATS] = {&c.c_gnfw, &c.alpha, &c.gamma, &c.t0g, &c.inv_dtg,
                         &c.pos_hi, &c.c_lo, &c.alpha_lo, &c.gamma_lo};
  for (int i = 0; i < N_FLOATS; ++i) *fl[i] = fv[i];
  c.buf = buf;
  c.ws = nullptr;
  c.ws_stride = 0;
  c.stage = 1;
  const int NP = c.n_press, PIX = c.n_pix, ND = c.n_data, NS = c.n_sh,
            NBA = c.n_band * c.n_ann, NBT = c.n_band * c.nT;
  const int NK = c.p_fam == P_KNOTS;
  const int MV = c.mass_veto;
  const int size[N_ARRAYS] = {NP, NP, NP * PIX, PIX * ND, ND, ND, c.sep, NP,
                              NS, NS, NBT, NBT, NS * c.n_ann, NBA, NBA, NBA,
                              NBA, c.D, c.D, c.D, c.D, c.n_conv, c.n_conv,
                              c.n_conv, 1, NK * 3 * NP, NK * 3 * NS,
                              NK * MV * 6 * (c.n_knots - 1),
                              (1 - NK) * MV * (NP + 2), (1 - NK) * MV * NP,
                              NK * MV * KX_COLS * (c.n_knots - 1)};
  int end = 0;
  for (int i = 0; i < N_ARRAYS; ++i) end = imax(end, c.off[i] + size[i]);
  c.n_buf = r4(end);
  return c;
}

// The scratch of one tile's profiles (float offsets, multiples of 4).
// R is scratch that three phases use in turn: the HSE mass (WT x n_press),
// the partial sums of pp @ L^T (KSPLIT / 2 x WT x PIX_PASS), the X-ray taps
// and emissivities and the Cash terms.  pairs: the count and list of the
// mass-veto pairs float32 is not sure of (PAIR_CAP of mass_veto.cuh).
struct TileLayout { int press, tsz, prof, res, sc, flags, pairs, R, total; };
__host__ __device__ inline TileLayout tile_layout(const LLConsts& c) {
  const int WT = TILE_WALKERS;
  TileLayout t;
  int o = 0;
  t.press = o; o += r4(WT * c.n_press);        // n_press x WT
  t.tsz = o;   o += r4(WT * c.sep);            // WT x sep
  t.prof = o;  o += WT * pix_stride(c.n_pix);  // WT x pix_stride
  t.res = o;   o += WT * r4(c.n_data);         // WT x n_data
  t.sc = o;    o += r4(WT * SC_STRIDE);
  t.flags = o; o += r4(2 * WT);                // ints
  t.pairs = o; o += r4(1 + PAIR_CAP);          // ints: count, list
  t.R = o;
  int xr = WT * c.n_sh * XS_N + 2 * WT * c.n_band * c.n_sh
           + WT * c.n_band * c.n_ann;
  o += r4(imax(imax(WT * c.n_press, KSPLIT / 2 * WT * PIX_PASS), xr));
  t.total = o;
  return t;
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

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// ---- cp.async staging of the constants --------------------------------
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ inline void stage_copy(float* dst, const float* src, int n) {
  int i0 = 0;
  if ((((uintptr_t)src) & 15) == 0) {
    const int n4 = n >> 2;
    for (int i = threadIdx.x; i < n4; i += blockDim.x)
      cp_async16(dst + 4 * i, src + 4 * i);
    i0 = n4 << 2;
  }
  for (int i = i0 + threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// FIT: the launch plan put the constants and the scratch in shared memory
// (the CL J1226 shapes).  Each kernel's body is instantiated twice: FIT =
// true in the kernel the launcher takes when the plan fits, where every
// pointer below is known to be a shared-memory one, so the compiler emits
// shared loads and stores and allocates registers for that body alone;
// FIT = false in its _large_ twin, which follows the plan at run time on
// generic pointers.

// The constants at buf + coff (c.n_buf floats: every array the tile
// reads) for the tiles that follow: when the plan stages them, start
// copying them into smem and return smem (the tile waits for the copy
// before its first read), else return them in place.  All threads call
// it, with no thread still reading a previous smem copy.
template <bool FIT>
__device__ inline const float* use_consts(const LLConsts& c, size_t coff,
                                          float* smem) {
  if (!FIT && !c.stage) return c.buf + coff;
  stage_copy(smem, c.buf + coff, c.n_buf);
  cp_async_commit();
  return smem;
}

// A tile's scratch: sm in shared memory, or this block's share of the
// global workspace when the plan put it there.
template <bool FIT>
__device__ __forceinline__ float* tile_scratch(const LLConsts& c, float* sm) {
  return (!FIT && c.ws) ? c.ws + (size_t)blockIdx.x * c.ws_stride : sm;
}

__device__ __forceinline__ void wait_staged() {
  cp_async_wait_all();
  __syncthreads();
}

// Tiles [t0, t1) of n_tiles for this block: contiguous, so a block of the
// cluster grid keeps its cluster's staged constants for as long as it can.
__device__ inline void block_tiles(int n_tiles, int* t0, int* t1) {
  *t0 = (int)((long long)blockIdx.x * n_tiles / gridDim.x);
  *t1 = (int)((long long)(blockIdx.x + 1) * n_tiles / gridDim.x);
}

// Per-walker scalars, one slot each in the tile's scalar area (the
// Vikhlinin T's and the double density's after the flagship's).
// S_VT0, S_VT0O, S_VTL, S_VTC, S_VSGN, S_VFLAG: the mass veto's tier-1
// tolerances, the masses' sign and flags (mass_veto.cuh::
// gnfw_walker_bounds).
enum Scal { S_P0, S_A, S_BCA, S_LNRP, S_BMC, S_N0SQ, S_RCI, S_RSI, S_EC,
            S_ES, S_TTX, S_Z, S_BSCALE, S_CAL, S_TOTAL, S_T0, S_INTEG,
            S_CHI2, S_CASH, S_T0V, S_TMINR, S_RCLI, S_ACOOL, S_RTI, S_CTH,
            S_N02SQ, S_RC2I, S_E2, S_VT0, S_VT0O, S_VTL, S_VTC, S_VSGN,
            S_VFLAG, N_SCAL };
static_assert(N_SCAL <= SC_STRIDE, "scalar slots");

// The profile scalars of one walker, in registers: lnn0sq = ln n_0^2.
struct Prof {
  float p0, a, bca, lnrp, bmc, n0sq, rci, rsi, ec, es, lnn0sq;
};
__device__ __forceinline__ Prof load_prof(const float* s) {
  return Prof{s[S_P0], s[S_A], s[S_BCA], s[S_LNRP], s[S_BMC], s[S_N0SQ],
              s[S_RCI], s[S_RSI], s[S_EC], s[S_ES], logf(s[S_N0SQ])};
}

// The density at one radius: ne2 = n_e^2 as a product of exponentials (as
// ll_body forms it), q = ln(n_e^2 / n_0^2) and lnne2 = ln n_e^2 beside
// it, normal: every factor of the product is a normal float, and inv =
// rsqrt(ne2), which is 1/n_e where normal (else exp(-lnne2 / 2) is:
// over_ne).  l1 = ln(1 + x_c^2), l2 = ln(1 + x_s^gamma), l3 (the double
// mode's ln(1 + x_2^2)), q1 (the first term's q), lnxc = ln x_c (where
// alpha != 0): what the mass veto's error bounds read.
struct Dens { float ne2, q, lnne2, inv, l1, l2, l3, q1, lnxc; bool normal; };

// The density at r; scw: the walker's scalar slots (the double mode's
// term)
template <bool FAM>
__device__ __forceinline__ Dens dens_of(const LLConsts& c, const Prof& s,
                                        const float* scw, float r) {
  float xc = r * s.rci;
  float xs = r * s.rsi;
  float xs_g = (c.gamma == 3.0f) ? xs * xs * xs : powf(xs, c.gamma);
  Dens d;
  d.l1 = log1pf(xc * xc);
  d.l2 = log1pf(xs_g);
  d.l3 = 0.0f;
  d.lnxc = 0.0f;
  d.q = -s.ec * d.l1 - s.es * d.l2;
  d.ne2 = s.n0sq * expf(d.q);
  d.normal = d.q > LN_NORMAL && s.lnn0sq + d.q > LN_NORMAL;
  if (c.alpha != 0.0f) {
    d.ne2 = d.ne2 * powf(xc, -c.alpha);
    d.lnxc = logf(xc);
    d.q = d.q - c.alpha * d.lnxc;
  }
  d.q1 = d.q;
  if (FAM && c.d_fam == D_DOUBLE) {
    // the beta-model term n02^2 (1 + (r/rc2)^2)^(-3 beta2), and q by a
    // log-add-exp
    const float x2 = r * scw[S_RC2I];
    d.l3 = log1pf(x2 * x2);
    const float q2 = scw[S_E2] * d.l3;
    d.ne2 = d.ne2 + scw[S_N02SQ] * expf(q2);
    const float ln02 = logf(scw[S_N02SQ]);
    const float d2 = (ln02 - s.lnn0sq) + q2;
    const float hi = fmaxf(d.q, d2), lo = fminf(d.q, d2);
    d.q = hi + log1pf(expf(lo - hi));
    d.normal = d.normal && q2 > LN_NORMAL && ln02 + q2 > LN_NORMAL;
  }
  d.lnne2 = s.lnn0sq + d.q;
  d.normal = d.normal && d.lnne2 > LN_NORMAL;
  d.inv = rsqrtf(d.ne2);
  return d;
}

template <bool B> struct BoolC { static constexpr bool value = B; };

// A mass m = sgn exp(lm) as sgn softplus(lm) = sgn ln(1 + |m|): strictly
// increasing in m, so it orders the masses as m does, and finite where
// exp(lm) would pass float32's range.
__device__ __forceinline__ float signed_log_mass(float lm, float sgn) {
  return sgn * (fmaxf(lm, 0.0f) + log1pf(expf(-fabsf(lm))));
}

// p / n_e: p x 1/n_e where n_e^2 is normal, else exp(ln p - ln n_e^2 / 2),
// which stays finite where 1/n_e alone would pass float32's range
__device__ __forceinline__ float over_ne(float p, const Dens& d) {
  return d.normal ? p * d.inv : expf(logf(p) - 0.5f * d.lnne2);
}

// The Vikhlinin temperature at r (b_t = 2): T0 (x^ac + Tmin/T0) / (x^ac +
// 1) (1 + (r/rt)^2)^(-ct/2), x = r / rcool, as ll_body's vikh_T.
__device__ __forceinline__ float vikh_T(const float* scw, float r) {
  const float xcl = expf(scw[S_ACOOL] * logf(r * scw[S_RCLI]));
  const float xt = r * scw[S_RTI];
  const float cool = (xcl + scw[S_TMINR]) / (xcl + 1.0f);
  return scw[S_T0V] * cool * expf(scw[S_CTH] * log1pf(xt * xt));
}

// The gNFW scalars of the walker whose parameter row is t.
__device__ __forceinline__ void gnfw_scalars(const LLConsts& c,
                                             const float* t, float* s) {
  float a = t[c.cix[R_A]], b = t[c.cix[R_B]];
  s[S_P0] = t[c.cix[R_P0]];
  s[S_A] = a;
  s[S_BCA] = (b - c.c_gnfw) / a;
  s[S_BMC] = b - c.c_gnfw;
  s[S_LNRP] = logf(t[c.cix[R_RP]]);
}

// log10 P of the knot lerp at a table row kt = (segment i, w0, w1): knot
// values v (the walker's row from its first knot), two FP32 products.
__device__ __forceinline__ float knot_log10(const float* kt, const float* v,
                                            int w0 = 1, int w1 = 2) {
  const int i = (int)kt[0];
  return __fmaf_rn(v[i + 1], kt[w1], __fmul_rn(v[i], kt[w0]));
}

// The gNFW pressure at ln r, with ln(1 + x^a), lnp = ln(P / P_0) and
// rel = P / P_0.
__device__ __forceinline__ float gnfw_press(const LLConsts& c, const Prof& s,
                                            float lnr, float* ln1xa_out,
                                            float* lnp_out, float* rel_out) {
  float lnx = lnr - s.lnrp;
  float za = s.a * lnx;
  float ln1xa = fmaxf(za, 0.0f) + log1pf(expf(-fabsf(za)));
  *ln1xa_out = ln1xa;
  const float lnp = -c.c_gnfw * lnx - s.bca * ln1xa;
  *lnp_out = lnp;
  *rel_out = expf(lnp);
  return s.p0 * *rel_out;
}

// the mass veto's tiers (they read the helpers above)
#include "mass_veto.cuh"

// The SZ chain of a tile: raw = pp @ L^T, the temperature-dependent y->mJy
// lerp (segment index = number of interior knots <= t, so both end segments
// extrapolate) x calibration, model = prof @ G^T, and the sum over data
// points of ((flux - model) * w)^2 -> chi[w * chi_stride].  pressT: n_press
// x WT pressures (walker fastest) in the scratch; st: the constants
// (use_consts).  The temperature of walker w at map radius p is
// t0[w * t0_stride] for p == 0 and tp[w * tp_stride + p - 1] above; its
// calibration is cal[w * cal_stride].  prof: WT x pix_stride(n_pix),
// red: KSPLIT / 2 x WT x PIX_PASS, res: WT x r4(n_data) floats of scratch.
// All threads of the block call it.
//
// raw, for each pass of PIX_PASS map radii: the k chunk kc of its WT /
// PPW warps holds k in [kc KC, (kc + 1) KC), KC = ceil(n_press / KSPLIT),
// summed in k order by FMAs from 0; the chunks then combine as s_kc +=
// s_kc+h for h = KSPLIT / 2, ..., 2, 1 (ops/sz_core.py::ksplit_matmul is
// the plain mirror).  model: one warp per (walker, GT_CHUNK data points),
// each lane the FMA sum of its map radii lane, lane + 32, lane + 64, ...,
// then a xor-butterfly per data point.
__device__ inline void sz_chain_tile(const LLConsts& c, const float* st,
                                     const float* pressT, const float* t0,
                                     int t0_stride, const float* tp,
                                     int tp_stride, const float* cal,
                                     int cal_stride, float* prof, float* red,
                                     float* res, float* chi,
                                     int chi_stride) {
  const int WT = TILE_WALKERS;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int NP = c.n_press, PIX = c.n_pix, ND = c.n_data;
  const float* LT = st + c.off[A_LT];
  const float* GT = st + c.off[A_GT];
  wait_staged();
  JT_MARK(4);
  const int PS = pix_stride(PIX);
  {
    const int wg = WT / PPW;                 // warps of one k chunk
    const int kc = warp / wg, wh = (warp - kc * wg) * PPW;
    const int KC = (NP + KSPLIT - 1) / KSPLIT;
    const int k0 = kc * KC;
    const int k1 = k0 + KC < NP ? k0 + KC : NP;
    for (int pb = 0; pb < PIX; pb += PIX_PASS) {
      int pix[PIX_LANE];
#pragma unroll
      for (int j = 0; j < PIX_LANE; ++j) {
        int p = pb + lane + 32 * j;
        pix[j] = p < PIX ? p : PIX - 1;
      }
      float acc[PPW][PIX_LANE];
#pragma unroll
      for (int w = 0; w < PPW; ++w)
#pragma unroll
        for (int j = 0; j < PIX_LANE; ++j) acc[w][j] = 0.f;
      for (int k = k0; k < k1; ++k) {
        float pw[PPW];
#pragma unroll
        for (int v = 0; v < PPW / 4; ++v) {
          const float4 q =
              *reinterpret_cast<const float4*>(pressT + k * WT + wh + 4 * v);
          pw[4 * v] = q.x;
          pw[4 * v + 1] = q.y;
          pw[4 * v + 2] = q.z;
          pw[4 * v + 3] = q.w;
        }
#pragma unroll
        for (int j = 0; j < PIX_LANE; ++j) {
          const float l = LT[k * PIX + pix[j]];
#pragma unroll
          for (int w = 0; w < PPW; ++w)
            acc[w][j] = __fmaf_rn(pw[w], l, acc[w][j]);
        }
      }
      for (int h = KSPLIT / 2; h > 0; h >>= 1) {
        if (kc >= h && kc < 2 * h) {
#pragma unroll
          for (int w = 0; w < PPW; ++w)
#pragma unroll
            for (int j = 0; j < PIX_LANE; ++j)
              red[((kc - h) * WT + wh + w) * PIX_PASS + lane + 32 * j] =
                  acc[w][j];
        }
        __syncthreads();
        if (kc < h) {
#pragma unroll
          for (int w = 0; w < PPW; ++w)
#pragma unroll
            for (int j = 0; j < PIX_LANE; ++j)
              acc[w][j] = __fadd_rn(
                  acc[w][j],
                  red[(kc * WT + wh + w) * PIX_PASS + lane + 32 * j]);
        }
        __syncthreads();
      }
      if (kc == 0) {
#pragma unroll
        for (int w = 0; w < PPW; ++w)
#pragma unroll
          for (int j = 0; j < PIX_LANE; ++j)
            prof[(wh + w) * PS + pb + lane + 32 * j] = acc[w][j];
      }
    }
  }
  __syncthreads();
  JT_MARK(5);
  {
    const float* cT = st + c.off[A_CONVT];
    const float* cV = st + c.off[A_CONVV];
    const float* cS = st + c.off[A_CONVS];
    for (int idx = tid; idx < WT * PIX; idx += nth) {
      const int w = idx / PIX, p = idx - w * PIX;
      float t = (p == 0) ? t0[w * t0_stride]
                : (p <= c.sep ? tp[w * tp_stride + p - 1] : 1.0f);
      // the number of interior knots <= t, by bisection: the packers
      // require a table that never decreases, so t >= cT[q] holds for a
      // prefix of q (a NaN t holds for none and takes segment 0, as
      // counting would)
      int lo = 1, hi = c.n_conv - 1;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (t >= cT[mid]) lo = mid + 1;
        else hi = mid;
      }
      const int ci = lo - 1;
      float conv = cV[ci] + (t - cT[ci]) * cS[ci];
      float* pr = prof + w * PS + p;
      *pr = *pr * conv * cal[w * cal_stride];
    }
  }
  __syncthreads();
  JT_MARK(6);
  {
    const float* fl = st + c.off[A_FLUX];
    const float* wr = st + c.off[A_WRES];
    const int RS = r4(ND);
    const int n_chunk = (ND + GT_CHUNK - 1) / GT_CHUNK;
    for (int unit = warp; unit < WT * n_chunk; unit += JT_WARPS) {
      const int w = unit / n_chunk;
      const int d0 = (unit - w * n_chunk) * GT_CHUNK;
      const float* pw = prof + w * PS;
      {
        float s[GT_CHUNK];
#pragma unroll
        for (int q = 0; q < GT_CHUNK; ++q) s[q] = 0.f;
#pragma unroll 3
        for (int p = lane; p < PIX; p += 32) {
          const float v = pw[p];
#pragma unroll
          for (int q = 0; q < GT_CHUNK; ++q)
            if (d0 + q < ND) s[q] = __fmaf_rn(v, GT[p * ND + d0 + q], s[q]);
        }
#pragma unroll
        for (int q = 0; q < GT_CHUNK; ++q) s[q] = warp_sum(s[q]);
        if (lane < GT_CHUNK && d0 + lane < ND) {
          float m = s[0];
#pragma unroll
          for (int q = 1; q < GT_CHUNK; ++q) m = lane == q ? s[q] : m;
          const int d = d0 + lane;
          float r = (fl[d] - m) * wr[d];
          res[w * RS + d] = r * r;
        }
      }
    }
    __syncthreads();
    JT_MARK(7);
    if (tid < WT) {
      float s = 0.f;
      for (int d = 0; d < ND; ++d) s += res[tid * RS + d];
      chi[tid * chi_stride] = s;
    }
    __syncthreads();
    JT_MARK(8);
  }
}

// Joint log-posterior of the TILE_WALKERS parameter rows in th (shared
// memory, row stride MAX_D) -> out[w] (shared memory).  All threads of the
// block must call it.  st: the constants (use_consts); sm:
// tile_layout(c).total floats of shared memory, unused when the plan put
// the scratch in the global workspace.  A thread's walker in the
// per-radius phases is tid % WT (the block's size is a multiple of WT).
// FAM: see the head of this file (the caller picks it by is_flagship).
template <bool FIT, bool FAM>
__device__ __forceinline__ void joint_ll_tile(const LLConsts& c,
                                              const float* st,
                                              const float* th, float* out,
                                              float* sm) {
  const int WT = TILE_WALKERS;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int NP = c.n_press, NS = c.n_sh, NB = c.n_band, NA = c.n_ann;
  const int TS = c.sep;
  const TileLayout L = tile_layout(c);
  sm = tile_scratch<FIT>(c, sm);
  float* pressT = sm + L.press;
  float* tsz = sm + L.tsz;
  float* prof = sm + L.prof;
  float* res = sm + L.res;
  float* sc = sm + L.sc;
  int* flags = (int*)(sm + L.flags);      // mass veto, x-ray veto
  int* npairs = (int*)(sm + L.pairs);     // mass-veto pairs to decide
  int* plist = npairs + 1;
  float* R = sm + L.R;
  const float INF = __int_as_float(0x7f800000);
  wait_staged();
  JT_MARK(0);
  JT_TILE_BEGIN();

  // ---- priors and r_c <= r_s veto: one thread per (walker, parameter),
  // ---- PL lanes a walker; the flagship's scalars by 16 threads beside
  // ---- them, a family's by lanes 1-4 of the walker's warp and the mass
  // ---- veto's bounds by lane 5 (the flagship's: in the pressure grid)
  constexpr int PL = FAM ? MAX_D : 16;
  if (tid < WT * PL) {
    const int w = tid / PL, d = tid - w * PL;
    const float* t = th + w * MAX_D;
    float* s = sc + w * SC_STRIDE;
    float g = 0.f;
    int out_box = 0;
    if (d < c.D) {
      const float v = t[d];
      out_box = !((v >= st[c.off[A_LO] + d]) && (v <= st[c.off[A_HI] + d]));
      const float dr = v - st[c.off[A_MU] + d];
      g = st[c.off[A_WG] + d] * dr * dr;
    }
    // fixed order over the lanes of this walker (lanes >= D add zeros)
#pragma unroll
    for (int o = PL / 2; o > 0; o >>= 1) {
      g += __shfl_xor_sync(0xffffffffu, g, o, PL);
      out_box |= __shfl_xor_sync(0xffffffffu, out_box, o, PL);
    }
    if (d == 0) {
      float total = out_box ? -INF : -0.5f * g;
      if (t[c.cix[R_LOGRC]] > t[c.cix[R_LOGRS]]) total = -INF;
      s[S_TOTAL] = total;
      flags[2 * w] = 0;
      flags[2 * w + 1] = 0;
      if (w == 0) *npairs = 0;
    } else if (FAM && d == 1) {
      float n0 = powf(10.0f, t[c.cix[R_LOGN0]]);
      s[S_N0SQ] = n0 * n0;
      s[S_RCI] = powf(10.0f, -t[c.cix[R_LOGRC]]);
      s[S_RSI] = powf(10.0f, -t[c.cix[R_LOGRS]]);
      s[S_EC] = 3.0f * t[c.cix[R_BETA]] - c.alpha / 2.0f;
      s[S_ES] = t[c.cix[R_EPS]] / c.gamma;
      s[S_CAL] = t[c.cix[R_CAL]];
      if (c.has_xray) {
        if (c.t_fam != T_VIKH) s[S_TTX] = powf(10.0f, t[c.cix[R_TRATIO]]);
        // line_scale scales exactly the metal-line part: Z_eff = Z * s
        s[S_Z] = c.has_ls ? t[c.cix[R_Z]] * t[c.cix[R_LS]] : t[c.cix[R_Z]];
        s[S_BSCALE] = t[c.cix[R_BSCALE]];
      }
    } else if (FAM && d == 2 && c.p_fam == P_GNFW) {
      gnfw_scalars(c, t, s);
    } else if (FAM && d == 3 && c.t_fam == T_VIKH) {
      s[S_T0V] = t[c.cix[R_T0]];
      s[S_TMINR] = t[c.cix[R_TMINR]];
      s[S_RCLI] = 1.0f / t[c.cix[R_RCOOL]];
      s[S_ACOOL] = t[c.cix[R_ACOOL]];
      s[S_RTI] = 1.0f / t[c.cix[R_RT]];
      s[S_CTH] = -0.5f * t[c.cix[R_CT]];
    } else if (FAM && d == 4 && c.d_fam == D_DOUBLE) {
      float n02 = powf(10.0f, t[c.cix[R_LOGN02]]);
      s[S_N02SQ] = n02 * n02;
      s[S_RC2I] = powf(10.0f, -t[c.cix[R_LOGRC2]]);
      s[S_E2] = -3.0f * t[c.cix[R_BETA2]];
    } else if (FAM && d == 5 && c.p_fam == P_GNFW && c.mass_veto) {
      gnfw_walker_bounds(c, st, t, s);
    }
  } else if (!FAM && tid - WT * PL < WT) {
    const int w = tid - WT * PL;
    const float* t = th + w * MAX_D;
    float* s = sc + w * SC_STRIDE;
    gnfw_scalars(c, t, s);
    float n0 = powf(10.0f, t[c.cix[R_LOGN0]]);
    s[S_N0SQ] = n0 * n0;
    s[S_RCI] = powf(10.0f, -t[c.cix[R_LOGRC]]);
    s[S_RSI] = powf(10.0f, -t[c.cix[R_LOGRS]]);
    s[S_EC] = 3.0f * t[c.cix[R_BETA]] - c.alpha / 2.0f;
    s[S_ES] = t[c.cix[R_EPS]] / c.gamma;
    s[S_TTX] = powf(10.0f, t[c.cix[R_TRATIO]]);
    s[S_Z] = t[c.cix[R_Z]];
    s[S_BSCALE] = t[c.cix[R_BSCALE]];
    s[S_CAL] = t[c.cix[R_CAL]];
  }
  __syncthreads();
  JT_MARK(1);

  // ---- pressure, T_SZ and (gNFW) HSE mass on the pressure grid, and the
  // ---- partial sums of T(0) and integrated Y: a thread's walker's
  // ---- scalars in registers
  float* mm = R;                                    // WT x n_press
  float* part = prof;                   // 2 x JT_WARPS x WT partial sums
  {
    const float* r = st + c.off[A_R];
    const float* lnr = st + c.off[A_LNR];
    const float* wT0 = st + c.off[A_WT0];
    const float* wint = st + c.off[A_WINT];
    const float* KG = st + c.off[A_KG];
    const int w = tid % WT, kstep = nth / WT;
    const float* scw = sc + w * SC_STRIDE;
    const float* kv = th + w * MAX_D + c.cix[R_KC0];
    const Prof s = load_prof(scw);
    const float sgn = (float)((s.p0 > 0.0f) - (s.p0 < 0.0f));
    const float sn0 = sgn * sqrtf(s.n0sq);
    float t0s, is;
    // the thread's radii on the product forms (ll_body's); then, for a
    // walker one of whose radii has n_e^2 not normal, its radii again on
    // the log forms: the mass as signed_log_mass, P / n_e by over_ne (a
    // rare branch, where a select would have the log forms evaluated
    // always)
    auto radii = [&](auto logs_t) {
      constexpr bool LOGS = decltype(logs_t)::value;
      bool slow = false;
      t0s = 0.f;
      is = 0.f;
      for (int k = tid / WT; k < NP; k += kstep) {
        const float rk = r[k];
        float P;
        const Dens dn = dens_of<FAM>(c, s, scw, rk);
        slow = slow | !dn.normal;
        if (FAM && c.p_fam == P_KNOTS) {
          P = expf(LN10F * knot_log10(KG + 3 * k, kv));
        } else {
          float x, lnp, rel;
          P = gnfw_press(c, s, lnr[k], &x, &lnp, &rel);
          const float f = 1.0f - expf(-x);
          const float g = c.c_gnfw + s.bmc * f;
          // (P / P_0) r g (1 / n_e) n_0 sign(P_0)
          mm[w * NP + k] =
              LOGS ? signed_log_mass(lnr[k] + logf(fabsf(g)) + lnp
                                         - 0.5f * dn.q,
                                     sgn * (float)((g > 0.0f) - (g < 0.0f)))
                   : rel * rk * g * dn.inv * sn0;
        }
        pressT[k * WT + w] = P;
        is = __fmaf_rn(P, wint[k], is);
        if (k < c.sep) {
          const float tz = (FAM && c.t_fam == T_VIKH) ? vikh_T(scw, rk)
                           : LOGS                     ? over_ne(P, dn)
                                                      : P * dn.inv;
          tsz[w * TS + k] = tz;
          t0s = __fmaf_rn(tz, wT0[k], t0s);
        }
      }
      return slow;
    };
    // flags[2 w] bit 2: walker w's masses on the log form
    const bool slow = radii(BoolC<false>{});
    if (slow) atomicOr(flags + 2 * w, 2);
    // the mass veto's bounds of walker w, on its last thread, which has a
    // radius fewer where 32 does not divide n_press (313 radii: 9 of 10),
    // while the other warps take their last radius: off the priors
    // phase's critical path
    if (!FAM && c.mass_veto && tid >= nth - WT)
      gnfw_walker_bounds(c, st, th + w * MAX_D, sc + w * SC_STRIDE);
    if (__syncthreads_or(slow) && (flags[2 * w] & 2)) radii(BoolC<true>{});
    // the 32 threads of walker w: lanes w and w + 16 of every warp
    t0s += __shfl_xor_sync(0xffffffffu, t0s, 16);
    is += __shfl_xor_sync(0xffffffffu, is, 16);
    if (lane < WT) {
      part[warp * WT + w] = t0s;
      part[(JT_WARPS + warp) * WT + w] = is;
    }
  }
  __syncthreads();
  JT_MARK(2);

  // ---- mass veto; T(0) and integrated Y summed over the warps in order ---
  // (float32 where it is sure; the pairs it is not sure of, of a walker
  // inside the prior box that no sure pair vetoes, listed for mass_veto.
  // cuh's tiers 2-3 (decide_pair): each thread keeps its own in pend, bit
  // j for its j-th pair, until a barrier has every sure veto in flags)
  auto list_pair = [&](int w, int k) {
    const int i = atomicAdd(npairs, 1);
    if (i < PAIR_CAP) plist[i] = (w << 16) | k;
    else atomicOr(flags + 2 * w, 32);      // every pair of w decided
  };
  unsigned long long pend = 0ull;
  if (FAM && c.mass_veto && c.p_fam == P_KNOTS) {
    // the segment-averaged mass at one log-midpoint per segment, M = -P
    // slope r / ne C scaled by n_0 C: strictly increasing, ending positive
    const int NM = c.n_knots - 1;
    const float* KV = st + c.off[A_KV];
    for (int idx = tid; idx < WT * NM; idx += nth) {
      const int w = idx / NM, j = idx - w * NM;
      const float* scw = sc + w * SC_STRIDE;
      const float* kv = th + w * MAX_D + c.cix[R_KC0];
      const float* row = KV + 6 * j;
      const float lnpm = LN10F * knot_log10(row, kv);
      const float sl = knot_log10(row, kv, 3, 4);
      const float rm = row[5];
      const Prof s = load_prof(scw);
      const Dens dn = dens_of<FAM>(c, s, scw, rm);
      const float lpn = lnpm - 0.5f * dn.q;
      mm[idx] = -sl * rm * expf(lpn);
      const float sgn = (float)((sl < 0.0f) - (sl > 0.0f));
      mm[WT * NM + idx] =
          signed_log_mass(logf(fabsf(sl)) + logf(rm) + lpn, sgn);
      knot_mass_bounds<FAM>(c, s, scw, row, kv, sl, lnpm, lpn, dn,
                            mm + 2 * WT * NM + idx, mm + 3 * WT * NM + idx);
    }
    __syncthreads();
    if (tid < WT) {
      // the product form, or the signed log form for a walker one of
      // whose masses the product form takes past float32's range; the
      // masses' signs exact from the knot values
      const float* m = mm + tid * NM;
      bool wide = false;
      for (int j = 0; j < NM; ++j)
        wide = wide | !(isfinite(m[j]) && m[j] != 0.0f);
      if (wide) m = mm + WT * NM + tid * NM;
      const float* kv = th + tid * MAX_D + c.cix[R_KC0];
      const float* scw = sc + tid * SC_STRIDE;
      const float cq = knot_cq<FAM>(c, load_prof(scw), scw);
      const float* KX = st + c.off[A_KX];
      bool bad = !(kv[NM] < kv[NM - 1]);
      for (int j = 0; j + 1 < NM; ++j)
        if (knot_tier1(m, mm + 2 * WT * NM + tid * NM,
                       mm + 3 * WT * NM + tid * NM, kv, KX[KX_COLS * j + 3],
                       cq, wide, j, &bad)) {
          if (j < 64) pend |= 1ull << j;
          else list_pair(tid, j);
        }
      if (bad) atomicOr(flags + 2 * tid, 1);
      else if (scw[S_TOTAL] > -INF)
        for (int j = 0; pend >> j; ++j)
          if ((pend >> j) & 1ull) list_pair(tid, j);
      pend = 0ull;
    }
  } else if (c.mass_veto) {
    // np.gradient(m) > 0: central differences inside, one-sided at the
    // edges; a NaN comparison is false and vetoes
    const int w = tid % WT;
    bool bad = false;
    if (sc[w * SC_STRIDE + S_TOTAL] > -INF)
      gnfw_tier1(mm + w * NP, sc + w * SC_STRIDE, flags[2 * w], tid / WT,
                 nth / WT, NP, &bad, [&](int k) {
                   const int j = (k - tid / WT) / (nth / WT);
                   if (j < 64) pend |= 1ull << j;
                   else list_pair(w, k);
                 });
    if (bad) atomicOr(flags + 2 * w, 1);
  }
  if (tid < WT) {
    float t0s = 0.f, is = 0.f;
    for (int q = 0; q < JT_WARPS; ++q) {
      t0s += part[q * WT + tid];
      is += part[(JT_WARPS + q) * WT + tid];
    }
    sc[tid * SC_STRIDE + S_T0] = t0s;
    sc[tid * SC_STRIDE + S_INTEG] = is;
  }
  if (__syncthreads_or(pend != 0ull)) {
    // the kept pairs of walkers no sure pair vetoed
    const int w = tid % WT;
    if (pend && !(flags[2 * w] & 1))
      for (int j = 0; pend >> j; ++j)
        if ((pend >> j) & 1ull) list_pair(w, tid / WT + j * (nth / WT));
    __syncthreads();
  }
  JT_MARK(3);

  // ---- SZ: raw = pp @ L^T, lerp x calibration, model = prof @ G^T, chi^2 --
  sz_chain_tile(c, st, pressT, sc + S_T0, SC_STRIDE, tsz, TS, sc + S_CAL,
                SC_STRIDE, prof, R, res, sc + S_CHI2, SC_STRIDE);

  // the listed mass-veto pairs (tiers 2-3), by the last warp: beside the
  // X-ray phases, which the other warps then take alone, or before the
  // combine; where the list overflowed, every pair of a walker flagged 32
  // as well
  auto decide_listed = [&]() {
    const int n = *npairs < PAIR_CAP ? *npairs : PAIR_CAP;
    const int per = (FAM && c.p_fam == P_KNOTS) ? c.n_knots - 2 : NP;
    const int all = *npairs > PAIR_CAP ? WT * per : 0;
#ifdef JT_PHASE_CLOCKS
    const long long t_side = clock64();
#endif
    for (int i = lane; i < n + all; i += 32) {
      int w, k;
      if (i < n) {
        w = plist[i] >> 16;
        k = plist[i] & 0xffff;
      } else {
        w = (i - n) / per;
        k = i - n - w * per;
        if (!(flags[2 * w] & 32)) continue;
      }
      decide_pair<FAM>(c, st, th, sc, flags, w, k);
    }
#ifdef JT_PHASE_CLOCKS
    __syncwarp();
    if (lane == 0 && n) {
      const long long dt = clock64() - t_side;
      JT_ADD(16, dt);
      JT_ADD(17, n);
      JT_ADD(18, 1);
      if (all) JT_ADD(19, 1);
      if (blockIdx.x == 0)
        atomicMax((unsigned long long*)&jt_clocks[20],
                  (unsigned long long)dt);
      JT_TILE_SIDE(dt);
    }
#endif
  };

  // ---- X-ray (none in an SZ-only session): midpoint profiles, two-tap
  // ---- count-rate lookup, projection, prediction, positivity veto, Cash
  const bool xray = !FAM || c.has_xray;
  float* xs = R;                                    // WT x NS x XS_N
  float* e0 = xs + WT * NS * XS_N;                  // WT x NB x NS
  float* e1 = e0 + WT * NB * NS;
  float* cash = e1 + WT * NB * NS;                  // WT x NB x NA
  const float* V = st + c.off[A_VOLST];
  const float* sigf = st + c.off[A_SIGF];
  const float* bgf = st + c.off[A_BGF];
  const float* cmf = st + c.off[A_CMF];
  const float* ctf = st + c.off[A_CTF];
  const int cells = NB * NA;
  // a tile with listed pairs runs the taps, the emissivities and the
  // projection on all warps but the last (nx threads, a named barrier
  // between the phases), and the last warp decides the pairs beside all
  // three: a float64 pair takes several thousand cycles, more than the
  // projection alone leaves idle.  Every element is computed as by nth
  // threads, so the values do not depend on the split.
  const bool split = xray && *npairs > 0;
  const int nx = split ? nth - 32 : nth;
  auto xbar = [&]() {
    if (split) asm volatile("barrier.sync 1, %0;" ::"r"(nx) : "memory");
    else __syncthreads();
  };
  if (xray && tid < nx) {
  {
    const float* midr = st + c.off[A_MIDR];
    const float* lnmid = st + c.off[A_LNMID];
    const float* KM = st + c.off[A_KM];
    for (int idx = tid; idx < WT * NS; idx += nx) {
      const int w = idx / NS, j = idx - w * NS;
      const float* scw = sc + w * SC_STRIDE;
      const Prof s = load_prof(scw);
      float Tm, n2;
      if (FAM && c.t_fam == T_VIKH) {
        n2 = dens_of<FAM>(c, s, scw, midr[j]).ne2;
        Tm = vikh_T(scw, midr[j]);
      } else {
        float pm;
        if (FAM && c.p_fam == P_KNOTS) {
          pm = expf(LN10F * knot_log10(KM + 3 * j,
                                       th + w * MAX_D + c.cix[R_KC0]));
        } else {
          float x1, l1, e1;
          pm = gnfw_press(c, s, lnmid[j], &x1, &l1, &e1);
        }
        const Dens dn = dens_of<FAM>(c, s, scw, midr[j]);
        n2 = dn.ne2;
        Tm = over_ne(pm, dn) * scw[S_TTX];
      }
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
      float* x = xs + idx * XS_N;
      x[0] = __int_as_float(k0);
      x[1] = __int_as_float(k1);
      x[2] = w0;
      x[3] = w1;
      x[4] = n2;
      x[5] = bad ? 1.0f : 0.0f;
    }
  }
  xbar();
  JT_MARK(9);
  {
    const float* LR0 = st + c.off[A_LR0];
    const float* LR1 = st + c.off[A_LR1];
    const float NaN = __int_as_float(0x7fc00000);
    for (int idx = tid; idx < WT * NB * NS; idx += nx) {
      const int w = idx / (NB * NS), rem = idx - w * NB * NS;
      const int b = rem / NS, j = rem - b * NS;
      const float* x = xs + (w * NS + j) * XS_N;
      const int k0 = __float_as_int(x[0]), k1 = __float_as_int(x[1]);
      const float w0 = x[2], w1 = x[3], n2 = x[4];
      const float z = sc[w * SC_STRIDE + S_Z];
      const float* t0r = LR0 + b * c.nT;
      const float* t1r = LR1 + b * c.nT;
      float l0 = w0 * t0r[k0] + w1 * t0r[k1];
      float l1 = w0 * t1r[k0] + w1 * t1r[k1];
      e0[idx] = x[5] != 0.0f ? NaN : expf(l0) * (1.0f - z) * n2;
      e1[idx] = expf(l1) * z * n2;
    }
  }
  xbar();
  JT_MARK(10);
    // the projection: one thread per (walker, band), PROJ_CHUNK annuli at
    // a time, each sum over the shells in order; p0 + p1 into cash
    for (int row = tid; row < WT * NB; row += nx) {
      const float* E0 = e0 + row * NS;
      const float* E1 = e1 + row * NS;
      for (int i0 = 0; i0 < NA; i0 += PROJ_CHUNK) {
        float p0[PROJ_CHUNK], p1[PROJ_CHUNK];
#pragma unroll
        for (int q = 0; q < PROJ_CHUNK; ++q) p0[q] = p1[q] = 0.f;
        for (int j = 0; j < NS; ++j) {
          const float a0 = E0[j], a1 = E1[j];
#pragma unroll
          for (int q = 0; q < PROJ_CHUNK; ++q) {
            const float v = i0 + q < NA ? V[j * NA + i0 + q] : 0.f;
            p0[q] = __fmaf_rn(a0, v, p0[q]);
            p1[q] = __fmaf_rn(a1, v, p1[q]);
          }
        }
#pragma unroll
        for (int q = 0; q < PROJ_CHUNK; ++q)
          if (i0 + q < NA) cash[row * NA + i0 + q] = p0[q] + p1[q];
      }
    }
  }
  // the listed mass-veto pairs: the last warp (alone before the combine
  // in an SZ-only session)
  if (warp == JT_WARPS - 1) decide_listed();
  __syncthreads();
  if (xray) {
    for (int idx = tid; idx < WT * cells; idx += nth) {
      const int w = idx / cells, bi = idx - w * cells;
      const float pred = cash[idx] * sigf[bi]
                         + sc[w * SC_STRIDE + S_BSCALE] * bgf[bi];
      if (!(pred > 0.0f) && cmf[bi] != 0.0f) flags[2 * w + 1] = 1;
      const float safe = (pred > 0.0f) ? pred : 1.0f;
      cash[idx] = cmf[bi] * (ctf[bi] * logf(safe) - safe);
    }
    __syncthreads();
    JT_MARK(11);
    for (int w = warp; w < WT; w += JT_WARPS) {
      float s = 0.f;
      for (int bi = lane; bi < cells; bi += 32) s += cash[w * cells + bi];
      s = warp_sum(s);
      if (lane == 0) sc[w * SC_STRIDE + S_CASH] = s;
    }
    __syncthreads();
  }
  JT_MARK(12);

  // ---- combine ------------------------------------------------------------
  if (tid < WT) {
    const float* s = sc + tid * SC_STRIDE;
    float total = s[S_TOTAL];
    if (flags[2 * tid] & 9) total = -INF;
    total = total - 0.5f * s[S_CHI2];
    float di = s[S_INTEG] - st[c.off[A_MUI]];
    total = total - 0.5f * di * di;
    if (!FAM || c.has_xray)
      total = total + (flags[2 * tid + 1] ? -INF : s[S_CASH]);
    out[tid] = isnan(total) ? -INF : total;
  }
  __syncthreads();
  JT_MARK(13);
  JT_TILE_END(*npairs);
}

// ---- host side ------------------------------------------------------------
// The tile takes at most MAX_D parameters and any number of radii.
static inline bool tile_fits(const LLConsts& c) {
  return c.D <= MAX_D && c.n_pix >= 1 && c.n_press >= 1;
}

// The flagship family, which the FAM = false tile computes.
static inline bool is_flagship(const LLConsts& c) {
  return c.p_fam == P_GNFW && c.t_fam == T_UPP && c.d_fam == D_SINGLE
         && c.has_xray && !c.has_ls && c.D <= 16;
}

// The kernel of a launch from k[FAM][!FIT]: FAM unless is_flagship, FIT
// when the plan stages the constants and keeps the scratch in shared
// memory.
template <typename Kernel>
static inline Kernel pick_kernel(const LLConsts& c, size_t ws,
                                 const Kernel (&k)[2][2]) {
  return k[!is_flagship(c)][!(c.stage && !ws)];
}
// pick_kernel's choice as one index, 2 x FAM + !FIT, which the launchers
// report so that each compiled instance has its own launch count
static inline int picked_instance(const LLConsts& c, size_t ws) {
  return 2 * !is_flagship(c) + !(c.stage && !ws);
}

// Where a launch keeps what its tiles read: own floats of shared memory
// the kernel needs for itself, scratch floats of the tiles' profiles.
// Both and the constants in shared memory when they fit in a block's
// shared memory; else the constants read in place (c->stage = 0); else the
// scratch too in a global workspace, scratch floats per block (*ws_floats).
// *smem: the dynamic shared memory in bytes.
static int plan_launch(LLConsts* c, size_t own, size_t scratch, size_t* smem,
                       size_t* ws_floats) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  const size_t limit = (size_t)optin / sizeof(float);
  c->stage = own + scratch + c->n_buf <= limit;
  *ws_floats = (c->stage || own + scratch <= limit) ? 0 : scratch;
  *smem = (own + (c->stage ? c->n_buf : 0) + (*ws_floats ? 0 : scratch))
          * sizeof(float);
  return 0;
}

// Allocate the workspace of a plan (blocks x ws_floats floats, ordered on
// the stream) into c->ws; release_workspace frees it after the launch.
static int take_workspace(LLConsts* c, int blocks, size_t ws_floats,
                          cudaStream_t stream) {
  c->ws = nullptr;
  c->ws_stride = ws_floats;
  if (!ws_floats) return 0;
  return (int)cudaMallocAsync((void**)&c->ws,
                              (size_t)blocks * ws_floats * sizeof(float),
                              stream);
}
static int release_workspace(const LLConsts& c, cudaStream_t stream) {
  cudaError_t e = cudaGetLastError();
  if (c.ws) {
    cudaError_t f = cudaFreeAsync(c.ws, stream);
    if (e == cudaSuccess) e = f;
  }
  return (int)e;
}

// Blocks of a launch that walks n_tiles tiles: as many as the card holds
// at once with smem bytes of dynamic shared memory (occupancy x SMs), at
// most n_tiles.  Returns a cudaError code (cudaErrorInvalidConfiguration
// when a block does not fit on an SM).  The card's capacity is asked once
// per kernel, device and size (the queries cost tens of microseconds of
// host time, more than a small launch).
template <typename Kernel>
static int resident_blocks(Kernel kernel, size_t smem, int n_tiles,
                           int* blocks) {
  struct Entry { const void* fn; int dev; size_t smem; int cap; };
  static Entry known[16];
  static int n_known = 0;
  *blocks = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  int cap = 0;
  for (int i = 0; i < (n_known < 16 ? n_known : 16); ++i)
    if (known[i].fn == (const void*)kernel && known[i].dev == dev
        && known[i].smem == smem)
      cap = known[i].cap;
  if (cap == 0) {
    // allow the kernel every size a plan may give it on this device, so a
    // launch of one size never finds the limit an other size set
    int occ = 0, sms = 0, optin = 0;
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel,
                                                        JT_THREADS, smem);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    if (occ < 1) return (int)cudaErrorInvalidConfiguration;
    cap = occ * sms;
    known[n_known % 16] = Entry{(const void*)kernel, dev, smem, cap};
    ++n_known;
  }
  *blocks = cap < n_tiles ? cap : n_tiles;
  return 0;
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
