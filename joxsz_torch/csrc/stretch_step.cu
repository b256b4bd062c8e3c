// Kernels 2, 3, 4 and 6: the stretch-move samplers, one launch per
// half-step and one per swap boundary.
//
// stretch_half_kernel is the half-step of three TPU kernels of
// joxsz_tpu/ops/pallas_joint.py: make_step_kernel (G = 1 group, the plain
// sampler), make_tempered_step_kernel (G = K rungs that share one set of
// constants and differ in beta: kernel 2) and make_multicluster_step_kernel
// (G = C clusters with beta = 1 that differ in their constants: kernel 4,
// per_cluster != 0).  The state's leading axis indexes the group, and a
// block, which holds a tile of one group's moving half (grid: tile x group),
// reads that group's beta or, in the cluster grid, that cluster's constants
// at buf + group * cstride.  Every walker of the moving half draws Philox
// bits, takes the stretch factor z (_stretch_z), a uniform partner in its
// own group's other half (the one-hot law), proposes y = x_p + z (x - x_p),
// evaluates the joint log-posterior through the shared joint_ll_tile, and
// accepts by _gw_accept: log u < (D-1) log z + beta (lp_y - lp).  Philox is
// keyed on (seed, 0) with counter (g*H + i, step, half, 0) for rungs and
// (i, step, half, cluster) for clusters, so a cluster's stream does not
// depend on how many clusters there are.  The swap kernel never runs on
// cluster-grid state.
//
// coupled_half_kernel (kernel 6) replaces make_coupled_half_kernel: the
// same half-step for one shard's block of the moving half, held in a buffer
// of its own, against a gathered copy of the whole fixed half.  Its draws
// are addressed by the row's place in the whole half, counter (row_off + i,
// step, half, 0), and joint_ll_tile does not depend on a walker's slot in
// its tile, so any split of the half over shards gives, bit for bit, what
// stretch_half_kernel gives for the whole ensemble at G = 1.  All of these
// share one piece of device code, stretch_half_tile.
//
// Kernel 3 (swap_kernel) replaces the swap sweep of
// make_tempered_step_kernel (pallas_joint.py:2383-2432) for one boundary
// kk: cold slot j of each half pairs with hot slot (j - shift) mod H (the
// rotation pairing), accepts by log u < (beta_kk - beta_kk+1)(lp_h - lp_c)
// on untempered lp, and exchanges the rows and lp; accept counts stay with
// the slot (they are a separate tensor).  sacc[kk] counts accepted swaps.
//
// State layout: x (G, W, D), lp (G, W), acc (G, W), group-major, float32;
// kernel 6: xu (H_loc, D), lpu/accu (H_loc,), xf (H, D).
// The decision arithmetic uses __f*_rn so it is never contracted into an
// FMA and rounds exactly as the plain torch version does.
#include "joint_ll.cuh"

// One tile of a half-step, the device code every stretch kernel shares:
// rows i0 .. i0 + TILE_WALKERS of a moving block of n_move rows (xm, lpm,
// accm) against a fixed half of n_fixed rows (xf).  Moving row i draws
// Philox at counter (ctr0 + i, step, which, c3).  The tail guard uses
// n_move for the moving rows and n_fixed for the partner clamp.
__device__ __forceinline__ void stretch_half_tile(
    float* __restrict__ xm, float* __restrict__ lpm, float* __restrict__ accm,
    const float* __restrict__ xf, int n_move, int n_fixed, uint32_t ctr0,
    uint32_t c3, int which, uint32_t seed, int step, float zc1, float zc2,
    float bg, size_t coff, const LLConsts& c, float* smem) {
  const int WT = TILE_WALKERS;
  float* y = smem;                         // WT x MAX_D proposals
  float* lpy = y + WT * MAX_D;             // WT
  float* rz = lpy + WT;                    // WT stretch factors
  float* ru = rz + WT;                     // WT accept uniforms
  int* slot = (int*)(ru + WT);             // WT moving rows
  int* pslot = slot + WT;                  // WT partner rows
  int* accf = pslot + WT;                  // WT accept flags
  float* sm = (float*)(accf + WT);
  const int D = c.D, tid = threadIdx.x;
  const int i0 = blockIdx.x * WT;
  if (tid < WT) {
    int i = i0 + tid < n_move ? i0 + tid : i0;
    uint32_t b[4];
    philox4x32_10(ctr0 + (uint32_t)i, (uint32_t)step, (uint32_t)which, c3,
                  seed, 0u, b);
    float u0 = bits_to_uniform(b[0]);
    float u1 = bits_to_uniform(b[1]);
    float t = __fadd_rn(zc1, __fmul_rn(u0, zc2));
    rz[tid] = __fmul_rn(t, t);
    ru[tid] = bits_to_uniform(b[2]);
    int pidx = (int)__fmul_rn(u1, (float)n_fixed);
    pidx = pidx < n_fixed - 1 ? pidx : n_fixed - 1;
    slot[tid] = i;
    pslot[tid] = pidx;
  }
  __syncthreads();
  for (int idx = tid; idx < WT * MAX_D; idx += blockDim.x) {
    int w = idx / MAX_D, d = idx - w * MAX_D;
    float v = 0.0f;
    if (d < D) {
      float xv = xm[(size_t)slot[w] * D + d];
      float xp = xf[(size_t)pslot[w] * D + d];
      v = __fadd_rn(xp, __fmul_rn(rz[w], __fsub_rn(xv, xp)));
    }
    y[idx] = v;
  }
  __syncthreads();
  joint_ll_tile(c, coff, y, lpy, sm);
  if (tid < WT) {
    int ok = 0;
    if (i0 + tid < n_move) {
      int s = slot[tid];
      float lm = lpm[s];
      float thr = __fadd_rn(__fmul_rn((float)(D - 1), logf(rz[tid])),
                            __fmul_rn(bg, __fsub_rn(lpy[tid], lm)));
      ok = logf(ru[tid]) < thr;
      if (ok) {
        lpm[s] = lpy[tid];
        accm[s] = accm[s] + 1.0f;
      }
    }
    accf[tid] = ok;
  }
  __syncthreads();
  for (int idx = tid; idx < WT * D; idx += blockDim.x) {
    int w = idx / D, d = idx - w * D;
    if (accf[w]) xm[(size_t)slot[w] * D + d] = y[w * MAX_D + d];
  }
}

__global__ void stretch_half_kernel(float* __restrict__ x,
                                    float* __restrict__ lp,
                                    float* __restrict__ acc,
                                    const float* __restrict__ beta, int W,
                                    int which, uint32_t seed, int step,
                                    float zc1, float zc2, int per_cluster,
                                    size_t cstride, LLConsts c) {
  extern __shared__ float smem[];
  const int H = W / 2, g = blockIdx.y;
  const size_t mv = (size_t)g * W + (size_t)which * H;
  const size_t fx = (size_t)g * W + (size_t)(1 - which) * H;
  stretch_half_tile(x + mv * c.D, lp + mv, acc + mv, x + fx * c.D, H, H,
                    per_cluster ? 0u : (uint32_t)(g * H),
                    per_cluster ? (uint32_t)g : 0u, which, seed, step, zc1,
                    zc2, beta ? beta[g] : 1.0f,
                    per_cluster ? (size_t)g * cstride : 0, c, smem);
}

// Kernel 6: one half-step of ONE ensemble of 2 H walkers for this shard's
// H_loc rows of the moving half (xu, lpu, accu: a buffer of its own)
// against the whole fixed half xf (H rows, a gathered copy).  Row i of the
// shard is row row_off + i of the half and draws at that counter, so the
// shards together draw exactly the bits stretch_half_kernel draws for the
// whole ensemble at G = 1.
__global__ void coupled_half_kernel(float* __restrict__ xu,
                                    float* __restrict__ lpu,
                                    float* __restrict__ accu,
                                    const float* __restrict__ xf, int H_loc,
                                    int H, int row_off, int which,
                                    uint32_t seed, int step, float zc1,
                                    float zc2, LLConsts c) {
  extern __shared__ float smem[];
  stretch_half_tile(xu, lpu, accu, xf, H_loc, H, (uint32_t)row_off, 0u,
                    which, seed, step, zc1, zc2, 1.0f, 0, c, smem);
}

__global__ void swap_kernel(float* __restrict__ x, float* __restrict__ lp,
                            int* __restrict__ sacc, int W, int D, int kk,
                            uint32_t seed, int step, int shift, float db) {
  const int H = W / 2;
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= 2 * H) return;
  int hb = t / H, j = t - hb * H;
  int jh = j - shift;
  if (jh < 0) jh += H;
  int cs = kk * W + hb * H + j;
  int hs = (kk + 1) * W + hb * H + jh;
  uint32_t b[4];
  philox4x32_10((uint32_t)j, (uint32_t)step, (uint32_t)(16 + 2 * kk + hb),
                0u, seed, 0u, b);
  float u = bits_to_uniform(b[0]);
  float lc = lp[cs], lh = lp[hs];
  if (logf(u) < __fmul_rn(db, __fsub_rn(lh, lc))) {
    for (int d = 0; d < D; ++d) {
      float v = x[(size_t)cs * D + d];
      x[(size_t)cs * D + d] = x[(size_t)hs * D + d];
      x[(size_t)hs * D + d] = v;
    }
    lp[cs] = lh;
    lp[hs] = lc;
    atomicAdd(sacc + kk, 1);
  }
}

static size_t half_smem_bytes(const LLConsts& c) {
  return (TILE_WALKERS * MAX_D + 3 * TILE_WALKERS + 3 * TILE_WALKERS
          + tile_smem_floats(c)) * sizeof(float);
}

// G groups of W walkers: K rungs (per_cluster == 0, beta (K,), one set of
// constants) or C clusters (per_cluster != 0, beta null, cluster g's
// constants at buf + g * cstride floats).
extern "C" int launch_stretch_half(float* x, float* lp, float* acc,
                                   const float* beta, int G, int W,
                                   int which, unsigned int seed, int step,
                                   float zc1, float zc2, int per_cluster,
                                   long long cstride, const float* buf,
                                   const int* iv, const float* fv,
                                   void* stream) {
  LLConsts c = make_consts(buf, iv, fv);
  size_t smem = half_smem_bytes(c);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(stretch_half_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  dim3 grid((W / 2 + TILE_WALKERS - 1) / TILE_WALKERS, G);
  stretch_half_kernel<<<grid, JT_THREADS, smem, (cudaStream_t)stream>>>(
      x, lp, acc, beta, W, which, seed, step, zc1, zc2, per_cluster,
      (size_t)cstride, c);
  return (int)cudaGetLastError();
}

// The moving block (H_loc rows) and the fixed half (H rows) are separate
// buffers; row_off is the block's first row within the half.
extern "C" int launch_coupled_half(float* xu, float* lpu, float* accu,
                                   const float* xf, int H_loc, int H,
                                   int row_off, int which, unsigned int seed,
                                   int step, float zc1, float zc2,
                                   const float* buf, const int* iv,
                                   const float* fv, void* stream) {
  LLConsts c = make_consts(buf, iv, fv);
  size_t smem = half_smem_bytes(c);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(coupled_half_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  int grid = (H_loc + TILE_WALKERS - 1) / TILE_WALKERS;
  coupled_half_kernel<<<grid, JT_THREADS, smem, (cudaStream_t)stream>>>(
      xu, lpu, accu, xf, H_loc, H, row_off, which, seed, step, zc1, zc2, c);
  return (int)cudaGetLastError();
}

extern "C" int launch_swap(float* x, float* lp, int* sacc, int W, int D,
                           int kk, unsigned int seed, int step, int shift,
                           float db, void* stream) {
  int n = W;   // 2 halves x H pairs
  swap_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      x, lp, sacc, W, D, kk, seed, step, shift, db);
  return (int)cudaGetLastError();
}
