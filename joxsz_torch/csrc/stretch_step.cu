// Kernels 2, 3 and 4: the stretch-move samplers, one launch per half-step
// and one per swap boundary.
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
// Kernel 3 (swap_kernel) replaces the swap sweep of
// make_tempered_step_kernel (pallas_joint.py:2383-2432) for one boundary
// kk: cold slot j of each half pairs with hot slot (j - shift) mod H (the
// rotation pairing), accepts by log u < (beta_kk - beta_kk+1)(lp_h - lp_c)
// on untempered lp, and exchanges the rows and lp; accept counts stay with
// the slot (they are a separate tensor).  sacc[kk] counts accepted swaps.
//
// State layout: x (G, W, D), lp (G, W), acc (G, W), group-major, float32.
// The decision arithmetic uses __f*_rn so it is never contracted into an
// FMA and rounds exactly as the plain torch version does.
#include "joint_ll.cuh"

__global__ void stretch_half_kernel(float* __restrict__ x,
                                    float* __restrict__ lp,
                                    float* __restrict__ acc,
                                    const float* __restrict__ beta, int W,
                                    int which, uint32_t seed, int step,
                                    float zc1, float zc2, int per_cluster,
                                    size_t cstride, LLConsts c) {
  extern __shared__ float smem[];
  const int WT = TILE_WALKERS;
  float* y = smem;                         // WT x MAX_D proposals
  float* lpy = y + WT * MAX_D;             // WT
  float* rz = lpy + WT;                    // WT stretch factors
  float* ru = rz + WT;                     // WT accept uniforms
  int* slot = (int*)(ru + WT);             // WT moving slots
  int* pslot = slot + WT;                  // WT partner slots
  int* accf = pslot + WT;                  // WT accept flags
  float* sm = (float*)(accf + WT);
  const int H = W / 2, D = c.D, tid = threadIdx.x;
  const int g = blockIdx.y, i0 = blockIdx.x * WT;
  const size_t coff = per_cluster ? (size_t)g * cstride : 0;
  const float bg = beta ? beta[g] : 1.0f;
  if (tid < WT) {
    int i = i0 + tid < H ? i0 + tid : i0;
    uint32_t b[4];
    if (per_cluster)
      philox4x32_10((uint32_t)i, (uint32_t)step, (uint32_t)which,
                    (uint32_t)g, seed, 0u, b);
    else
      philox4x32_10((uint32_t)(g * H + i), (uint32_t)step, (uint32_t)which,
                    0u, seed, 0u, b);
    float u0 = bits_to_uniform(b[0]);
    float u1 = bits_to_uniform(b[1]);
    float t = __fadd_rn(zc1, __fmul_rn(u0, zc2));
    rz[tid] = __fmul_rn(t, t);
    ru[tid] = bits_to_uniform(b[2]);
    int pidx = (int)__fmul_rn(u1, (float)H);
    pidx = pidx < H - 1 ? pidx : H - 1;
    slot[tid] = g * W + which * H + i;
    pslot[tid] = g * W + (1 - which) * H + pidx;
  }
  __syncthreads();
  for (int idx = tid; idx < WT * MAX_D; idx += blockDim.x) {
    int w = idx / MAX_D, d = idx - w * MAX_D;
    float v = 0.0f;
    if (d < D) {
      float xm = x[(size_t)slot[w] * D + d];
      float xp = x[(size_t)pslot[w] * D + d];
      v = __fadd_rn(xp, __fmul_rn(rz[w], __fsub_rn(xm, xp)));
    }
    y[idx] = v;
  }
  __syncthreads();
  joint_ll_tile(c, coff, y, lpy, sm);
  if (tid < WT) {
    int ok = 0;
    if (i0 + tid < H) {
      int s = slot[tid];
      float lm = lp[s];
      float thr = __fadd_rn(__fmul_rn((float)(D - 1), logf(rz[tid])),
                            __fmul_rn(bg, __fsub_rn(lpy[tid], lm)));
      ok = logf(ru[tid]) < thr;
      if (ok) {
        lp[s] = lpy[tid];
        acc[s] = acc[s] + 1.0f;
      }
    }
    accf[tid] = ok;
  }
  __syncthreads();
  for (int idx = tid; idx < WT * D; idx += blockDim.x) {
    int w = idx / D, d = idx - w * D;
    if (accf[w]) x[(size_t)slot[w] * D + d] = y[w * MAX_D + d];
  }
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
  size_t smem = (TILE_WALKERS * MAX_D + 3 * TILE_WALKERS
                 + 3 * TILE_WALKERS + tile_smem_floats(c)) * sizeof(float);
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

extern "C" int launch_swap(float* x, float* lp, int* sacc, int W, int D,
                           int kk, unsigned int seed, int step, int shift,
                           float db, void* stream) {
  int n = W;   // 2 halves x H pairs
  swap_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      x, lp, sacc, W, D, kk, seed, step, shift, db);
  return (int)cudaGetLastError();
}
