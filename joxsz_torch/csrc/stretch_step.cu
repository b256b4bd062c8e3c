// The stretch-move samplers: the step kernel (n_steps full steps in one
// cooperative launch) and kernel 6 (one half-step of one shard's block).
//
// stretch_steps_kernel runs what three TPU kernels of
// joxsz_tpu/ops/pallas_joint.py run in one call, n_inner full steps:
// make_step_kernel (G = 1 group, the plain sampler), make_tempered_step_
// kernel (G = K rungs that share one set of constants and differ in beta)
// and make_multicluster_step_kernel (G = C clusters with beta = 1 that
// differ in their constants, per_cluster != 0).  Each step is
//   half 0 | barrier | half 1 | barrier | [boundary kk | barrier] x (K-1)
// on a persistent grid: as many blocks as the card holds at once, each
// walking a contiguous range of the moving half's tiles (G x ceil(H / WT))
// and keeping the constants staged in shared memory across all steps
// where they fit (a block of the cluster grid restages when its range
// crosses into another cluster; see plan_launch for the larger shapes).
// The grid barrier is a counter in device memory that every block's
// thread 0 increments and then waits on; the cooperative
// launch guarantees that all blocks are resident, and it fails (the
// wrapper raises) when they cannot be.
//
// A half-step tile: every walker of the moving half draws Philox bits,
// takes the stretch factor z (_stretch_z), a uniform partner in its own
// group's other half (the one-hot law), proposes y = x_p + z (x - x_p),
// evaluates the joint log-posterior through the shared joint_ll_tile, and
// accepts by _gw_accept: log u < (D-1) log z + beta (lp_y - lp).  Philox is
// keyed on (seed, 0) with counter (g*H + i, step, half, 0) for rungs and
// (i, step, half, cluster) for clusters, so a cluster's stream does not
// depend on how many clusters there are.
//
// The swap sweep (pallas_joint.py:2383-2432) runs after half 1 on the
// whole grid, boundaries kk = 0 .. K-2 in order with a barrier after each
// (boundary kk + 1 reads rung kk + 1, which kk may have changed), each
// block a share of the pairs: cold slot j of each half pairs with
// hot slot (j - shift) mod H, shift = rotation_shift(seed, step, kk, H)
// computed here in int32 as sampling/tempered.py does it; a pair draws at
// counter (j, step, 16 + 2 kk + half, 0), accepts by log u < (beta_kk -
// beta_kk+1)(lp_h - lp_c) on untempered lp, and exchanges the rows and lp;
// accept counts stay with the slot.  sacc[kk] counts accepted swaps.
//
// Frames: with thin > 0, after every thin-th step the kernel writes the
// cold rung (rungs; after the swap sweep, each block a share of the rows,
// then a barrier) or every cluster (cluster grid; each tile its own rows)
// into chain (Gs, n_steps / thin, W,
// D) and chain_lp (Gs, n_steps / thin, W), Gs = 1 for rungs and C for
// clusters.  Steps are numbered step0 .. step0 + n_steps - 1 within the
// Philox seed's chunk, so a range of one step is the per-step entry the
// identity checks use.
//
// coupled_half_kernel (kernel 6) replaces make_coupled_half_kernel: one
// half-step for one shard's block of the moving half, held in a buffer of
// its own, against a gathered copy of the whole fixed half.  Its draws are
// addressed by the row's place in the whole half, counter (row_off + i,
// step, half, 0), and joint_ll_tile does not depend on a walker's slot in
// its tile, so any split of the half over shards gives, bit for bit, what
// the step kernel gives for the whole ensemble at G = 1.  Both kernels run
// one piece of device code per tile, stretch_half_tile.
//
// What bounds them on the card: the likelihood of the moving rows (~84 k
// FP32 operations a walker); the step kernel also pays 2 + (K-1) grid
// barriers a step.
//
// State layout: x (G, W, D), lp (G, W), acc (G, W), group-major, float32;
// kernel 6: xu (H_loc, D), lpu/accu (H_loc,), xf (H, D).
// The decision arithmetic uses __f*_rn so it is never contracted into an
// FMA and rounds exactly as the plain torch version does.
#include "joint_ll.cuh"

// shared floats of a half-step tile besides joint_ll_tile's
#define HALF_EXTRA (TILE_WALKERS * MAX_D + 6 * TILE_WALKERS + 4)
// parameters a swap moves through registers at a time
#define SWAP_CHUNK 16

// One tile of a half-step: rows i0 .. i0 + TILE_WALKERS of a moving block
// of n_move rows (xm, lpm, accm) against a fixed half of n_fixed rows (xf).
// Moving row i draws Philox at counter (ctr0 + i, step, which, c3).  The
// tail guard uses n_move for the moving rows and n_fixed for the partner
// clamp.  x and xf are plain pointers, never __restrict__: in the step
// kernel other blocks write them between barriers, and a read-only (.nc)
// load would not see that.  With fx non-null the tile then copies its
// rows' new x and lp to fx / flp (a frame).  st: the staged constants of
// the tile's group; smem: HALF_EXTRA floats, then tile_layout(c).total
// floats of scratch unless the plan put that in the global workspace.
template <bool FIT, bool FAM>
__device__ __forceinline__ void stretch_half_tile(
    float* xm, float* lpm, float* accm, const float* xf, int n_move,
    int n_fixed, int i0, uint32_t ctr0, uint32_t c3, int which,
    uint32_t seed, int step, float zc1, float zc2, float bg,
    const LLConsts& c, const float* st, float* smem, float* fx, float* flp) {
  const int WT = TILE_WALKERS;
  float* y = smem;                         // WT x MAX_D proposals
  float* lpy = y + WT * MAX_D;             // WT
  float* rz = lpy + WT;                    // WT stretch factors
  float* ru = rz + WT;                     // WT accept uniforms
  int* slot = (int*)(ru + WT);             // WT moving rows
  int* pslot = slot + WT;                  // WT partner rows
  int* accf = pslot + WT;                  // WT accept flags
  float* sm = smem + HALF_EXTRA;
  const int D = c.D, tid = threadIdx.x;
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
  joint_ll_tile<FIT, FAM>(c, st, y, lpy, sm);
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
      if (flp) flp[s] = ok ? lpy[tid] : lm;
    }
    accf[tid] = ok;
  }
  __syncthreads();
  for (int idx = tid; idx < WT * D; idx += blockDim.x) {
    int w = idx / D, d = idx - w * D;
    if (i0 + w < n_move) {
      size_t at = (size_t)slot[w] * D + d;
      if (accf[w]) xm[at] = y[w * MAX_D + d];
      if (fx) fx[at] = accf[w] ? y[w * MAX_D + d] : xm[at];
    }
  }
  __syncthreads();
}

// Swap-pairing shift of boundary kk at step: the int32 expression of
// pallas_joint.py:2386-2388 (wrapping multiply, arithmetic >> 8, floor-mod
// by H), as sampling/tempered.py::rotation_shift computes it.
__device__ inline int rotation_shift(uint32_t seed, int step, int kk, int H) {
  uint32_t v = seed * 1103515245u + (uint32_t)step * 40503u
               + (uint32_t)kk * 10007u;
  int s = ((int)v) >> 8;
  int m = s % H;
  return m < 0 ? m + H : m;
}

struct StepArgs {
  float* x;
  float* lp;
  float* acc;
  int* sacc;               // (G - 1,) accepted swaps; rungs only
  const float* beta;       // (G,) rung betas; null on the cluster grid
  const float* db;         // (G - 1,) beta_kk - beta_kk+1; rungs only
  float* chain;            // frames, or null
  float* chain_lp;
  unsigned int* bar;       // grid barrier counter, 0 at launch
  size_t cstride;
  int G, W, step0, n_steps, thin, per_cluster;
  uint32_t seed;
  float zc1, zc2;
};

__device__ __forceinline__ void grid_barrier(unsigned int* bar,
                                             unsigned int& target) {
  target += gridDim.x;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
    while (*(volatile unsigned int*)bar < target) __nanosleep(32);
    __threadfence();
  }
  __syncthreads();
}

// Boundary kk of the swap sweep of step i for this block's share of the
// 2 H pairs (the grid splits them evenly; boundaries run in order with a
// grid barrier between them).  cnt: one int of shared memory.
__device__ void swap_boundary(const StepArgs& a, int D, int i, int kk,
                              int* cnt) {
  const int H = a.W / 2, tid = threadIdx.x;
  const int shift = rotation_shift(a.seed, i, kk, H);
  const float db = a.db[kk];
  int p0, p1;
  block_tiles(2 * H, &p0, &p1);
  if (tid == 0) *cnt = 0;
  __syncthreads();
  int n = 0;
  for (int t = p0 + tid; t < p1; t += blockDim.x) {
    const int hb = t / H, j = t - hb * H;
    int jh = j - shift;
    if (jh < 0) jh += H;
    const size_t cs = (size_t)kk * a.W + hb * H + j;
    const size_t hs = (size_t)(kk + 1) * a.W + hb * H + jh;
    uint32_t b[4];
    philox4x32_10((uint32_t)j, (uint32_t)i, (uint32_t)(16 + 2 * kk + hb),
                  0u, a.seed, 0u, b);
    const float u = bits_to_uniform(b[0]);
    const float lc = a.lp[cs], lh = a.lp[hs];
    if (logf(u) < __fmul_rn(db, __fsub_rn(lh, lc))) {
      // both rows into registers first, SWAP_CHUNK values at a time: a
      // round trip per chunk, not per value
      for (int d0 = 0; d0 < D; d0 += SWAP_CHUNK) {
        float rc[SWAP_CHUNK], rh[SWAP_CHUNK];
#pragma unroll
        for (int q = 0; q < SWAP_CHUNK; ++q)
          if (d0 + q < D) {
            rc[q] = a.x[cs * D + d0 + q];
            rh[q] = a.x[hs * D + d0 + q];
          }
#pragma unroll
        for (int q = 0; q < SWAP_CHUNK; ++q)
          if (d0 + q < D) {
            a.x[cs * D + d0 + q] = rh[q];
            a.x[hs * D + d0 + q] = rc[q];
          }
      }
      a.lp[cs] = lh;
      a.lp[hs] = lc;
      ++n;
    }
  }
  if (n) atomicAdd(cnt, n);
  __syncthreads();
  if (tid == 0 && *cnt) atomicAdd(a.sacc + kk, *cnt);
}

template <bool FIT, bool FAM>
__device__ __forceinline__ void stretch_steps_body(const StepArgs& a,
                                                   const LLConsts& c,
                                                   float* smem) {
  const int WT = TILE_WALKERS, D = c.D, H = a.W / 2;
  int* cnt = (int*)(smem + (c.stage ? c.n_buf : 0));   // 4 floats
  float* sm = (float*)cnt + 4;            // HALF_EXTRA, then the scratch
  const float* st = smem;                 // set by use_consts per group
  const int tiles_g = (H + WT - 1) / WT;
  int t0, t1;
  block_tiles(a.G * tiles_g, &t0, &t1);
  const int swaps = a.per_cluster ? 0 : a.G - 1;
  const int n_keep = a.thin > 0 ? a.n_steps / a.thin : 0;
  long long staged = -1;
  unsigned int target = 0;
  for (int i = a.step0; i < a.step0 + a.n_steps; ++i) {
    const int n_done = i - a.step0 + 1;
    const int f = (a.thin > 0 && n_done % a.thin == 0) ? n_done / a.thin - 1
                                                        : -1;
    for (int which = 0; which < 2; ++which) {
      for (int t = t0; t < t1; ++t) {
        const int g = t / tiles_g, tile = t - g * tiles_g;
        const size_t coff = a.per_cluster ? (size_t)g * a.cstride : 0;
        if ((long long)coff != staged) {
          __syncthreads();
          st = use_consts<FIT>(c, coff, smem);
          staged = (long long)coff;
        }
        const size_t mv = (size_t)g * a.W + (size_t)which * H;
        const size_t fx = (size_t)g * a.W + (size_t)(1 - which) * H;
        float* frame = nullptr;
        float* frame_lp = nullptr;
        if (f >= 0 && swaps == 0 && (a.per_cluster || g == 0)) {
          const size_t fr = (size_t)g * n_keep + f;
          frame = a.chain + (fr * a.W + (size_t)which * H) * D;
          frame_lp = a.chain_lp + fr * a.W + (size_t)which * H;
        }
        stretch_half_tile<FIT, FAM>(
            a.x + mv * D, a.lp + mv, a.acc + mv, a.x + fx * D, H, H,
            tile * WT, a.per_cluster ? 0u : (uint32_t)(g * H),
            a.per_cluster ? (uint32_t)g : 0u, which, a.seed, i, a.zc1, a.zc2,
            a.beta ? a.beta[g] : 1.0f, c, st, sm, frame, frame_lp);
      }
      grid_barrier(a.bar, target);
    }
    if (swaps > 0) {
      JT_MARK(14);
      for (int kk = 0; kk < swaps; ++kk) {
        swap_boundary(a, D, i, kk, cnt);
        grid_barrier(a.bar, target);
      }
      JT_MARK(15);
      if (f >= 0) {
        // the cold rung after the sweep, each block its share of the rows
        int r0, r1;
        block_tiles(a.W, &r0, &r1);
        float* fx = a.chain + (size_t)f * a.W * D;
        float* flp = a.chain_lp + (size_t)f * a.W;
        for (int t = r0 * D + threadIdx.x; t < r1 * D; t += blockDim.x)
          fx[t] = a.x[t];
        for (int t = r0 + threadIdx.x; t < r1; t += blockDim.x)
          flp[t] = a.lp[t];
        grid_barrier(a.bar, target);
      }
    }
  }
}

// the flagship (FAM = false) and every family (_fam_), each where the plan
// fits and in its _large_ twin
#define STRETCH_STEPS_KERNEL(name, FIT, FAM)                                \
  __global__ void __launch_bounds__(JT_THREADS, 1)                          \
  name(StepArgs a, LLConsts c) {                                            \
    extern __shared__ __align__(16) float smem[];                           \
    stretch_steps_body<FIT, FAM>(a, c, smem);                               \
  }
STRETCH_STEPS_KERNEL(stretch_steps_kernel, true, false)
STRETCH_STEPS_KERNEL(stretch_steps_large_kernel, false, false)
STRETCH_STEPS_KERNEL(stretch_steps_fam_kernel, true, true)
STRETCH_STEPS_KERNEL(stretch_steps_fam_large_kernel, false, true)

// Kernel 6: one half-step of ONE ensemble of 2 H walkers for this shard's
// H_loc rows of the moving half (xu, lpu, accu: a buffer of its own)
// against the whole fixed half xf (H rows, a gathered copy).  Row i of the
// shard is row row_off + i of the half and draws at that counter, so the
// shards together draw exactly the bits the step kernel draws for the
// whole ensemble at G = 1.
template <bool FIT, bool FAM>
__device__ __forceinline__ void coupled_half_body(
    float* xu, float* lpu, float* accu, const float* xf, int H_loc, int H,
    int row_off, int which, uint32_t seed, int step, float zc1, float zc2,
    const LLConsts& c, float* smem) {
  float* sm = smem + (c.stage ? c.n_buf : 0) + 4;   // as the step kernel's
  const float* st = use_consts<FIT>(c, 0, smem);
  int t0, t1;
  block_tiles((H_loc + TILE_WALKERS - 1) / TILE_WALKERS, &t0, &t1);
  for (int t = t0; t < t1; ++t)
    stretch_half_tile<FIT, FAM>(xu, lpu, accu, xf, H_loc, H,
                                t * TILE_WALKERS, (uint32_t)row_off, 0u,
                                which, seed, step, zc1, zc2, 1.0f, c, st, sm,
                                nullptr, nullptr);
}

#define COUPLED_HALF_KERNEL(name, FIT, FAM)                                 \
  __global__ void __launch_bounds__(JT_THREADS, 1)                          \
  name(float* xu, float* lpu, float* accu, const float* xf, int H_loc,      \
       int H, int row_off, int which, uint32_t seed, int step, float zc1,   \
       float zc2, LLConsts c) {                                             \
    extern __shared__ __align__(16) float smem[];                           \
    coupled_half_body<FIT, FAM>(xu, lpu, accu, xf, H_loc, H, row_off,       \
                                which, seed, step, zc1, zc2, c, smem);      \
  }
COUPLED_HALF_KERNEL(coupled_half_kernel, true, false)
COUPLED_HALF_KERNEL(coupled_half_large_kernel, false, false)
COUPLED_HALF_KERNEL(coupled_half_fam_kernel, true, true)
COUPLED_HALF_KERNEL(coupled_half_fam_large_kernel, false, true)

typedef void (*StepKernel)(StepArgs, LLConsts);
typedef void (*CoupledKernel)(float*, float*, float*, const float*, int, int,
                              int, int, uint32_t, int, float, float,
                              LLConsts);
static const StepKernel STEP_KERNELS[2][2] = {
    {stretch_steps_kernel, stretch_steps_large_kernel},
    {stretch_steps_fam_kernel, stretch_steps_fam_large_kernel}};
static const CoupledKernel COUPLED_KERNELS[2][2] = {
    {coupled_half_kernel, coupled_half_large_kernel},
    {coupled_half_fam_kernel, coupled_half_fam_large_kernel}};

// The launch plan of both kernels: 4 + HALF_EXTRA floats of their own
// (the swap count, the proposals), the tile's scratch.
static int plan_half(LLConsts* c, size_t* smem, size_t* ws) {
  if (!tile_fits(*c)) return (int)cudaErrorInvalidValue;
  return plan_launch(c, 4 + HALF_EXTRA, tile_layout(*c).total, smem, ws);
}

// The step kernel's grid for G groups of W walkers: out[0] blocks, out[1]
// dynamic shared memory in bytes, out[2] 1 when the constants are staged
// in shared memory, out[3] the floats of global scratch per block (0: the
// scratch is in shared memory).
extern "C" int stretch_steps_config(int G, int W, const int* iv,
                                    const float* fv, int* out) {
  static const float none = 0.0f;
  LLConsts c = make_consts(&none, iv, fv);
  size_t smem = 0, ws = 0;
  int err = plan_half(&c, &smem, &ws);
  if (err) return err;
  out[1] = (int)smem;
  out[2] = c.stage;
  out[3] = (int)ws;
  return resident_blocks(pick_kernel(c, ws, STEP_KERNELS), smem,
                         G * ((W / 2 + TILE_WALKERS - 1) / TILE_WALKERS),
                         &out[0]);
}

// G groups of W walkers: K rungs (per_cluster == 0, beta and db on the
// device, one set of constants) or C clusters (per_cluster != 0, beta and
// db null, cluster g's constants at buf + g * cstride floats).  One
// cooperative launch of n_steps full steps; bar: one zeroed unsigned int.
extern "C" int launch_stretch_steps(
    float* x, float* lp, float* acc, int* sacc, const float* beta,
    const float* db, int G, int W, unsigned int seed, int step0, int n_steps,
    int thin, float* chain, float* chain_lp, float zc1, float zc2,
    int per_cluster, long long cstride, unsigned int* bar, const float* buf,
    const int* iv, const float* fv, void* stream) {
  LLConsts c = make_consts(buf, iv, fv);
  int dev = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  size_t smem = 0, ws = 0;
  int err = plan_half(&c, &smem, &ws);
  auto kernel = pick_kernel(c, ws, STEP_KERNELS);
  int blocks = 0;
  if (!err)
    err = resident_blocks(kernel, smem,
                          G * ((W / 2 + TILE_WALKERS - 1) / TILE_WALKERS),
                          &blocks);
  if (!err) err = take_workspace(&c, blocks, ws, (cudaStream_t)stream);
  if (err) return err;
  StepArgs a;
  a.x = x; a.lp = lp; a.acc = acc; a.sacc = sacc; a.beta = beta; a.db = db;
  a.chain = chain; a.chain_lp = chain_lp; a.bar = bar;
  a.cstride = (size_t)cstride;
  a.G = G; a.W = W; a.step0 = step0; a.n_steps = n_steps; a.thin = thin;
  a.per_cluster = per_cluster; a.seed = seed; a.zc1 = zc1; a.zc2 = zc2;
  void* args[] = {&a, &c};
  e = cudaLaunchCooperativeKernel((void*)kernel, dim3(blocks),
                                  dim3(JT_THREADS), args, smem,
                                  (cudaStream_t)stream);
  const int done = release_workspace(c, (cudaStream_t)stream);
  return e != cudaSuccess ? (int)e : done;
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
  size_t smem = 0, ws = 0;
  int err = plan_half(&c, &smem, &ws);
  auto kernel = pick_kernel(c, ws, COUPLED_KERNELS);
  int blocks = 0;
  if (!err)
    err = resident_blocks(kernel, smem,
                          (H_loc + TILE_WALKERS - 1) / TILE_WALKERS, &blocks);
  if (!err) err = take_workspace(&c, blocks, ws, (cudaStream_t)stream);
  if (err) return err;
  kernel<<<blocks, JT_THREADS, smem, (cudaStream_t)stream>>>(
      xu, lpu, accu, xf, H_loc, H, row_off, which, seed, step, zc1, zc2, c);
  return release_workspace(c, (cudaStream_t)stream);
}
