// Kernel 1: batched joint log-posterior, theta (B, D) f32 -> (B,) f32.
// Replaces joxsz_tpu/ops/pallas_joint.py::make_joint_core (pallas_call of
// ll_body over walker tiles).  A grid of as many blocks as the card holds
// at once, each taking the constants once (staged in shared memory where
// they fit, see plan_launch) and walking its contiguous range of tiles of
// TILE_WALKERS walkers; rows past B in the last tile repeat the tile's
// first row and are not written.
#include "joint_ll.cuh"

template <bool FIT, bool FAM>
__device__ __forceinline__ void joint_ll_body(const float* __restrict__ theta,
                                              int B, float* __restrict__ out,
                                              const LLConsts& c,
                                              float* smem) {
  const int WT = TILE_WALKERS;
  float* th = smem + (c.stage ? c.n_buf : 0);      // WT x MAX_D
  float* res = th + WT * MAX_D;                     // WT
  float* sm = res + WT;                             // the tile's scratch
  const float* st = use_consts<FIT>(c, 0, smem);
  int t0, t1;
  block_tiles((B + WT - 1) / WT, &t0, &t1);
  for (int t = t0; t < t1; ++t) {
    const int row0 = t * WT;
    for (int idx = threadIdx.x; idx < WT * MAX_D; idx += blockDim.x) {
      int w = idx / MAX_D, d = idx - w * MAX_D;
      int row = row0 + w < B ? row0 + w : row0;
      th[idx] = d < c.D ? theta[(size_t)row * c.D + d] : 0.0f;
    }
    __syncthreads();
    joint_ll_tile<FIT, FAM>(c, st, th, res, sm);
    if (threadIdx.x < WT && row0 + threadIdx.x < B)
      out[row0 + threadIdx.x] = res[threadIdx.x];
  }
}

// the flagship (FAM = false) and every family (_fam_), each where the plan
// fits and in its _large_ twin
#define JOINT_LL_KERNEL(name, FIT, FAM)                                     \
  __global__ void __launch_bounds__(JT_THREADS, 1)                          \
  name(const float* __restrict__ theta, int B, float* __restrict__ out,     \
       LLConsts c) {                                                        \
    extern __shared__ __align__(16) float smem[];                           \
    joint_ll_body<FIT, FAM>(theta, B, out, c, smem);                        \
  }
JOINT_LL_KERNEL(joint_ll_kernel, true, false)
JOINT_LL_KERNEL(joint_ll_large_kernel, false, false)
JOINT_LL_KERNEL(joint_ll_fam_kernel, true, true)
JOINT_LL_KERNEL(joint_ll_fam_large_kernel, false, true)

typedef void (*LLKernel)(const float*, int, float*, LLConsts);
static const LLKernel LL_KERNELS[2][2] = {
    {joint_ll_kernel, joint_ll_large_kernel},
    {joint_ll_fam_kernel, joint_ll_fam_large_kernel}};

extern "C" int launch_joint_ll(const float* theta, int B, float* out,
                               const float* buf, const int* iv,
                               const float* fv, void* stream) {
  LLConsts c = make_consts(buf, iv, fv);
  if (!tile_fits(c)) return (int)cudaErrorInvalidValue;
  size_t smem = 0, ws = 0;
  int err = plan_launch(&c, TILE_WALKERS * (MAX_D + 1), tile_layout(c).total,
                        &smem, &ws);
  auto kernel = pick_kernel(c, ws, LL_KERNELS);
  int blocks = 0;
  if (!err)
    err = resident_blocks(kernel, smem,
                          (B + TILE_WALKERS - 1) / TILE_WALKERS, &blocks);
  if (!err) err = take_workspace(&c, blocks, ws, (cudaStream_t)stream);
  if (err) return err;
  kernel<<<blocks, JT_THREADS, smem, (cudaStream_t)stream>>>(theta, B, out,
                                                              c);
  return release_workspace(c, (cudaStream_t)stream);
}
