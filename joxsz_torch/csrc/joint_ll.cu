// Kernel 1: batched joint log-posterior, theta (B, D) f32 -> (B,) f32.
// Replaces joxsz_tpu/ops/pallas_joint.py::make_joint_core (pallas_call of
// ll_body over walker tiles).  One block of JT_THREADS threads per tile of
// TILE_WALKERS walkers; rows past B in the last tile repeat the tile's
// first row and are not written.
#include "joint_ll.cuh"

__global__ void joint_ll_kernel(const float* __restrict__ theta, int B,
                                float* __restrict__ out, LLConsts c) {
  extern __shared__ float smem[];
  float* th = smem;                          // TILE_WALKERS x MAX_D
  float* res = th + TILE_WALKERS * MAX_D;    // TILE_WALKERS
  float* sm = res + TILE_WALKERS;
  const int row0 = blockIdx.x * TILE_WALKERS;
  for (int idx = threadIdx.x; idx < TILE_WALKERS * MAX_D; idx += blockDim.x) {
    int w = idx / MAX_D, d = idx - w * MAX_D;
    int row = row0 + w < B ? row0 + w : row0;
    th[idx] = d < c.D ? theta[(size_t)row * c.D + d] : 0.0f;
  }
  __syncthreads();
  joint_ll_tile(c, 0, th, res, sm);
  if (threadIdx.x < TILE_WALKERS && row0 + threadIdx.x < B)
    out[row0 + threadIdx.x] = res[threadIdx.x];
}

extern "C" int launch_joint_ll(const float* theta, int B, float* out,
                               const float* buf, const int* iv,
                               const float* fv, void* stream) {
  LLConsts c = make_consts(buf, iv, fv);
  size_t smem = (TILE_WALKERS * MAX_D + TILE_WALKERS + tile_smem_floats(c))
                * sizeof(float);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(joint_ll_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  int grid = (B + TILE_WALKERS - 1) / TILE_WALKERS;
  joint_ll_kernel<<<grid, JT_THREADS, smem, (cudaStream_t)stream>>>(
      theta, B, out, c);
  return (int)cudaGetLastError();
}
