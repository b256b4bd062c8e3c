// Fused SZ-likelihood core: pp (B, n_press), t_all (B, n_pix), calibration
// (B,) f32 -> -chi^2/2 (B,) f32.  Replaces joxsz_tpu/ops/pallas_kernels.py::
// make_sz_core (pallas_call over walker tiles of pp @ L^T -> T-dependent
// y->mJy lerp x calibration -> @ G^T -> -1/2 sum(((flux - model) w)^2)).
// One block of JT_THREADS threads per tile of TILE_WALKERS walkers: the
// tile's pp and t_all rows are staged in shared memory, then the block runs
// sz_chain_tile, the device function the joint-likelihood kernel runs for
// the same chain (FP32 FMAs, no tensor cores).  L^T and G^T stay in global
// memory and are read through L1/L2 once per tile.  Rows past B in the last
// tile repeat the tile's first row and are not written.  A NaN input gives
// a NaN output.
#include "joint_ll.cuh"

__global__ void sz_core_kernel(const float* __restrict__ pp,
                               const float* __restrict__ tall,
                               const float* __restrict__ cal, int B,
                               float* __restrict__ out, LLConsts c) {
  extern __shared__ float smem[];
  const int WT = TILE_WALKERS, NP = c.n_press, PIX = c.n_pix;
  float* press = smem;                 // WT x NP
  float* ts = press + WT * NP;         // WT x PIX
  float* prof = ts + WT * PIX;         // WT x PIX
  float* cals = prof + WT * PIX;       // WT
  float* chi = cals + WT;              // WT
  float* red = chi + WT;               // JT_WARPS x WT
  const int row0 = blockIdx.x * WT;
  for (int idx = threadIdx.x; idx < WT * NP; idx += blockDim.x) {
    int w = idx / NP, k = idx - w * NP;
    int row = row0 + w < B ? row0 + w : row0;
    press[idx] = pp[(size_t)row * NP + k];
  }
  for (int idx = threadIdx.x; idx < WT * PIX; idx += blockDim.x) {
    int w = idx / PIX, p = idx - w * PIX;
    int row = row0 + w < B ? row0 + w : row0;
    ts[idx] = tall[(size_t)row * PIX + p];
  }
  if (threadIdx.x < WT) {
    int row = row0 + threadIdx.x < B ? row0 + threadIdx.x : row0;
    cals[threadIdx.x] = cal[row];
  }
  __syncthreads();
  sz_chain_tile(c, 0, press, ts, PIX, ts + 1, PIX, cals, 1, prof, red, chi, 1);
  if (threadIdx.x < WT && row0 + threadIdx.x < B)
    out[row0 + threadIdx.x] = -0.5f * chi[threadIdx.x];
}

extern "C" int launch_sz_core(const float* pp, const float* tall,
                              const float* cal, int B, float* out,
                              const float* buf, const int* iv,
                              const float* fv, void* stream) {
  LLConsts c = make_consts(buf, iv, fv);
  size_t smem = (size_t)(TILE_WALKERS * (c.n_press + 2 * c.n_pix + 2)
                         + JT_WARPS * TILE_WALKERS) * sizeof(float);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(sz_core_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  int grid = (B + TILE_WALKERS - 1) / TILE_WALKERS;
  sz_core_kernel<<<grid, JT_THREADS, smem, (cudaStream_t)stream>>>(
      pp, tall, cal, B, out, c);
  return (int)cudaGetLastError();
}
