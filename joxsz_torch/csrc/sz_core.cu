// Fused SZ-likelihood core: pp (B, n_press), t_all (B, n_pix), calibration
// (B,) f32 -> -chi^2/2 (B,) f32.  Replaces joxsz_tpu/ops/pallas_kernels.py::
// make_sz_core (pallas_call over walker tiles of pp @ L^T -> T-dependent
// y->mJy lerp x calibration -> @ G^T -> -1/2 sum(((flux - model) w)^2)).
// A grid of as many blocks as the card holds at once: each stages L^T and
// G^T in shared memory once (cp.async; in place where they do not fit, see
// plan_launch) and walks its contiguous range of tiles of TILE_WALKERS
// walkers, copying the tile's pp (walker fastest) and t_all rows into its
// scratch and running sz_chain_tile, the device function the
// joint-likelihood kernel runs for the same chain (FP32 FMAs, no tensor
// cores).  Rows past B in the last tile repeat the tile's first row and are
// not written.  A NaN input gives a NaN output.
#include "joint_ll.cuh"

template <bool FIT>
__device__ __forceinline__ void sz_core_body(
    const float* __restrict__ pp, const float* __restrict__ tall,
    const float* __restrict__ cal, int B, float* __restrict__ out,
    const LLConsts& c, float* smem) {
  const int WT = TILE_WALKERS, NP = c.n_press, PIX = c.n_pix;
  const float* st = use_consts<FIT>(c, 0, smem);
  float* pressT = tile_scratch<FIT>(c, smem + (c.stage ? c.n_buf : 0));
  float* ts = pressT + r4(WT * NP);                  // WT x PIX
  float* prof = ts + r4(WT * PIX);                   // WT x pix_stride
  float* red = prof + WT * pix_stride(PIX);    // KSPLIT / 2 x WT x PIX_PASS
  float* res = red + KSPLIT / 2 * WT * PIX_PASS;     // WT x r4(n_data)
  float* cals = res + WT * r4(c.n_data);             // WT
  float* chi = cals + WT;                            // WT
  int t0, t1;
  block_tiles((B + WT - 1) / WT, &t0, &t1);
  for (int t = t0; t < t1; ++t) {
    const int row0 = t * WT;
    for (int idx = threadIdx.x; idx < WT * NP; idx += blockDim.x) {
      int k = idx / WT, w = idx - k * WT;
      int row = row0 + w < B ? row0 + w : row0;
      pressT[idx] = pp[(size_t)row * NP + k];
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
    sz_chain_tile(c, st, pressT, ts, PIX, ts + 1, PIX, cals, 1, prof, red, res,
                  chi, 1);
    if (threadIdx.x < WT && row0 + threadIdx.x < B)
      out[row0 + threadIdx.x] = -0.5f * chi[threadIdx.x];
  }
}

__global__ void __launch_bounds__(JT_THREADS, 1)
sz_core_kernel(const float* __restrict__ pp, const float* __restrict__ tall,
               const float* __restrict__ cal, int B,
               float* __restrict__ out, LLConsts c) {
  extern __shared__ __align__(16) float smem[];
  sz_core_body<true>(pp, tall, cal, B, out, c, smem);
}

__global__ void __launch_bounds__(JT_THREADS, 1)
sz_core_large_kernel(const float* __restrict__ pp,
                     const float* __restrict__ tall,
                     const float* __restrict__ cal, int B,
                     float* __restrict__ out, LLConsts c) {
  extern __shared__ __align__(16) float smem[];
  sz_core_body<false>(pp, tall, cal, B, out, c, smem);
}

extern "C" int launch_sz_core(const float* pp, const float* tall,
                              const float* cal, int B, float* out,
                              const float* buf, const int* iv,
                              const float* fv, void* stream,
                              int* picked) {
  LLConsts c = make_consts(buf, iv, fv);
  if (!tile_fits(c)) return (int)cudaErrorInvalidValue;
  const int WT = TILE_WALKERS;
  // pressT, ts, prof, red, res, cals, chi
  const size_t scratch = r4(WT * c.n_press) + r4(WT * c.n_pix)
                         + WT * pix_stride(c.n_pix)
                         + KSPLIT / 2 * WT * PIX_PASS + WT * r4(c.n_data)
                         + 2 * WT;
  size_t smem = 0, ws = 0;
  int err = plan_launch(&c, 0, scratch, &smem, &ws);
  auto kernel = c.stage && !ws ? sz_core_kernel : sz_core_large_kernel;
  *picked = !(c.stage && !ws);     // the instance launched: 1 for _large_
  int blocks = 0;
  if (!err) err = resident_blocks(kernel, smem, (B + WT - 1) / WT, &blocks);
  if (!err) err = take_workspace(&c, blocks, ws, (cudaStream_t)stream);
  if (err) return err;
  kernel<<<blocks, JT_THREADS, smem, (cudaStream_t)stream>>>(pp, tall, cal, B,
                                                              out, c);
  return release_workspace(c, (cudaStream_t)stream);
}
