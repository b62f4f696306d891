// Masked L2 gradient norms, one per (cluster, task) row (paper eq. 6).
//
// Replaces the TPU kernel masked_gradnorm_pallas
// (src/repro/kernels/masked_gradnorm/kernel.py, body _gradnorm_kernel),
// which the simulator vmaps over the clusters. Here one launch covers all
// C*T rows, each against its cluster's mask row:
//   out[c, t] = sqrt( sum_p (g[c, t, p] * mask[c, p])^2 )
//
// Bound: device memory. Each row's P gradient words are read once, each
// mask row once per task (from L2 after the first), about 17 MB for the
// paper round (C=10, T=3, P=131328): a few microseconds at 3.35 TB/s, so a
// launch costs more than the bytes. Design: one block per row strides over
// P with coalesced loads and accumulates in float32 registers, then reduces
// with warp shuffles and one shared-memory pass before the square root. No
// atomics: the summation order is fixed, so the result is deterministic.
// With only C*T blocks the card is far from full; splitting rows over more
// blocks needs a second pass and is left for a later change.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void masked_gradnorm_kernel(const float* __restrict__ g,
                                       const float* __restrict__ mask,
                                       float* __restrict__ out, int64_t P,
                                       int n_tasks) {
  const int row = blockIdx.x;
  const int c = row / n_tasks;
  const float* gr = g + (int64_t)row * P;
  const float* mr = mask + (int64_t)c * P;
  float acc = 0.0f;
  for (int64_t k = threadIdx.x; k < P; k += blockDim.x) {
    const float v = gr[k] * mr[k];
    acc += v * v;
  }
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  }
  __shared__ float warp_sums[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < (int)(blockDim.x >> 5) ? warp_sums[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1) {
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    }
    if (lane == 0) out[row] = sqrtf(acc);
  }
}

}  // namespace

extern "C" int masked_gradnorm_f32(const float* g, const float* mask,
                                   float* out, int64_t P, int n_clusters,
                                   int n_tasks, int block,
                                   cudaStream_t stream) {
  masked_gradnorm_kernel<<<n_clusters * n_tasks, block, 0, stream>>>(
      g, mask, out, P, n_tasks);
  return (int)cudaGetLastError();
}
