// Slab OTA estimator from supplied stream words (paper eqs. 7-10): K3.
//
// Replaces the TPU kernel ota_aggregate_pallas
// (src/repro/kernels/ota_channel/kernel.py, body _ota_aggregate_kernel), and
// the compiled supplied-bits branch of ota_aggregate_fused_pallas, which calls
// it section by section.
//
// Input: the (C, n) weighted gradients wg_l = sum_n p[l,n] g[l,n] (rows at a
// caller-given stride, so a section's columns of the (C, P) packed slab are
// read in place), the (C, >= n) gain words (int32 bit patterns, rows at their
// own stride), the (n,) noise words, the params row [sigma2_0 .. sigma2_{C-1},
// H_th, noise_std, ota_on] and the per-cluster p_pass = erfc(sqrt(H_th /
// 2 sigma2_l)), computed by the caller with the same torch call as the plain
// version. Per entry, ota_estimate.cuh: masked sum over the clusters in order,
// Box-Muller AWGN, the guarded |M| * N estimate. The denominator is the static
// |M| * N, as in the reference kernel (no live mask, no N_eff).
//
// Bound: device memory. Each entry reads C weighted-gradient words, C gain
// words and one noise word and writes one output word: 4 * (2C + 2) bytes,
// 88 bytes at C = 10, so about 0.35 GB for the paper model's 3,938,304
// entries, 0.10 ms at 3.35 TB/s. The arithmetic (3C + ~30 flops per entry)
// is far below the float32 rate.
// Design: one thread per entry in a grid-stride loop, so every load of wg,
// bits and nbits is coalesced along the entries and each byte moves once; the
// cluster loop runs inside the thread in the reference's order. The params
// row and p_pass stay device data (p_pass staged in shared memory), so the
// launch never waits for the host. Any n runs in one launch: the tail is
// bounds-checked. The (rows, 128) blocking and the row-block picking of the
// TPU kernel are gone.
#include <cstdint>
#include <cuda_runtime.h>

#include "ota_estimate.cuh"

namespace {

__global__ void ota_aggregate_kernel(
    const float* __restrict__ wg,       // (C, >= n), row stride wg_stride
    int64_t wg_stride,
    const int32_t* __restrict__ bits,   // (C, >= n), row stride bits_stride
    int64_t bits_stride,
    const int32_t* __restrict__ nbits,  // (n,)
    const float* __restrict__ params,   // (C + 3,)
    const float* __restrict__ p_pass,   // (C,)
    float* __restrict__ out,            // (n,)
    int64_t n, int n_clusters, int n_clients) {
  extern __shared__ float pp[];
  for (int k = threadIdx.x; k < n_clusters; k += blockDim.x) {
    pp[k] = p_pass[k];
  }
  __syncthreads();
  const float noise_std = params[n_clusters + 1];
  const float ota_on = params[n_clusters + 2];
  const bool off = ota_on < 0.5f;
  const float n_cl = (float)n_clients;

  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += stride) {
    ota::Acc a = ota::acc_init();
    for (int l = 0; l < n_clusters; ++l) {
      ota::acc_add(a, (uint32_t)bits[(int64_t)l * bits_stride + j], pp[l],
                   off, wg[(int64_t)l * wg_stride + j]);
    }
    out[j] = ota::finish(a, (uint32_t)nbits[j], noise_std, ota_on, n_cl);
  }
}

}  // namespace

extern "C" int ota_aggregate_f32(const float* wg, int64_t wg_stride,
                                 const int32_t* bits, int64_t bits_stride,
                                 const int32_t* nbits, const float* params,
                                 const float* p_pass, float* out, int64_t n,
                                 int n_clusters, int n_clients, int grid,
                                 int block, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)n_clusters;
  ota_aggregate_kernel<<<grid, block, smem, stream>>>(
      wg, wg_stride, bits, bits_stride, nbits, params, p_pass, out, n,
      n_clusters, n_clients);
  return (int)cudaGetLastError();
}
