// Per-cluster channel mask and apply on a packed slab (paper eq. 7, the
// gain-threshold law): out = M o x, mask = M.
//
// Replaces the TPU kernel ota_channel_pallas
// (src/repro/kernels/ota_channel/kernel.py, body _ota_channel_kernel).
//
// Per entry j:
//   h    = BoxMuller(bits[j]) * sqrt(sigma2)    (ota::gaussian: the two u16
//                                                halves of the word)
//   M    = h * h >= H_th  or  ota_on < 0.5
//   out  = M ? x[j] : 0,  mask = M ? 1 : 0
// with params = [sigma2, H_th, ota_on], the reference's (1, 3) block. Unlike
// K1 and K3-K6 the mask thresholds the gain itself, not a uniform against
// P(|H|^2 >= H_th): this is the law of the packed final-layer gather of the
// distributed step, whose estimate the reference also draws this way.
//
// Bound: device memory. Each entry reads one x word and one bits word and
// writes two words, 16 bytes an entry, against one logf, one cosf and one
// sqrtf (the IEEE library versions: the build has no fast math) and a few
// multiplies. At the paper MLP's 3,936,512 entries: 0.0188 ms over 3.35 TB/s.
// Design: a grid-stride loop, one thread per entry, so every load and store is
// coalesced and each byte moves once; sqrt(sigma2) once per thread. The Box-
// Muller arithmetic is the one K3 and K4 draw their noise with
// (ota_estimate.cuh), every multiply an explicit round-to-nearest. The ragged
// tail is bounds-checked, so a slab of any length runs in one launch.
#include <cstdint>
#include <cuda_runtime.h>

#include "ota_estimate.cuh"

namespace {

__global__ void ota_channel_kernel(
    const float* __restrict__ x,        // (n,)
    const int32_t* __restrict__ bits,   // (n,)
    const float* __restrict__ params,   // (3,) [sigma2, H_th, ota_on]
    float* __restrict__ out,            // (n,)
    float* __restrict__ mask,           // (n,)
    int64_t n) {
  const float sig = sqrtf(params[0]);
  const float h_th = params[1];
  const bool off = params[2] < 0.5f;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += stride) {
    const float h = __fmul_rn(ota::gaussian((uint32_t)bits[j]), sig);
    const bool m = __fmul_rn(h, h) >= h_th || off;
    out[j] = m ? x[j] : 0.0f;
    mask[j] = m ? 1.0f : 0.0f;
  }
}

}  // namespace

extern "C" int ota_channel_f32(const float* x, const int32_t* bits,
                               const float* params, float* out, float* mask,
                               int64_t n, int grid, int block,
                               cudaStream_t stream) {
  ota_channel_kernel<<<grid, block, 0, stream>>>(x, bits, params, out, mask,
                                                 n);
  return (int)cudaGetLastError();
}
