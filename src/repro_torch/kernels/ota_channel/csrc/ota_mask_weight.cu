// Fused channel mask and weighted apply (paper eq. 7): (M o (w*x), M).
//
// Replaces the TPU kernel ota_mask_weight_pallas
// (src/repro/kernels/ota_channel/kernel.py, body _ota_mask_weight_kernel).
//
// Per entry j of row r:
//   u      = float(bits[r, j]) * 2^-32      (uint32 -> float rounds to nearest,
//                                            like bits.astype(f32))
//   M      = u < p_pass  or  ota_on < 0.5
//   out    = M ? w * x[r, j] : 0
//   mask   = M ? 1 : 0
// with params = [sigma2, H_th, ota_on, w] and p_pass = erfc(sqrt(H_th/2sigma2))
// computed by the caller with the same torch call its plain version makes, so
// kernel and plain version agree on every mask.
//
// Bound: device memory. Each entry reads one x word and one bits word and
// writes two words: 16 bytes an entry, against one compare and one multiply.
// The streaming engines call it once per (cluster, leaf): 10 x 3,938,304
// entries per paper round, about 0.63 GB, 0.19 ms at 3.35 TB/s.
// Design: a grid-stride loop over the row, one thread per entry, so every load
// and store is coalesced and each byte moves once; blockIdx.y walks the rows.
// Rows of bits sit at a caller-given stride, so a column slice of a wider
// section stream is read in place. The ragged tail is bounds-checked, so a
// leaf of any length runs in one launch. The params row and p_pass stay
// device data: the launch never waits for the host.
//
// Compiled without --use_fast_math; the only arithmetic on x is one multiply.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kInv2Pow32 = 2.3283064365386963e-10f;  // 2^-32, exact

__global__ void ota_mask_weight_kernel(
    const float* __restrict__ x,        // (rows, n), contiguous
    const int32_t* __restrict__ bits,   // (rows, >= n), row stride bits_stride
    int64_t bits_stride,
    const float* __restrict__ params,   // (4,) [sigma2, H_th, ota_on, w]
    const float* __restrict__ p_pass,   // (1,)
    float* __restrict__ out,            // (rows, n)
    float* __restrict__ mask,           // (rows, n)
    int64_t n) {
  const bool off = params[2] < 0.5f;
  const float w = params[3];
  const float pp = p_pass[0];
  const int64_t row = blockIdx.y;
  const float* xr = x + row * n;
  const int32_t* br = bits + row * bits_stride;
  float* outr = out + row * n;
  float* maskr = mask + row * n;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += stride) {
    const float u = __uint2float_rn((uint32_t)br[j]) * kInv2Pow32;
    const bool m = u < pp || off;
    outr[j] = m ? w * xr[j] : 0.0f;
    maskr[j] = m ? 1.0f : 0.0f;
  }
}

}  // namespace

extern "C" int ota_mask_weight_f32(const float* x, const int32_t* bits,
                                   int64_t bits_stride, const float* params,
                                   const float* p_pass, float* out,
                                   float* mask, int64_t n, int rows, int grid,
                                   int block, cudaStream_t stream) {
  const dim3 grid_dim((unsigned)grid, (unsigned)rows);
  ota_mask_weight_kernel<<<grid_dim, block, 0, stream>>>(
      x, bits, bits_stride, params, p_pass, out, mask, n);
  return (int)cudaGetLastError();
}
