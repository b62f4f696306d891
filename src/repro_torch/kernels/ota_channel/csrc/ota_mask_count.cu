// Collective-free local channel work of the distributed slab step (paper
// eqs. 3, 7 and the |M| count of eq. 10): out = M_me o (w*x), cnt = sum_l M_l.
//
// Replaces the TPU kernel ota_mask_count_pallas
// (src/repro/kernels/ota_channel/kernel.py, body _ota_mask_count_kernel).
//
// Per entry j, over every cluster l = 0 .. C-1 in order:
//   u_l   = float(bits[l, j]) * 2^-32     (uint32 -> float rounds to nearest,
//                                          like bits.astype(f32))
//   M_l   = (u_l < p_pass_l  or  ota_on < 0.5)  and  live_l > 0.5
//   cnt   = sum_l M_l
//   out   = M_me ? w * x[j] : 0
// with params = [sigma2_0..C-1, H_th, ota_on, w, me, live_0..C-1] (the
// reference's (1, 2C+4) block) and p_pass_l = erfc(sqrt(H_th/2sigma2_l))
// computed by the caller with the same torch call its plain version makes, so
// kernel and plain version agree on every mask, and so on out and cnt bit for
// bit (one multiply; a sum of 0/1 terms is exact in any order).
//
// Bound: device memory. Each entry reads one x word and C bits words and writes
// two words: (12 + 4C) bytes an entry against C compares and adds. At the
// paper MLP's 3,936,512 entries that is 0.0235 ms at C = 2 and 0.0611 ms at
// C = 10 over 3.35 TB/s.
// Design: a grid-stride loop, one thread per entry, the cluster loop inside
// the thread, so every load and store is coalesced and each byte moves once.
// Rows of bits sit at a caller-given stride, so a leaf's column slice of the
// (C, section) streams is read in place. The per-cluster p_pass and live flags
// are staged once per block in shared memory. The ragged tail is bounds-checked,
// so a leaf of any length runs in one launch.
//
// Compiled without --use_fast_math; the adds and the multiply round to nearest.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kInv2Pow32 = 2.3283064365386963e-10f;  // 2^-32, exact

__global__ void ota_mask_count_kernel(
    const float* __restrict__ x,        // (n,)
    const int32_t* __restrict__ bits,   // (C, >= n), row stride bits_stride
    int64_t bits_stride,
    const float* __restrict__ params,   // (2C + 4,)
    const float* __restrict__ p_pass,   // (C,)
    float* __restrict__ out,            // (n,)
    float* __restrict__ cnt,            // (n,)
    int64_t n, int c) {
  extern __shared__ float s[];          // [p_pass_0..C-1, live_0..C-1]
  for (int l = threadIdx.x; l < c; l += blockDim.x) {
    s[l] = p_pass[l];
    s[c + l] = params[c + 4 + l];
  }
  __syncthreads();
  const bool off = params[c + 1] < 0.5f;
  const float w = params[c + 2];
  const float me = params[c + 3];
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += stride) {
    float count = 0.0f;
    bool mine = false;
    for (int l = 0; l < c; ++l) {
      const float u = __fmul_rn(
          __uint2float_rn((uint32_t)bits[(int64_t)l * bits_stride + j]),
          kInv2Pow32);
      const bool m = (u < s[l] || off) && s[c + l] > 0.5f;
      count = __fadd_rn(count, m ? 1.0f : 0.0f);
      mine = mine || (m && me == (float)l);
    }
    out[j] = mine ? __fmul_rn(w, x[j]) : 0.0f;
    cnt[j] = count;
  }
}

}  // namespace

extern "C" int ota_mask_count_f32(const float* x, const int32_t* bits,
                                  int64_t bits_stride, const float* params,
                                  const float* p_pass, float* out, float* cnt,
                                  int64_t n, int c, int grid, int block,
                                  cudaStream_t stream) {
  const size_t smem = 2 * (size_t)c * sizeof(float);
  ota_mask_count_kernel<<<grid, block, smem, stream>>>(
      x, bits, bits_stride, params, p_pass, out, cnt, n, c);
  return (int)cudaGetLastError();
}
