// The per-entry slab estimate of paper eqs. 7-10, shared by K3
// (ota_aggregate.cu, bits supplied) and K4 (ota_aggregate_fused.cu, bits drawn
// in-kernel), so that on the same stream words the two give the same float32
// bits; its Box-Muller draw is also K7's gain (ota_channel.cu):
//
//   M_l = u_l < p_pass_l  or  ota_on < 0.5,  u_l = float(bits_l) * 2^-32
//   y   = sum_l M_l * wg_l  (l = 0 .. C-1 in order)
//         + BoxMuller(nbits) * noise_std * ota_on
//   out = cnt > 0 ? y / (max(cnt, 1) * N) : 0,  cnt = sum_l M_l
//
// Every add and multiply is an explicit round-to-nearest intrinsic, so the
// compiler cannot contract a pair into a fused multiply-add differently in
// the two kernels; logf, cosf and sqrtf are the IEEE library versions (the
// build has no fast math). The uint32 -> float conversion rounds to nearest,
// like bits.astype(f32).
#pragma once

#include <cstdint>

namespace ota {

constexpr float kTwoPi = 6.283185307179586f;
constexpr float kInv2Pow32 = 2.3283064365386963e-10f;  // 2^-32, exact
constexpr float kInv2Pow16 = 1.0f / 65536.0f;          // exact

struct Acc {
  float y;
  float cnt;
};

__device__ __forceinline__ Acc acc_init() { return Acc{0.0f, 0.0f}; }

// Fold cluster l's term into the running sum: its mask from the gain word b.
__device__ __forceinline__ void acc_add(Acc& a, uint32_t b, float p_pass,
                                        bool off, float wg) {
  const float u = __fmul_rn(__uint2float_rn(b), kInv2Pow32);
  const bool m = u < p_pass || off;
  a.y = __fadd_rn(a.y, m ? wg : 0.0f);
  a.cnt = __fadd_rn(a.cnt, m ? 1.0f : 0.0f);
}

// One N(0, 1) draw per word, Box-Muller on its two u16 halves:
//   u1 = (hi + 1) / 65536 in (0, 1],  u2 = lo / 65536,
//   h  = sqrt(-2 log u1) * cos(2 pi u2).
__device__ __forceinline__ float gaussian(uint32_t b) {
  const float u1 =
      __fmul_rn(__fadd_rn(__uint2float_rn(b >> 16), 1.0f), kInv2Pow16);
  const float u2 = __fmul_rn(__uint2float_rn(b & 0xFFFFu), kInv2Pow16);
  const float r = sqrtf(__fmul_rn(-2.0f, logf(u1)));
  return __fmul_rn(r, cosf(__fmul_rn(kTwoPi, u2)));
}

// AWGN from the noise word, then the guarded |M| * N estimate.
__device__ __forceinline__ float finish(const Acc& a, uint32_t nb,
                                        float noise_std, float ota_on,
                                        float n_clients) {
  const float h = gaussian(nb);
  const float z = __fmul_rn(__fmul_rn(h, noise_std), ota_on);
  const float y = __fadd_rn(a.y, z);
  return a.cnt > 0.0f
             ? __fdiv_rn(y, __fmul_rn(fmaxf(a.cnt, 1.0f), n_clients))
             : 0.0f;
}

}  // namespace ota
