// Client-folded OTA estimator for one gradient leaf (paper eqs. 3, 7-10).
//
// Replaces the TPU kernel ota_aggregate_client_pallas
// (src/repro/kernels/ota_channel/kernel.py, bodies
// _ota_aggregate_client_kernel and _ota_aggregate_client_cblk_kernel).
//
// Per flat entry j of the leaf:
//   wg_l  = sum_n p[l,n] * g[l,n,j]                              (eq. 3)
//   M_l   = (u_l(j) < p_pass_l  or  ota_on < 0.5)  and  live_l >= 0.5
//   y     = sum_l M_l * wg_l + BoxMuller(nbits[j]) * z_std * ota_on   (eq. 8)
//   out   = cnt > 0 ? y / (max(cnt, 1) * max(N_eff, 1)) : 0     (eq. 10)
// with u_l(j) = float(bits[l, j]) * 2^-32 (uint32 -> float rounds to nearest,
// like bits.astype(f32)) and cnt = sum_l M_l.
//
// Bound: device memory. Each entry reads C*N gradient words, C gain-bit
// words and one noise word and writes one output word: (C*N*4 + C*4 + 4 + 4)
// bytes, about 0.66 GB for the paper round (C=10, N=3, 3.94M entries),
// 0.2 ms at 3.35 TB/s. The arithmetic (2*C*N + a few*C flops plus one
// log/sqrt/cos per entry) is two orders of magnitude below the f32 rate.
// Design: one thread per entry (grid-stride), so every load of g, bits and
// nbits is coalesced along j and each input byte is read exactly once; the
// cluster loop l and client loop n run inside the thread in the reference's
// order. The params row (sigma2, p, H_th, z_std, ota_on, live, N_eff) and the
// per-cluster p_pass stay device data, staged once per block in shared
// memory, so the launch never synchronises with the host. The ragged tail is
// bounds-checked, so any leaf length runs in one launch. Gain bits may sit in
// a wider section stream: the row stride is an argument, so the caller
// passes a slice without copying it.
//
// Compiled without --use_fast_math: logf, cosf, sqrtf and the division stay
// IEEE, as in the reference. Contraction of multiply-add into FMA (nvcc's
// default) changes rounding in the last place only.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kTwoPi = 6.283185307179586f;
constexpr float kInv2Pow32 = 2.3283064365386963e-10f;  // 2^-32, exact

__global__ void ota_client_fold_kernel(
    const float* __restrict__ g,        // (C, N, n)
    const int32_t* __restrict__ bits,   // (C, >= n), row stride bits_stride
    int64_t bits_stride,
    const int32_t* __restrict__ nbits,  // (n,)
    const float* __restrict__ params,   // (C*(N+2)+4,)
    const float* __restrict__ p_pass,   // (C,)
    float* __restrict__ out,            // (n,)
    int64_t n, int n_clusters, int n_clients) {
  extern __shared__ float sp[];
  const int n_params = n_clusters * (n_clients + 2) + 4;
  for (int k = threadIdx.x; k < n_params + n_clusters; k += blockDim.x) {
    sp[k] = k < n_params ? params[k] : p_pass[k - n_params];
  }
  __syncthreads();
  const int c = n_clusters, nc = n_clients;
  const int base = c + c * nc;
  const float noise_std = sp[base + 1];
  const float ota_on = sp[base + 2];
  const float n_eff = sp[base + 3 + c];
  const bool off = ota_on < 0.5f;
  const float* pp = sp + n_params;

  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += stride) {
    float acc = 0.0f;
    float cnt = 0.0f;
    for (int l = 0; l < c; ++l) {
      float wg = 0.0f;
      for (int i = 0; i < nc; ++i) {
        wg = wg + sp[c + l * nc + i] * g[(int64_t)(l * nc + i) * n + j];
      }
      const uint32_t b = (uint32_t)bits[(int64_t)l * bits_stride + j];
      const float u = __uint2float_rn(b) * kInv2Pow32;
      const bool m = (u < pp[l] || off) && sp[base + 3 + l] >= 0.5f;
      acc = acc + (m ? wg : 0.0f);
      cnt = cnt + (m ? 1.0f : 0.0f);
    }
    const uint32_t nb = (uint32_t)nbits[j];
    const float u1 = (__uint2float_rn(nb >> 16) + 1.0f) * (1.0f / 65536.0f);
    const float u2 = __uint2float_rn(nb & 0xFFFFu) * (1.0f / 65536.0f);
    const float r = sqrtf(-2.0f * logf(u1));
    const float z = r * cosf(kTwoPi * u2) * noise_std * ota_on;
    const float y = acc + z;
    out[j] = cnt > 0.0f
                 ? y / (fmaxf(cnt, 1.0f) * fmaxf(n_eff, 1.0f))
                 : 0.0f;
  }
}

}  // namespace

extern "C" int ota_client_fold_f32(const float* g, const int32_t* bits,
                                   int64_t bits_stride, const int32_t* nbits,
                                   const float* params, const float* p_pass,
                                   float* out, int64_t n, int n_clusters,
                                   int n_clients, int grid, int block,
                                   cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (size_t)(n_clusters * (n_clients + 3) + 4);
  ota_client_fold_kernel<<<grid, block, smem, stream>>>(
      g, bits, bits_stride, nbits, params, p_pass, out, n, n_clusters,
      n_clients);
  return (int)cudaGetLastError();
}
