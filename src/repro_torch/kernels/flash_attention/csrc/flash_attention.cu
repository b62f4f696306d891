// Flash attention forward: causal GQA self-attention with an optional
// sliding window, online softmax in float32 (K8).
//
// Replaces the TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention/kernel.py, body _flash_kernel), which
// the serving path reaches through flash_attention/ops.py when
// attn_impl == "pallas". It computes the same function:
//   o[b, i, h, :] = sum_j softmax_j(s_ij) v[b, j, h / G, :],
//   s_ij = (q[b, i, h, :] . k[b, j, h / G, :]) / sqrt(D),
// over keys j <= i (and i - j < window when a window is set), with
// G = H / KV query heads per KV head. Positions are 0..S-1, as in the
// reference's prefill.
//
// Bound: operations. Per (b, h) the unmasked pairs number about S^2 / 2
// without a window and S * W with one; each costs 2 * D multiply-adds
// (QK^T and PV). At StarCoder2-3B's prefill (S=8192, W=4096, D=128,
// H=24, B=4) that is 1.24 TFLOP per layer, 1.25 ms at the H100's dense
// bf16 tensor-core rate, while q, k, v and o are 0.44 GB (0.13 ms).
//
// Design. The TPU kernel walks a sequential (q block, kv block) grid and
// keeps m, l and acc in VMEM scratch; here one block owns one (b, h,
// query tile) and loops over the key tiles itself, so one launch covers a
// whole layer. Operands are read in place in the model's (B, S, H, D)
// layout (no transposes, no copies). Key tiles wholly above the diagonal or
// wholly outside the window for every row of the query tile are skipped,
// loads included; the partial ones are masked element by element. Any
// S >= 1 works: rows and keys past S are zero-filled and never written.
// Three kernels; ops.launch picks one by dtype and head dim (a rule, not a
// fallback):
//   bfloat16, D = 64, 80, ..., 256 (a multiple of 16): flash_hopper_kernel
//   (flash_hopper.cuh), for Hopper. 3 warpgroups: a TMA producer and two
//   wgmma consumers of 64 query rows each, 128-row query tiles against key
//   tiles in a 2-stage ring guarded by mbarriers. One instantiation per D,
//   in two sources compiled in parallel, with two tilings:
//   - tiling A, D <= 128 (flash_hopper_narrow.cu): 128-key tiles. Q and K
//     are 64-column panels with the 128-byte swizzle (two at D > 64: 32 KB
//     a tile); TMA zero-fills the columns past D, and S = Q K^T runs D / 16
//     k-slices of m64n128k16, none over those zeros. V is panels of the
//     widest swizzle atom that divides D (64 columns at D 64/128, 32 with
//     the 64-byte swizzle at 96, 16 with the 32-byte one at 80 and 112),
//     so P V runs at N = D (m64n{D}k16; V 24 KB at D = 96, 20 KB at 80).
//     Shared memory Q + 2 stages of K and V: at most 160 KB. Registers per
//     consumer thread: S 64 floats, P 32, O D / 2: at most 160 live under
//     setmaxnreg's 240.
//   - tiling B, 128 < D <= 256 (flash_hopper_wide.cu): 64-key tiles, since
//     128-key tiles would take 64 + 2 * 2 * 64 = 320 KB. Q is four 128-row
//     panels (64 KB), K and V 64-row panels (32 KB each a stage): 192 KB
//     of the 227 KB. S per consumer is 64 x 64 (m64n64k16: 32 floats, P
//     16); P V runs as n128 chunks over V's 128-byte-swizzled panel pairs
//     ({0, 1}, then {2, 3} or {2} as n64), the columns past D TMA's zeros
//     (N = 256 at D = 240: x 1.07 on P V). O holds 128 floats, about 176
//     live in all (ptxas spills a few bytes at D 240 and 256). A warp
//     whose rows all kept their running max skips O's rescale (D / 2
//     multiplies a thread, more than the tile's 32 scores cost).
//   Tiling A's P V at N = D, not at N = 128 over V's two 128-byte-swizzled
//   panels with TMA's zeros past D (x 1.33 on P V at D = 96, x 1.6 at
//   80), because it is faster: the two tilings, timed once on an H100
//   80GB HBM3 at 700 W, took 0.2462 ms against 0.3177 at Phi-3-vision-
//   4.2B's layer (B=1, S=4096, 32 heads, D=96, causal) and 0.2321 against
//   0.2998 at StableLM-3B's (D=80). Only N = D is built.
//   bfloat16, other D (below 64, or not a multiple of 16): flash_bf16_kernel,
//   4 warps, 64 query rows (16 per warp) against 64-key tiles staged in
//   shared memory with synchronous loads and two barriers per key tile;
//   S = QK^T and O += PV on mma.sync m16n8k16 (float32 accumulate,
//   fragments by ldmatrix), D zero-filled to the next of 64/128/256 in
//   shared memory only. It ran StarCoder2-3B's layer at 18 % of the bound
//   and Phi-3-vision's (D = 96) at 10 %; ops.launch(kernel="mma_sync")
//   still runs it at a Hopper head dim, to time the two designs.
//   float32: flash_f32_kernel, plain FMA, 32 query rows of 4 threads each
//   (a quarter of D per thread) against 32-key tiles, every product in
//   float32.
// The bf16 kernels round the probabilities to bfloat16 for PV, as flash
// attention does, and keep the softmax in float32 (the Hopper kernel's
// exponentials are ex2.approx, within 2 ulp, far below the bf16 rounding).
// Masking uses -inf with a guard (a row with no live key so far takes
// m = 0 for its exponentials), so a fully masked row segment leaves
// nothing behind in l or acc. The reference's -1e30 leaves exp(0) mass
// there that a later alpha = exp(-1e30 - m) wipes; both give the same
// result for every row that sees its own position, which causal
// self-attention always does.
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "flash_hopper.cuh"

namespace {

constexpr int kThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------- bf16 path
constexpr int kBq = 64;    // query rows per block, 16 per warp
constexpr int kBkv = 64;   // keys per tile
constexpr int kPad = 8;    // bf16 elements of padding per shared-memory row

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// c += a (16x16, row) * b (16x8, col), bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows row0 .. row0 + 63 of a (S, stride) bf16 matrix, columns 0 .. D-1,
// into a (64, DP + kPad) shared tile; zeros past S and past D
template <int DP>
__device__ __forceinline__ void load_tile_bf16(uint16_t* dst,
                                               const uint16_t* src,
                                               int64_t stride, int row0,
                                               int S, int D, bool vec) {
  constexpr int kLd = DP + kPad;
  constexpr int kChunks = DP / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < kBkv * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    const int row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < S && c < D) {
      const uint16_t* p = src + (int64_t)row * stride + c;
      if (vec) {
        val = *reinterpret_cast<const uint4*>(p);
      } else {
        uint16_t e[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) e[j] = (c + j < D) ? p[j] : uint16_t(0);
        val.x = e[0] | (uint32_t(e[1]) << 16);
        val.y = e[2] | (uint32_t(e[3]) << 16);
        val.z = e[4] | (uint32_t(e[5]) << 16);
        val.w = e[6] | (uint32_t(e[7]) << 16);
      }
    }
    *reinterpret_cast<uint4*>(dst + r * kLd + c) = val;
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
    flash_bf16_kernel(const uint16_t* __restrict__ q,
                      const uint16_t* __restrict__ k,
                      const uint16_t* __restrict__ v,
                      __nv_bfloat16* __restrict__ o, int S, int H, int KV,
                      int D, int window, float scale, bool vec) {
  constexpr int kLd = DP + kPad;
  constexpr int kDn = DP / 8;  // n8 tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* sQ = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* sK = sQ + kBq * kLd;
  uint16_t* sV = sK + kBkv * kLd;

  const int n_qt = gridDim.x;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * kBq;  // longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / KV);
  const int q_last = min(q0 + kBq, S) - 1;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // fragment row within 8
  const int t4 = lane & 3;   // fragment column pair
  const int mi = lane >> 3;  // ldmatrix: which 8x8 matrix this lane addresses
  const int ri = lane & 7;   // ldmatrix: which row of it

  const int64_t q_stride = (int64_t)H * D;
  const int64_t kv_stride = (int64_t)KV * D;
  const uint16_t* qb = q + (int64_t)b * S * q_stride + (int64_t)h * D;
  const uint16_t* kb = k + (int64_t)b * S * kv_stride + (int64_t)hk * D;
  const uint16_t* vb = v + (int64_t)b * S * kv_stride + (int64_t)hk * D;

  load_tile_bf16<DP>(sQ, qb, q_stride, q0, S, D, vec);

  const int kv_first = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_lo = kv_first / kBkv;
  const int t_hi = q_last / kBkv;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8

  float acc[kDn][4];
#pragma unroll
  for (int i = 0; i < kDn; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  for (int t = t_lo; t <= t_hi; ++t) {
    const int k0 = t * kBkv;
    __syncthreads();  // the previous tile's reads are done
    load_tile_bf16<DP>(sK, kb, kv_stride, k0, S, D, vec);
    load_tile_bf16<DP>(sV, vb, kv_stride, k0, S, D, vec);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
      uint32_t a[4];
      ldsm_x4(a, sQ + (warp * 16 + ri + (mi & 1) * 8) * kLd + kk +
                     (mi >> 1) * 8);
#pragma unroll
      for (int n = 0; n < 8; n += 2) {
        uint32_t bk[4];
        ldsm_x4(bk, sK + (n * 8 + ri + (mi >> 1) * 8) * kLd + kk +
                        (mi & 1) * 8);
        mma_bf16(s[n], a, bk[0], bk[1]);
        mma_bf16(s[n + 1], a, bk[2], bk[3]);
      }
    }

    // scale, mask, online softmax (rows row0 and row0 + 8)
    const bool edge = (k0 + kBkv - 1 > q0) ||
                      (window > 0 && q_last - k0 >= window) ||
                      (k0 + kBkv > S);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float val = s[n][e] * scale;
        if (edge) {
          const int row = row0 + (e >> 1) * 8;
          const int col = k0 + n * 8 + t4 * 2 + (e & 1);
          const int diff = row - col;
          const bool live = diff >= 0 && col < S &&
                            (window <= 0 || diff < window);
          val = live ? val : -INFINITY;
        }
        s[n][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    }
    float alpha[2], m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      m_use[r] = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = expf(m_run[r] - m_use[r]);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[n][e] - m_use[e >> 1]);
        s[n][e] = p;
        l_run[e >> 1] += p;
      }
    }
#pragma unroll
    for (int i = 0; i < kDn; ++i) {
      acc[i][0] *= alpha[0];
      acc[i][1] *= alpha[0];
      acc[i][2] *= alpha[1];
      acc[i][3] *= alpha[1];
    }

    // O += P V: P's accumulator fragments are the A fragments of PV
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
      a[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
      a[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
      a[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
#pragma unroll
      for (int dn = 0; dn < kDn; dn += 2) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, sV + (j * 16 + ri + (mi & 1) * 8) * kLd + dn * 8 +
                              (mi >> 1) * 8);
        mma_bf16(acc[dn], a, bv[0], bv[1]);
        mma_bf16(acc[dn + 1], a, bv[2], bv[3]);
      }
    }
  }

  // finalize: the row sums over the four lanes of each row, then o = acc / l
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(kFull, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(kFull, l_run[r], 2);
    l_run[r] = fmaxf(l_run[r], 1e-30f);
  }
  const bool pairs = (D % 2) == 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row >= S) continue;
    __nv_bfloat16* orow = o + ((int64_t)b * S + row) * q_stride +
                          (int64_t)h * D;
#pragma unroll
    for (int dn = 0; dn < kDn; ++dn) {
      const int col = dn * 8 + t4 * 2;
      const float x0 = acc[dn][2 * r] / l_run[r];
      const float x1 = acc[dn][2 * r + 1] / l_run[r];
      if (pairs && col + 1 < D) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(x0, x1);
      } else {
        if (col < D) orow[col] = __float2bfloat16_rn(x0);
        if (col + 1 < D) orow[col + 1] = __float2bfloat16_rn(x1);
      }
    }
  }
}

// ----------------------------------------------------------------- f32 path
constexpr int kBqF = 32;   // query rows per block, 4 threads per row
constexpr int kBkvF = 32;  // keys per tile

template <int DPT>  // head-dim columns per thread: d = quarter + 4 * i
__global__ void __launch_bounds__(kThreads)
    flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     int S, int H, int KV, int D, int window, float scale,
                     bool vec) {
  constexpr int DP = 4 * DPT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);
  float* sV = sK + kBkvF * DP;

  const int n_qt = gridDim.x;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * kBqF;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / KV);
  const int q_last = min(q0 + kBqF, S) - 1;
  const int quarter = threadIdx.x & 3;
  const int row = q0 + (threadIdx.x >> 2);

  const int64_t q_stride = (int64_t)H * D;
  const int64_t kv_stride = (int64_t)KV * D;
  const float* kb = k + (int64_t)b * S * kv_stride + (int64_t)hk * D;
  const float* vb = v + (int64_t)b * S * kv_stride + (int64_t)hk * D;

  float qr[DPT];
  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    const int d = quarter + 4 * i;
    qr[i] = (row < S && d < D)
                ? q[((int64_t)b * S + row) * q_stride + (int64_t)h * D + d]
                : 0.f;
    acc[i] = 0.f;
  }
  float m_run = -INFINITY, l_run = 0.f;

  const int kv_first = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_lo = kv_first / kBkvF;
  const int t_hi = q_last / kBkvF;
  for (int t = t_lo; t <= t_hi; ++t) {
    const int k0 = t * kBkvF;
    __syncthreads();
    constexpr int kQuads = DP / 4;
    for (int i = threadIdx.x; i < kBkvF * kQuads; i += kThreads) {
      const int r = i / kQuads;
      const int c = (i % kQuads) * 4;
      const int krow = k0 + r;
      float4 kv4 = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vv4 = kv4;
      if (krow < S && c < D) {
        const float* kp = kb + (int64_t)krow * kv_stride + c;
        const float* vp = vb + (int64_t)krow * kv_stride + c;
        if (vec) {
          kv4 = *reinterpret_cast<const float4*>(kp);
          vv4 = *reinterpret_cast<const float4*>(vp);
        } else {
          kv4.x = kp[0];
          vv4.x = vp[0];
          if (c + 1 < D) { kv4.y = kp[1]; vv4.y = vp[1]; }
          if (c + 2 < D) { kv4.z = kp[2]; vv4.z = vp[2]; }
          if (c + 3 < D) { kv4.w = kp[3]; vv4.w = vp[3]; }
        }
      }
      *reinterpret_cast<float4*>(sK + r * DP + c) = kv4;
      *reinterpret_cast<float4*>(sV + r * DP + c) = vv4;
    }
    __syncthreads();

    float sc[kBkvF];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBkvF; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i)
        part = fmaf(qr[i], sK[j * DP + quarter + 4 * i], part);
      part += __shfl_xor_sync(kFull, part, 1);
      part += __shfl_xor_sync(kFull, part, 2);
      const int col = k0 + j;
      const int diff = row - col;
      const bool live = diff >= 0 && col < S &&
                        (window <= 0 || diff < window);
      sc[j] = live ? part * scale : -INFINITY;
      mx = fmaxf(mx, sc[j]);
    }
    const float m_new = fmaxf(m_run, mx);
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    const float alpha = expf(m_run - m_use);
    m_run = m_new;
    l_run *= alpha;
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < kBkvF; ++j) {
      const float p = expf(sc[j] - m_use);
      l_run += p;
#pragma unroll
      for (int i = 0; i < DPT; ++i)
        acc[i] = fmaf(p, sV[j * DP + quarter + 4 * i], acc[i]);
    }
  }

  if (row < S) {
    const float l = fmaxf(l_run, 1e-30f);
    float* orow = o + ((int64_t)b * S + row) * q_stride + (int64_t)h * D;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int d = quarter + 4 * i;
      if (d < D) orow[d] = acc[i] / l;
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <int DP>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                int S, int H, int KV, int D, int window, float scale,
                cudaStream_t stream) {
  const int smem = (kBq + 2 * kBkv) * (DP + kPad) * (int)sizeof(uint16_t);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const bool vec = D % 8 == 0 && aligned16(q) && aligned16(k) &&
                   aligned16(v);
  const dim3 grid((S + kBq - 1) / kBq, H, B);
  flash_bf16_kernel<DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<__nv_bfloat16*>(o), S, H,
      KV, D, window, scale, vec);
  return (int)cudaGetLastError();
}

template <int DPT>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int S, int H, int KV, int D, int window, float scale,
               cudaStream_t stream) {
  const int smem = 2 * kBkvF * 4 * DPT * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel<DPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const bool vec = D % 4 == 0 && aligned16(k) && aligned16(v);
  const dim3 grid((S + kBqF - 1) / kBqF, H, B);
  flash_f32_kernel<DPT><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, H, KV, D,
      window, scale, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o (B, S, H, D) and k, v (B, S, KV, D), contiguous; window 0 = none
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int B, int S,
                                    int H, int KV, int D, int window,
                                    float scale, cudaStream_t stream) {
  if (D <= 64)
    return launch_bf16<64>(q, k, v, o, B, S, H, KV, D, window, scale,
                           stream);
  if (D <= 128)
    return launch_bf16<128>(q, k, v, o, B, S, H, KV, D, window, scale,
                            stream);
  return launch_bf16<256>(q, k, v, o, B, S, H, KV, D, window, scale, stream);
}

extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o, int B, int S,
                                   int H, int KV, int D, int window,
                                   float scale, cudaStream_t stream) {
  if (D <= 32)
    return launch_f32<8>(q, k, v, o, B, S, H, KV, D, window, scale, stream);
  if (D <= 64)
    return launch_f32<16>(q, k, v, o, B, S, H, KV, D, window, scale, stream);
  if (D <= 128)
    return launch_f32<32>(q, k, v, o, B, S, H, KV, D, window, scale, stream);
  return launch_f32<64>(q, k, v, o, B, S, H, KV, D, window, scale, stream);
}

// The Hopper path (TMA + wgmma, flash_hopper.cuh) for bf16 at D = 64, 80,
// ..., 256: q, k, v 16-byte aligned with the layout above
extern "C" int flash_attention_bf16_hopper(const void* q, const void* k,
                                           const void* v, void* o, int B,
                                           int S, int H, int KV, int D,
                                           int window, float scale,
                                           cudaStream_t stream) {
  if (D % 16 != 0 || D < 64 || D > 256) return (int)cudaErrorInvalidValue;
  if (D <= 128)
    return k8_hopper::launch_narrow(q, k, v, o, B, S, H, KV, D, window, scale,
                                    stream);
  return k8_hopper::launch_wide(q, k, v, o, B, S, H, KV, D, window, scale,
                                stream);
}
