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
//   bfloat16, D in {64, 128}: flash_hopper_kernel, for Hopper. 3
//   warpgroups: a TMA producer and two wgmma consumers of 64 query rows
//   each, 128-row query tiles against 128-key tiles in a 2-stage ring
//   guarded by mbarriers (its own comment below).
//   bfloat16, other D (StableLM's 80, Gemma-3's 240, up to 256):
//   flash_bf16_kernel, 4 warps, 64 query rows (16 per warp) against 64-key
//   tiles staged in shared memory with synchronous loads and two barriers
//   per key tile; S = QK^T and O += PV on mma.sync m16n8k16 (float32
//   accumulate, fragments by ldmatrix), D zero-filled to the next of
//   64/128/256 in shared memory only. At StarCoder2-3B's shape it ran at
//   18 % of the bound; it stays for these head dims.
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

#include "hopper.cuh"

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

// ------------------------------------------------- bf16 path for Hopper
// One CTA of 3 warpgroups owns one (b, h) and a 128-row query tile.
// Warpgroup 0 is the producer: one thread issues every TMA load (Q once, then
// the K and V tiles of each key tile into a ring of kStages stages) and its
// warpgroup gives up registers (setmaxnreg). Warpgroups 1 and 2 are the
// consumers, 64 query rows each: S = Q K^T by wgmma from shared memory, the
// online softmax in float32 registers, P rounded to bfloat16 in registers,
// O += P V by wgmma with P from registers. A consumer overlaps the two
// products: with O rescaled to tile i - 1's running max, it issues S of key
// tile i, then P V of tile i - 1, waits for S alone and runs tile i's
// softmax (one FFMA and one ex2.approx per score) while P V is still on the
// tensor cores, and packs P once P V is done. K and V each have a "full"
// barrier per stage
// (the TMA's transaction count) and an "empty" one that every consumer
// thread arrives on once the wgmma reading it is done, so a K slot refills
// while its stage's V is still in use. Operands are read in place through
// 4-D tensor maps over (D, heads, S, B), in 64-column panels of 128 bytes
// with the 128-byte swizzle that wgmma reads; TMA zero-fills rows past S.
// Key tiles are walked from the diagonal down, so the masked ones come
// first.
constexpr int kWgThreads = 128;
constexpr int kHopperThreads = 3 * kWgThreads;
constexpr int kHBq = 128;     // query rows per CTA, 64 per consumer
constexpr int kHBkv = 128;    // keys per tile
constexpr int kStages = 2;
constexpr int kPanelBytes = 128 * 128;  // 128 rows x 64 bf16 columns
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

template <int D>
struct HopperSmem {
  static constexpr int kPanels = D / 64;
  static constexpr int kTile = kPanels * kPanelBytes;  // Q, K or V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kTile;                     // + stage * 2 * kTile
  static constexpr int kBar = kTile + kStages * 2 * kTile;
  // q_full, then per stage k_full, v_full, k_empty, v_empty
  static constexpr int kBytes = kBar + 8 * (1 + 4 * kStages);
};

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One consumer's softmax step on a tile of raw scores s (64 rows x 128 keys
// of the accumulator layout: this thread's rows row0 and row0 + 8): mask,
// new running max in log2 units, and s becomes the probabilities
// exp2(s * scale_log2 - m), one FFMA and one ex2 an entry; alpha is the
// factor that rescales the old l (here) and O (by the caller).
__device__ __forceinline__ void hopper_softmax_p(
    float (&s)[64], float (&m_run)[2], float (&l_run)[2], float (&alpha)[2],
    bool edge, int row0, int k0, int t4, int S, int window,
    float scale_log2) {
  if (edge) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + (e >> 1) * 8;
        const int col = k0 + 8 * j + 2 * t4 + (e & 1);
        const int diff = row - col;
        const bool live = diff >= 0 && col < S &&
                          (window <= 0 || diff < window);
        if (!live) s[4 * j + e] = -INFINITY;
      }
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  }
  float neg_m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
    // scale_log2 > 0, so the max of the scaled scores is the scaled max
    const float m_new = fmaxf(m_run[r], mx[r] * scale_log2);
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    alpha[r] = ex2_approx(m_run[r] - m_use);
    m_run[r] = m_new;
    l_run[r] *= alpha[r];
    neg_m[r] = -m_use;
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    s[i] = ex2_approx(fmaf(s[i], scale_log2, neg_m[(i >> 1) & 1]));
    l_run[(i >> 1) & 1] += s[i];
  }
}

// The probabilities in bfloat16 as the A fragments of P V: the accumulator
// fragments of S are the A fragments, k-slice kk (keys 16 kk .. 16 kk + 15)
// in pa[4 kk .. 4 kk + 3].
__device__ __forceinline__ void hopper_pack_p(const float (&s)[64],
                                              uint32_t (&pa)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) pa[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
}

template <int D>
__device__ __forceinline__ void hopper_issue_s(float (&s)[64], uint32_t q_rows,
                                               uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * kPanelBytes + (kk % 4) * 32;
    hopper::wgmma_ss_n128(s, hopper::sw128_desc(q_rows + off, 16, 1024),
                          hopper::sw128_desc(k_tile + off, 16, 1024), kk > 0);
  }
}

template <int D>
__device__ __forceinline__ void hopper_issue_pv(float (&acc)[D / 2],
                                                const uint32_t (&pa)[32],
                                                uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                           pa[4 * kk + 3]};
    const uint64_t dv =
        hopper::sw128_desc(v_tile + kk * 16 * 128, kPanelBytes, 1024);
    if constexpr (D == 128) {
      hopper::wgmma_rs_n128(acc, a, dv);
    } else {
      hopper::wgmma_rs_n64(acc, a, dv);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kHopperThreads, 1)
    flash_hopper_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        __nv_bfloat16* __restrict__ o, int S, int H, int KV,
                        int window, float scale_log2) {
  using L = HopperSmem<D>;
  constexpr int kDn = D / 8;  // n8 blocks of the output
  extern __shared__ unsigned char smem_raw[];
  // the swizzle atoms must sit on 1024-byte boundaries of shared memory
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bar = base + L::kBar;
  const uint32_t q_full = bar;
  auto k_full = [&](int st) { return bar + 8u * (1 + 4 * st); };
  auto v_full = [&](int st) { return bar + 8u * (2 + 4 * st); };
  auto k_empty = [&](int st) { return bar + 8u * (3 + 4 * st); };
  auto v_empty = [&](int st) { return bar + 8u * (4 + 4 * st); };
  auto k_tile = [&](int st) { return base + L::kK + st * 2 * L::kTile; };
  auto v_tile = [&](int st) { return k_tile(st) + L::kTile; };

  const int q0 = (gridDim.x - 1 - (int)blockIdx.x) * kHBq;  // longest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / KV);
  const int q_last = min(q0 + kHBq, S) - 1;
  const int kv_first = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_lo = kv_first / kHBkv;
  const int t_hi = q_last / kHBkv;
  const int n_tiles = t_hi - t_lo + 1;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      hopper::mbar_init(k_full(st), 1);
      hopper::mbar_init(v_full(st), 1);
      hopper::mbar_init(k_empty(st), 2 * kWgThreads);
      hopper::mbar_init(v_empty(st), 2 * kWgThreads);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / kWgThreads;
  if (wg == 0) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      hopper::mbar_arrive_tx(q_full, L::kTile);
      for (int p = 0; p < L::kPanels; ++p)
        hopper::tma_load_4d(base + L::kQ + p * kPanelBytes, &tm_q, q_full,
                            64 * p, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        const uint32_t free_parity = (i / kStages - 1) & 1;
        const int k0 = (t_hi - i) * kHBkv;
        if (i >= kStages) hopper::mbar_wait(k_empty(st), free_parity);
        hopper::mbar_arrive_tx(k_full(st), L::kTile);
        for (int p = 0; p < L::kPanels; ++p)
          hopper::tma_load_4d(k_tile(st) + p * kPanelBytes, &tm_k, k_full(st),
                              64 * p, hk, k0, b);
        if (i >= kStages) hopper::mbar_wait(v_empty(st), free_parity);
        hopper::mbar_arrive_tx(v_full(st), L::kTile);
        for (int p = 0; p < L::kPanels; ++p)
          hopper::tma_load_4d(v_tile(st) + p * kPanelBytes, &tm_v, v_full(st),
                              64 * p, hk, k0, b);
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int cw = wg - 1;
    const int tid = threadIdx.x - wg * kWgThreads;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int t4 = lane & 3;
    const int wg_row0 = q0 + 64 * cw;
    const int row0 = wg_row0 + 16 * warp + (lane >> 2);  // and row0 + 8
    const uint32_t q_rows = base + L::kQ + cw * 64 * 128;
    auto edge = [&](int k0) {
      return (k0 + kHBkv - 1 > wg_row0) ||
             (window > 0 && wg_row0 + 63 - k0 >= window) || (k0 + kHBkv > S);
    };

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};
    float alpha[2] = {1.f, 1.f};
    float s[64];
    uint32_t pa[32];

    // tile 0: S, its softmax, P
    hopper::mbar_wait(q_full, 0);
    hopper::mbar_wait(k_full(0), 0);
    hopper::wgmma_fence();
    hopper_issue_s<D>(s, q_rows, k_tile(0));
    hopper::wgmma_commit();
    hopper::fence_regs(s);
    hopper::wgmma_wait_all();
    hopper::fence_regs(s);
    hopper::mbar_arrive(k_empty(0));
    hopper_softmax_p(s, m_run, l_run, alpha, edge(t_hi * kHBkv), row0,
                     t_hi * kHBkv, t4, S, window, scale_log2);
    hopper_pack_p(s, pa);

    for (int i = 1; i < n_tiles; ++i) {
      const int st = i % kStages;
      const int prev = (i - 1) % kStages;
      const int k0 = (t_hi - i) * kHBkv;
      // O to tile i - 1's max, then S of tile i and P V of tile i - 1 in
      // flight together
#pragma unroll
      for (int j = 0; j < kDn; ++j) {
        acc[4 * j + 0] *= alpha[0];
        acc[4 * j + 1] *= alpha[0];
        acc[4 * j + 2] *= alpha[1];
        acc[4 * j + 3] *= alpha[1];
      }
      hopper::mbar_wait(k_full(st), (i / kStages) & 1);
      hopper::mbar_wait(v_full(prev), ((i - 1) / kStages) & 1);
      hopper::fence_regs(acc);
      hopper::fence_regs(pa);
      hopper::wgmma_fence();
      hopper_issue_s<D>(s, q_rows, k_tile(st));
      hopper::wgmma_commit();
      hopper::fence_regs(s);
      hopper_issue_pv<D>(acc, pa, v_tile(prev));
      hopper::wgmma_commit();
      hopper::fence_regs(acc);
      hopper::fence_regs(pa);
      // S done (the older group); P V may still run
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      hopper::fence_regs(s);
      hopper::mbar_arrive(k_empty(st));
      hopper_softmax_p(s, m_run, l_run, alpha, edge(k0), row0, k0, t4, S,
                       window, scale_log2);
      hopper::wgmma_wait_all();
      hopper::fence_regs(acc);
      hopper::fence_regs(pa);
      hopper::mbar_arrive(v_empty(prev));
      hopper_pack_p(s, pa);
    }
    // P V of the last tile
#pragma unroll
    for (int j = 0; j < kDn; ++j) {
      acc[4 * j + 0] *= alpha[0];
      acc[4 * j + 1] *= alpha[0];
      acc[4 * j + 2] *= alpha[1];
      acc[4 * j + 3] *= alpha[1];
    }
    const int last = (n_tiles - 1) % kStages;
    hopper::mbar_wait(v_full(last), ((n_tiles - 1) / kStages) & 1);
    hopper::fence_regs(acc);
    hopper::fence_regs(pa);
    hopper::wgmma_fence();
    hopper_issue_pv<D>(acc, pa, v_tile(last));
    hopper::wgmma_commit();
    hopper::fence_regs(acc);
    hopper::wgmma_wait_all();
    hopper::fence_regs(acc);
    hopper::fence_regs(pa);

    // o = acc / l: the row sums over the four lanes of each row
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] += __shfl_xor_sync(kFull, l_run[r], 1);
      l_run[r] += __shfl_xor_sync(kFull, l_run[r], 2);
      l_run[r] = fmaxf(l_run[r], 1e-30f);
      const int row = row0 + 8 * r;
      if (row >= S) continue;
      __nv_bfloat16* orow = o + ((int64_t)b * S + row) * ((int64_t)H * D) +
                            (int64_t)h * D;
#pragma unroll
      for (int j = 0; j < kDn; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * t4) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r] / l_run[r],
                                  acc[4 * j + 2 * r + 1] / l_run[r]);
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

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no -lcuda
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiledFn>(p);
    }
  }
  return fn;
}

// (B, S, heads, D) bf16, contiguous: 4-D map over (D, heads, S, B), boxes of
// 64 columns x 1 head x `rows` rows x 1, 128-byte swizzle, zero fill
bool tensor_map_bshd(EncodeTiledFn encode, CUtensorMap* map, const void* ptr,
                     int B, int S, int heads, int D, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_hopper(const void* q, const void* k, const void* v, void* o,
                  int B, int S, int H, int KV, int window, float scale,
                  cudaStream_t stream) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!tensor_map_bshd(encode, &tm_q, q, B, S, H, D, kHBq) ||
      !tensor_map_bshd(encode, &tm_k, k, B, S, KV, D, kHBkv) ||
      !tensor_map_bshd(encode, &tm_v, v, B, S, KV, D, kHBkv)) {
    return (int)cudaErrorInvalidValue;
  }
  // setmaxnreg moves registers inside the CTA's allocation: the producer's
  // release has to cover the consumers' request
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, flash_hopper_kernel<D>);
  if (err != cudaSuccess) return (int)err;
  if (kWgThreads * (attr.numRegs - kProducerRegs) <
      2 * kWgThreads * (kConsumerRegs - attr.numRegs)) {
    return (int)cudaErrorInvalidConfiguration;
  }
  const int smem = HopperSmem<D>::kBytes + 1024;  // + alignment slack
  err = cudaFuncSetAttribute(flash_hopper_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kHBq - 1) / kHBq, H, B);
  flash_hopper_kernel<D><<<grid, kHopperThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), S, H, KV, window,
      scale * 1.4426950408889634f);
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

// The Hopper path (TMA + wgmma) for bf16 at D in {64, 128}: q, k, v 16-byte
// aligned with the layout above
extern "C" int flash_attention_bf16_hopper(const void* q, const void* k,
                                           const void* v, void* o, int B,
                                           int S, int H, int KV, int D,
                                           int window, float scale,
                                           cudaStream_t stream) {
  if (D == 64)
    return launch_hopper<64>(q, k, v, o, B, S, H, KV, window, scale, stream);
  if (D == 128)
    return launch_hopper<128>(q, k, v, o, B, S, H, KV, window, scale, stream);
  return (int)cudaErrorInvalidValue;
}
