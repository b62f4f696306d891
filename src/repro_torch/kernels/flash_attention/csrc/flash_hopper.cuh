// K8's Hopper kernel (TMA + wgmma) for bfloat16 at the head dims D = 64, 80,
// ..., 256 (multiples of 16): the kernel template and its launch. Two
// sources instantiate it, so that nvcc compiles the instantiations in
// parallel: flash_hopper_narrow.cu (D <= 128, tiling A) and
// flash_hopper_wide.cu (D > 128, tiling B). flash_attention.cu's header
// gives the design and its arithmetic.
//
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
// barrier per stage (the TMA's transaction count) and an "empty" one that
// every consumer thread arrives on once the wgmma reading it is done, so a
// K slot refills while its stage's V is still in use. Operands are read in
// place through 4-D tensor maps over (D, heads, S, B); TMA zero-fills rows
// past S and columns past D (a box that straddles D lands as zeros, never
// as the next head's columns). Key tiles are walked from the diagonal down,
// so the masked ones come first.
#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "hopper.cuh"

namespace k8_hopper {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWgThreads = 128;
constexpr int kThreads = 3 * kWgThreads;
constexpr int kBq = 128;  // query rows per CTA, 64 per consumer
constexpr int kStages = 2;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

// Shared-memory tiling at head dim D. Q and K are 64-column panels with the
// 128-byte swizzle (K-major operands of S = Q K^T); the last panel's columns
// past D are TMA's zeros, and S runs D / 16 k-slices, so none of them enter
// a product. V (the MN-major operand of P V) is panels of kVCols columns
// with a swizzle kVCols * 2 bytes wide; P V's output width kN covers D.
template <int D>
struct Tiling {
  static_assert(D % 16 == 0 && D >= 64 && D <= 256,
                "the Hopper kernel takes D = 64, 80, ..., 256");
  // tiling A (D <= 128): 128-key tiles; tiling B: 64-key tiles, so Q and
  // two stages of K and V fit in shared memory
  static constexpr int kBkv = D <= 128 ? 128 : 64;
  static constexpr int kPanels = (D + 63) / 64;
  // the widest swizzle atom that divides D, so that P V runs at N = D;
  // tiling B keeps 64 and runs P V as n128 (+ n128 or n64) chunks
  static constexpr int kVCols =
      (D > 128 || D % 64 == 0) ? 64 : (D % 32 == 0 ? 32 : 16);
  static constexpr int kVPanels = (D + kVCols - 1) / kVCols;
  static constexpr int kN = kVCols * kVPanels;  // P V's output columns
  static constexpr int kVRow = 2 * kVCols;      // bytes of a V panel row
  static constexpr int kQPanel = kBq * 128;
  static constexpr int kKPanel = kBkv * 128;
  static constexpr int kVPanel = kBkv * kVRow;
  static constexpr int kQBytes = kPanels * kQPanel;
  static constexpr int kKBytes = kPanels * kKPanel;
  static constexpr int kVBytes = kVPanels * kVPanel;
  static constexpr int kStageBytes = kKBytes + kVBytes;
  static constexpr int kBar = kQBytes + kStages * kStageBytes;
  // q_full, then per stage k_full, v_full, k_empty, v_empty
  static constexpr int kBytes = kBar + 8 * (1 + 4 * kStages);
  static constexpr int kS = kBkv / 2;  // scores per consumer thread
  static_assert(kN <= 128 || kVCols == 64, "P V chunks of 128 columns");
  static_assert(kVPanel % 1024 == 0, "panels on swizzle-atom boundaries");
};

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// One consumer's softmax step on a tile of raw scores s (64 rows x 2 NS
// keys in the accumulator layout: this thread's rows row0 and row0 + 8):
// mask, new running max in log2 units, and s becomes the probabilities
// exp2(s * scale_log2 - m), one FFMA and one ex2 an entry; alpha is the
// factor that rescales the old l (here) and O (by the caller).
template <int NS>
__device__ __forceinline__ void softmax_p(float (&s)[NS], float (&m_run)[2],
                                          float (&l_run)[2],
                                          float (&alpha)[2], bool edge,
                                          int row0, int k0, int t4, int S,
                                          int window, float scale_log2) {
  if (edge) {
#pragma unroll
    for (int j = 0; j < NS / 4; ++j) {
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
  for (int i = 0; i < NS; ++i) {
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
  for (int i = 0; i < NS; ++i) {
    s[i] = ex2_approx(fmaf(s[i], scale_log2, neg_m[(i >> 1) & 1]));
    l_run[(i >> 1) & 1] += s[i];
  }
}

// The probabilities in bfloat16 as the A fragments of P V: the accumulator
// fragments of S are the A fragments, k-slice kk (keys 16 kk .. 16 kk + 15)
// in pa[4 kk .. 4 kk + 3].
template <int NS>
__device__ __forceinline__ void pack_p(const float (&s)[NS],
                                       uint32_t (&pa)[NS / 2]) {
#pragma unroll
  for (int i = 0; i < NS / 2; ++i) pa[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
}

// S = Q K^T over D / 16 k-slices: a k-slice is 32 bytes of a 128-byte row,
// four to a panel
template <int D>
__device__ __forceinline__ void issue_s(float (&s)[Tiling<D>::kS],
                                        uint32_t q_rows, uint32_t k_tile) {
  using T = Tiling<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    hopper::wgmma_ss<T::kBkv>(
        s,
        hopper::smem_desc(q_rows + (kk / 4) * T::kQPanel + col, 16, 1024, 1),
        hopper::smem_desc(k_tile + (kk / 4) * T::kKPanel + col, 16, 1024, 1),
        kk > 0);
  }
}

// O += P V over the tile's kBkv / 16 k-slices: one wgmma of N = kN per
// k-slice, or two (128 columns, then the rest) past 128
template <int D, int NA = Tiling<D>::kS / 2>
__device__ __forceinline__ void issue_pv(float (&acc)[Tiling<D>::kN / 2],
                                         const uint32_t (&pa)[NA],
                                         uint32_t v_tile) {
  using T = Tiling<D>;
  constexpr uint32_t kLayout = hopper::layout_of(T::kVRow);
#pragma unroll
  for (int kk = 0; kk < T::kBkv / 16; ++kk) {
    const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                           pa[4 * kk + 3]};
    const uint32_t rows = v_tile + kk * 16 * T::kVRow;
    if constexpr (T::kN <= 128) {
      hopper::wgmma_rs<T::kN>(
          acc, a, hopper::smem_desc(rows, T::kVPanel, 8 * T::kVRow, kLayout));
    } else {
      hopper::wgmma_rs<128>(
          acc, a, hopper::smem_desc(rows, T::kVPanel, 8 * T::kVRow, kLayout));
      hopper::wgmma_rs<T::kN - 128>(
          acc + 64, a,
          hopper::smem_desc(rows + 2 * T::kVPanel, T::kVPanel, 8 * T::kVRow,
                            kLayout));
    }
  }
}

// O's columns below D (the rest are zeros, never stored) to the new max.
// Tiling B skips it when no row of the warp raised its max (every alpha
// exactly 1, so the result is the same bit for bit): at 64-key tiles its
// D / 2 multiplies a thread outweigh the tile's 32 scores. At tiling A the
// vote cost more than it saved.
template <int D>
__device__ __forceinline__ void rescale(float (&acc)[Tiling<D>::kN / 2],
                                        const float (&alpha)[2]) {
  if constexpr (Tiling<D>::kBkv == 64) {
    if (__all_sync(kFull, alpha[0] == 1.f && alpha[1] == 1.f)) return;
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    acc[4 * j + 0] *= alpha[0];
    acc[4 * j + 1] *= alpha[0];
    acc[4 * j + 2] *= alpha[1];
    acc[4 * j + 3] *= alpha[1];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_hopper_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        __nv_bfloat16* __restrict__ o, int S, int H, int KV,
                        int window, float scale_log2) {
  using T = Tiling<D>;
  constexpr int kBkv = T::kBkv;
  extern __shared__ unsigned char smem_raw[];
  // the swizzle atoms must sit on 1024-byte boundaries of shared memory
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bar = base + T::kBar;
  const uint32_t q_full = bar;
  auto k_full = [&](int st) { return bar + 8u * (1 + 4 * st); };
  auto v_full = [&](int st) { return bar + 8u * (2 + 4 * st); };
  auto k_empty = [&](int st) { return bar + 8u * (3 + 4 * st); };
  auto v_empty = [&](int st) { return bar + 8u * (4 + 4 * st); };
  auto k_tile = [&](int st) {
    return base + T::kQBytes + st * T::kStageBytes;
  };
  auto v_tile = [&](int st) { return k_tile(st) + T::kKBytes; };

  const int q0 = (gridDim.x - 1 - (int)blockIdx.x) * kBq;  // longest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / KV);
  const int q_last = min(q0 + kBq, S) - 1;
  const int kv_first = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_lo = kv_first / kBkv;
  const int t_hi = q_last / kBkv;
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
      // transaction counts are whole boxes, TMA's zero-filled columns and
      // rows included
      hopper::mbar_arrive_tx(q_full, T::kQBytes);
      for (int p = 0; p < T::kPanels; ++p)
        hopper::tma_load_4d(base + p * T::kQPanel, &tm_q, q_full, 64 * p, h,
                            q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        const uint32_t free_parity = (i / kStages - 1) & 1;
        const int k0 = (t_hi - i) * kBkv;
        if (i >= kStages) hopper::mbar_wait(k_empty(st), free_parity);
        hopper::mbar_arrive_tx(k_full(st), T::kKBytes);
        for (int p = 0; p < T::kPanels; ++p)
          hopper::tma_load_4d(k_tile(st) + p * T::kKPanel, &tm_k, k_full(st),
                              64 * p, hk, k0, b);
        if (i >= kStages) hopper::mbar_wait(v_empty(st), free_parity);
        hopper::mbar_arrive_tx(v_full(st), T::kVBytes);
        for (int p = 0; p < T::kVPanels; ++p)
          hopper::tma_load_4d(v_tile(st) + p * T::kVPanel, &tm_v, v_full(st),
                              T::kVCols * p, hk, k0, b);
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
    const uint32_t q_rows = base + cw * 64 * 128;
    auto edge = [&](int k0) {
      return (k0 + kBkv - 1 > wg_row0) ||
             (window > 0 && wg_row0 + 63 - k0 >= window) || (k0 + kBkv > S);
    };

    float acc[T::kN / 2];
#pragma unroll
    for (int i = 0; i < T::kN / 2; ++i) acc[i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};
    float alpha[2] = {1.f, 1.f};
    float s[T::kS];
    uint32_t pa[T::kS / 2];

    // tile 0: S, its softmax, P
    hopper::mbar_wait(q_full, 0);
    hopper::mbar_wait(k_full(0), 0);
    hopper::wgmma_fence();
    issue_s<D>(s, q_rows, k_tile(0));
    hopper::wgmma_commit();
    hopper::fence_regs(s);
    hopper::wgmma_wait_all();
    hopper::fence_regs(s);
    hopper::mbar_arrive(k_empty(0));
    softmax_p(s, m_run, l_run, alpha, edge(t_hi * kBkv), row0, t_hi * kBkv,
              t4, S, window, scale_log2);
    pack_p(s, pa);

    for (int i = 1; i < n_tiles; ++i) {
      const int st = i % kStages;
      const int prev = (i - 1) % kStages;
      const int k0 = (t_hi - i) * kBkv;
      // O to tile i - 1's max, then S of tile i and P V of tile i - 1 in
      // flight together
      rescale<D>(acc, alpha);
      hopper::mbar_wait(k_full(st), (i / kStages) & 1);
      hopper::mbar_wait(v_full(prev), ((i - 1) / kStages) & 1);
      hopper::fence_regs(acc);
      hopper::fence_regs(pa);
      hopper::wgmma_fence();
      issue_s<D>(s, q_rows, k_tile(st));
      hopper::wgmma_commit();
      hopper::fence_regs(s);
      issue_pv<D>(acc, pa, v_tile(prev));
      hopper::wgmma_commit();
      hopper::fence_regs(acc);
      hopper::fence_regs(pa);
      // S done (the older group); P V may still run
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      hopper::fence_regs(s);
      hopper::mbar_arrive(k_empty(st));
      softmax_p(s, m_run, l_run, alpha, edge(k0), row0, k0, t4, S, window,
                scale_log2);
      hopper::wgmma_wait_all();
      hopper::fence_regs(acc);
      hopper::fence_regs(pa);
      hopper::mbar_arrive(v_empty(prev));
      pack_p(s, pa);
    }
    // P V of the last tile
    rescale<D>(acc, alpha);
    const int last = (n_tiles - 1) % kStages;
    hopper::mbar_wait(v_full(last), ((n_tiles - 1) / kStages) & 1);
    hopper::fence_regs(acc);
    hopper::fence_regs(pa);
    hopper::wgmma_fence();
    issue_pv<D>(acc, pa, v_tile(last));
    hopper::wgmma_commit();
    hopper::fence_regs(acc);
    hopper::wgmma_wait_all();
    hopper::fence_regs(acc);
    hopper::fence_regs(pa);

    // o = acc / l: the row sums over the four lanes of each row; only the
    // D / 8 column blocks below D are stored
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
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * t4) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r] / l_run[r],
                                  acc[4 * j + 2 * r + 1] / l_run[r]);
      }
    }
  }
}

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no -lcuda
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
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
// `cols` columns x 1 head x `rows` rows x 1, a swizzle as wide as a box row
// (cols * 2 bytes: 128, 64 or 32), zero fill past every dimension's end
inline bool tensor_map_bshd(EncodeTiledFn encode, CUtensorMap* map,
                            const void* ptr, int B, int S, int heads, int D,
                            int cols, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                 : (cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                               : CU_TENSOR_MAP_SWIZZLE_32B);
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, int KV, int window, float scale,
           cudaStream_t stream) {
  using T = Tiling<D>;
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!tensor_map_bshd(encode, &tm_q, q, B, S, H, D, 64, kBq) ||
      !tensor_map_bshd(encode, &tm_k, k, B, S, KV, D, 64, T::kBkv) ||
      !tensor_map_bshd(encode, &tm_v, v, B, S, KV, D, T::kVCols, T::kBkv)) {
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
  const int smem = T::kBytes + 1024;  // + alignment slack
  err = cudaFuncSetAttribute(flash_hopper_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kBq - 1) / kBq, H, B);
  flash_hopper_kernel<D><<<grid, kThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), S, H, KV, window,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

// The launches of one tiling, by D (flash_hopper_narrow.cu: 64 <= D <= 128,
// flash_hopper_wide.cu: 128 < D <= 256); cudaErrorInvalidValue for a D the
// source does not instantiate
int launch_narrow(const void* q, const void* k, const void* v, void* o,
                  int B, int S, int H, int KV, int D, int window,
                  float scale, cudaStream_t stream);
int launch_wide(const void* q, const void* k, const void* v, void* o, int B,
                int S, int H, int KV, int D, int window, float scale,
                cudaStream_t stream);

}  // namespace k8_hopper
