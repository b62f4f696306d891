// Masked L2 gradient norms, one per (cluster, task) row (paper eq. 6).
//
// Replaces the TPU kernel masked_gradnorm_pallas
// (src/repro/kernels/masked_gradnorm/kernel.py, body _gradnorm_kernel),
// which the simulator vmaps over the clusters. Here one launch covers all
// C*T rows, each against its cluster's mask row:
//   out[c, t] = sqrt( sum_p (g[c, t, p] * mask[c, p])^2 )
//
// Bound: device memory. Each row's P gradient words are read once and each
// mask row once: 21.0 MB for the paper round (C=10, T=3, P=131328), 6.3 us
// at 3.35 TB/s.
// Design: rows are split. A 1-D grid of C * splits * T blocks, the tasks of
// one (cluster, segment) adjacent, so a mask segment is read from device
// memory once and from L2 by the other tasks; splits is chosen by the
// wrapper from the SM count so that every SM holds several blocks. A block
// reads its segment with float4 loads, four pairs in flight per thread,
// when P and the base pointers allow (scalar loads otherwise), sums
// (g * m)^2 in float32 registers, reduces with warp shuffles and one
// shared-memory pass, and writes one partial. The last
// block of a row to finish (a __threadfence and a per-row ticket) adds the
// row's partials in index order, writes the square root and resets the
// ticket for the next launch. Every sum has a fixed order, so two launches
// give the same bits. No atomics touch the values.
//
// masked_gradnorm_rowblock_f32 is the design this replaced (one block per
// row, C*T blocks, scalar loads), kept callable so that a run on the card
// can time both.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

// The block's float32 sum of v over its threads, in a fixed order; thread 0
// gets the result.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[32];
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? warp_sums[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1) {
      v += __shfl_down_sync(0xffffffffu, v, off);
    }
  }
  return v;
}

__global__ void __launch_bounds__(kThreads) masked_gradnorm_split_kernel(
    const float* __restrict__ g, const float* __restrict__ mask,
    float* __restrict__ partial, unsigned* __restrict__ tickets,
    float* __restrict__ out, int64_t P, int n_tasks, int splits, int64_t seg,
    bool vec) {
  const int t = blockIdx.x % n_tasks;
  const int s = (blockIdx.x / n_tasks) % splits;
  const int c = blockIdx.x / (n_tasks * splits);
  const int row = c * n_tasks + t;
  const int64_t lo = (int64_t)s * seg;
  const int64_t hi = lo + seg < P ? lo + seg : P;
  const float* gr = g + (int64_t)row * P;
  const float* mr = mask + (int64_t)c * P;
  float acc = 0.0f;
  if (vec) {
    // lo, hi and P are multiples of 4 and the bases 16-byte aligned; each
    // thread keeps kUnroll float4 pairs in flight
    const float4* g4 = reinterpret_cast<const float4*>(gr + lo);
    const float4* m4 = reinterpret_cast<const float4*>(mr + lo);
    const int64_t n4 = hi > lo ? (hi - lo) / 4 : 0;
    for (int64_t i0 = threadIdx.x; i0 < n4; i0 += kUnroll * kThreads) {
      float4 a[kUnroll], m[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t i = i0 + u * kThreads;
        a[u] = i < n4 ? __ldg(g4 + i) : make_float4(0.f, 0.f, 0.f, 0.f);
        m[u] = i < n4 ? __ldg(m4 + i) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float x = a[u].x * m[u].x, y = a[u].y * m[u].y;
        const float z = a[u].z * m[u].z, w = a[u].w * m[u].w;
        acc += x * x;
        acc += y * y;
        acc += z * z;
        acc += w * w;
      }
    }
  } else {
    for (int64_t k = lo + threadIdx.x; k < hi; k += kThreads) {
      const float v = gr[k] * mr[k];
      acc += v * v;
    }
  }
  acc = block_sum(acc);

  __shared__ bool last;
  if (threadIdx.x == 0) {
    partial[(int64_t)row * splits + s] = acc;
    __threadfence();
    last = atomicAdd(&tickets[row], 1u) == (unsigned)(splits - 1);
  }
  __syncthreads();
  if (last && threadIdx.x == 0) {
    __threadfence();
    float sum = 0.0f;
    for (int k = 0; k < splits; ++k) {
      sum += __ldcg(partial + (int64_t)row * splits + k);
    }
    out[row] = sqrtf(sum);
    tickets[row] = 0u;
  }
}

__global__ void masked_gradnorm_rowblock_kernel(const float* __restrict__ g,
                                                const float* __restrict__ mask,
                                                float* __restrict__ out,
                                                int64_t P, int n_tasks) {
  const int row = blockIdx.x;
  const int c = row / n_tasks;
  const float* gr = g + (int64_t)row * P;
  const float* mr = mask + (int64_t)c * P;
  float acc = 0.0f;
  for (int64_t k = threadIdx.x; k < P; k += blockDim.x) {
    const float v = gr[k] * mr[k];
    acc += v * v;
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) out[row] = sqrtf(acc);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// partial: (C*T*splits,) float32 scratch; tickets: (C*T,) zeros, left zero
extern "C" int masked_gradnorm_f32(const float* g, const float* mask,
                                   float* partial, unsigned* tickets,
                                   float* out, int64_t P, int n_clusters,
                                   int n_tasks, int splits,
                                   cudaStream_t stream) {
  if (splits < 1) return (int)cudaErrorInvalidValue;
  const bool vec = P % 4 == 0 && aligned16(g) && aligned16(mask);
  int64_t seg = (P + splits - 1) / splits;
  if (vec) seg = (seg + 3) / 4 * 4;
  const int64_t blocks = (int64_t)n_clusters * n_tasks * splits;
  masked_gradnorm_split_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      g, mask, partial, tickets, out, P, n_tasks, splits, seg, vec);
  return (int)cudaGetLastError();
}

extern "C" int masked_gradnorm_rowblock_f32(const float* g, const float* mask,
                                            float* out, int64_t P,
                                            int n_clusters, int n_tasks,
                                            cudaStream_t stream) {
  masked_gradnorm_rowblock_kernel<<<n_clusters * n_tasks, 512, 0, stream>>>(
      g, mask, out, P, n_tasks);
  return (int)cudaGetLastError();
}
