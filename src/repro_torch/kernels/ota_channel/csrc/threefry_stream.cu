// The channel's stream words drawn on the card: every simulator, bank and
// distributed path draws its gain and noise words here when its tensors lie
// on the card (kernels/ota_channel/ops.py: chunk_stream, chunked_stream,
// stream_range, bits).
//
// Two forms, both bit-identical to repro_torch/rng.py and so to jax.random in
// either jax_threefry_partitionable layout, through threefry.cuh's fold_in and
// stream_pair:
//   chunked: words [start, start + length) of each key's chunk-quantized
//            stream (DESIGN.md section 4): word i lies in chunk j = i / CHUNK
//            and is bits(fold_in(key, j), CHUNK)[i % CHUNK];
//   flat:    bits(key, n) for any n, the whole draw (K7's padded slab words
//            and the seeded init's normal leaves).
// It is not a port of a TPU kernel: the reference draws these words with
// XLA (ota.stream_range_bits), and K4 draws the same words inside its own
// kernel (ota_aggregate_fused.cu).
//
// Bound: integer operations. A word costs one threefry2x32 hash in the
// partitionable layout (half a hash in the original one), 48 INT32-pipe
// operations each (the count of K4's bound, from the SASS of the hash:
// python -m repro_torch.kernels.sass_mix threefry), and 4 bytes written. The paper round's 43.3 M words are 2.08 G
// operations, 0.124 ms at 132 SMs x 64 lanes x 1.98 GHz, against 0.052 ms of
// writes at 3.35 TB/s.
// Design: one launch covers K keys (grid.y) and every chunk the range meets
// (grid.x). A block walks 1024 word pairs (q, q + H) of one chunk, H its half
// length, so both words of an original-layout hash are kept and the stores of
// each half are coalesced. Its chunk key is hashed once, into shared memory;
// words outside the range are neither hashed (partitionable) nor stored.
#include <cstdint>
#include <cuda_runtime.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPairsPerThread = 4;
constexpr uint32_t kPairsPerBlock = kThreads * kPairsPerThread;
constexpr uint32_t kBlocksPerChunk = threefry::kHalf / kPairsPerBlock;

__global__ void __launch_bounds__(kThreads)
    threefry_chunked_kernel(const int32_t* __restrict__ keys, int64_t start,
                            int64_t length, int64_t out_stride,
                            int partitionable, int32_t* __restrict__ out) {
  __shared__ uint32_t ckey[2];
  const int k = blockIdx.y;
  const int64_t chunk = start / threefry::kChunk + blockIdx.x / kBlocksPerChunk;
  const uint32_t q0 = (blockIdx.x % kBlocksPerChunk) * kPairsPerBlock;
  const int64_t base = chunk * threefry::kChunk;
  const int64_t end = start + length;
  // the block's words: [base + q0, + ppb) and [base + H + q0, + ppb)
  const bool lo_in = base + q0 + kPairsPerBlock > start && base + q0 < end;
  const bool hi_in = base + threefry::kHalf + q0 + kPairsPerBlock > start &&
                     base + threefry::kHalf + q0 < end;
  if (!lo_in && !hi_in) return;
  if (threadIdx.x == 0) {
    threefry::fold_in((uint32_t)keys[2 * k], (uint32_t)keys[2 * k + 1],
                      (uint32_t)chunk, ckey[0], ckey[1]);
  }
  __syncthreads();
  const uint32_t c0 = ckey[0], c1 = ckey[1];
  const bool part = partitionable != 0;
  int32_t* row = out + (int64_t)k * out_stride;
#pragma unroll
  for (int p = 0; p < kPairsPerThread; ++p) {
    const uint32_t q = q0 + p * kThreads + threadIdx.x;
    const int64_t ia = base + q;
    const int64_t ib = ia + threefry::kHalf;
    const bool need_a = ia >= start && ia < end;
    const bool need_b = ib >= start && ib < end;
    if (!need_a && !need_b) continue;
    uint32_t wa, wb;
    threefry::stream_pair(c0, c1, q, threefry::kHalf, threefry::kChunk, part,
                          need_a, need_b, wa, wb);
    if (need_a) row[ia - start] = (int32_t)wa;
    if (need_b) row[ib - start] = (int32_t)wb;
  }
}

__global__ void __launch_bounds__(kThreads)
    threefry_flat_kernel(const int32_t* __restrict__ keys, int64_t n,
                         int64_t out_stride, int partitionable,
                         int32_t* __restrict__ out) {
  const int k = blockIdx.y;
  const uint32_t half = (uint32_t)((n + 1) / 2);
  const uint32_t k0 = (uint32_t)keys[2 * k], k1 = (uint32_t)keys[2 * k + 1];
  const bool part = partitionable != 0;
  int32_t* row = out + (int64_t)k * out_stride;
  const int64_t q0 = (int64_t)blockIdx.x * kPairsPerBlock;
#pragma unroll
  for (int p = 0; p < kPairsPerThread; ++p) {
    const int64_t q = q0 + p * kThreads + threadIdx.x;
    if (q >= half) break;
    const bool need_b = q + half < n;
    uint32_t wa, wb;
    threefry::stream_pair(k0, k1, (uint32_t)q, half, (uint32_t)n, part, true,
                          need_b, wa, wb);
    row[q] = (int32_t)wa;
    if (need_b) row[q + half] = (int32_t)wb;
  }
}

}  // namespace

// keys: (n_keys, 2) int32 bit patterns; out: rows of out_stride words
extern "C" int threefry_chunked_u32(const int32_t* keys, int n_keys,
                                    int64_t start, int64_t length,
                                    int64_t out_stride, int partitionable,
                                    int32_t* out, cudaStream_t stream) {
  if (length <= 0 || n_keys <= 0) return 0;
  const int64_t j0 = start / threefry::kChunk;
  const int64_t j1 = (start + length - 1) / threefry::kChunk;
  const dim3 grid((unsigned)((j1 - j0 + 1) * kBlocksPerChunk),
                  (unsigned)n_keys);
  threefry_chunked_kernel<<<grid, kThreads, 0, stream>>>(
      keys, start, length, out_stride, partitionable, out);
  return (int)cudaGetLastError();
}

extern "C" int threefry_flat_u32(const int32_t* keys, int n_keys, int64_t n,
                                 int64_t out_stride, int partitionable,
                                 int32_t* out, cudaStream_t stream) {
  if (n <= 0 || n_keys <= 0) return 0;
  const int64_t half = (n + 1) / 2;
  const dim3 grid((unsigned)((half + kPairsPerBlock - 1) / kPairsPerBlock),
                  (unsigned)n_keys);
  threefry_flat_kernel<<<grid, kThreads, 0, stream>>>(keys, n, out_stride,
                                                      partitionable, out);
  return (int)cudaGetLastError();
}
