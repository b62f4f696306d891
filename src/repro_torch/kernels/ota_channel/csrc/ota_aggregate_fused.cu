// Slab OTA estimator for one packed section with its stream words drawn in
// the kernel (paper eqs. 7-10): K4.
//
// Replaces the TPU kernel ota_aggregate_fused_pallas
// (src/repro/kernels/ota_channel/kernel.py; interpret-mode bodies
// _ota_aggregate_interp_kernel and _ota_aggregate_supplied_kernel, the shared
// _fused_body, the chunk draw _interp_chunk_bits). Its compiled TPU branch
// seeds the TPU's hardware PRNG (tpu_hw_seed, _hw_chunk_bits), a different
// stream that Hopper does not have: those are not ported. Here the kernel runs
// threefry2x32 (threefry.cuh) and draws exactly the words of the
// chunk-quantized stream, so it is bit-exact to the oracle in both
// jax_threefry_partitionable layouts:
//   gain word i of cluster l, chunk j: bits(fold_in(fold_in(gain_key, l), j),
//                                           CHUNK)[i]
//   noise word i, chunk j:             bits(fold_in(noise_key, j), CHUNK)[i]
// with CHUNK = 131072 words and a partial last chunk truncated.
//
// The estimate per entry is K3's (ota_estimate.cuh, the same device code), so
// on the same words K3 and K4 agree bit for bit.
//
// Bound: integer operations. The kernel moves 4 * (C + 1) bytes per entry
// (C weighted-gradient words in, one output word out): 44 bytes at C = 10,
// about 0.17 GB for the paper model, 0.05 ms at 3.35 TB/s. But it hashes
// (C + 1) words per entry, one threefry2x32 per word in the partitionable
// layout and one per word pair in the original one. nvcc issues a hash as
// 20 rotates (SHF), 21 xors (LOP3) and 7 three-input adds (IADD3) on the
// INT32 pipe (64 lanes per SM) and its other adds as IMAD on the FMA pipe:
// 48 INT32 operations per hash, about 2.1 G for the paper model in the
// partitionable layout, 0.12 ms at 132 SMs x 64 lanes x 1.98 GHz (0.06 ms
// in the original layout; the rotates and xors alone, 0.11 and 0.05 ms).
// Design: a block never straddles a chunk. Block k of chunk j walks the pair
// index q of 512 word pairs (q, q + H), H = CHUNK / 2, so both words of an
// original-layout hash are used and loads stay coalesced in both halves; 128
// blocks cover a chunk, and blocks past a partial chunk's end return at once.
// Each block derives its C + 1 chunk keys (two fold_ins for a gain key, one for
// the noise key) into shared memory once; each thread then hashes its words
// and folds the clusters in order l = 0 .. C-1. The params row and p_pass
// stay device data. No (C, n) bits buffer is ever written.
#include <cstdint>
#include <cuda_runtime.h>

#include "ota_estimate.cuh"
#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPairsPerThread = 2;
constexpr uint32_t kPairsPerBlock = kThreads * kPairsPerThread;
constexpr uint32_t kBlocksPerChunk = threefry::kHalf / kPairsPerBlock;

__global__ void __launch_bounds__(kThreads) ota_aggregate_fused_kernel(
    const float* __restrict__ wg,       // (C, >= n), row stride wg_stride
    int64_t wg_stride, uint32_t gk0, uint32_t gk1, uint32_t nk0, uint32_t nk1,
    const float* __restrict__ params,   // (C + 3,)
    const float* __restrict__ p_pass,   // (C,)
    float* __restrict__ out,            // (n,)
    int64_t n, int n_clusters, int n_clients, int partitionable) {
  extern __shared__ uint32_t smem[];
  uint32_t* keys = smem;                                 // (C + 1, 2)
  float* pp = (float*)(smem + 2 * (n_clusters + 1));     // (C,)

  const uint32_t chunk = blockIdx.x / kBlocksPerChunk;
  const uint32_t q0 = (blockIdx.x % kBlocksPerChunk) * kPairsPerBlock;
  const int64_t base = (int64_t)chunk * threefry::kChunk;
  const int64_t rest = n - base;
  const uint32_t len =
      rest < (int64_t)threefry::kChunk ? (uint32_t)rest : threefry::kChunk;
  if (q0 >= len) return;  // the whole block lies past the stream's end

  for (int k = threadIdx.x; k <= n_clusters; k += blockDim.x) {
    uint32_t c0, c1;
    if (k < n_clusters) {
      threefry::fold_in(gk0, gk1, (uint32_t)k, c0, c1);
    } else {
      c0 = nk0;
      c1 = nk1;
    }
    threefry::fold_in(c0, c1, chunk, keys[2 * k], keys[2 * k + 1]);
  }
  for (int k = threadIdx.x; k < n_clusters; k += blockDim.x) {
    pp[k] = p_pass[k];
  }
  __syncthreads();

  const float noise_std = params[n_clusters + 1];
  const float ota_on = params[n_clusters + 2];
  const bool off = ota_on < 0.5f;
  const float n_cl = (float)n_clients;
  const bool part = partitionable != 0;
  const uint32_t* nkey = keys + 2 * n_clusters;

  for (int p = 0; p < kPairsPerThread; ++p) {
    const uint32_t q = q0 + p * kThreads + threadIdx.x;
    if (q >= len) break;
    const bool has_b = q + threefry::kHalf < len;
    const int64_t ja = base + q;
    const int64_t jb = ja + threefry::kHalf;
    ota::Acc a = ota::acc_init();
    ota::Acc b = ota::acc_init();
    for (int l = 0; l < n_clusters; ++l) {
      uint32_t wa, wb;
      threefry::chunk_pair(keys[2 * l], keys[2 * l + 1], q, part, has_b, wa,
                           wb);
      const float* row = wg + (int64_t)l * wg_stride;
      ota::acc_add(a, wa, pp[l], off, row[ja]);
      if (has_b) ota::acc_add(b, wb, pp[l], off, row[jb]);
    }
    uint32_t na, nb;
    threefry::chunk_pair(nkey[0], nkey[1], q, part, has_b, na, nb);
    out[ja] = ota::finish(a, na, noise_std, ota_on, n_cl);
    if (has_b) out[jb] = ota::finish(b, nb, noise_std, ota_on, n_cl);
  }
}

}  // namespace

extern "C" int ota_aggregate_fused_f32(
    const float* wg, int64_t wg_stride, uint32_t gk0, uint32_t gk1,
    uint32_t nk0, uint32_t nk1, const float* params, const float* p_pass,
    float* out, int64_t n, int n_clusters, int n_clients, int partitionable,
    cudaStream_t stream) {
  const int64_t n_chunks = (n + threefry::kChunk - 1) / threefry::kChunk;
  const int64_t grid = n_chunks * kBlocksPerChunk;
  const size_t smem = sizeof(uint32_t) * (size_t)(3 * n_clusters + 2);
  ota_aggregate_fused_kernel<<<(unsigned)grid, kThreads, smem, stream>>>(
      wg, wg_stride, gk0, gk1, nk0, nk1, params, p_pass, out, n, n_clusters,
      n_clients, partitionable);
  return (int)cudaGetLastError();
}
