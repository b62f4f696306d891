// threefry2x32 on the device, bit-identical to jax.random and to
// repro_torch/rng.py: the hash, fold_in, and the word layout of one chunk of
// the chunk-quantized stream (DESIGN.md section 4) under both values of
// jax_threefry_partitionable.
//
// A chunk is bits(chunk_key, CHUNK) with CHUNK = 1024 * 128 words. Its words
// come in pairs (q, q + H), H = CHUNK / 2, q in [0, H):
//   partitionable: word i is y0 ^ y1 of threefry2x32(chunk_key, (0, i)), so a
//                  pair costs two hashes;
//   original:      word q is y0 and word q + H is y1 of
//                  threefry2x32(chunk_key, (q, q + H)), one hash for the pair.
// A kernel that walks the pair index q therefore reads both words of a hash in
// either layout, and a partial last chunk simply drops the words at or past
// its length (the stream truncates, it is not redrawn shorter).
//
// One hash is 20 rounds of add, rotate (one funnel shift) and xor, 5 key
// injections of two adds each, 2 initial adds and the parity word; for
// sm_90a nvcc issues its 20 rotates, 21 xors and about 7 of its adds (as
// three-input IADD3) to the INT32 pipe and the other adds as IMAD to the FMA
// pipe. No other header or library is needed.
#pragma once

#include <cstdint>

namespace threefry {

constexpr uint32_t kChunk = 1024u * 128u;   // CHUNK_ROWS * LANE words
constexpr uint32_t kHalf = kChunk / 2u;     // H: the pair distance
constexpr uint32_t kParity = 0x1BD11BDAu;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// threefry2x32 with 20 rounds, as jax._src.prng unrolls it.
__device__ __forceinline__ void hash(uint32_t k0, uint32_t k1, uint32_t x0,
                                     uint32_t x1, uint32_t& y0, uint32_t& y1) {
  const uint32_t k2 = k0 ^ k1 ^ kParity;
  x0 += k0;
  x1 += k1;
#define THREEFRY_ROUND(r) \
  x0 += x1;               \
  x1 = rotl(x1, r);       \
  x1 ^= x0;
  THREEFRY_ROUND(13) THREEFRY_ROUND(15) THREEFRY_ROUND(26) THREEFRY_ROUND(6)
  x0 += k1; x1 += k2 + 1u;
  THREEFRY_ROUND(17) THREEFRY_ROUND(29) THREEFRY_ROUND(16) THREEFRY_ROUND(24)
  x0 += k2; x1 += k0 + 2u;
  THREEFRY_ROUND(13) THREEFRY_ROUND(15) THREEFRY_ROUND(26) THREEFRY_ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  THREEFRY_ROUND(17) THREEFRY_ROUND(29) THREEFRY_ROUND(16) THREEFRY_ROUND(24)
  x0 += k1; x1 += k2 + 4u;
  THREEFRY_ROUND(13) THREEFRY_ROUND(15) THREEFRY_ROUND(26) THREEFRY_ROUND(6)
  x0 += k2; x1 += k0 + 5u;
#undef THREEFRY_ROUND
  y0 = x0;
  y1 = x1;
}

// jax.random.fold_in: the key hashed with the counter (0, data), both words.
__device__ __forceinline__ void fold_in(uint32_t k0, uint32_t k1,
                                        uint32_t data, uint32_t& f0,
                                        uint32_t& f1) {
  hash(k0, k1, 0u, data, f0, f1);
}

// Words q and q + H of the chunk keyed (k0, k1). With need_b false only word
// q is needed (the partial last chunk ends before q + H), which saves the
// second hash of the partitionable layout.
__device__ __forceinline__ void chunk_pair(uint32_t k0, uint32_t k1,
                                           uint32_t q, bool partitionable,
                                           bool need_b, uint32_t& wa,
                                           uint32_t& wb) {
  uint32_t y0, y1;
  if (partitionable) {
    hash(k0, k1, 0u, q, y0, y1);
    wa = y0 ^ y1;
    wb = 0u;
    if (need_b) {
      hash(k0, k1, 0u, q + kHalf, y0, y1);
      wb = y0 ^ y1;
    }
  } else {
    hash(k0, k1, q, q + kHalf, y0, y1);
    wa = y0;
    wb = y1;
  }
}

// Words q and q + half of bits(key, len) for any len, half = ceil(len / 2)
// (a chunk is the case len = kChunk, half = kHalf). In the original layout
// the counter iota is zero-padded to even length, so the pair of the last
// q of an odd len hashes (q, 0). need_a / need_b say which words the caller
// keeps; the partitionable layout hashes only those.
__device__ __forceinline__ void stream_pair(uint32_t k0, uint32_t k1,
                                            uint32_t q, uint32_t half,
                                            uint32_t len, bool partitionable,
                                            bool need_a, bool need_b,
                                            uint32_t& wa, uint32_t& wb) {
  uint32_t y0, y1;
  wa = 0u;
  wb = 0u;
  if (partitionable) {
    if (need_a) {
      hash(k0, k1, 0u, q, y0, y1);
      wa = y0 ^ y1;
    }
    if (need_b) {
      hash(k0, k1, 0u, q + half, y0, y1);
      wb = y0 ^ y1;
    }
  } else {
    hash(k0, k1, q, q + half < len ? q + half : 0u, y0, y1);
    wa = y0;
    wb = y1;
  }
}

}  // namespace threefry
