// Philox4x32-10 dropout masks, the CUDA twin of mgsv_tpu_torch/ops/philox.py
// (bit-identical draws): element e of stream (a, b) under `seed` is word
// e & 3 of Philox4x32-10(counter (e >> 2, a, b, 0), key (seed, 0)); it is
// kept when that word >= thresh and then scaled by `scale` = 1 / (1 - rate).
// A mask is never stored: each use site, forward or backward, draws again.
#pragma once

#include <cuda_runtime.h>

struct Dropout {
  unsigned seed;
  unsigned thresh;   // 0: no dropout
  float scale;
};

__device__ __forceinline__ unsigned philox_word(unsigned seed, unsigned a, unsigned b,
                                                unsigned e) {
  unsigned c0 = e >> 2, c1 = a, c2 = b, c3 = 0u, k0 = seed, k1 = 0u;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const unsigned lo0 = 0xD2511F53u * c0, hi0 = __umulhi(0xD2511F53u, c0);
    const unsigned lo1 = 0xCD9E8D57u * c2, hi1 = __umulhi(0xCD9E8D57u, c2);
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  switch (e & 3u) {
    case 0: return c0;
    case 1: return c1;
    case 2: return c2;
    default: return c3;
  }
}

// The mask value of element e of stream (a, b): 0, or d.scale (1 at rate 0).
__device__ __forceinline__ float keep(const Dropout& d, unsigned a, unsigned b, unsigned e) {
  if (d.thresh == 0u) return 1.f;
  return philox_word(d.seed, a, b, e) >= d.thresh ? d.scale : 0.f;
}
