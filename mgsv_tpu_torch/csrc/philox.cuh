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

// The four words of Philox4x32-10(counter (c, a, b, 0), key (seed, 0)):
// elements 4 c .. 4 c + 3 of stream (a, b).
__device__ __forceinline__ uint4 philox4(unsigned seed, unsigned a, unsigned b, unsigned c) {
  unsigned c0 = c, c1 = a, c2 = b, c3 = 0u, k0 = seed, k1 = 0u;
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
  return make_uint4(c0, c1, c2, c3);
}

__device__ __forceinline__ unsigned word_of(const uint4& w, unsigned i) {
  switch (i & 3u) {
    case 0: return w.x;
    case 1: return w.y;
    case 2: return w.z;
    default: return w.w;
  }
}

__device__ __forceinline__ unsigned philox_word(unsigned seed, unsigned a, unsigned b,
                                                unsigned e) {
  return word_of(philox4(seed, a, b, e >> 2), e);
}

// The mask value of element e of stream (a, b): 0, or d.scale (1 at rate 0).
__device__ __forceinline__ float keep(const Dropout& d, unsigned a, unsigned b, unsigned e) {
  if (d.thresh == 0u) return 1.f;
  return philox_word(d.seed, a, b, e) >= d.thresh ? d.scale : 0.f;
}

// The mask values of elements e and e + 1 of stream (a, b): one Philox
// call when both lie in one group of four (e even), two otherwise.
__device__ __forceinline__ void keep2(const Dropout& d, unsigned a, unsigned b, unsigned e,
                                      float& k0, float& k1) {
  if (d.thresh == 0u) {
    k0 = k1 = 1.f;
    return;
  }
  const uint4 w = philox4(d.seed, a, b, e >> 2);
  k0 = word_of(w, e) >= d.thresh ? d.scale : 0.f;
  const unsigned w1 = (e & 3u) != 3u ? word_of(w, e + 1) : philox_word(d.seed, a, b, e + 1);
  k1 = w1 >= d.thresh ? d.scale : 0.f;
}
