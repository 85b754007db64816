// X-Pool pooled cosine similarity for Hopper (sm_90a): the training
// forward and backward, and the evaluation forward.
//
// Replaces the Pallas TPU kernels of mgsv_tpu/ops/pallas/xpool_sim_vjp.py:
// _core_fwd (kernel _fwd_kernel) and _core_bwd (kernel _bwd_kernel), the
// custom VJP of _xpool_core; and of mgsv_tpu/ops/pallas/xpool_sim.py:
// xpool_sim_fused (kernel _xpool_sim_kernel), the corpus similarity of an
// evaluation, which is the same forward at dropout rate 0 (mgsv_xpool_sim_fwd
// with threshold 0 launches xpool_fwd_kernel<false>, which has no dropout
// code compiled in).  For every (music m, video v) pair the pair
// stage (_pair_stage_fwd) computes
//
//   p    = softmax_s(q_v . k_m[s] / sqrt(D), masked snippets -> -1e9)   [S]
//   h    = LN2(p v_m Wout^T + bout)
//   o    = LN3(h + drop_(m,v)(h Wlin^T + blin))
//   sim  = <o / |o|, vhat_v>
//
// with weights in torch's [out, in] layout and the dropout mask of pair
// (m, v), channel d drawn from philox.cuh (stream (m, v), element d).
//
// What bounds it on the card: the pair stage is 360,448 FLOP per pair as the
// forward does it, 94.5 GFLOP at V = M = 512, against inputs of a few MB:
// the arithmetic bounds it (an evaluation over V = M = 2,048 is 1.5 TFLOP
// as this kernel does it; applying Wout to v once per track instead of once
// per pair would make it 0.99).  The forward keeps everything O(M V D) out
// of device memory: a block takes one music and 64 videos, and runs the
// four products of the stage (scores, p v_m, Wout, Wlin) as 3xTF32
// tensor-core tiles (tf32_tile.cuh) on two [64, 256] shared-memory tiles,
// with Wout and Wlin (256 KB each, more than the 227 KB a block may hold)
// streamed through it in 32-deep K-slices, as the encoder layer's FFN
// streams its weights.
//
// The backward (mgsv_xpool_sim_bwd, float32 as JAX's _core_bwd) takes
// Wout once per track, not per pair: Wout acts linearly on the softmax-
// weighted sum before bout and LN2, so Wout (sum_s p_s v_ms) + bout =
// sum_s p_s u_ms + bout with u_m = v_m Wout^T, and dWout = sum du_m^T v_m,
// dv_m = du_m Wout with du_m = sum_v p_mv^T dpre_mv: the least work,
// 2 x 66.7 GFLOP at V = M = 512.  It runs the pairs a chunk of G musics at
// a time (G V near kChunkPairs: 128 musics at V = 512), every product on
// the wgmma core of wgmma_gemm.cuh in 3xTF32 (batched over the chunk's
// musics where a product is per music: scores q k_m^T, p u_m, dpre u_m^T,
// p^T dpre, ds^T q, ds k_m), the row-wise steps (softmax, LN2, LN3 with the
// cosine, their backwards) one warp per pair row, and the linear branch's
// dropout in the Wlin product's epilogue.  Only a chunk's pair tensors
// ([G V, D] floats, about 67 MB each) are ever in device memory.  dq and
// dvhat sum over musics, the weight and vector gradients over pairs: each
// chunk sums its musics in order (dq, dvhat) or its rows in 1024-row
// slices (the GEMM core's split-K and the column sums), and the chunks'
// partials are summed in chunk order, so a step is reproducible from run
// to run (no atomics).  Ragged V, M and S are TMA's zero fill and the
// epilogues' bounds.

#include <algorithm>

#include "layer_bwd_kernels.cuh"

namespace {

constexpr int kVecs = 6;              // the vector gradients: dg3, db3, dblin, dg2, db2, dbout

struct Pair {
  const float *q, *k, *v, *mask, *vhat;
  const float *wout, *bout, *g2, *b2, *wlin, *blin, *g3, *b3;
  int V, S;
  Dropout drop;
};

// Per-block shared memory of the forward: two activation tiles, the weight
// staging ring and per-row statistics.
struct Smem {
  float *t0, *t1, *ws, *inv_n, *sim;
};

__device__ Smem carve(float* base) {
  Smem s;
  s.t0 = base;
  s.t1 = s.t0 + kTileFloats;
  s.ws = s.t1 + kTileFloats;
  s.inv_n = s.ws + 2 * kWsFloats;
  s.sim = s.inv_n + kRows;
  return s;
}

constexpr size_t kSmemBytes = sizeof(float) * (size_t)(2 * kTileFloats + 2 * kWsFloats + 2 * kRows);

__host__ __device__ constexpr int pad32(int n) { return (n + 31) & ~31; }

// The pair stage of music m and videos v0 .. v0+63: leaves o = LN3(...) in
// t0 and h in t1, |o|^-1 and the similarity per row in inv_n and sim.
// kDrop = false compiles the dropout test out of the Wlin epilogue (rate 0:
// evaluation).
template <bool kDrop>
__device__ void pair_forward(const Pair& a, int m, int v0, const Smem& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int S = a.S, sp = pad32(S);
  const float scale = rsqrtf((float)kCols);
  const float* k_m = a.k + (size_t)m * S * kCols;
  const float* v_m = a.v + (size_t)m * S * kCols;
  const float* mask_m = a.mask + (size_t)m * S;
  Acc acc;

  // scores = q k_m^T / sqrt(D), masked; softmax over the S snippets
  load_rows(s.t0, a.q, nullptr, v0, a.V);
  zero(acc);
  gemm(acc, s.t0, k_m, kCols, 0, kCols, s.ws, S);
  for_each_acc(acc, [&](int r, int c, float& x) {
    s.t1[r * kLda + c] = c < S ? (mask_m[c] != 0.f ? x * scale : kBigNeg) : 0.f;
  });
  __syncthreads();
  for (int r = warp; r < kRows; r += kWarps) {
    float* row = s.t1 + r * kLda;
    float mx = -INFINITY;
    for (int c = lane; c < S; c += 32) mx = fmaxf(mx, row[c]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int c = lane; c < S; c += 32) {
      const float e = expf(row[c] - mx);
      row[c] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int c = lane; c < S; c += 32) row[c] /= sum;
  }
  __syncthreads();

  // ctx = p v_m
  zero(acc);
  gemm_t(acc, s.t1, v_m, kCols, 0, sp, S, s.ws);
  for_each_acc(acc, [&](int r, int c, float& x) { s.t0[r * kLda + c] = x; });
  __syncthreads();

  // h = LN2(ctx Wout^T + bout)
  zero(acc);
  gemm(acc, s.t0, a.wout, kCols, 0, kCols, s.ws);
  for_each_acc(acc, [&](int r, int c, float& x) { s.t1[r * kLda + c] = x + a.bout[c]; });
  __syncthreads();
  layer_norm_rows(s.t1, a.g2, a.b2);

  // o = LN3(h + drop(h Wlin^T + blin))
  zero(acc);
  gemm(acc, s.t1, a.wlin, kCols, 0, kCols, s.ws);
  for_each_acc(acc, [&](int r, int c, float& x) {
    float lin = x + a.blin[c];
    if constexpr (kDrop) lin *= keep(a.drop, m, v0 + r, c);
    s.t0[r * kLda + c] = lin + s.t1[r * kLda + c];
  });
  __syncthreads();
  layer_norm_rows(s.t0, a.g3, a.b3);

  // sim = <o / |o|, vhat>
  for (int r = warp; r < kRows; r += kWarps) {
    const float* row = s.t0 + r * kLda;
    const bool valid = v0 + r < a.V;
    const float* vh = a.vhat + (size_t)(v0 + r) * kCols;
    float n2 = 0.f, dot = 0.f;
    for (int c = lane; c < kCols; c += 32) {
      n2 = fmaf(row[c], row[c], n2);
      if (valid) dot = fmaf(row[c], vh[c], dot);
    }
    const float inv_n = rsqrtf(fmaxf(warp_sum(n2), 1e-24f));
    dot = warp_sum(dot);
    if (lane == 0) {
      s.inv_n[r] = inv_n;
      s.sim[r] = dot * inv_n;
    }
  }
  __syncthreads();
}

// sims [M, V]: grid (ceil(V / 64), M).
template <bool kDrop>
__global__ void __launch_bounds__(kThreads, 1) xpool_fwd_kernel(Pair a, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  const Smem s = carve(reinterpret_cast<float*>(smem4));
  const int v0 = blockIdx.x * kRows, m = blockIdx.y;
  pair_forward<kDrop>(a, m, v0, s);
  for (int r = threadIdx.x; r < kRows; r += kThreads)
    if (v0 + r < a.V) out[(size_t)m * a.V + v0 + r] = s.sim[r];
}

bool bad_shape(int V, int M, int S, int D) {
  return V < 1 || M < 1 || M > 65535 || S < 1 || S > kCols || D != kCols;
}

void launch_fwd(const Pair& a, float* out, int M, cudaStream_t stream) {
  const dim3 grid((a.V + kRows - 1) / kRows, M);
  if (a.drop.thresh != 0u)
    xpool_fwd_kernel<true><<<grid, kThreads, kSmemBytes, stream>>>(a, out);
  else
    xpool_fwd_kernel<false><<<grid, kThreads, kSmemBytes, stream>>>(a, out);
}

// ---- the backward (xpool_sim_bwd): launches on the GEMM core of
// wgmma_gemm.cuh, music chunk by music chunk

// Pair rows per chunk: a chunk takes G = max(1, kChunkPairs / V) musics, so
// its pair tensors ([G V, D] floats) stay near 67 MB.
constexpr int kChunkPairs = 65536;

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

inline int chunk_musics(int V, int M) { return std::max(1, std::min(M, kChunkPairs / V)); }

// Scores of a chunk: out[z][v][s] = q_v . k_(m0 + z)s / sqrt(D), a masked
// snippet at -1e9 (row stride ld >= S).
struct ScoreEpi {
  float* out;
  const float* mask;     // [M, S] from music m0
  int V, S, ld;
  float scale;
  static constexpr bool kWarpKeep = false;
  struct In {};
  __device__ In load(int, int) const { return {}; }
  __device__ void operator()(int z, int r, int c, float v) const {
    out[((size_t)z * V + r) * ld + c] = mask[(size_t)z * S + c] != 0.f ? v * scale : kBigNeg;
  }
  __device__ void pair(int z, int r, int c, float v0, float v1, In, const float (&)[2]) const {
    (*this)(z, r, c, v0);
    (*this)(z, r, c + 1, v1);
  }
};

// out[z][r][c] = scale * value (+ bias[c]), row stride ld, batch stride
// rows * ld.
struct StoreEpi {
  float* out;
  const float* bias;
  int rows, ld;
  float scale;
  static constexpr bool kWarpKeep = false;
  struct In {};
  __device__ In load(int, int) const { return {}; }
  __device__ void operator()(int z, int r, int c, float v) const {
    out[((size_t)z * rows + r) * ld + c] = v * scale + (bias ? bias[c] : 0.f);
  }
  __device__ void pair(int z, int r, int c, float v0, float v1, In, const float (&)[2]) const {
    float2 o = make_float2(v0 * scale, v1 * scale);
    if (bias) {
      o.x += bias[c];
      o.y += bias[c + 1];
    }
    *reinterpret_cast<float2*>(out + ((size_t)z * rows + r) * ld + c) = o;
  }
};

// The linear branch of pair row r = (m - m0) V + v: t3 = h + drop_(m,v)(x + blin).
struct LinEpi {
  float* t3;
  const float *h, *blin;
  int V, m0;
  Dropout drop;
  static constexpr bool kWarpKeep = true;
  struct In {
    float2 h;
  };
  __device__ In load(int r, int c) const {
    return In{*reinterpret_cast<const float2*>(h + (size_t)r * kCols + c)};
  }
  __device__ void warp_keep(int, int r0, int r1, int c, float (&kp)[2][2]) const {
    if (drop.thresh == 0u) return;
    pair_keep(drop, [&](int r, int c4) {
      return philox4(drop.seed, m0 + r / V, r % V, c4 >> 2);
    }, r0, r1, c, kp);
  }
  __device__ void pair(int, int r, int c, float v0, float v1, const In& in,
                       const float (&kp)[2]) const {
    *reinterpret_cast<float2*>(t3 + (size_t)r * kCols + c) =
        make_float2((v0 + blin[c]) * kp[0] + in.h.x, (v1 + blin[c + 1]) * kp[1] + in.h.y);
  }
  __device__ void operator()(int, int, int, float) const {}   // D is even
};

// Softmax over the S snippets of each pair row (row stride ld), in place;
// one warp per row.
__global__ void softmax_rows_kernel(float* __restrict__ s, int rows, int S, int ld) {
  const int lane = threadIdx.x & 31, row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  float* x = s + (size_t)row * ld;
  float mx = -INFINITY;
  for (int c = lane; c < S; c += 32) mx = fmaxf(mx, x[c]);
  mx = warp_max(mx);
  float sum = 0.f;
  for (int c = lane; c < S; c += 32) {
    const float e = expf(x[c] - mx);
    x[c] = e;
    sum += e;
  }
  sum = warp_sum(sum);
  for (int c = lane; c < S; c += 32) x[c] /= sum;
}

// ds = p (dp - sum_s p dp), zero at masked snippets (their scores are
// constants), in place of dp; one warp per pair row.
__global__ void softmax_bwd_rows_kernel(const float* __restrict__ p, float* __restrict__ dp,
                                        const float* __restrict__ mask, int rows, int V, int S,
                                        int ld) {
  const int lane = threadIdx.x & 31, row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float* pr = p + (size_t)row * ld;
  float* d = dp + (size_t)row * ld;
  const float* mk = mask + (size_t)(row / V) * S;
  float dot = 0.f;
  for (int c = lane; c < S; c += 32) dot = fmaf(d[c], pr[c], dot);
  dot = warp_sum(dot);
  for (int c = lane; c < S; c += 32) d[c] = mk[c] != 0.f ? pr[c] * (d[c] - dot) : 0.f;
}

// The pair-row kernels' six column sums per block of kSumRows rows: the
// head kernel's three, then LN2's backward's three.
constexpr int kSumStride = kVecs * kCols;

// The head of pair rows r = (m - m0) V + v: from t3 = h + lin, o = LN3(t3),
// sim = <o / |o|, vhat_v>; then the backward of the cosine and of LN3 under
// the cotangent g[m][v]: gohat = g o / |o| (dvhat's term), do = g (vhat -
// sim o / |o|) / |o|, du3 = LN3'(do) and dlin = du3 * the pair's dropout
// mask; column sums do xhat3 (dg3), do (db3), dlin (dblin).
__global__ void __launch_bounds__(kThreads)
head_bwd_kernel(const float* __restrict__ t3, const float* __restrict__ vhat,
                const float* __restrict__ g, const float* __restrict__ g3,
                const float* __restrict__ b3, float* __restrict__ gohat,
                float* __restrict__ du3, float* __restrict__ dlin, float* __restrict__ part,
                int rows, int V, int m0, Dropout drop) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float acc[3][kVec] = {};
  constexpr int kWarpRows = kSumRows / kWarps;
  for (int i = 0; i < kWarpRows; ++i) {
    const int row = blockIdx.x * kSumRows + warp * kWarpRows + i;
    if (row >= rows) break;
    const int m = m0 + row / V, v = row % V;
    const size_t base = (size_t)row * kCols;
    float x[kVec], o[kVec], vh[kVec], s = 0.f;
#pragma unroll
    for (int t = 0; t < kVec; ++t) s += (x[t] = t3[base + lane + 32 * t]);
    const float mean = warp_sum(s) / kCols;
    float q = 0.f;
#pragma unroll
    for (int t = 0; t < kVec; ++t) {
      x[t] -= mean;
      q = fmaf(x[t], x[t], q);
    }
    const float inv3 = rsqrtf(warp_sum(q) / kCols + kLnEps);
    float n2 = 0.f, dot = 0.f;
#pragma unroll
    for (int t = 0; t < kVec; ++t) {
      const int c = lane + 32 * t;
      x[t] *= inv3;                                     // xhat3
      o[t] = x[t] * g3[c] + b3[c];
      vh[t] = vhat[(size_t)v * kCols + c];
      n2 = fmaf(o[t], o[t], n2);
      dot = fmaf(o[t], vh[t], dot);
    }
    const float inv_n = rsqrtf(fmaxf(warp_sum(n2), 1e-24f));
    const float sim = warp_sum(dot) * inv_n, gv = g[(size_t)m * V + v];
    float s1 = 0.f, s2 = 0.f, dog[kVec];
#pragma unroll
    for (int t = 0; t < kVec; ++t) {
      const int c = lane + 32 * t;
      const float oh = o[t] * inv_n;
      const float d = gv * (vh[t] - sim * oh) * inv_n;
      gohat[base + c] = gv * oh;
      acc[0][t] = fmaf(d, x[t], acc[0][t]);
      acc[1][t] += d;
      dog[t] = d * g3[c];
      s1 += dog[t];
      s2 = fmaf(dog[t], x[t], s2);
    }
    const float m1 = warp_sum(s1) / kCols, m2 = warp_sum(s2) / kCols;
#pragma unroll
    for (int t = 0; t < kVec; ++t) {
      const int c = lane + 32 * t;
      const float du = (dog[t] - m1 - x[t] * m2) * inv3;
      const float dl = du * keep(drop, m, v, c);
      du3[base + c] = du;
      dlin[base + c] = dl;
      acc[2][t] += dl;
    }
  }
  write_block_sums<3>(acc, part, kSumStride);
}

}  // namespace

extern "C" int mgsv_xpool_sim_init() {
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(xpool_fwd_kernel<true>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)kSmemBytes)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(xpool_fwd_kernel<false>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)kSmemBytes)) != cudaSuccess)
    return (int)err;
  return 0;
}

// sims [M, V] of the pair stage on `stream`, dropout (seed, thresh, scale)
// as in philox.cuh (thresh 0: none, and the <false> instantiation without
// the mask code, as an evaluation takes it), grid (ceil(V / 64), M); the
// caller splits M above 65,535.  q, vhat [V, D]; k, v [M, S, D]; mask
// [M, S]; the 8 stage weights in torch layout.  Returns the CUDA error.
extern "C" int mgsv_xpool_sim_fwd(const float* q, const float* k, const float* v,
                                  const float* mask, const float* vhat, const float* wout,
                                  const float* bout, const float* g2, const float* b2,
                                  const float* wlin, const float* blin, const float* g3,
                                  const float* b3, float* out, int V, int M, int S, int D,
                                  unsigned seed, unsigned thresh, float scale, void* stream) {
  if (bad_shape(V, M, S, D)) return (int)cudaErrorInvalidValue;
  const Pair a{q, k, v, mask, vhat, wout, bout, g2, b2, wlin, blin, g3, b3, V, S,
               Dropout{seed, thresh, scale}};
  launch_fwd(a, out, M, static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// Floats of device workspace mgsv_xpool_sim_bwd needs.
extern "C" size_t mgsv_xpool_sim_bwd_workspace(int V, int M, int S) {
  const size_t G = chunk_musics(V, M), P = G * V, d = kCols, sp = round4(S);
  const size_t nc = (M + G - 1) / G, ms = (size_t)M * S;
  const size_t zp = (P + kChunk - 1) / kChunk, zm = (ms + kChunk - 1) / kChunk;
  const size_t partial = std::max(zp, zm) * d * d;
  const size_t blocks = nc * ((P + kSumRows - 1) / kSumRows);
  return 2 * align4(ms * d) +            // u = v Wout^T, du
         9 * align4(P * d) + align4(P) + // the chunk's pair tensors, LN2's 1/std
         2 * align4(P * sp) +            // p, then ds in place of dp
         2 * align4(nc * V * d) +        // dq, dvhat per chunk
         align4(nc * d * d) +            // dWlin per chunk
         align4(blocks * kVecs * d) +    // the six vectors' block sums
         align4(partial);                // the launches' split-K partials
}

// Gradients of sum(g * sims) with respect to q, k, v, vhat and the 8 stage
// weights (torch layout), on `stream`.  Returns the first CUDA error.
extern "C" int mgsv_xpool_sim_bwd(
    const float* q, const float* k, const float* v, const float* mask, const float* vhat,
    const float* wout, const float* bout, const float* g2, const float* b2,
    const float* wlin, const float* blin, const float* g3, const float* b3, const float* g,
    float* dq, float* dk, float* dv, float* dvhat, float* dwout, float* dbout, float* dg2,
    float* db2, float* dwlin, float* dblin, float* dg3, float* db3, float* ws, int V, int M,
    int S, int D, unsigned seed, unsigned thresh, float scale, void* stream) {
  if (bad_shape(V, M, S, D)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dropout drop{seed, thresh, scale};
  const int G = chunk_musics(V, M), Sp = round4(S), nc = (M + G - 1) / G;
  const size_t P = (size_t)G * V, d = kCols, ms = (size_t)M * S;
  float* cur = ws;
  auto take = [&](size_t n) { float* p = cur; cur += align4(n); return p; };
  float *u = take(ms * d), *du = take(ms * d);
  float *pre = take(P * d), *h = take(P * d), *xh2 = take(P * d), *t3 = take(P * d),
        *gohat = take(P * d), *du3 = take(P * d), *dlin = take(P * d), *dh = take(P * d),
        *dpre = take(P * d);
  float* dq_m = t3;    // each music's dq term, once t3 is consumed
  float* inv2 = take(P);
  float *pb = take(P * Sp), *dsb = take(P * Sp);
  float *dq_c = take((size_t)nc * V * d), *dvhat_c = take((size_t)nc * V * d);
  float* dwlin_c = take((size_t)nc * d * d);
  // [block][6][D]: per block of pair rows, dg3 | db3 | dblin then dg2 | db2 |
  // dbout (the row kernels' three sums each)
  float* vec_b = take((size_t)nc * ((P + kSumRows - 1) / kSumRows) * kVecs * d);
  float* partial = cur;
  const float rs = rsqrtf((float)kCols);
  cudaError_t err = cudaSuccess;
  auto ok = [&](cudaError_t e) {
    if (err == cudaSuccess) err = e != cudaSuccess ? e : cudaGetLastError();
    return err == cudaSuccess;
  };
  const Dropout none{0u, 0u, 1.f};
  Launcher per_track{st, M * S, 1, none, partial};

  // u = v Wout^T, once per track
  per_track.rowgemm({v, D, D, wout, D, 0, nullptr, 0, -1, D, nullptr, 0, nullptr, 0, u, D}, D);
  if (!ok(per_track.err)) return (int)err;

  int blocks = 0;                       // row blocks of the chunks so far
  for (int c = 0; c < nc; ++c) {
    const int m0 = c * G, g_n = std::min(G, M - m0), rows = g_n * V;
    Launcher k2{st, rows, 1, none, partial};
    const unsigned row_blocks = (rows + kWarps - 1) / kWarps;
    const int sum_blocks = (rows + kSumRows - 1) / kSumRows;
    float* vec = vec_b + (size_t)blocks * kVecs * d;
    blocks += sum_blocks;
    const float* k_c = k + (size_t)m0 * S * d;
    const float* u_c = u + (size_t)m0 * S * d;
    const Operand q_k{q, D, V, D};                       // q [V][D], K-major
    // scores and softmax: p [g_n][V][Sp]
    ok(wg_gemm<false, false, false>(q_k, Operand{k_c, D, S, D, (long)S * D, g_n}, V, S, D, g_n,
                                    0, false, true,
                                    ScoreEpi{pb, mask + (size_t)m0 * S, V, S, Sp, rs}, st));
    softmax_rows_kernel<<<row_blocks, kThreads, 0, st>>>(pb, rows, S, Sp);
    // pre = p u_m + bout; h = LN2(pre)
    const Operand p_k{pb, Sp, V, S, (long)V * Sp, g_n};  // p, K-major over snippets
    ok(wg_gemm<false, false, true>(p_k, Operand{u_c, D, S, D, (long)S * D, g_n}, V, D, S, g_n,
                                   0, true, true, StoreEpi{pre, bout, V, D, 1.f}, st));
    k2.ln_fwd(pre, g2, b2, h, xh2, inv2);
    // t3 = h + drop(h Wlin^T + blin)
    ok(wg_gemm<false, false, false>(Operand{h, D, rows, D}, Operand{wlin, D, D, D}, rows, D, D, 1,
                                    0, false, false, LinEpi{t3, h, blin, V, m0, drop}, st));
    if (!ok(k2.err)) return (int)err;
    head_bwd_kernel<<<sum_blocks, kThreads, 0, st>>>(t3, vhat, g, g3, b3, gohat, du3, dlin, vec,
                                                     rows, V, m0, drop);
    k2.wgrad(dlin, D, D, h, D, D, dwlin_c + (size_t)c * d * d);
    // dh = du3 + dlin Wlin; dpre = LN2'(dh)
    k2.rowgemm({dlin, D, D, wlin, D, 1, nullptr, 0, -1, D, nullptr, 0, du3, D, dh, D}, D);
    if (!ok(k2.err)) return (int)err;
    ln_bwd_sum_kernel<3><<<sum_blocks, kThreads, 0, st>>>(dh, xh2, inv2, g2, dpre, vec + 3 * d,
                                                          kSumStride, rows);
    // dp = dpre u_m^T, then ds in its place
    const Operand dpre_k{dpre, D, V, D, (long)V * D, g_n};
    ok(wg_gemm<false, false, false>(dpre_k, Operand{u_c, D, S, D, (long)S * D, g_n}, V, S, D, g_n,
                                    0, true, true, StoreEpi{dsb, nullptr, V, Sp, 1.f}, st));
    softmax_bwd_rows_kernel<<<row_blocks, kThreads, 0, st>>>(pb, dsb, mask + (size_t)m0 * S,
                                                             rows, V, S, Sp);
    // du_m = sum_v p^T dpre (a whole track's sum in one product)
    ok(wg_gemm<false, true, true>(Operand{pb, Sp, V, S, (long)V * Sp, g_n}, dpre_k, S, D, V, g_n,
                                  0, true, true,
                                  StoreEpi{du + (size_t)m0 * S * d, nullptr, S, D, 1.f}, st));
    // dk_m = sum_v ds^T q / sqrt(D)
    const Operand ds_t{dsb, Sp, V, S, (long)V * Sp, g_n};
    ok(wg_gemm<false, true, true>(ds_t, Operand{q, D, V, D}, S, D, V, g_n, 0, true, false,
                                  StoreEpi{dk + (size_t)m0 * S * d, nullptr, S, D, rs}, st));
    // dq's and dvhat's terms of each music, then their sums over the chunk
    // (music order)
    ok(wg_gemm<false, false, true>(Operand{dsb, Sp, V, S, (long)V * Sp, g_n},
                                   Operand{k_c, D, S, D, (long)S * D, g_n}, V, D, S, g_n, 0, true,
                                   true, StoreEpi{dq_m, nullptr, V, D, rs}, st));
    k2.partial = dq_m;
    k2.reduce(g_n, (size_t)V * d, dq_c + (size_t)c * V * d);
    k2.partial = gohat;
    k2.reduce(g_n, (size_t)V * d, dvhat_c + (size_t)c * V * d);
    k2.partial = partial;
    if (!ok(k2.err)) return (int)err;
  }

  // the sums over chunks, in chunk order; dWout and dv once per track
  Launcher fin{st, 1, 1, none, nullptr};
  fin.partial = dq_c;
  fin.reduce(nc, (size_t)V * d, dq);
  fin.partial = dvhat_c;
  fin.reduce(nc, (size_t)V * d, dvhat);
  fin.partial = dwlin_c;
  fin.reduce(nc, d * d, dwlin);
  if (fin.check())
    sum_blocks_kernel<kVecs><<<kVecs, kCols, 0, st>>>(
        vec_b, blocks, kSumStride, SumOut<kVecs>{{dg3, db3, dblin, dg2, db2, dbout}});
  per_track.wgrad(du, D, D, v, D, D, dwout);
  per_track.rowgemm({du, D, D, wout, D, 1, nullptr, 0, -1, D, nullptr, 0, nullptr, 0, dv, D}, D);
  ok(fin.err);
  ok(per_track.err);
  return (int)err;
}
