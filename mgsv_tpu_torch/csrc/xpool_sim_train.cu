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
// What bounds it on the card: the pair stage is 360,448 FLOP per pair, 94.5
// GFLOP at V = M = 512 in the forward and about twice that in the backward,
// against inputs of a few MB: the arithmetic bounds it (an evaluation over
// V = M = 2,048 is 1.5 TFLOP as this kernel does it; applying Wout to v
// once per track instead of once per pair would make it 0.99).  The design keeps
// everything O(M V D) out of device memory in the forward: a block takes
// one music and 64 videos, and runs the four products of the stage (scores,
// p v_m, Wout, Wlin) as 3xTF32 tensor-core tiles (tf32_tile.cuh) on two
// [64, 256] shared-memory tiles, with Wout and Wlin (256 KB each, more
// than the 227 KB a block may hold) streamed through it in 32-deep
// K-slices, as the encoder layer's FFN streams its weights.
//
// The backward: a block owns one music m and loops over every 64-video
// tile, recomputing the pair stage, so dk[m] and dv[m] build up in the
// block's own rows with no atomics.  The pair intermediates of the current
// tile (p, ctx, LN2/LN3 normalized rows, h) go to a per-music scratch of
// [5, 64, 256] floats.  dq and dvhat are sums over m, and the 8 weight
// gradients sums over all pairs: each block writes per-music partials and
// reduce_kernel sums them in music order afterwards, so a step is
// reproducible from run to run.  Ragged V is masked inside the kernel
// (rows past V load as zero, carry a zero cotangent, and are not stored).

#include <algorithm>

#include "philox.cuh"
#include "tf32_tile.cuh"

namespace {

constexpr int kScratchTiles = 5;      // p, ctx, xhat2, h, xhat3
constexpr int kScratchFloats = kScratchTiles * kRows * kCols;
constexpr int kVecs = 6;              // dbout, dg2, db2, dblin, dg3, db3

struct Pair {
  const float *q, *k, *v, *mask, *vhat;
  const float *wout, *bout, *g2, *b2, *wlin, *blin, *g3, *b3;
  int V, S;
  Dropout drop;
};

// Per-block shared memory: two activation tiles, the weight staging ring,
// the gemm_tn staging tile and per-row statistics.
struct Smem {
  float *t0, *t1, *ws, *ga, *inv2, *inv3, *inv_n, *sim, *gv;
};

__device__ Smem carve(float* base) {
  Smem s;
  s.t0 = base;
  s.t1 = s.t0 + kTileFloats;
  s.ws = s.t1 + kTileFloats;
  s.ga = s.ws + 2 * kWsFloats;
  s.inv2 = s.ga + kRows * kLdws;
  s.inv3 = s.inv2 + kRows;
  s.inv_n = s.inv3 + kRows;
  s.sim = s.inv_n + kRows;
  s.gv = s.sim + kRows;
  return s;
}

constexpr size_t kSmemBytes =
    sizeof(float) * (size_t)(2 * kTileFloats + 2 * kWsFloats + kRows * kLdws + 5 * kRows);

__host__ __device__ constexpr int pad32(int n) { return (n + 31) & ~31; }

// The pair stage of music m and videos v0 .. v0+63: leaves o = LN3(...) in
// t0 and h in t1, |o|^-1 and the similarity per row in inv_n and sim.  With
// a scratch (the backward) it also keeps p, ctx, xhat2, h, xhat3 there and
// 1/std of LN2 and LN3 in inv2, inv3.  kDrop = false compiles the dropout
// test out of the Wlin epilogue (rate 0: evaluation).
template <bool kDrop>
__device__ void pair_forward(const Pair& a, int m, int v0, const Smem& s, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int S = a.S, sp = pad32(S);
  const float scale = rsqrtf((float)kCols);
  const float* k_m = a.k + (size_t)m * S * kCols;
  const float* v_m = a.v + (size_t)m * S * kCols;
  const float* mask_m = a.mask + (size_t)m * S;
  float* sp_p = scratch;
  float* sp_ctx = scratch ? scratch + 1 * kRows * kCols : nullptr;
  float* sp_x2 = scratch ? scratch + 2 * kRows * kCols : nullptr;
  float* sp_h = scratch ? scratch + 3 * kRows * kCols : nullptr;
  float* sp_x3 = scratch ? scratch + 4 * kRows * kCols : nullptr;
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
  if (sp_p) store_rows(sp_p, kCols, 0, s.t1, 0, kRows);

  // ctx = p v_m
  zero(acc);
  gemm_t(acc, s.t1, v_m, kCols, 0, sp, S, s.ws);
  for_each_acc(acc, [&](int r, int c, float& x) { s.t0[r * kLda + c] = x; });
  __syncthreads();
  if (sp_ctx) store_rows(sp_ctx, kCols, 0, s.t0, 0, kRows);

  // h = LN2(ctx Wout^T + bout)
  zero(acc);
  gemm(acc, s.t0, a.wout, kCols, 0, kCols, s.ws);
  for_each_acc(acc, [&](int r, int c, float& x) { s.t1[r * kLda + c] = x + a.bout[c]; });
  __syncthreads();
  layer_norm_rows(s.t1, a.g2, a.b2, sp_x2, kCols, s.inv2);
  if (sp_h) store_rows(sp_h, kCols, 0, s.t1, 0, kRows);

  // o = LN3(h + drop(h Wlin^T + blin))
  zero(acc);
  gemm(acc, s.t1, a.wlin, kCols, 0, kCols, s.ws);
  for_each_acc(acc, [&](int r, int c, float& x) {
    float lin = x + a.blin[c];
    if constexpr (kDrop) lin *= keep(a.drop, m, v0 + r, c);
    s.t0[r * kLda + c] = lin + s.t1[r * kLda + c];
  });
  __syncthreads();
  layer_norm_rows(s.t0, a.g3, a.b3, sp_x3, kCols, s.inv3);

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
  pair_forward<kDrop>(a, m, v0, s, nullptr);
  for (int r = threadIdx.x; r < kRows; r += kThreads)
    if (v0 + r < a.V) out[(size_t)m * a.V + v0 + r] = s.sim[r];
}

// In-place LayerNorm backward of each row of a [kRows][kLda] tile
// (cotangent in, cotangent of the LN input out), xhat rows from device
// memory (row stride kCols).
__device__ void ln_bwd_rows(float* t, const float* __restrict__ xhat, const float* inv,
                            const float* __restrict__ g) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < kRows; r += kWarps) {
    float* row = t + r * kLda;
    const float* xh = xhat + (size_t)r * kCols;
    float dyg[kCols / 32], s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < kCols / 32; ++i) {
      const int c = lane + 32 * i;
      dyg[i] = row[c] * g[c];
      s1 += dyg[i];
      s2 = fmaf(dyg[i], xh[c], s2);
    }
    const float m1 = warp_sum(s1) / kCols, m2 = warp_sum(s2) / kCols;
#pragma unroll
    for (int i = 0; i < kCols / 32; ++i) {
      const int c = lane + 32 * i;
      row[c] = (dyg[i] - m1 - xh[c] * m2) * inv[r];
    }
  }
  __syncthreads();
}

// out[n0 + r][c] += scale * acc for rows n0 + r < nrows of a [*][kCols]
// matrix this block alone updates.
__device__ void add_tile(float* out, int n0, int nrows, Acc& acc, float scale = 1.f) {
  for_each_acc(acc, [&](int r, int c, float& x) {
    if (n0 + r < nrows) out[(size_t)(n0 + r) * kCols + c] += scale * x;
  });
}

struct Grads {
  const float* g;                    // [M, V] cotangent of sims
  float *dk, *dv;                    // [M, S, D]
  float *dq_part, *dvhat_part;       // [M, V, D]
  float* dw_part;                    // [M, 2, D, D]: dWout, dWlin
  float* dvec_part;                  // [M, 6, D]: dbout, dg2, db2, dblin, dg3, db3
  float* scratch;                    // [M, 5, 64, D]
};

// grid (M): block m loops over every 64-video tile.
__global__ void __launch_bounds__(kThreads, 1) xpool_bwd_kernel(Pair a, Grads gr) {
  extern __shared__ float4 smem4[];
  const Smem s = carve(reinterpret_cast<float*>(smem4));
  const int m = blockIdx.x, S = a.S, sp = pad32(S), c = threadIdx.x;
  const float scale = rsqrtf((float)kCols);
  const float* k_m = a.k + (size_t)m * S * kCols;
  const float* v_m = a.v + (size_t)m * S * kCols;
  float* dk_m = gr.dk + (size_t)m * S * kCols;
  float* dv_m = gr.dv + (size_t)m * S * kCols;
  float* dwout = gr.dw_part + (size_t)m * 2 * kCols * kCols;
  float* dwlin = dwout + kCols * kCols;
  float* scratch = gr.scratch + (size_t)m * kScratchFloats;
  const float* sp_p = scratch;
  const float* sp_ctx = scratch + 1 * kRows * kCols;
  const float* sp_x2 = scratch + 2 * kRows * kCols;
  const float* sp_h = scratch + 3 * kRows * kCols;
  const float* sp_x3 = scratch + 4 * kRows * kCols;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (size_t i = threadIdx.x; i < (size_t)S * kCols; i += kThreads) dk_m[i] = dv_m[i] = 0.f;
  for (size_t i = threadIdx.x; i < (size_t)2 * kCols * kCols; i += kThreads) dwout[i] = 0.f;
  // thread c owns column c of the six vector gradients
  float dbout = 0.f, dg2 = 0.f, db2 = 0.f, dblin = 0.f, dg3 = 0.f, db3 = 0.f;
  Acc acc;

  for (int v0 = 0; v0 < a.V; v0 += kRows) {
    const int nv = min(kRows, a.V - v0);
    pair_forward<true>(a, m, v0, s, scratch);    // t0 = o, t1 = h
    for (int r = threadIdx.x; r < kRows; r += kThreads)
      s.gv[r] = r < nv ? gr.g[(size_t)m * a.V + v0 + r] : 0.f;
    __syncthreads();

    // cosine: dvhat += g ohat; do = g (vhat - sim ohat) / |o|
    for (int r = warp; r < kRows; r += kWarps) {
      float* row = s.t0 + r * kLda;
      const float* vh = a.vhat + (size_t)(v0 + r) * kCols;
      float* dvh = gr.dvhat_part + ((size_t)m * a.V + v0 + r) * kCols;
      for (int j = lane; j < kCols; j += 32) {
        const float ohat = row[j] * s.inv_n[r];
        if (r < nv) {
          dvh[j] = s.gv[r] * ohat;
          row[j] = s.gv[r] * (vh[j] - s.sim[r] * ohat) * s.inv_n[r];
        } else {
          row[j] = 0.f;
        }
      }
    }
    __syncthreads();

    // LN3 (each thread reads its column before the rows are rewritten)
    for (int r = 0; r < kRows; ++r) {
      const float d = s.t0[r * kLda + c];
      dg3 = fmaf(d, sp_x3[(size_t)r * kCols + c], dg3);
      db3 += d;
    }
    __syncthreads();
    ln_bwd_rows(s.t0, sp_x3, s.inv3, a.g3);       // t0 = du

    // dropout on the linear branch; dWlin += dlin^T h; dh = du + dlin Wlin
    for (int e = threadIdx.x; e < kRows * kCols; e += kThreads) {
      const int r = e / kCols, j = e % kCols;
      s.t1[r * kLda + j] = s.t0[r * kLda + j] * keep(a.drop, m, v0 + r, j);
    }
    __syncthreads();
    for (int r = 0; r < kRows; ++r) dblin += s.t1[r * kLda + c];
    for (int n0 = 0; n0 < kCols; n0 += kRows) {
      zero(acc);
      gemm_tn(acc, s.t1, kLda, n0, sp_h, kCols, 0, kRows, s.ga, s.ws);
      add_tile(dwlin, n0, kCols, acc);
    }
    zero(acc);
    gemm_t(acc, s.t1, a.wlin, kCols, 0, kCols, kCols, s.ws);
    for_each_acc(acc, [&](int r, int j, float& x) { s.t0[r * kLda + j] += x; });
    __syncthreads();

    // LN2; dWout += dc1^T ctx; dctx = dc1 Wout
    for (int r = 0; r < kRows; ++r) {
      const float d = s.t0[r * kLda + c];
      dg2 = fmaf(d, sp_x2[(size_t)r * kCols + c], dg2);
      db2 += d;
    }
    __syncthreads();
    ln_bwd_rows(s.t0, sp_x2, s.inv2, a.g2);       // t0 = dc1
    for (int r = 0; r < kRows; ++r) dbout += s.t0[r * kLda + c];
    for (int n0 = 0; n0 < kCols; n0 += kRows) {
      zero(acc);
      gemm_tn(acc, s.t0, kLda, n0, sp_ctx, kCols, 0, kRows, s.ga, s.ws);
      add_tile(dwout, n0, kCols, acc);
    }
    zero(acc);
    gemm_t(acc, s.t0, a.wout, kCols, 0, kCols, kCols, s.ws);
    for_each_acc(acc, [&](int r, int j, float& x) { s.t1[r * kLda + j] = x; });
    __syncthreads();                               // t1 = dctx

    // softmax: dp = dctx v_m^T; ds = p (dp - sum_s dp p), zero at masked
    // snippets (their scores are constants, so q and k get nothing there)
    zero(acc);
    gemm(acc, s.t1, v_m, kCols, 0, kCols, s.ws, S);
    for_each_acc(acc, [&](int r, int j, float& x) { s.t0[r * kLda + j] = j < S ? x : 0.f; });
    __syncthreads();
    const float* mask_m = a.mask + (size_t)m * S;
    for (int r = warp; r < kRows; r += kWarps) {
      float* row = s.t0 + r * kLda;
      const float* p = sp_p + (size_t)r * kCols;
      float dot = 0.f;
      for (int j = lane; j < S; j += 32) dot = fmaf(row[j], p[j], dot);
      dot = warp_sum(dot);
      for (int j = lane; j < S; j += 32) row[j] = mask_m[j] != 0.f ? p[j] * (row[j] - dot) : 0.f;
    }
    __syncthreads();                               // t0 = ds

    // dv_m += p^T dctx; dq = scale ds k_m; dk_m += scale ds^T q
    for (int n0 = 0; n0 < S; n0 += kRows) {
      zero(acc);
      gemm_tn(acc, sp_p, kCols, n0, s.t1, kLda, 0, kRows, s.ga, s.ws);
      add_tile(dv_m, n0, S, acc);
    }
    zero(acc);
    gemm_t(acc, s.t0, k_m, kCols, 0, sp, S, s.ws);
    for_each_acc(acc, [&](int r, int j, float& x) {
      if (r < nv) gr.dq_part[((size_t)m * a.V + v0 + r) * kCols + j] = x * scale;
    });
    for (int n0 = 0; n0 < S; n0 += kRows) {
      zero(acc);
      gemm_tn(acc, s.t0, kLda, n0, a.q + (size_t)v0 * kCols, kCols, 0, nv, s.ga, s.ws);
      add_tile(dk_m, n0, S, acc, scale);
    }
  }
  float* vec = gr.dvec_part + (size_t)m * kVecs * kCols;
  vec[0 * kCols + c] = dbout;
  vec[1 * kCols + c] = dg2;
  vec[2 * kCols + c] = db2;
  vec[3 * kCols + c] = dblin;
  vec[4 * kCols + c] = dg3;
  vec[5 * kCols + c] = db3;
}

// out[i] = sum_z P[z * zstride + i] for i < n, z in order.
__global__ void reduce_kernel(const float* __restrict__ P, int Z, size_t zstride, size_t n,
                              float* __restrict__ out) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int z = 0; z < Z; ++z) acc += P[(size_t)z * zstride + i];
    out[i] = acc;
  }
}

size_t align4(size_t n) { return (n + 3) & ~(size_t)3; }

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

}  // namespace

extern "C" int mgsv_xpool_sim_init() {
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(xpool_fwd_kernel<true>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)kSmemBytes)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(xpool_fwd_kernel<false>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)kSmemBytes)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(xpool_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
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
extern "C" size_t mgsv_xpool_sim_bwd_workspace(int V, int M) {
  const size_t m = M, d = kCols;
  return 2 * align4(m * V * d) + align4(m * 2 * d * d) + align4(m * kVecs * d) +
         align4(m * kScratchFloats);
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t vd = (size_t)V * kCols, dd = (size_t)kCols * kCols;
  float* cur = ws;
  auto take = [&](size_t n) { float* p = cur; cur += align4(n); return p; };
  Grads gr;
  gr.g = g;
  gr.dk = dk;
  gr.dv = dv;
  gr.dq_part = take((size_t)M * vd);
  gr.dvhat_part = take((size_t)M * vd);
  gr.dw_part = take((size_t)M * 2 * dd);
  gr.dvec_part = take((size_t)M * kVecs * kCols);
  gr.scratch = take((size_t)M * kScratchFloats);
  const Pair a{q, k, v, mask, vhat, wout, bout, g2, b2, wlin, blin, g3, b3, V, S,
               Dropout{seed, thresh, scale}};
  xpool_bwd_kernel<<<M, kThreads, kSmemBytes, st>>>(a, gr);
  cudaError_t err = cudaGetLastError();

  // fixed-order sums over the musics, straight into the outputs
  auto reduce = [&](const float* part, size_t zstride, size_t n, float* out) {
    if (err != cudaSuccess) return;
    const unsigned blocks = (unsigned)std::min<size_t>((n + kThreads - 1) / kThreads, 2112);
    reduce_kernel<<<blocks, kThreads, 0, st>>>(part, M, zstride, n, out);
    err = cudaGetLastError();
  };
  reduce(gr.dq_part, vd, vd, dq);
  reduce(gr.dvhat_part, vd, vd, dvhat);
  reduce(gr.dw_part, 2 * dd, dd, dwout);
  reduce(gr.dw_part + dd, 2 * dd, dd, dwlin);
  float* vecs[] = {dbout, dg2, db2, dblin, dg3, db3};
  for (int i = 0; i < kVecs; ++i)
    reduce(gr.dvec_part + (size_t)i * kCols, (size_t)kVecs * kCols, kCols, vecs[i]);
  return (int)err;
}
