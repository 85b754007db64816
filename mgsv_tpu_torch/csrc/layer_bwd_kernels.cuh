// The launches of a transformer layer's backward by recompute, shared by
// fused_encoder_layer_bwd.cu (the post-norm DETR encoder layer) and
// fused_temporal_layer_bwd.cu (the temporal-tower layer):
//
//  * rowgemm_kernel: activation x weight products, 64-row tiles, 256 output
//    columns per block, the 3xTF32 tiles of tf32_tile.cuh, with the bias /
//    ReLU / dropout / ReLU or GELU gate / residual epilogues fused.
//  * ln_fwd_kernel, ln_bwd_kernel: LayerNorm statistics and its backward,
//    one warp per row; dropout_kernel: a mask (after a GELU) over a tensor.
//  * Weight gradients dW = G^T H over all B*L rows as split-K GEMMs
//    (wgrad_kernel: each block one 64 x 256 output tile over one 2048-row
//    chunk, its rows staged K-major with cp.async, double-buffered) whose
//    per-chunk partials reduce_kernel then sums in chunk order; bias and
//    LayerNorm gradients (column sums, 32 columns per block) take the same
//    two passes.  No float atomics: a step is reproducible from run to run.
//  * attention_bwd_kernel: the attention backward per (head, batch row) in
//    shared memory, in two sweeps (query rows, then key rows) so every sum
//    has one owner.
//
// Launcher strings them on one stream and keeps the first CUDA error.  Its
// bf16 flag takes every product with bf16 operands and float32 sums
// (precision "bf16", tf32_tile.cuh); LayerNorm, the column sums and the
// epilogues stay float32.
#pragma once

#include <algorithm>

#include "temporal_layer.cuh"

namespace {

constexpr int kChunk = 2048;          // rows per split-K partial
constexpr int kVec = kCols / 32;      // LayerNorm row values per lane

// C[r][n0 + c] = epilogue(A[r][0..K) . W^T), 256 columns per block.
// W is a torch [Nout][K] weight (row stride ldw), or with wt a row-major
// [K][Nout] matrix.  Epilogue, in order: + bias, ReLU, * dropout mask of
// `site` (element l * width + column), the gate (zero where gate <= 0: the
// ReLU's derivative; with gelu_gate, times gelu'(gate): the GELU's at its
// input), + res.  The gate kind is a template parameter of the kernel, so
// the ReLU form compiles without the GELU's code.
struct RowGemm {
  const float* A; int lda; int K;
  const float* W; int ldw; int wt;
  const float* bias; int relu; int site; int width;
  const float* gate; int ldgate;
  const float* res; int ldres;
  float* C; int ldc;
  int gelu_gate;
};

template <bool kGeluGate, bool kBf16 = false>
__global__ void __launch_bounds__(kThreads, 1)
rowgemm_kernel(RowGemm p, int rows, int L, Dropout drop) {
  extern __shared__ float4 smem4[];
  float* A = reinterpret_cast<float*>(smem4);
  float* Ws = A + kTileFloats;
  const int r0 = blockIdx.x * kRows, n0 = blockIdx.y * kCols;
  Acc acc;
  zero(acc);
  for (int k0 = 0; k0 < p.K; k0 += kCols) {
    load_rows(A, p.A + k0, nullptr, r0, rows, p.lda);
    if (p.wt)
      gemm_t<kBf16>(acc, A, p.W + (size_t)k0 * p.ldw, p.ldw, n0, kCols, kCols, Ws);
    else
      gemm<kBf16>(acc, A, p.W + k0, p.ldw, n0, kCols, Ws);
  }
  for_each_acc(acc, [&](int r, int c, float& v) {
    const int gr = r0 + r, n = n0 + c;
    float o = v;
    if (gr < rows) {
      if (p.bias) o += p.bias[n];
      if (p.relu) o = fmaxf(o, 0.f);
      if (p.site >= 0) o *= keep(drop, gr / L, p.site, (gr % L) * p.width + n);
      if (p.gate) {
        const float gv = p.gate[(size_t)gr * p.ldgate + n];
        if constexpr (kGeluGate)
          o *= gelu_grad(gv);
        else if (!(gv > 0.f))
          o = 0.f;
      }
      if (p.res) o += p.res[(size_t)gr * p.ldres + n];
    }
    A[r * kLda + c] = o;
  });
  __syncthreads();
  store_rows(p.C, p.ldc, n0, A, r0, rows);
}

// LayerNorm statistics of each [256] row: xhat, 1 / std and (when y is
// given) y = xhat * g + beta.  One warp per row.
__global__ void ln_fwd_kernel(const float* __restrict__ in, const float* __restrict__ g,
                              const float* __restrict__ beta, float* __restrict__ y,
                              float* __restrict__ xhat, float* __restrict__ inv_out, int rows) {
  const int lane = threadIdx.x & 31, row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float* src = in + (size_t)row * kCols;
  float v[kVec], s = 0.f;
#pragma unroll
  for (int t = 0; t < kVec; ++t) s += (v[t] = src[lane + 32 * t]);
  const float mean = warp_sum(s) / kCols;
  float q = 0.f;
#pragma unroll
  for (int t = 0; t < kVec; ++t) {
    const float d = v[t] - mean;
    q = fmaf(d, d, q);
  }
  const float inv = rsqrtf(warp_sum(q) / kCols + kLnEps);
#pragma unroll
  for (int t = 0; t < kVec; ++t) {
    const int c = lane + 32 * t;
    const float xh = (v[t] - mean) * inv;
    xhat[(size_t)row * kCols + c] = xh;
    if (y) y[(size_t)row * kCols + c] = xh * g[c] + beta[c];
  }
  if (lane == 0) inv_out[row] = inv;
}

// dx = (dy g - mean(dy g) - xhat mean(dy g xhat)) / std, one warp per row.
__global__ void ln_bwd_kernel(const float* __restrict__ dy, const float* __restrict__ xhat,
                              const float* __restrict__ inv, const float* __restrict__ g,
                              float* __restrict__ dx, int rows) {
  const int lane = threadIdx.x & 31, row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const size_t base = (size_t)row * kCols;
  float dyg[kVec], xh[kVec], s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int t = 0; t < kVec; ++t) {
    const int c = lane + 32 * t;
    dyg[t] = dy[base + c] * g[c];
    xh[t] = xhat[base + c];
    s1 += dyg[t];
    s2 = fmaf(dyg[t], xh[t], s2);
  }
  const float m1 = warp_sum(s1) / kCols, m2 = warp_sum(s2) / kCols, iv = inv[row];
#pragma unroll
  for (int t = 0; t < kVec; ++t)
    dx[base + lane + 32 * t] = (dyg[t] - m1 - xh[t] * m2) * iv;
}

// out = in (gelu(in) with gelu_in) * dropout mask of `site` over a
// [rows][width] tensor.
__global__ void dropout_kernel(const float* __restrict__ in, float* __restrict__ out,
                               int rows, int width, int L, int site, Dropout drop,
                               int gelu_in) {
  const size_t n = (size_t)rows * width;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int gr = (int)(i / width), c = (int)(i % width);
    const float v = gelu_in ? gelu(in[i]) : in[i];
    out[i] = v * keep(drop, gr / L, site, (gr % L) * width + c);
  }
}

__global__ void add_kernel(const float* __restrict__ a, const float* __restrict__ b,
                           float* __restrict__ out, size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    out[i] = a[i] + b[i];
}

// P[z][c] = sum over rows of chunk z of G[r][c] (* H[r][c] when given): a
// block takes 32 columns and its warps every kWarps-th row of the chunk
// (one row of 32 columns is one 128-byte read), then adds the warps'
// totals in warp order.
__global__ void colsum_kernel(const float* __restrict__ G, const float* __restrict__ H,
                              int ld, int cols, int rows, float* __restrict__ P) {
  __shared__ float part[kWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane, z = blockIdx.y;
  const int r1 = min(rows, (z + 1) * kChunk);
  float s = 0.f;
  if (c < cols)
    for (int r = z * kChunk + warp; r < r1; r += kWarps)
      s += H ? G[(size_t)r * ld + c] * H[(size_t)r * ld + c] : G[(size_t)r * ld + c];
  part[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && c < cols) {
    float t = 0.f;
    for (int w = 0; w < kWarps; ++w) t += part[w][lane];
    P[(size_t)z * cols + c] = t;
  }
}

// P[z][n][k] = sum over rows r of chunk z of G[r][n] H[r][k]; block tile
// 64 (n) x 256 (k).  P is [Z][Nout][K].
template <bool kBf16 = false>
__global__ void __launch_bounds__(kThreads)
wgrad_kernel(const float* __restrict__ G, int ldg, const float* __restrict__ H, int ldh,
             int rows, int nout, int K, float* __restrict__ P) {
  extern __shared__ float4 smem4[];
  float* Ga = reinterpret_cast<float*>(smem4);
  float* Ws = Ga + 2 * kGaFloats;
  const int n0 = blockIdx.x * kRows, k0 = blockIdx.y * kCols, z = blockIdx.z;
  Acc acc;
  zero(acc);
  gemm_tn<true, kBf16>(acc, G, ldg, n0, H + k0, ldh, z * kChunk, min(rows, (z + 1) * kChunk),
                       Ga, Ws);
  float* out = P + (size_t)z * nout * K;
  for_each_acc(acc, [&](int r, int c, float& v) {
    out[(size_t)(n0 + r) * K + k0 + c] = v;
  });
}

// out[i] = sum_z P[z][i], z in order: the fixed-order second pass.
__global__ void reduce_kernel(const float* __restrict__ P, int Z, size_t n,
                              float* __restrict__ out) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < Z; ++z) s += P[(size_t)z * n + i];
    out[i] = s;
  }
}

__host__ __device__ constexpr size_t attention_bwd_smem_bytes(int L) {
  return sizeof(float) * (size_t)(4 * L * kPad + 4 * L + 2 * kWarps * ((L + 3) & ~3));
}

// Attention backward of one (head, batch row): q, k, v, dctx of the head in
// shared memory.  Sweep 1, a warp per query row i (lanes over keys j):
// softmax statistics, D_i = sum_j p_ij m_ij dp_ij and dq_i.  Sweep 2, a warp
// per key row j (lanes over queries i): dv_j = sum_i p_ij m_ij dctx_i and
// dk_j = scale sum_i ds_ij q_i.  Writes dq | dk | dv into dqkv [B, L, 3D].
// A null mask means every key is valid.  kBf16: q, k, v and dctx are
// rounded to bf16 as they are staged, and so are the dropped weights and
// ds before their products (JAX's cast of each operand).
template <bool kBf16 = false>
__global__ void __launch_bounds__(kThreads)
attention_bwd_kernel(const float* __restrict__ qkv, const float* __restrict__ dctx,
                     const float* __restrict__ mask, float* __restrict__ dqkv, int L,
                     Dropout drop) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int h = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* q_s = smem;
  float* k_s = q_s + L * kPad;
  float* v_s = k_s + L * kPad;
  float* d_s = v_s + L * kPad;       // dctx
  float* m_s = d_s + L * kPad;       // key mask
  float* mx_s = m_s + L;             // row max of the scores
  float* sum_s = mx_s + L;           // row sum of exp
  float* dd_s = sum_s + L;           // D_i
  const int Lp = (L + 3) & ~3;
  float* pa = dd_s + L + 2 * warp * Lp;
  float* pb = pa + Lp;
  const float scale = 1.0f / sqrtf((float)kHeadDim);

  const size_t row0 = (size_t)b * L;
  for (int e = threadIdx.x; e < L * kHeadDim; e += kThreads) {
    const int r = e / kHeadDim, c = e % kHeadDim;
    const float* row = qkv + (row0 + r) * 3 * kCols + h * kHeadDim + c;
    const float dc = dctx[(row0 + r) * kCols + h * kHeadDim + c];
    q_s[r * kPad + c] = kBf16 ? round_bf16(row[0]) : row[0];
    k_s[r * kPad + c] = kBf16 ? round_bf16(row[kCols]) : row[kCols];
    v_s[r * kPad + c] = kBf16 ? round_bf16(row[2 * kCols]) : row[2 * kCols];
    d_s[r * kPad + c] = kBf16 ? round_bf16(dc) : dc;
  }
  for (int j = threadIdx.x; j < L; j += kThreads) m_s[j] = mask != nullptr ? mask[row0 + j] : 1.f;
  __syncthreads();

  for (int i = warp; i < L; i += kWarps) {          // sweep 1: query rows
    float qi[kHeadDim], di[kHeadDim];
#pragma unroll
    for (int c = 0; c < kHeadDim; ++c) {
      qi[c] = q_s[i * kPad + c];
      di[c] = d_s[i * kPad + c];
    }
    float mx = -INFINITY;
    for (int j = lane; j < L; j += 32) {
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < kHeadDim; ++c) s = fmaf(qi[c], k_s[j * kPad + c], s);
      s = m_s[j] == 0.f ? kBigNeg : s * scale;
      pa[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < L; j += 32) {
      const float e = expf(pa[j] - mx);
      pa[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    float dsum = 0.f;
    for (int j = lane; j < L; j += 32) {
      float dp = 0.f;
#pragma unroll
      for (int c = 0; c < kHeadDim; ++c) dp = fmaf(di[c], v_s[j * kPad + c], dp);
      const float p = pa[j] / sum, dpm = dp * keep(drop, b, h, i * L + j);
      pa[j] = p;
      pb[j] = dpm;
      dsum = fmaf(p, dpm, dsum);
    }
    dsum = warp_sum(dsum);
    __syncwarp();
    float dq = 0.f;                  // masked keys' scores are constants: no gradient
    for (int j = 0; j < L; ++j)
      if (m_s[j] != 0.f) {
        const float ds = pa[j] * (pb[j] - dsum);
        dq = fmaf(kBf16 ? round_bf16(ds) : ds, k_s[j * kPad + lane], dq);
      }
    dqkv[(row0 + i) * 3 * kCols + h * kHeadDim + lane] = dq * scale;
    if (lane == 0) {
      mx_s[i] = mx;
      sum_s[i] = sum;
      dd_s[i] = dsum;
    }
    __syncwarp();
  }
  __syncthreads();

  for (int j = warp; j < L; j += kWarps) {          // sweep 2: key rows
    float kj[kHeadDim], vj[kHeadDim];
#pragma unroll
    for (int c = 0; c < kHeadDim; ++c) {
      kj[c] = k_s[j * kPad + c];
      vj[c] = v_s[j * kPad + c];
    }
    const bool valid = m_s[j] != 0.f;
    for (int i = lane; i < L; i += 32) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < kHeadDim; ++c) {
        s = fmaf(q_s[i * kPad + c], kj[c], s);
        dp = fmaf(d_s[i * kPad + c], vj[c], dp);
      }
      s = valid ? s * scale : kBigNeg;
      const float p = expf(s - mx_s[i]) / sum_s[i];
      const float m = keep(drop, b, h, i * L + j);
      const float pd = p * m, ds = valid ? p * (dp * m - dd_s[i]) : 0.f;
      pa[i] = kBf16 ? round_bf16(pd) : pd;           // dropped weight: feeds dv
      pb[i] = kBf16 ? round_bf16(ds) : ds;           // ds: feeds dk
    }
    __syncwarp();
    float dk = 0.f, dv = 0.f;
    for (int i = 0; i < L; ++i) {
      dv = fmaf(pa[i], d_s[i * kPad + lane], dv);
      dk = fmaf(pb[i], q_s[i * kPad + lane], dk);
    }
    float* out = dqkv + (row0 + j) * 3 * kCols + h * kHeadDim + lane;
    out[kCols] = dk * scale;
    out[2 * kCols] = dv;
    __syncwarp();
  }
}

constexpr size_t kWgradSmem = sizeof(float) * (size_t)(2 * kGaFloats + 2 * kWsFloats);

inline size_t align4(size_t n) { return (n + 3) & ~(size_t)3; }

struct Launcher {
  cudaStream_t s;
  int rows, L;
  Dropout drop;
  float* partial;
  cudaError_t err = cudaSuccess;
  bool bf16 = false;

  bool check() {
    if (err == cudaSuccess) err = cudaGetLastError();
    return err == cudaSuccess;
  }
  int zs() const { return (rows + kChunk - 1) / kChunk; }
  unsigned grid1d(size_t n) const {
    return (unsigned)std::min<size_t>((n + kThreads - 1) / kThreads, 132 * 16);
  }

  void rowgemm(const RowGemm& p, int nout) {
    if (!check()) return;
    auto* kernel = p.gelu_gate ? (bf16 ? rowgemm_kernel<true, true> : rowgemm_kernel<true, false>)
                               : (bf16 ? rowgemm_kernel<false, true>
                                       : rowgemm_kernel<false, false>);
    kernel<<<dim3((rows + kRows - 1) / kRows, nout / kCols), kThreads, kGemmSmem, s>>>(
        p, rows, L, drop);
  }
  void ln_fwd(const float* in, const float* g, const float* beta, float* y, float* xhat,
              float* inv) {
    if (!check()) return;
    ln_fwd_kernel<<<(rows + kWarps - 1) / kWarps, kThreads, 0, s>>>(in, g, beta, y, xhat, inv,
                                                                     rows);
  }
  void ln_bwd(const float* dy, const float* xhat, const float* inv, const float* g, float* dx) {
    if (!check()) return;
    ln_bwd_kernel<<<(rows + kWarps - 1) / kWarps, kThreads, 0, s>>>(dy, xhat, inv, g, dx, rows);
  }
  // out = in (gelu(in) with gelu_in) * the dropout mask of `site`
  void dropout(const float* in, float* out, int width, int site, bool gelu_in = false) {
    if (!check()) return;
    dropout_kernel<<<grid1d((size_t)rows * width), kThreads, 0, s>>>(in, out, rows, width, L,
                                                                     site, drop, gelu_in);
  }
  // out = a + b over n floats
  void add(const float* a, const float* b, float* out, size_t n) {
    if (!check()) return;
    add_kernel<<<grid1d(n), kThreads, 0, s>>>(a, b, out, n);
  }
  void reduce(int Z, size_t n, float* out) {
    if (!check()) return;
    reduce_kernel<<<grid1d(n), kThreads, 0, s>>>(partial, Z, n, out);
  }
  // out[c] = sum over all rows of G[r][c] (* H[r][c])
  void colsum(const float* G, const float* H, int ld, int cols, float* out) {
    if (!check()) return;
    colsum_kernel<<<dim3((cols + 31) / 32, zs()), kThreads, 0, s>>>(
        G, H, ld, cols, rows, partial);
    reduce(zs(), cols, out);
  }
  // out[n][k] = sum over all rows of G[r][n] H[r][k]  (out [nout][K])
  void wgrad(const float* G, int ldg, int nout, const float* H, int ldh, int K, float* out) {
    if (!check()) return;
    auto* kernel = bf16 ? wgrad_kernel<true> : wgrad_kernel<false>;
    kernel<<<dim3(nout / kRows, K / kCols, zs()), kThreads, kWgradSmem, s>>>(G, ldg, H, ldh,
                                                                              rows, nout, K,
                                                                              partial);
    reduce(zs(), (size_t)nout * K, out);
  }
  // the attention backward of (b) over B sequences of L rows
  void attention_bwd(const float* qkv, const float* dctx, const float* mask, float* dqkv, int B,
                     int H, int len) {
    if (!check()) return;
    auto* kernel = bf16 ? attention_bwd_kernel<true> : attention_bwd_kernel<false>;
    kernel<<<dim3(H, B), kThreads, attention_bwd_smem_bytes(len), s>>>(qkv, dctx, mask, dqkv,
                                                                      len, drop);
  }
};

// The dynamic shared memory of the launches above (and of the forward
// attention the recompute runs), for sequences up to max_l.
inline cudaError_t layer_bwd_init(int max_l) {
  cudaError_t err = attention_init(max_l);
  for (auto* kernel : {rowgemm_kernel<false, false>, rowgemm_kernel<true, false>,
                       rowgemm_kernel<false, true>, rowgemm_kernel<true, true>})
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)kGemmSmem);
  for (auto* kernel : {attention_bwd_kernel<false>, attention_bwd_kernel<true>})
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)attention_bwd_smem_bytes(max_l));
  for (auto* kernel : {wgrad_kernel<false>, wgrad_kernel<true>})
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)kWgradSmem);
  return err;
}

}  // namespace
