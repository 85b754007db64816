// The launches of the port's transformer layers, forward and backward by
// recompute: the post-norm DETR encoder layer (fused_encoder_layer{,_bwd}.cu),
// the temporal-tower layer (fused_temporal_layer{,_bwd}.cu) and the DETR
// decoder layer (fused_decoder_layer{,_bwd}.cu).  Each layer's forward is
// one launch sequence (encoder_layer_fwd and temporal_layer_fwd here,
// decoder_layer_fwd in decoder_layer_kernels.cuh) that its backward's
// recompute runs too:
//
//  * rowgemm: activation x weight products over all rows on the wgmma core
//    of wgmma_gemm.cuh (128 x 128 tiles fed by TMA), the weight read as a
//    torch [N][K] weight or, for dX = dY W, as W[k][n] (MN-major, transposed
//    in shared memory), with the bias / ReLU / dropout / ReLU or GELU gate /
//    residual epilogue on the accumulators.
//  * wgrad: weight gradients dW = G^T H over all B*L rows on the same core,
//    both operands MN-major, K (the rows) split into 1024-row slices whose
//    partials reduce_kernel then sums in slice order; a bias gradient (the
//    column sums of G) is summed in the same product as G's slices are
//    converted (PartialSumEpi, the temporal layer's backward) or, with
//    colsum, in two passes of its own (32 columns per block).  No float
//    atomics: a step is reproducible from run to run.
//  * ln_fwd_kernel: LayerNorm statistics, one warp per row;
//    ln_bwd_sum_kernel: its backward with the gradients of its parameters
//    (column sums per 256-row block, summed in block order);
//    dropout_kernel: a mask over a tensor.
//  * attention_bwd_tc_kernel (and, at "bf16", the recompute's
//    attention_fwd_tc_kernel): the attention of one (head, batch row) on
//    the tensor cores (mma.sync: m16n8k16 bf16, or 3xTF32 m16n8k8), q, k,
//    v (and dctx) of the head in shared memory, FlashAttention-2 style: the
//    [L, L] weights are rebuilt from the row statistics and never leave
//    registers.  The backward runs two sweeps, over query rows (statistics,
//    D_i = sum_j p_ij m_ij dp_ij, then dq) and over key rows (dk, dv), so
//    every sum has one owner: no atomics.  At "f32" the recompute takes the
//    forward kernel's float32 attention, with its statistics.  (The
//    temporal layer's backward runs attention_bwd_wg.cuh's wgmma kernel up
//    to its kWgaMaxL instead.)
//
// Launcher strings them on one stream and keeps the first CUDA error.  Its
// bf16 flag takes every product with bf16 operands and float32 sums
// (precision "bf16"); LayerNorm, softmax, the column sums and the
// epilogues stay float32.
#pragma once

#include <algorithm>

#include "temporal_layer.cuh"
#include "wgmma_gemm.cuh"

namespace {

constexpr int kChunk = 1024;          // rows per split-K partial
constexpr int kVec = kCols / 32;      // LayerNorm row values per lane

// C[r][n] = epilogue(A[r][0..K) . W^T), n < Nout.  W is a torch [Nout][K]
// weight (row stride ldw), or with wt a row-major [K][Nout] matrix.
// Epilogue, in order: + bias, the store of that pre-activation to pre
// (same layout as C), the activation `act` (kActRelu or kActGelu), *
// dropout mask of `site` (element l * width + column), the gate (zero where
// gate <= 0: the ReLU's derivative; with gelu_gate, times gelu'(gate): the
// GELU's at its input), + res, + res2 (RowEpi compiles only the parts a
// launch applies).
struct RowGemm {
  const float* A; int lda; int K;
  const float* W; int ldw; int wt;
  const float* bias; int act; int site; int width;
  const float* gate; int ldgate;
  const float* res; int ldres;
  float* C; int ldc;
  int gelu_gate;
  const float* res2; int ldres2;   // a second residual, added last
  float* pre;
};

// The epilogue's parts, as compile-time flags, so an epilogue compiles only
// what it applies (and keeps its registers for the accumulators).
enum : unsigned { kEpiBias = 1, kEpiRelu = 2, kEpiDrop = 4, kEpiGate = 8, kEpiGelu = 16,
                  kEpiRes = 32, kEpiRes2 = 64, kEpiGeluAct = 128, kEpiPre = 256 };
// RowGemm::act
enum : int { kActRelu = 1, kActGelu = 2 };

// Mask values kp[h][e] of columns c + e (c even, a multiple of 4 apart
// between the quads) of rows r0 (h = 0) and r1 (h = 1) of a GEMM
// accumulator: the two lanes of a pair (lane 2i, 2i + 1) share their rows
// and a group of four columns, one Philox call's words (group(row, first
// column)), so the even lane draws row r0's group, the odd lane row r1's,
// and they swap.  Every lane of the warp calls it.
template <class Group>
__device__ __forceinline__ void pair_keep(const Dropout& d, Group group, int r0, int r1, int c,
                                          float (&kp)[2][2]) {
  const int odd = threadIdx.x & 1;
  const uint4 mine = group(odd ? r1 : r0, c & ~3);
  uint4 other;
  other.x = __shfl_xor_sync(0xffffffffu, mine.x, 1);
  other.y = __shfl_xor_sync(0xffffffffu, mine.y, 1);
  other.z = __shfl_xor_sync(0xffffffffu, mine.z, 1);
  other.w = __shfl_xor_sync(0xffffffffu, mine.w, 1);
  const uint4 w[2] = {odd ? other : mine, odd ? mine : other};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    kp[h][0] = word_of(w[h], c & 2) >= d.thresh ? d.scale : 0.f;
    kp[h][1] = word_of(w[h], (c & 2) + 1) >= d.thresh ? d.scale : 0.f;
  }
}

template <unsigned F>
struct RowEpi {
  RowGemm p;
  int L;
  Dropout drop;
  static constexpr bool kWarpKeep = (F & kEpiDrop) != 0;
  __device__ void warp_keep(int, int r0, int r1, int c, float (&kp)[2][2]) const {
    pair_keep(drop, [&](int r, int c4) {
      return philox4(drop.seed, r / L, p.site, ((r % L) * p.width + c4) >> 2);
    }, r0, r1, c, kp);
  }
  // the inputs of columns n, n + 1 (n even), loaded ahead of the stores
  struct In {
    float2 bias, gate, res, res2;
  };
  __device__ In load(int r, int n) const {
    In in;
    if (F & kEpiBias) in.bias = *reinterpret_cast<const float2*>(p.bias + n);
    if (F & kEpiGate) in.gate = *reinterpret_cast<const float2*>(p.gate + (size_t)r * p.ldgate + n);
    if (F & kEpiRes) in.res = *reinterpret_cast<const float2*>(p.res + (size_t)r * p.ldres + n);
    if (F & kEpiRes2)
      in.res2 = *reinterpret_cast<const float2*>(p.res2 + (size_t)r * p.ldres2 + n);
    return in;
  }
  __device__ float2 apply(int r, int n, float2 o, const In& in, const float (&kp)[2],
                         bool two = true) const {
    if (F & kEpiBias) {
      o.x += in.bias.x;
      o.y += in.bias.y;
    }
    if (F & kEpiPre) {
      float* pre = p.pre + (size_t)r * p.ldc + n;
      if (two)
        *reinterpret_cast<float2*>(pre) = o;
      else
        *pre = o.x;
    }
    if (F & kEpiRelu) {
      o.x = fmaxf(o.x, 0.f);
      o.y = fmaxf(o.y, 0.f);
    }
    if (F & kEpiGeluAct) {
      o.x = gelu(o.x);
      o.y = gelu(o.y);
    }
    if (F & kEpiDrop) {
      o.x *= kp[0];
      o.y *= kp[1];
    }
    if (F & kEpiGate) {
      if (F & kEpiGelu) {
        o.x *= gelu_grad(in.gate.x);
        o.y *= gelu_grad(in.gate.y);
      } else {
        if (!(in.gate.x > 0.f)) o.x = 0.f;
        if (!(in.gate.y > 0.f)) o.y = 0.f;
      }
    }
    if (F & kEpiRes) {
      o.x += in.res.x;
      o.y += in.res.y;
    }
    if (F & kEpiRes2) {
      o.x += in.res2.x;
      o.y += in.res2.y;
    }
    return o;
  }
  __device__ void pair(int, int r, int n, float v0, float v1, const In& in,
                       const float (&kp)[2]) const {
    *reinterpret_cast<float2*>(p.C + (size_t)r * p.ldc + n) =
        apply(r, n, make_float2(v0, v1), in, kp);
  }
  // a last odd column n
  __device__ void operator()(int, int r, int n, float v) const {
    In in;
    if (F & kEpiBias) in.bias.x = p.bias[n];
    if (F & kEpiGate) in.gate.x = p.gate[(size_t)r * p.ldgate + n];
    if (F & kEpiRes) in.res.x = p.res[(size_t)r * p.ldres + n];
    if (F & kEpiRes2) in.res2.x = p.res2[(size_t)r * p.ldres2 + n];
    in.bias.y = in.gate.y = in.res.y = in.res2.y = 0.f;
    float kp[2] = {1.f, 1.f};
    if (F & kEpiDrop) kp[0] = keep(drop, r / L, p.site, (r % L) * p.width + n);
    p.C[(size_t)r * p.ldc + n] = apply(r, n, make_float2(v, 0.f), in, kp, false).x;
  }
};

// LayerNorm of each [256] row: y = xhat * g + beta, xhat and 1 / std, each
// written where its pointer is not null.  One warp per row.
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
    if (xhat) xhat[(size_t)row * kCols + c] = xh;
    if (y) y[(size_t)row * kCols + c] = xh * g[c] + beta[c];
  }
  if (lane == 0 && inv_out) inv_out[row] = inv;
}

// Row kernels with column sums: a block takes kSumRows consecutive rows,
// each warp kSumRows / kWarps of them in order, and writes its NQ column
// sums ([NQ][D], over its rows) to part + blockIdx.x * stride; the warps'
// sums are added in warp order and the blocks' later in block order
// (sum_blocks_kernel), so the sums are reproducible.
constexpr int kSumRows = 256;

template <int NQ>
__device__ void write_block_sums(float (&acc)[NQ][kVec], float* __restrict__ part, int stride) {
  __shared__ float ws_[kWarps][NQ][kCols];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int t = 0; t < kVec; ++t) ws_[warp][q][lane + 32 * t] = acc[q][t];
  __syncthreads();
  for (int e = threadIdx.x; e < NQ * kCols; e += blockDim.x) {
    float sum = 0.f;
    for (int w = 0; w < kWarps; ++w) sum += ws_[w][e / kCols][e % kCols];
    part[(size_t)blockIdx.x * stride + e] = sum;
  }
}

// out.p[q][c] = sum over blocks z < Z, in order, of part[z * stride + q D + c]:
// launch block q sums the q-th column sum.
template <int NQ>
struct SumOut {
  float* p[NQ];
};

template <int NQ>
__global__ void sum_blocks_kernel(const float* __restrict__ part, int Z, int stride,
                                  SumOut<NQ> out) {
  const float* src = part + (size_t)blockIdx.x * kCols + threadIdx.x;
  float acc = 0.f;
#pragma unroll 8
  for (int z = 0; z < Z; ++z) acc += src[(size_t)z * stride];
  out.p[blockIdx.x][threadIdx.x] = acc;
}

// LayerNorm's backward with its parameters' gradients: dx = (dy g - mean(dy
// g) - xhat mean(dy g xhat)) / std, and the column sums dy xhat (dg), dy
// (dbeta) and, with NQ = 3, dx.
template <int NQ>
__global__ void __launch_bounds__(kThreads)
ln_bwd_sum_kernel(const float* __restrict__ dy, const float* __restrict__ xhat,
                  const float* __restrict__ inv, const float* __restrict__ gamma,
                  float* __restrict__ dx, float* __restrict__ part, int stride, int rows) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float acc[NQ][kVec] = {};
  constexpr int kWarpRows = kSumRows / kWarps;
  for (int i = 0; i < kWarpRows; ++i) {
    const int row = blockIdx.x * kSumRows + warp * kWarpRows + i;
    if (row >= rows) break;
    const size_t base = (size_t)row * kCols;
    float dyg[kVec], xh[kVec], s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int t = 0; t < kVec; ++t) {
      const int c = lane + 32 * t;
      const float d = dy[base + c];
      xh[t] = xhat[base + c];
      acc[0][t] = fmaf(d, xh[t], acc[0][t]);
      acc[1][t] += d;
      dyg[t] = d * gamma[c];
      s1 += dyg[t];
      s2 = fmaf(dyg[t], xh[t], s2);
    }
    const float m1 = warp_sum(s1) / kCols, m2 = warp_sum(s2) / kCols, iv = inv[row];
#pragma unroll
    for (int t = 0; t < kVec; ++t) {
      const float v = (dyg[t] - m1 - xh[t] * m2) * iv;
      dx[base + lane + 32 * t] = v;
      if constexpr (NQ == 3) acc[2][t] += v;
    }
  }
  write_block_sums<NQ>(acc, part, stride);
}

// out = in * dropout mask of `site` over a [rows][width] tensor (width a
// multiple of 4), four elements per thread: one Philox call gives a group's
// four mask words.
__global__ void dropout_kernel(const float* __restrict__ in, float* __restrict__ out,
                               int rows, int width, int L, int site, Dropout drop) {
  const size_t n4 = (size_t)rows * width / 4;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    const int gr = (int)(4 * i / width), c = (int)(4 * i % width);
    float4 v = reinterpret_cast<const float4*>(in)[i];
    if (drop.thresh != 0u) {
      const uint4 w = philox4(drop.seed, gr / L, site, ((gr % L) * width + c) >> 2);
      v.x *= w.x >= drop.thresh ? drop.scale : 0.f;
      v.y *= w.y >= drop.thresh ? drop.scale : 0.f;
      v.z *= w.z >= drop.thresh ? drop.scale : 0.f;
      v.w *= w.w >= drop.thresh ? drop.scale : 0.f;
    }
    reinterpret_cast<float4*>(out)[i] = v;
  }
}

__global__ void add_kernel(const float* __restrict__ a, const float* __restrict__ b,
                           float* __restrict__ out, size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    out[i] = a[i] + b[i];
}

// P[z][c] = sum over rows of chunk z of G[r][c]: a block takes 32 columns
// and its warps every kWarps-th row of the chunk (one row of 32 columns is
// one 128-byte read), then adds the warps' totals in warp order.
__global__ void colsum_kernel(const float* __restrict__ G, int ld, int cols, int rows,
                              float* __restrict__ P) {
  __shared__ float part[kWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane, z = blockIdx.y;
  const int r1 = min(rows, (z + 1) * kChunk);
  float s = 0.f;
  if (c < cols)
    for (int r = z * kChunk + warp; r < r1; r += kWarps)
      s += G[(size_t)r * ld + c];
  part[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && c < cols) {
    float t = 0.f;
    for (int w = 0; w < kWarps; ++w) t += part[w][lane];
    P[(size_t)z * cols + c] = t;
  }
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

// The same for a weight gradient with its bias (PartialSumEpi): out[i] as
// above for i < n, and bias[m] = sum_z (Pb[z][0][m] + Pb[z][1][m]), z in
// order, Pb = P + Z n.
__global__ void reduce_wb_kernel(const float* __restrict__ P, int Z, size_t n, int M,
                                 float* __restrict__ out, float* __restrict__ bias) {
  const float* Pb = P + (size_t)Z * n;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n + M;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    if (i < n) {
      for (int z = 0; z < Z; ++z) s += P[(size_t)z * n + i];
      out[i] = s;
    } else {
      const size_t m = i - n;
      for (int z = 0; z < Z; ++z) {
        s += Pb[(size_t)2 * z * M + m];
        s += Pb[(size_t)(2 * z + 1) * M + m];
      }
      bias[m] = s;
    }
  }
}

// ---- attention on the tensor cores (one block per (head, batch row))

// ten warps, one 16-row block each at L = 152; the backward is bounded to
// 96 registers a thread, so that two of its blocks share an SM
constexpr int kAttThreads = 320;

// Sequences padded to a multiple of 16 rows.  Each head tensor X [L, 32]
// sits in shared memory in the form its fragments read:
//  * float32: Xt[channel][row], row stride att_ld = 8 mod 16 floats, so
//    fragment reads hit distinct banks; each value is split into its two
//    tf32 halves as a fragment is loaded;
//  * bf16: rounded once as it is staged, in bf16 pairs: Ck[c / 2][row]
//    (channels c, c + 1 of a row: the operands of q.k-type products) and
//    Pp[channel][r / 2] (rows r, r + 1 of a channel: the B operand of
//    p.v-type products), row strides att_ld and att_ldp = 4 mod 8 words.
__host__ __device__ constexpr int att_lp(int L) { return (L + 15) & ~15; }
__host__ __device__ constexpr int att_ld(int L) { return att_lp(L) + 8; }
__host__ __device__ constexpr int att_ldp(int L) { return att_lp(L) / 2 + 4; }
__host__ __device__ constexpr int att_words(int L) { return (att_lp(L) + 31) / 32; }
// 4-byte words of one head tensor (the same at both precisions)
__host__ __device__ constexpr int att_head_words(int L) { return kHeadDim * att_ld(L); }
// head tensors, four [Lp] rows, and (backward) the dropout mask's bits
__host__ __device__ constexpr size_t attention_tc_smem_bytes(int L, int arrays) {
  return sizeof(float) * ((size_t)arrays * att_head_words(L) + 4 * (size_t)att_lp(L) +
                          (arrays == 4 ? (size_t)att_lp(L) * att_words(L) : 0));
}

template <bool kBf16>
struct Head {
  const float* xt;     // float32: Xt[c][r]
  int ld;
  __device__ Head(const float* base, int L) : xt(base), ld(att_ld(L)) {}
};
template <>
struct Head<true> {
  const unsigned* ck;  // bf16 pairs along the channels
  const unsigned* pp;  // bf16 pairs along the rows
  int ld, ldp;
  __device__ Head(const float* base, int L)
      : ck(reinterpret_cast<const unsigned*>(base)),
        pp(reinterpret_cast<const unsigned*>(base) + (kHeadDim / 2) * att_ld(L)),
        ld(att_ld(L)), ldp(att_ldp(L)) {}
};

// Stages rows [0, L) of a head tensor (row stride rstride in device
// memory) into `base` in Head<kBf16>'s form, rows L .. Lp - 1 as zeros.
template <bool kBf16>
__device__ void stage_head(float* base, const float* __restrict__ src, size_t rstride, int L) {
  const int Lp = att_lp(L), ld = att_ld(L);
  if constexpr (kBf16) {
    unsigned* ck = reinterpret_cast<unsigned*>(base);
    unsigned* pp = ck + (kHeadDim / 2) * ld;
    const int ldp = att_ldp(L);
    for (int e = threadIdx.x; e < Lp * (kHeadDim / 2); e += blockDim.x) {
      const int r = e / (kHeadDim / 2), c2 = e % (kHeadDim / 2);
      float2 v = make_float2(0.f, 0.f);
      if (r < L) v = *reinterpret_cast<const float2*>(src + (size_t)r * rstride + 2 * c2);
      ck[c2 * ld + r] = pack_bf16(v.x, v.y);
    }
    for (int e = threadIdx.x; e < (Lp / 2) * kHeadDim; e += blockDim.x) {
      const int r2 = e / kHeadDim, c = e % kHeadDim;
      const float a = 2 * r2 < L ? src[(size_t)(2 * r2) * rstride + c] : 0.f;
      const float b = 2 * r2 + 1 < L ? src[(size_t)(2 * r2 + 1) * rstride + c] : 0.f;
      pp[c * ldp + r2] = pack_bf16(a, b);
    }
  } else {
    for (int e = threadIdx.x; e < Lp * kHeadDim; e += blockDim.x) {
      const int r = e / kHeadDim, c = e % kHeadDim;
      base[c * ld + r] = r < L ? src[(size_t)r * rstride + c] : 0.f;
    }
  }
}

// The A fragments of rows r0 .. r0 + 15 of a head tensor over its 32
// channels: 4 k-steps of m16n8k8 (tf32 halves, split once here) or 2 of
// m16n8k16 (bf16 pairs).
template <bool kBf16>
struct RowFrag {
  unsigned hi[4][4], lo[4][4];
};
template <>
struct RowFrag<true> {
  unsigned v[2][4];
};

__device__ __forceinline__ void mma3s(float (&c)[4], const unsigned (&ah)[4],
                                      const unsigned (&al)[4], float b0, float b1) {
  unsigned bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

template <bool kBf16>
__device__ __forceinline__ void load_row_frag(RowFrag<kBf16>& f, const Head<kBf16>& X, int r0,
                                              int g, int t) {
  const int ra = r0 + g, rb = r0 + g + 8;
  if constexpr (kBf16) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const unsigned* k0 = X.ck + (8 * s + t) * X.ld;
      const unsigned* k1 = k0 + 4 * X.ld;
      f.v[s][0] = k0[ra];
      f.v[s][1] = k0[rb];
      f.v[s][2] = k1[ra];
      f.v[s][3] = k1[rb];
    }
  } else {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int o0 = (8 * s + t) * X.ld, o1 = o0 + 4 * X.ld;
      split_tf32(X.xt[o0 + ra], f.hi[s][0], f.lo[s][0]);
      split_tf32(X.xt[o0 + rb], f.hi[s][1], f.lo[s][1]);
      split_tf32(X.xt[o1 + ra], f.hi[s][2], f.lo[s][2]);
      split_tf32(X.xt[o1 + rb], f.hi[s][3], f.lo[s][3]);
    }
  }
}

// c = rows(f) . X[c0 .. c0 + 8)^T over the 32 channels (a 16 x 8 tile in
// the C-fragment layout: c[e] at row g + 8 (e / 2), column 2 t + e % 2).
template <bool kBf16>
__device__ __forceinline__ void dot_tile(float (&c)[4], const RowFrag<kBf16>& f,
                                         const Head<kBf16>& X, int c0, int g, int t) {
  // two independent accumulation chains (even and odd k-steps), summed at
  // the end, so consecutive products do not wait on each other
  float c2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] = 0.f;
  const int col = c0 + g;
  if constexpr (kBf16) {
    const unsigned* k0 = X.ck + t * X.ld;
    const unsigned* k1 = X.ck + (8 + t) * X.ld;
    mma_bf16(c, f.v[0], k0[col], k0[4 * X.ld + col]);
    mma_bf16(c2, f.v[1], k1[col], k1[4 * X.ld + col]);
  } else {
#pragma unroll
    for (int s = 0; s < 4; s += 2) {
      const int o0 = (8 * s + t) * X.ld + col, o1 = o0 + 8 * X.ld;
      mma3s(c, f.hi[s], f.lo[s], X.xt[o0], X.xt[o0 + 4 * X.ld]);
      mma3s(c2, f.hi[s + 1], f.lo[s + 1], X.xt[o1], X.xt[o1 + 4 * X.ld]);
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += c2[e];
}

// acc[nd] (16 rows x channels 8 nd .. 8 nd + 7) += x . X[p0 .. p0 + 16),
// x the C fragments of two 16 x 8 tiles over positions p0 .. p0 + 15: the
// fragments become A operands in place (bf16: the m16n8k16 pairing, x
// rounded as it is packed; tf32: each tile one k-step with its k order
// permuted, position p0 + 2t + e standing at k t + 4 e, and X's rows read
// in the same order).
template <bool kBf16>
__device__ __forceinline__ void acc_pv(float (&acc)[4][4], const float (&x)[2][4],
                                       const Head<kBf16>& X, int p0, int g, int t) {
  if constexpr (kBf16) {
    const unsigned a[4] = {pack_bf16(x[0][0], x[0][1]), pack_bf16(x[0][2], x[0][3]),
                           pack_bf16(x[1][0], x[1][1]), pack_bf16(x[1][2], x[1][3])};
#pragma unroll
    for (int nd = 0; nd < 4; ++nd) {
      const unsigned* row = X.pp + (8 * nd + g) * X.ldp + p0 / 2 + t;
      mma_bf16(acc[nd], a, row[0], row[4]);
    }
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      unsigned ah[4], al[4];
      split_tf32(x[h][0], ah[0], al[0]);
      split_tf32(x[h][2], ah[1], al[1]);
      split_tf32(x[h][1], ah[2], al[2]);
      split_tf32(x[h][3], ah[3], al[3]);
#pragma unroll
      for (int nd = 0; nd < 4; ++nd) {
        const int o = (8 * nd + g) * X.ld + p0 + 8 * h + 2 * t;
        mma3s(acc[nd], ah, al, X.xt[o], X.xt[o + 1]);
      }
    }
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Online softmax statistics of this thread's two rows: running max mx,
// sum of exp l and (with dd) sum of exp times m dp, over one 16 x 8 tile
// of scaled scores v (padding keys at -inf).
__device__ __forceinline__ void online_update(const float (&v)[4], const float* w, float (&mx)[2],
                                              float (&l)[2], float* dd) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const float tmax = fmaxf(v[2 * rr], v[2 * rr + 1]);
    if (tmax > mx[rr]) {
      const float a = expf(mx[rr] - tmax);
      l[rr] *= a;
      if (dd) dd[rr] *= a;
      mx[rr] = tmax;
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (v[2 * rr + u] == -INFINITY) continue;
      const float e = expf(v[2 * rr + u] - mx[rr]);
      l[rr] += e;
      if (dd) dd[rr] = fmaf(e, w[2 * rr + u], dd[rr]);
    }
  }
}

// Combines the quad's partial statistics (the four lanes of a row).
__device__ __forceinline__ void quad_combine(float (&mx)[2], float (&l)[2], float* dd) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const float m = quad_max(mx[rr]);
    const float a = mx[rr] == -INFINITY ? 0.f : expf(mx[rr] - m);
    l[rr] = quad_sum(l[rr] * a);
    if (dd) dd[rr] = quad_sum(dd[rr] * a);
    mx[rr] = m;
  }
}

// Scaled scores of one tile: a masked key (msk 0) at -1e9, a padding key
// (msk < 0) at -inf.
__device__ __forceinline__ void scaled(float (&v)[4], const float (&c)[4], const float* msk,
                                       int j0, int t, float scale) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float m = msk[j0 + 2 * t + (e & 1)];
    v[e] = m < 0.f ? -INFINITY : (m != 0.f ? c[e] * scale : kBigNeg);
  }
}

// The dropout mask values kq[rr][u] of weights (ir + 8 rr, j + u), j the
// thread's even column: when L is a multiple of 4 every row starts a group
// of four mask words, so a lane pair draws each group once (pair_keep);
// else one Philox call per pair (keep2).  Every lane of the warp calls it;
// values outside [0, L) are not used.
__device__ __forceinline__ void att_keep(const Dropout& drop, int b, int h, int L, int ir, int j,
                                         float (&kq)[2][2]) {
  if (drop.thresh == 0u) {
    kq[0][0] = kq[0][1] = kq[1][0] = kq[1][1] = 1.f;
  } else if ((L & 3) == 0) {
    pair_keep(drop, [&](int r, int c4) {
      return philox4(drop.seed, b, h, (unsigned)(r * L + c4) >> 2);
    }, ir, ir + 8, j, kq);
  } else {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int i = ir + 8 * rr;
      kq[rr][0] = kq[rr][1] = 0.f;
      if (i < L && j < L) keep2(drop, b, h, i * L + j, kq[rr][0], kq[rr][1]);
    }
  }
}

// The recompute's attention forward at precision "bf16": ctx [B, L, D] from
// qkv [B, L, 3D] (q, k, v rounded to bf16 as staged), and each row's softmax
// max and sum [B, H, L] into stats.  The weights are normalized, dropped
// (as torch does, after the softmax) and rounded to bf16 before p v: JAX's
// order.  A null mask means every key is valid.
__global__ void __launch_bounds__(kAttThreads)
attention_fwd_tc_kernel(const float* __restrict__ qkv, const float* __restrict__ mask,
                        float* __restrict__ ctx, float2* __restrict__ stats, int L, Dropout drop) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int h = blockIdx.x, b = blockIdx.y, Lp = att_lp(L), hw = att_head_words(L);
  float* msk = sm + 3 * hw;
  const size_t row0 = (size_t)b * L;
  const float* base = qkv + row0 * 3 * kCols + h * kHeadDim;
  stage_head<true>(sm, base, 3 * kCols, L);
  stage_head<true>(sm + hw, base + kCols, 3 * kCols, L);
  stage_head<true>(sm + 2 * hw, base + 2 * kCols, 3 * kCols, L);
  for (int j = threadIdx.x; j < Lp; j += blockDim.x)
    msk[j] = j < L ? (mask != nullptr ? mask[row0 + j] : 1.f) : -1.f;
  __syncthreads();
  const Head<true> Q(sm, L), K(sm + hw, L), V(sm + 2 * hw, L);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const float scale = 1.0f / sqrtf((float)kHeadDim);
  for (int r0 = 16 * warp; r0 < Lp; r0 += 16 * (kAttThreads / 32)) {
    RowFrag<true> qa;
    load_row_frag(qa, Q, r0, g, t);
    float mx[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    for (int j0 = 0; j0 < Lp; j0 += 8) {
      float c[4], v[4];
      dot_tile(c, qa, K, j0, g, t);
      scaled(v, c, msk, j0, t, scale);
      online_update(v, nullptr, mx, l, nullptr);
    }
    quad_combine(mx, l, nullptr);
    if (stats != nullptr && t == 0)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
        if (r0 + g + 8 * rr < L)
          stats[((size_t)b * gridDim.x + h) * L + r0 + g + 8 * rr] = make_float2(mx[rr], l[rr]);
    float acc[4][4] = {};
    for (int j0 = 0; j0 < Lp; j0 += 16) {
      float x[2][4];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float c[4], v[4];
        dot_tile(c, qa, K, j0 + 8 * hf, g, t);
        scaled(v, c, msk, j0 + 8 * hf, t, scale);
        float kq[2][2];
        att_keep(drop, b, h, L, r0 + g, j0 + 8 * hf + 2 * t, kq);
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            float p = v[2 * rr + u] == -INFINITY ? 0.f : expf(v[2 * rr + u] - mx[rr]);
            x[hf][2 * rr + u] = p / l[rr] * kq[rr][u];
          }
        }
      }
      acc_pv<true>(acc, x, V, j0, g, t);
    }
#pragma unroll
    for (int nd = 0; nd < 4; ++nd)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int i = r0 + g + 8 * rr;
        if (i < L)
          *reinterpret_cast<float2*>(ctx + (row0 + i) * kCols + h * kHeadDim + 8 * nd + 2 * t) =
              make_float2(acc[nd][2 * rr], acc[nd][2 * rr + 1]);
      }
  }
}

// The attention backward of one (head, batch row): q, k, v, dctx of the
// head in shared memory.  Sweep 1, a warp per 16 query rows: one pass for
// the softmax statistics and D_i = sum_j p_ij m_ij dp_ij (dp = dctx v^T,
// online), then dq = scale ds k with ds = p (dp m - D) (zero at masked
// keys: their scores are constants).  Sweep 2, a warp per 16 key rows:
// dv = (p m)^T dctx and dk = scale ds^T q, from the statistics sweep 1
// left in shared memory.  The dropout mask is drawn once, in sweep 1's
// first pass, and kept as bits.  Writes dq | dk | dv into dqkv [B, L, 3D].
// kBf16: q, k, v and dctx rounded to bf16 as they are staged, and the
// dropped weights and ds as they enter their products.
template <bool kBf16>
__global__ void __launch_bounds__(kAttThreads, 2)
attention_bwd_tc_kernel(const float* __restrict__ qkv, const float* __restrict__ dctx,
                        const float* __restrict__ mask, const float* __restrict__ ctx,
                        const float2* __restrict__ stats, float* __restrict__ dqkv, int L,
                        Dropout drop) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int h = blockIdx.x, b = blockIdx.y, Lp = att_lp(L), hw = att_head_words(L);
  // per query row: max, 1 / sum of exp, D
  float *msk = sm + 4 * hw, *mx_s = msk + Lp, *sum_s = mx_s + Lp, *dd_s = sum_s + Lp;
  // bit j % 32 of word i W + j / 32: the dropout mask of weight (i, j),
  // drawn once in sweep 1 and read by the later passes
  const int W = att_words(L);
  unsigned* bits = reinterpret_cast<unsigned*>(dd_s + Lp);
  for (int e = threadIdx.x; e < Lp * W; e += blockDim.x) bits[e] = 0u;
  auto mkeep = [&](int i, int j) {
    if (drop.thresh == 0u) return 1.f;
    return (bits[i * W + (j >> 5)] >> (j & 31)) & 1u ? drop.scale : 0.f;
  };
  const size_t row0 = (size_t)b * L;
  const float* base = qkv + row0 * 3 * kCols + h * kHeadDim;
  stage_head<kBf16>(sm, base, 3 * kCols, L);
  stage_head<kBf16>(sm + hw, base + kCols, 3 * kCols, L);
  stage_head<kBf16>(sm + 2 * hw, base + 2 * kCols, 3 * kCols, L);
  stage_head<kBf16>(sm + 3 * hw, dctx + row0 * kCols + h * kHeadDim, kCols, L);
  for (int j = threadIdx.x; j < Lp; j += blockDim.x)
    msk[j] = j < L ? (mask != nullptr ? mask[row0 + j] : 1.f) : -1.f;
  __syncthreads();
  const Head<kBf16> Q(sm, L), K(sm + hw, L), V(sm + 2 * hw, L), Dc(sm + 3 * hw, L);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const float scale = 1.0f / sqrtf((float)kHeadDim);
  constexpr int kStep = 16 * (kAttThreads / 32);

  for (int r0 = 16 * warp; r0 < Lp; r0 += kStep) {          // sweep 1: query rows
    RowFrag<kBf16> qa, da;
    load_row_frag(qa, Q, r0, g, t);
    load_row_frag(da, Dc, r0, g, t);
    float mx[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, dd[2] = {0.f, 0.f};
    float il[2];
    const bool from_fwd = stats != nullptr;
    if (from_fwd) {
      // the recompute's statistics, and D_i = dctx_i . ctx_i (= sum_j p_ij
      // m_ij dp_ij, ctx_i being sum_j p_ij m_ij v_j): no pass over the keys
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int i = r0 + g + 8 * rr;
        float part = 0.f;
        if (i < L) {
          const float2 st = stats[((size_t)b * gridDim.x + h) * L + i];
          mx[rr] = st.x;
          l[rr] = st.y;
          const float* a1 = dctx + (row0 + i) * kCols + h * kHeadDim + 8 * t;
          const float* a2 = ctx + (row0 + i) * kCols + h * kHeadDim + 8 * t;
#pragma unroll
          for (int c = 0; c < 8; ++c) part = fmaf(a1[c], a2[c], part);
        } else {
          l[rr] = 1.f;
        }
        dd[rr] = quad_sum(part);
        il[rr] = 1.f / l[rr];
      }
    } else {
      for (int j0 = 0; j0 < Lp; j0 += 8) {
        float c[4], dp[4], v[4], w[4];
        dot_tile(c, qa, K, j0, g, t);
        dot_tile(dp, da, V, j0, g, t);
        scaled(v, c, msk, j0, t, scale);
        float kq[2][2];
        att_keep(drop, b, h, L, r0 + g, j0 + 2 * t, kq);
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int j = j0 + 2 * t, i = r0 + g + 8 * rr;
          const float kp[2] = {kq[rr][0], kq[rr][1]};
          if (i < L && j < L) {
            if (drop.thresh != 0u)
              atomicOr(&bits[i * W + (j >> 5)],
                       ((kp[0] != 0.f ? 1u : 0u) | (kp[1] != 0.f ? 2u : 0u)) << (j & 31));
          }
          w[2 * rr] = dp[2 * rr] * kp[0];
          w[2 * rr + 1] = dp[2 * rr + 1] * kp[1];
        }
        online_update(v, w, mx, l, dd);
      }
      quad_combine(mx, l, dd);
      il[0] = 1.f / l[0];
      il[1] = 1.f / l[1];
      dd[0] *= il[0];
      dd[1] *= il[1];
      __syncwarp();
    }
    float dq[4][4] = {};
    for (int j0 = 0; j0 < Lp; j0 += 16) {
      float x[2][4];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float c[4], dp[4];
        dot_tile(c, qa, K, j0 + 8 * hf, g, t);
        dot_tile(dp, da, V, j0 + 8 * hf, g, t);
        float kq[2][2];
        if (from_fwd) att_keep(drop, b, h, L, r0 + g, j0 + 8 * hf + 2 * t, kq);
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int j = j0 + 8 * hf + 2 * t, i = r0 + g + 8 * rr;
          float kp[2] = {0.f, 0.f};
          if (i < L && j < L) {
            if (from_fwd) {
              kp[0] = kq[rr][0];
              kp[1] = kq[rr][1];
              if (drop.thresh != 0u)
                atomicOr(&bits[i * W + (j >> 5)],
                         ((kp[0] != 0.f ? 1u : 0u) | (kp[1] != 0.f ? 2u : 0u)) << (j & 31));
            } else {
              kp[0] = mkeep(i, j);
              kp[1] = mkeep(i, j + 1);
            }
          }
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            float ds = 0.f;
            if (msk[j + u] > 0.f && i < L) {
              const float p = expf(c[2 * rr + u] * scale - mx[rr]) * il[rr];
              ds = p * (dp[2 * rr + u] * kp[u] - dd[rr]);
            }
            x[hf][2 * rr + u] = ds;
          }
        }
      }
      acc_pv<kBf16>(dq, x, K, j0, g, t);
    }
#pragma unroll
    for (int nd = 0; nd < 4; ++nd)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int i = r0 + g + 8 * rr;
        if (i < L)
          *reinterpret_cast<float2*>(dqkv + (row0 + i) * 3 * kCols + h * kHeadDim + 8 * nd +
                                     2 * t) =
              make_float2(dq[nd][2 * rr] * scale, dq[nd][2 * rr + 1] * scale);
      }
    if (t == 0) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        mx_s[r0 + g + 8 * rr] = mx[rr];
        sum_s[r0 + g + 8 * rr] = il[rr];
        dd_s[r0 + g + 8 * rr] = dd[rr];
      }
    }
  }
  __syncthreads();

  for (int j0 = 16 * warp; j0 < Lp; j0 += kStep) {          // sweep 2: key rows
    RowFrag<kBf16> ka, va;
    load_row_frag(ka, K, j0, g, t);
    load_row_frag(va, V, j0, g, t);
    const float mj[2] = {msk[j0 + g], msk[j0 + g + 8]};
    float dk[4][4] = {}, dv[4][4] = {};
    for (int i0 = 0; i0 < Lp; i0 += 16) {
      float xp[2][4], xs[2][4];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float st[4], dpt[4];
        dot_tile(st, ka, Q, i0 + 8 * hf, g, t);
        dot_tile(dpt, va, Dc, i0 + 8 * hf, g, t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i0 + 8 * hf + 2 * t + (e & 1), j = j0 + g + 8 * (e >> 1);
          const float m = mj[e >> 1];
          float pm = 0.f, ds = 0.f;
          if (m >= 0.f && i < L) {
            const float p = expf((m != 0.f ? st[e] * scale : kBigNeg) - mx_s[i]) * sum_s[i];
            const float k = mkeep(i, j);
            pm = p * k;
            if (m != 0.f) ds = p * (dpt[e] * k - dd_s[i]);
          }
          xp[hf][e] = pm;
          xs[hf][e] = ds;
        }
      }
      acc_pv<kBf16>(dv, xp, Dc, i0, g, t);
      acc_pv<kBf16>(dk, xs, Q, i0, g, t);
    }
#pragma unroll
    for (int nd = 0; nd < 4; ++nd)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int j = j0 + g + 8 * rr;
        if (j < L) {
          float* out = dqkv + (row0 + j) * 3 * kCols + h * kHeadDim + 8 * nd + 2 * t;
          *reinterpret_cast<float2*>(out + kCols) =
              make_float2(dk[nd][2 * rr] * scale, dk[nd][2 * rr + 1] * scale);
          *reinterpret_cast<float2*>(out + 2 * kCols) =
              make_float2(dv[nd][2 * rr], dv[nd][2 * rr + 1]);
        }
      }
  }
}

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
  void keep_err(cudaError_t e) {
    if (err == cudaSuccess) err = e;
  }
  int zs() const { return (rows + kChunk - 1) / kChunk; }
  unsigned grid1d(size_t n) const {
    return (unsigned)std::min<size_t>((n + kThreads - 1) / kThreads, 132 * 16);
  }

  template <bool kBf, unsigned F>
  cudaError_t rowgemm_as(const RowGemm& p, int nout) {
    const Operand a{p.A, p.lda, rows, p.K};
    const RowEpi<F> epi{p, L, drop};
    if (p.wt)
      return wg_gemm<kBf, false, true>(a, Operand{p.W, p.ldw, p.K, nout}, rows, nout, p.K, 1, 0,
                                       false, false, epi, s);
    return wg_gemm<kBf, false, false>(a, Operand{p.W, p.ldw, nout, p.K}, rows, nout, p.K, 1, 0,
                                      false, false, epi, s);
  }
  template <unsigned F>
  cudaError_t rowgemm_f(const RowGemm& p, int nout) {
    return bf16 ? rowgemm_as<true, F>(p, nout) : rowgemm_as<false, F>(p, nout);
  }
  // The epilogues the layers use: a torch weight ([N][K]) alone or with
  // bias, then ReLU or GELU, dropout or the residual; a transposed weight
  // (dX = dY W) with a gate, dropout or one or two residuals.
  void rowgemm(const RowGemm& p, int nout) {
    if (!check()) return;
    const unsigned f = (p.bias ? kEpiBias : 0u) | (p.act == kActRelu ? kEpiRelu : 0u) |
                       (p.act == kActGelu ? kEpiGeluAct : 0u) |
                       (p.site >= 0 && drop.thresh != 0u ? kEpiDrop : 0u) |
                       (p.gate ? kEpiGate : 0u) | (p.gate && p.gelu_gate ? kEpiGelu : 0u) |
                       (p.res ? kEpiRes : 0u) | (p.res2 ? kEpiRes2 : 0u) |
                       (p.pre ? kEpiPre : 0u);
    cudaError_t e = cudaErrorNotSupported;
    if (!p.wt) {
      switch (f) {
        case 0: e = rowgemm_f<0>(p, nout); break;
        case kEpiBias: e = rowgemm_f<kEpiBias>(p, nout); break;
        case kEpiBias | kEpiRes: e = rowgemm_f<kEpiBias | kEpiRes>(p, nout); break;
        case kEpiBias | kEpiRelu: e = rowgemm_f<kEpiBias | kEpiRelu>(p, nout); break;
        case kEpiBias | kEpiDrop | kEpiRes:
          e = rowgemm_f<kEpiBias | kEpiDrop | kEpiRes>(p, nout);
          break;
        case kEpiBias | kEpiRelu | kEpiDrop:
          e = rowgemm_f<kEpiBias | kEpiRelu | kEpiDrop>(p, nout);
          break;
        case kEpiBias | kEpiGeluAct: e = rowgemm_f<kEpiBias | kEpiGeluAct>(p, nout); break;
        case kEpiBias | kEpiGeluAct | kEpiDrop:
          e = rowgemm_f<kEpiBias | kEpiGeluAct | kEpiDrop>(p, nout);
          break;
        case kEpiBias | kEpiPre | kEpiGeluAct:
          e = rowgemm_f<kEpiBias | kEpiPre | kEpiGeluAct>(p, nout);
          break;
        case kEpiBias | kEpiPre | kEpiGeluAct | kEpiDrop:
          e = rowgemm_f<kEpiBias | kEpiPre | kEpiGeluAct | kEpiDrop>(p, nout);
          break;
      }
    } else {
      switch (f) {
        case 0: e = rowgemm_f<0>(p, nout); break;
        case kEpiRes: e = rowgemm_f<kEpiRes>(p, nout); break;
        case kEpiRes | kEpiRes2: e = rowgemm_f<kEpiRes | kEpiRes2>(p, nout); break;
        case kEpiGate: e = rowgemm_f<kEpiGate>(p, nout); break;
        case kEpiDrop | kEpiGate: e = rowgemm_f<kEpiDrop | kEpiGate>(p, nout); break;
        case kEpiGate | kEpiGelu: e = rowgemm_f<kEpiGate | kEpiGelu>(p, nout); break;
        case kEpiDrop | kEpiGate | kEpiGelu:
          e = rowgemm_f<kEpiDrop | kEpiGate | kEpiGelu>(p, nout);
          break;
      }
    }
    keep_err(e);
  }
  void ln_fwd(const float* in, const float* g, const float* beta, float* y, float* xhat,
              float* inv) {
    if (!check()) return;
    ln_fwd_kernel<<<(rows + kWarps - 1) / kWarps, kThreads, 0, s>>>(in, g, beta, y, xhat, inv,
                                                                     rows);
  }
  // LayerNorm's backward dx, with its gradients dg = sum dy xhat, dbeta =
  // sum dy
  void ln_bwd_sums(const float* dy, const float* xhat, const float* inv, const float* g,
                   float* dx, float* dg, float* dbeta) {
    if (!check()) return;
    const int blocks = (rows + kSumRows - 1) / kSumRows;
    ln_bwd_sum_kernel<2><<<blocks, kThreads, 0, s>>>(dy, xhat, inv, g, dx, partial, 2 * kCols,
                                                      rows);
    if (!check()) return;
    sum_blocks_kernel<2><<<2, kCols, 0, s>>>(partial, blocks, 2 * kCols, SumOut<2>{{dg, dbeta}});
  }
  // out = in * the dropout mask of `site`
  void dropout(const float* in, float* out, int width, int site) {
    if (!check()) return;
    dropout_kernel<<<grid1d((size_t)rows * width / 4), kThreads, 0, s>>>(in, out, rows, width,
                                                                         L, site, drop);
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
  // out[c] = sum over all rows of G[r][c]
  void colsum(const float* G, int ld, int cols, float* out) {
    if (!check()) return;
    colsum_kernel<<<dim3((cols + 31) / 32, zs()), kThreads, 0, s>>>(G, ld, cols, rows, partial);
    reduce(zs(), cols, out);
  }
  // out[n][k] = sum over all rows of G[r][n] H[r][k]  (out [nout][K]); with
  // bias, also bias[n] = sum over all rows of G[r][n], taken in the same
  // pass (PartialSumEpi) and summed with the partials: no launch over G of
  // its own.  The partials need zs() (nout K + 2 nout) floats.
  void wgrad(const float* G, int ldg, int nout, const float* H, int ldh, int K, float* out,
             float* bias = nullptr) {
    if (!check()) return;
    const Operand a{G, ldg, rows, nout}, b{H, ldh, rows, K};
    const size_t n = (size_t)nout * K;
    if (bias) {
      const PartialSumEpi epi{{partial, nout, K}, partial + zs() * n};
      keep_err(bf16 ? wg_gemm<true, true, true>(a, b, nout, K, rows, zs(), kChunk, false, false,
                                                epi, s)
                    : wg_gemm<false, true, true>(a, b, nout, K, rows, zs(), kChunk, false,
                                                 false, epi, s));
      if (!check()) return;
      reduce_wb_kernel<<<grid1d(n + nout), kThreads, 0, s>>>(partial, zs(), n, nout, out, bias);
      return;
    }
    const PartialEpi epi{partial, nout, K};
    keep_err(bf16 ? wg_gemm<true, true, true>(a, b, nout, K, rows, zs(), kChunk, false, false,
                                              epi, s)
                  : wg_gemm<false, true, true>(a, b, nout, K, rows, zs(), kChunk, false, false,
                                               epi, s));
    reduce(zs(), n, out);
  }
  // the attention forward (ctx; with stats, each row's softmax max and sum
  // [B, H, len]) of B sequences of len rows: at "bf16" on the tensor cores;
  // at "f32" the float32 attention_kernel (encoder_layer_kernels.cuh), which
  // computes the scores and p v with float32 multiply-adds: faster at these
  // lengths than 3xTF32 on mma.sync
  void attention_fwd(const float* qkv, const float* mask, float* ctx, int B, int H, int len,
                     float2* stats = nullptr) {
    if (!check()) return;
    if (!bf16) {
      launch_attention(qkv, mask, ctx, B, H, len, drop, s, stats);
      return;
    }
    attention_fwd_tc_kernel<<<dim3(H, B), kAttThreads, attention_tc_smem_bytes(len, 3), s>>>(
        qkv, mask, ctx, stats, len, drop);
  }
  // the attention backward over B sequences of len rows; with the
  // recompute's ctx and stats at precision "f32", D_i from dctx_i . ctx_i
  void attention_bwd(const float* qkv, const float* dctx, const float* mask, float* dqkv, int B,
                     int H, int len, const float* ctx = nullptr, const float2* stats = nullptr) {
    if (!check()) return;
    auto* kernel = bf16 ? attention_bwd_tc_kernel<true> : attention_bwd_tc_kernel<false>;
    if (bf16) ctx = nullptr, stats = nullptr;
    kernel<<<dim3(H, B), kAttThreads, attention_tc_smem_bytes(len, 4), s>>>(
        qkv, dctx, mask, ctx, stats, dqkv, len, drop);
  }
};

// The layer's tensors in torch's [out, in] layout (in_proj_weight rows q|k|v);
// the temporal layer's in the same order.
struct EncoderWeights {
  const float *w_in, *b_in, *w_out, *b_out, *g1, *be1, *w1, *b1, *w2, *b2, *g2, *be2;
};

// What the forward writes, per row: a = x + pos, qkv [3D], ctx, r (the
// residual sums before each LayerNorm), y1 = LN1(r), h1 [F] (the dropped
// ReLU); and, where not null, LN1's and LN2's xhat and 1 / std, the
// attention rows' softmax statistics [B, H, L] and out = LN2(r).
struct EncoderActs {
  float *a, *qkv, *ctx, *r, *y1, *h1;
  float *xh1, *inv1, *xh2, *inv2, *out;
  float2* stats;
};

// The post-norm DETR encoder layer's forward: x + pos; q|k (from x + pos)
// and v (from x) on the GEMM core with their biases; the attention (at
// "bf16" on the tensor cores, at "f32" attention_kernel's float32 one);
// the out-projection with dropout (site H) and the residual x; LN1; FFN1
// with bias, ReLU and dropout (H + 1); FFN2 with dropout (H + 2) and the
// residual y1; LN2.  Kernel #1 (fused_encoder_layer.cu) keeps `out`, #2's
// recompute (fused_encoder_layer_bwd.cu) the statistics its backward reads:
// both run this one sequence.
inline void encoder_layer_fwd(Launcher& k, const float* x, const float* pos, const float* mask,
                              const EncoderWeights& w, const EncoderActs& t, int B, int H,
                              int F) {
  const int D = kCols;
  k.add(x, pos, t.a, (size_t)k.rows * D);
  k.rowgemm({t.a, D, D, w.w_in, D, 0, w.b_in, 0, -1, D, nullptr, 0, nullptr, 0, t.qkv, 3 * D},
            2 * D);
  k.rowgemm({x, D, D, w.w_in + (size_t)2 * D * D, D, 0, w.b_in + 2 * D, 0, -1, D, nullptr, 0,
             nullptr, 0, t.qkv + 2 * D, 3 * D},
            D);
  k.attention_fwd(t.qkv, mask, t.ctx, B, H, k.L, t.stats);
  k.rowgemm({t.ctx, D, D, w.w_out, D, 0, w.b_out, 0, H, D, nullptr, 0, x, D, t.r, D}, D);
  k.ln_fwd(t.r, w.g1, w.be1, t.y1, t.xh1, t.inv1);
  k.rowgemm({t.y1, D, D, w.w1, D, 0, w.b1, kActRelu, H + 1, F, nullptr, 0, nullptr, 0, t.h1, F},
            F);
  k.rowgemm({t.h1, F, F, w.w2, F, 0, w.b2, 0, H + 2, D, nullptr, 0, t.y1, D, t.r, D}, D);
  k.ln_fwd(t.r, w.g2, w.be2, t.out, t.xh2, t.inv2);
}

// What temporal_layer_fwd writes, per row: y = LN1(x), qkv [3D], ctx,
// u = y + ctx Wo^T + bo, z = LN2(u), h1 [F] = drop_H(gelu(z W1^T + b1));
// and, where not null, LN1's and LN2's xhat and 1 / std, the attention
// rows' softmax statistics [B, H, L], a1 [F] = z W1^T + b1 (a second store
// of FFN1's epilogue: the backward reads both) and out.
struct TemporalActs {
  float *y, *qkv, *ctx, *u, *z, *h1;
  float *xh1, *inv1, *xh2, *inv2, *a1, *out;
  float2* stats;
};

// What kernel #5's forward keeps for its backward when a gradient will be
// taken, in the order both C entries take the pointers and the wrapper
// allocates the tensors (ops/cuda/fused_temporal_layer.py::SAVED): all of
// TemporalActs but u and out.
enum TemporalSaved : int { kSavedY, kSavedQkv, kSavedCtx, kSavedZ, kSavedXh1, kSavedInv1,
                           kSavedXh2, kSavedInv2, kSavedA1, kSavedH1, kSavedStats };

inline TemporalActs temporal_saved(float* const* s) {
  TemporalActs t{};
  t.y = s[kSavedY];
  t.qkv = s[kSavedQkv];
  t.ctx = s[kSavedCtx];
  t.z = s[kSavedZ];
  t.xh1 = s[kSavedXh1];
  t.inv1 = s[kSavedInv1];
  t.xh2 = s[kSavedXh2];
  t.inv2 = s[kSavedInv2];
  t.a1 = s[kSavedA1];
  t.h1 = s[kSavedH1];
  t.stats = reinterpret_cast<float2*>(s[kSavedStats]);
  return t;
}

// The temporal-tower layer's forward: LN1; the packed q|k|v product; the
// float32 attention with its per-head dropout sites; the out-projection
// with the residual y; LN2; FFN1 with the GELU and dropout (site H) in its
// epilogue (given a1, which stores the pre-activation there too); FFN2
// with dropout (H + 1) and the residual z into out.  Kernel #5
// (fused_temporal_layer.cu) keeps `out` (and, for a gradient, the
// TemporalSaved set), its backward's recompute (fused_temporal_layer_bwd.cu)
// that set: both run this one sequence, so the two give the same bits.
inline void temporal_layer_fwd(Launcher& k, const float* x, const float* mask,
                               const EncoderWeights& w, const TemporalActs& t, int B, int H,
                               int F) {
  const int D = kCols;
  k.ln_fwd(x, w.g1, w.be1, t.y, t.xh1, t.inv1);
  k.rowgemm({t.y, D, D, w.w_in, D, 0, w.b_in, 0, -1, D, nullptr, 0, nullptr, 0, t.qkv, 3 * D},
            3 * D);
  k.attention_fwd(t.qkv, mask, t.ctx, B, H, k.L, t.stats);
  k.rowgemm({t.ctx, D, D, w.w_out, D, 0, w.b_out, 0, -1, D, nullptr, 0, t.y, D, t.u, D}, D);
  k.ln_fwd(t.u, w.g2, w.be2, t.z, t.xh2, t.inv2);
  k.rowgemm({t.z, D, D, w.w1, D, 0, w.b1, kActGelu, H, F, nullptr, 0, nullptr, 0, t.h1, F, 0,
             nullptr, 0, t.a1},
            F);
  if (t.out)
    k.rowgemm({t.h1, F, F, w.w2, F, 0, w.b2, 0, H + 1, D, nullptr, 0, t.z, D, t.out, D}, D);
}

// The dynamic shared memory of encoder_layer_fwd's attention launches at
// both precisions, for sequences up to max_l.  The GEMM core sets its own
// at each launch.
inline cudaError_t encoder_fwd_init(int max_l) {
  cudaError_t err = attention_init(max_l);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(attention_fwd_tc_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)attention_tc_smem_bytes(max_l, 3));
  return err;
}

// The dynamic shared memory of the launches above (and of the forward
// attention of #1's launches, which the decoder's recompute runs), for
// sequences up to max_l.
inline cudaError_t layer_bwd_init(int max_l) {
  cudaError_t err = encoder_fwd_init(max_l);
  for (auto* kernel : {attention_bwd_tc_kernel<false>, attention_bwd_tc_kernel<true>})
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)attention_tc_smem_bytes(max_l, 4));
  return err;
}

}  // namespace
