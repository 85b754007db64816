// The first design's forward launches of the post-norm DETR encoder layer
// (GEMMs on mma.sync tiles), which now serve other layers: the decoder
// layer's forward and recompute (#6, decoder_layer_kernels.cuh: qkv_kernel,
// ffn_kernel and, for its self-attention, attention_kernel), the temporal
// layer's forward (#5, fused_temporal_layer.cu: attention_kernel), and the
// float32 attention of the encoder layer's own forward sequence
// (layer_bwd_kernels.cuh::encoder_layer_fwd, #1 and #2's recompute at
// "f32"; its GEMMs run on the wgmma core).
// Every weight is in torch's [out, in] layout (in_proj_weight rows q|k|v).
// Dropout sites, drawn from philox.cuh with stream (batch row b, site):
// heads 0..H-1 the attention weights (element i L + j), H the attention
// output (l D + c), H+1 after the ReLU (l F + f), H+2 the FFN output (l D +
// c).  Every product is float32 (3xTF32 on mma.sync tiles, or CUDA-core
// multiply-adds in the attention).
#pragma once

#include <initializer_list>

#include "philox.cuh"
#include "tf32_tile.cuh"

namespace {

constexpr int kHeadDim = 32;          // one lane per head channel
constexpr int kPad = kHeadDim + 1;    // padded [L][kPad] rows: conflict-free columns
constexpr int kMaxL = 256;            // longest sequence (attention shared memory)
constexpr int kMaxB = 65535;          // batch rows: grid y of the attention launch

constexpr size_t kGemmSmem = sizeof(float) * (size_t)(kTileFloats + 2 * kWsFloats);
constexpr size_t kFfnSmem = sizeof(float) * (size_t)(2 * kTileFloats + 2 * kWsFloats);

// (a) [64 rows x 256 cols] tiles of a packed projection over the
// flattened B*L rows: part p = blockIdx.y of the output (weight rows
// [p D, p D + D)) from x+pos for p < pos_parts and from x after, into
// column p D of a [B*L, ld_out] buffer.  The encoder takes q|k|v
// (pos_parts 2, ld_out 3D); the decoder's cross-attention k|v of its
// memory (pos_parts 1) and its q (one part).
__global__ void __launch_bounds__(kThreads, 1)
qkv_kernel(const float* __restrict__ x, const float* __restrict__ pos,
           const float* __restrict__ w_in, const float* __restrict__ b_in,
           float* __restrict__ qkv, int rows, int pos_parts = 2, int ld_out = 3 * kCols) {
  extern __shared__ float4 smem4[];
  float* A = reinterpret_cast<float*>(smem4);   // [kRows][kLda]: input, then output
  float* Ws = A + kTileFloats;                   // [2][kCols][kLdws]
  const int r0 = blockIdx.x * kRows, part = blockIdx.y;   // encoder: 0 q, 1 k, 2 v
  load_rows(A, x, part < pos_parts ? pos : nullptr, r0, rows);
  Acc acc;
  zero(acc);
  gemm(acc, A, w_in, kCols, part * kCols, kCols, Ws);
  const float* bias = b_in + part * kCols;
  for_each_acc(acc, [&](int r, int c, float& v) { A[r * kLda + c] = v + bias[c]; });
  __syncthreads();
  store_rows(qkv, ld_out, part * kCols, A, r0, rows);
}

// The dropout mask values (k0, k1) of weights (i0, j) and (i1, j), lane's
// key j = jb + lane: with L a multiple of 4 every row starts a group of four
// mask words, so in each group of four lanes the first draws row i0's
// group and the second row i1's, and the four read them by shuffles (one
// Philox call per two lanes); else one per weight.  Every lane of the warp
// calls it; values for j >= L are not used.
__device__ __forceinline__ void row_pair_keep(const Dropout& drop, unsigned b, unsigned h, int L,
                                              int i0, int i1, int jb, float& k0, float& k1) {
  const int lane = threadIdx.x & 31, j = jb + lane;
  if ((L & 3) == 0) {
    const int sub = lane & 3, lead = lane & ~3;
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (sub < 2) w = philox4(drop.seed, b, h, (unsigned)((sub ? i1 : i0) * L + (j & ~3)) >> 2);
    uint4 w0, w1;
    w0.x = __shfl_sync(0xffffffffu, w.x, lead);
    w0.y = __shfl_sync(0xffffffffu, w.y, lead);
    w0.z = __shfl_sync(0xffffffffu, w.z, lead);
    w0.w = __shfl_sync(0xffffffffu, w.w, lead);
    w1.x = __shfl_sync(0xffffffffu, w.x, lead + 1);
    w1.y = __shfl_sync(0xffffffffu, w.y, lead + 1);
    w1.z = __shfl_sync(0xffffffffu, w.z, lead + 1);
    w1.w = __shfl_sync(0xffffffffu, w.w, lead + 1);
    k0 = word_of(w0, sub) >= drop.thresh ? drop.scale : 0.f;
    k1 = word_of(w1, sub) >= drop.thresh ? drop.scale : 0.f;
  } else if (j < L) {
    k0 = keep(drop, b, h, i0 * L + j);
    k1 = keep(drop, b, h, i1 * L + j);
  }
}

// Softmax rows start 16-byte aligned and hold L rounded up to 4 floats.
__host__ __device__ constexpr int attention_rows_offset(int L) {
  return (3 * L * kPad + L + 3) & ~3;
}

__host__ __device__ constexpr size_t attention_smem_bytes(int L) {
  return sizeof(float) * (size_t)(attention_rows_offset(L) + 2 * kWarps * ((L + 3) & ~3));
}

// (b) One block per (head, batch row).  The head's q, k, v ([L, 32] each)
// sit in shared memory; each warp takes two query rows at a time, their
// scores one key per lane, and writes ctx [B, L, D] (and, given stats, each
// row's softmax max and sum [B, H, L], for a backward).  Dropout multiplies
// the normalized weights (after the softmax sum), as torch does.  kDrop
// false (rate 0, the serving path) compiles the mask code out.  A null mask
// means every key is valid.
template <bool kDrop>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const float* __restrict__ qkv, const float* __restrict__ mask,
                 float* __restrict__ ctx, int L, Dropout drop, float2* __restrict__ stats) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int h = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* q_s = smem;                 // [L][kPad], pre-scaled by 1/sqrt(dh)
  float* k_s = q_s + L * kPad;       // [L][kPad]
  float* v_s = k_s + L * kPad;       // [L][kPad]
  float* m_s = v_s + L * kPad;       // [L] key mask
  const int Lp = (L + 3) & ~3;
  float* p0 = smem + attention_rows_offset(L) + 2 * warp * Lp;   // this warp's two
  float* p1 = p0 + Lp;                                            // softmax rows

  const float scale = 1.0f / sqrtf((float)kHeadDim);
  const float* base = qkv + (size_t)b * L * 3 * kCols + h * kHeadDim;
  for (int e = threadIdx.x; e < L * kHeadDim; e += kThreads) {
    const int r = e / kHeadDim, c = e % kHeadDim;
    const float* row = base + (size_t)r * 3 * kCols + c;
    q_s[r * kPad + c] = row[0] * scale;
    k_s[r * kPad + c] = row[kCols];
    v_s[r * kPad + c] = row[2 * kCols];
  }
  for (int j = threadIdx.x; j < L; j += kThreads)
    m_s[j] = mask != nullptr ? mask[(size_t)b * L + j] : 1.f;
  __syncthreads();

  for (int i0 = 2 * warp; i0 < L; i0 += 2 * kWarps) {
    const int i1 = i0 + 1 < L ? i0 + 1 : i0;
    float qa[kHeadDim], qb[kHeadDim];
#pragma unroll
    for (int c = 0; c < kHeadDim; ++c) {
      qa[c] = q_s[i0 * kPad + c];
      qb[c] = q_s[i1 * kPad + c];
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
    for (int j = lane; j < L; j += 32) {
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int c = 0; c < kHeadDim; ++c) {
        const float kv = k_s[j * kPad + c];
        s0 = fmaf(qa[c], kv, s0);
        s1 = fmaf(qb[c], kv, s1);
      }
      if (m_s[j] == 0.f) s0 = s1 = kBigNeg;
      p0[j] = s0;
      p1[j] = s1;
      mx0 = fmaxf(mx0, s0);
      mx1 = fmaxf(mx1, s1);
    }
    mx0 = warp_max(mx0);
    mx1 = warp_max(mx1);
    float sum0 = 0.f, sum1 = 0.f;
    for (int jb = 0; jb < L; jb += 32) {   // every lane takes each step (row_pair_keep)
      const int j = jb + lane;
      float k0 = 1.f, k1 = 1.f;
      if constexpr (kDrop) row_pair_keep(drop, b, h, L, i0, i1, jb, k0, k1);
      if (j < L) {
        const float e0 = expf(p0[j] - mx0), e1 = expf(p1[j] - mx1);
        sum0 += e0;
        sum1 += e1;
        p0[j] = e0 * k0;
        p1[j] = e1 * k1;
      }
    }
    sum0 = warp_sum(sum0);
    sum1 = warp_sum(sum1);
    if (stats != nullptr && lane == 0) {
      float2* st = stats + ((size_t)b * gridDim.x + h) * L;
      st[i0] = make_float2(mx0, sum0);
      st[i1] = make_float2(mx1, sum1);
    }
    __syncwarp();
    float acc0 = 0.f, acc1 = 0.f;
    int j = 0;
    for (; j + 4 <= L; j += 4) {           // four keys per broadcast 16-byte read
      const float4 a = *reinterpret_cast<const float4*>(p0 + j);
      const float4 c = *reinterpret_cast<const float4*>(p1 + j);
      const float* v = v_s + j * kPad + lane;
      acc0 = fmaf(a.x, v[0], acc0);
      acc1 = fmaf(c.x, v[0], acc1);
      acc0 = fmaf(a.y, v[kPad], acc0);
      acc1 = fmaf(c.y, v[kPad], acc1);
      acc0 = fmaf(a.z, v[2 * kPad], acc0);
      acc1 = fmaf(c.z, v[2 * kPad], acc1);
      acc0 = fmaf(a.w, v[3 * kPad], acc0);
      acc1 = fmaf(c.w, v[3 * kPad], acc1);
    }
    for (; j < L; ++j) {
      const float vv = v_s[j * kPad + lane];
      acc0 = fmaf(p0[j], vv, acc0);
      acc1 = fmaf(p1[j], vv, acc1);
    }
    float* out = ctx + ((size_t)b * L + i0) * kCols + h * kHeadDim + lane;
    out[0] = acc0 / sum0;
    if (i1 != i0) out[kCols] = acc1 / sum1;
    __syncwarp();
  }
}

// (c) One block per 64 rows.  Out-proj, dropout, residual and LN1; the FFN
// in 256-wide slices of the hidden dimension, each ReLU slice (dropped out)
// kept in shared memory and folded straight into the second GEMM's register
// accumulators; dropout, residual and LN2.  kDrop as in (b).
template <bool kDrop>
__global__ void __launch_bounds__(kThreads, 1)
ffn_kernel(const float* __restrict__ x, const float* __restrict__ ctx,
           const float* __restrict__ w_out, const float* __restrict__ b_out,
           const float* __restrict__ g1, const float* __restrict__ be1,
           const float* __restrict__ w1, const float* __restrict__ b1,
           const float* __restrict__ w2, const float* __restrict__ b2,
           const float* __restrict__ g2, const float* __restrict__ be2,
           float* __restrict__ out, int rows, int L, int H, int F, Dropout drop) {
  extern __shared__ float4 smem4[];
  float* A = reinterpret_cast<float*>(smem4);  // ctx, then each ReLU slice, then y1 + FFN
  float* Y = A + kTileFloats;                   // x + out-proj, then LN1 output
  float* Ws = Y + kTileFloats;                  // [2][kCols][kLdws]
  const int r0 = blockIdx.x * kRows;
  // mask value of (tile row r, site, element column c of a `width`-wide site)
  auto site_keep = [&](int r, int site, int width, int c) {
    if (!kDrop) return 1.f;
    const int gr = r0 + r;
    return keep(drop, gr / L, site, (gr % L) * width + c);
  };

  load_rows(A, ctx, nullptr, r0, rows);
  Acc acc;
  zero(acc);
  gemm(acc, A, w_out, kCols, 0, kCols, Ws);
  for_each_acc(acc, [&](int r, int c, float& v) {
    Y[r * kLda + c] = (v + b_out[c]) * site_keep(r, H, kCols, c);
  });
  __syncthreads();
  for (int e = threadIdx.x; e < kRows * kCols / 4; e += kThreads) {
    const int r = e / (kCols / 4), c4 = e % (kCols / 4), gr = r0 + r;
    if (gr < rows) {
      float4* y = reinterpret_cast<float4*>(Y + r * kLda + 4 * c4);
      const float4 xv = reinterpret_cast<const float4*>(x + (size_t)gr * kCols)[c4];
      y->x += xv.x; y->y += xv.y; y->z += xv.z; y->w += xv.w;
    }
  }
  __syncthreads();
  layer_norm_rows(Y, g1, be1);

  Acc acc2;
  zero(acc2);
  for (int f0 = 0; f0 < F; f0 += kCols) {
    zero(acc);
    gemm(acc, Y, w1, kCols, f0, kCols, Ws);
    for_each_acc(acc, [&](int r, int c, float& v) {
      A[r * kLda + c] = fmaxf(v + b1[f0 + c], 0.f) * site_keep(r, H + 1, F, f0 + c);
    });
    __syncthreads();
    gemm(acc2, A, w2 + f0, F, 0, kCols, Ws);
  }
  for_each_acc(acc2, [&](int r, int c, float& v) {
    A[r * kLda + c] = (v + b2[c]) * site_keep(r, H + 2, kCols, c) + Y[r * kLda + c];
  });
  __syncthreads();
  layer_norm_rows(A, g2, be2);
  store_rows(out, kCols, 0, A, r0, rows);
}

// Both instantiations of (b): dynamic shared memory for sequences up to
// max_l.
inline cudaError_t attention_init(int max_l = kMaxL) {
  const int bytes = (int)attention_smem_bytes(max_l);
  cudaError_t err = cudaSuccess;
  for (auto* kernel : {attention_kernel<false>, attention_kernel<true>})
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  return err;
}

// Launches (b) over B rows on `s`; rate 0 takes the instantiation without
// mask code.
inline void launch_attention(const float* qkv, const float* mask, float* ctx, int B, int H,
                             int L, const Dropout& drop, cudaStream_t s,
                             float2* stats = nullptr) {
  const dim3 grid(H, B);
  const size_t smem = attention_smem_bytes(L);
  auto* kernel = drop.thresh != 0u ? attention_kernel<true> : attention_kernel<false>;
  kernel<<<grid, kThreads, smem, s>>>(qkv, mask, ctx, L, drop, stats);
}

// The decoder forward's GEMM launches (float32, no dropout): dynamic shared
// memory.
inline cudaError_t gemm_launches_init() {
  cudaError_t err = cudaFuncSetAttribute(qkv_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kGemmSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ffn_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kFfnSmem);
  return err;
}

}  // namespace
