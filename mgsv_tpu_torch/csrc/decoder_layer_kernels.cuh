// Pieces of the post-norm DETR decoder layer shared by fused_decoder_layer.cu
// (the forward) and fused_decoder_layer_bwd.cu (its recompute and
// backward): the cross-attention of Q query rows over the L memory rows of
// their batch row, forward and backward, and the layer's forward launches.
//
// Layouts: query-side tensors are [B*Q, D] (row b Q + i), memory-side
// [B*L, D]; the cross-attention's k | v of the memory sit in one [B*L, 2D]
// buffer (k from memory + pos, v from memory, one GEMM over all B*L rows);
// every weight is in torch's [out, in] layout, in_proj_weight rows q|k|v.
#pragma once

#include "layer_bwd_kernels.cuh"

namespace {

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

__host__ __device__ constexpr size_t cross_attention_smem_bytes(int L) {
  return sizeof(float) * (size_t)(2 * L * kPad + round4(L) + kWarps * round4(L));
}

// One block per (head, batch row).  The head's k and v of the batch row's
// L memory rows ([L, 32] each) sit in shared memory; each warp takes one
// query row at a time: scores one key per lane (a masked key scores -1e9,
// so a row with no valid key gets uniform weights, as JAX's NEG_INF does),
// softmax, then p v with one lane per head channel.  ctx [B*Q, D].
__global__ void __launch_bounds__(kThreads)
cross_attention_kernel(const float* __restrict__ q, const float* __restrict__ kv,
                       const float* __restrict__ mask, float* __restrict__ ctx, int Q, int L) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int h = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* k_s = smem;                  // [L][kPad]
  float* v_s = k_s + L * kPad;        // [L][kPad]
  float* m_s = v_s + L * kPad;        // [L] key mask
  float* p = m_s + round4(L) + warp * round4(L);   // this warp's softmax row
  const float scale = 1.0f / sqrtf((float)kHeadDim);

  const float* base = kv + (size_t)b * L * 2 * kCols + h * kHeadDim;
  for (int e = threadIdx.x; e < L * kHeadDim; e += kThreads) {
    const int r = e / kHeadDim, c = e % kHeadDim;
    k_s[r * kPad + c] = base[(size_t)r * 2 * kCols + c];
    v_s[r * kPad + c] = base[(size_t)r * 2 * kCols + kCols + c];
  }
  for (int j = threadIdx.x; j < L; j += kThreads) m_s[j] = mask[(size_t)b * L + j];
  __syncthreads();

  for (int i = warp; i < Q; i += kWarps) {
    const float* qrow = q + ((size_t)b * Q + i) * kCols + h * kHeadDim;
    float qi[kHeadDim];
#pragma unroll
    for (int c = 0; c < kHeadDim; ++c) qi[c] = qrow[c] * scale;
    float mx = -INFINITY;
    for (int j = lane; j < L; j += 32) {
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < kHeadDim; ++c) s = fmaf(qi[c], k_s[j * kPad + c], s);
      if (m_s[j] == 0.f) s = kBigNeg;
      p[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < L; j += 32) {
      const float e = expf(p[j] - mx);
      p[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    __syncwarp();
    float acc = 0.f;
    for (int j = 0; j < L; ++j) acc = fmaf(p[j], v_s[j * kPad + lane], acc);
    ctx[((size_t)b * Q + i) * kCols + h * kHeadDim + lane] = acc / sum;
    __syncwarp();
  }
}

__host__ __device__ constexpr size_t cross_attention_bwd_smem_bytes(int Q, int L) {
  const int m = round4(Q > L ? Q : L);
  return sizeof(float) *
         (size_t)(2 * Q * kPad + 2 * L * kPad + round4(L) + 3 * round4(Q) + 2 * kWarps * m);
}

// The cross-attention backward of one (head, batch row), as
// attention_bwd_kernel does it for the encoder's square attention: q and
// dctx of the Q query rows, k and v of the L memory rows in shared memory.
// Sweep 1, a warp per query row i (lanes over keys j): softmax statistics,
// D_i = sum_j p_ij dp_ij and dq_i.  Sweep 2, a warp per key row j (lanes
// over queries i): dv_j = sum_i p_ij dctx_i and dk_j = scale sum_i ds_ij
// q_i.  Every sum has one owner: no atomics.  A masked key's score is a
// constant, so it gets no dk and feeds no dq.  Writes dq [B*Q, D] and
// dk | dv into dkv [B*L, 2D].
__global__ void __launch_bounds__(kThreads)
cross_attention_bwd_kernel(const float* __restrict__ q, const float* __restrict__ kv,
                           const float* __restrict__ mask, const float* __restrict__ dctx,
                           float* __restrict__ dq, float* __restrict__ dkv, int Q, int L) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int h = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m = round4(Q > L ? Q : L);
  float* q_s = smem;                  // [Q][kPad]
  float* d_s = q_s + Q * kPad;        // [Q][kPad] dctx
  float* k_s = d_s + Q * kPad;        // [L][kPad]
  float* v_s = k_s + L * kPad;        // [L][kPad]
  float* m_s = v_s + L * kPad;        // [L] key mask
  float* mx_s = m_s + round4(L);      // [Q] row max of the scores
  float* sum_s = mx_s + round4(Q);    // [Q] row sum of exp
  float* dd_s = sum_s + round4(Q);    // [Q] D_i
  float* pa = dd_s + round4(Q) + 2 * warp * m;
  float* pb = pa + m;
  const float scale = 1.0f / sqrtf((float)kHeadDim);

  const size_t qrow0 = (size_t)b * Q, mrow0 = (size_t)b * L;
  for (int e = threadIdx.x; e < Q * kHeadDim; e += kThreads) {
    const int r = e / kHeadDim, c = e % kHeadDim;
    q_s[r * kPad + c] = q[(qrow0 + r) * kCols + h * kHeadDim + c];
    d_s[r * kPad + c] = dctx[(qrow0 + r) * kCols + h * kHeadDim + c];
  }
  for (int e = threadIdx.x; e < L * kHeadDim; e += kThreads) {
    const int r = e / kHeadDim, c = e % kHeadDim;
    const float* row = kv + (mrow0 + r) * 2 * kCols + h * kHeadDim + c;
    k_s[r * kPad + c] = row[0];
    v_s[r * kPad + c] = row[kCols];
  }
  for (int j = threadIdx.x; j < L; j += kThreads) m_s[j] = mask[mrow0 + j];
  __syncthreads();

  for (int i = warp; i < Q; i += kWarps) {          // sweep 1: query rows
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
      const float pj = pa[j] / sum;
      pa[j] = pj;
      pb[j] = dp;
      dsum = fmaf(pj, dp, dsum);
    }
    dsum = warp_sum(dsum);
    __syncwarp();
    float acc = 0.f;
    for (int j = 0; j < L; ++j)
      if (m_s[j] != 0.f) acc = fmaf(pa[j] * (pb[j] - dsum), k_s[j * kPad + lane], acc);
    dq[(qrow0 + i) * kCols + h * kHeadDim + lane] = acc * scale;
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
    for (int i = lane; i < Q; i += 32) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < kHeadDim; ++c) {
        s = fmaf(q_s[i * kPad + c], kj[c], s);
        dp = fmaf(d_s[i * kPad + c], vj[c], dp);
      }
      s = valid ? s * scale : kBigNeg;
      const float pij = expf(s - mx_s[i]) / sum_s[i];
      pa[i] = pij;                                   // feeds dv
      pb[i] = valid ? pij * (dp - dd_s[i]) : 0.f;    // ds: feeds dk
    }
    __syncwarp();
    float dk = 0.f, dv = 0.f;
    for (int i = 0; i < Q; ++i) {
      dv = fmaf(pa[i], d_s[i * kPad + lane], dv);
      dk = fmaf(pb[i], q_s[i * kPad + lane], dk);
    }
    float* out = dkv + (mrow0 + j) * 2 * kCols + h * kHeadDim + lane;
    out[0] = dk * scale;
    out[kCols] = dv;
    __syncwarp();
  }
}

// The decoder layer's weights, torch [out, in] layout; the self-attention's
// six are null without self-attention.
struct DecoderWeights {
  const float *sa_w_in, *sa_b_in, *sa_w_out, *sa_b_out, *n1_g, *n1_b;
  const float *ca_w_in, *ca_b_in, *ca_w_out, *ca_b_out, *n2_g, *n2_b;
  const float *w1, *b1, *w2, *b2, *n3_g, *n3_b;
};

// Dynamic shared memory of every launch the forward and backward take,
// for Q and L up to kMaxL.
inline cudaError_t decoder_layer_init() {
  cudaError_t err = gemm_launches_init();
  if (err == cudaSuccess) err = layer_bwd_init(kMaxL);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(cross_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)cross_attention_smem_bytes(kMaxL));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(cross_attention_bwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)cross_attention_bwd_smem_bytes(kMaxL, kMaxL));
  return err;
}

inline bool decoder_shape_ok(int B, int Q, int L, int D, int H, int F) {
  return B >= 1 && B <= kMaxB && Q >= 1 && Q <= kMaxL && L >= 1 && L <= kMaxL && D == kCols &&
         H * kHeadDim == D && F >= kCols && F % kCols == 0;
}

// The forward up to the cross-attention, on the launchers' stream: kv
// [B*L, 2D] of the memory; with self-attention its q | k | v sa_qkv
// [B*Q, 3D], its context sa_ctx, t1 = LN1(tgt + sa_ctx Wo^T + bo) with
// LN1's xhat1 and inv1 (r1 is scratch); the cross-attention's q (from
// t1 + qpos) and ctx.  Returns t1 (tgt without self-attention).
inline const float* decoder_attention_fwd(Launcher& lq, Launcher& lm, const DecoderWeights& w,
                                          const float* tgt, const float* mem, const float* mask,
                                          const float* pos, const float* qpos, int B, int Q,
                                          int L, int H, bool self_attn, float* kv,
                                          float* sa_qkv, float* sa_ctx, float* r1, float* t1,
                                          float* xh1, float* inv1, float* q, float* ctx) {
  const int Nq = B * Q, Nm = B * L;
  if (!lq.check() || !lm.check()) return tgt;
  qkv_kernel<<<dim3((Nm + kRows - 1) / kRows, 2), kThreads, kGemmSmem, lm.s>>>(
      mem, pos, w.ca_w_in + (size_t)kCols * kCols, w.ca_b_in + kCols, kv, Nm, 1, 2 * kCols);
  const float* t1p = tgt;
  if (self_attn) {
    if (!lm.check()) return tgt;
    qkv_kernel<<<dim3((Nq + kRows - 1) / kRows, 3), kThreads, kGemmSmem, lq.s>>>(
        tgt, qpos, w.sa_w_in, w.sa_b_in, sa_qkv, Nq, 2, 3 * kCols);
    if (!lq.check()) return tgt;
    launch_attention(sa_qkv, nullptr, sa_ctx, B, H, Q, lq.drop, lq.s);
    lq.rowgemm({sa_ctx, kCols, kCols, w.sa_w_out, kCols, 0, w.sa_b_out, 0, -1, kCols, nullptr, 0,
                tgt, kCols, r1, kCols},
               kCols);
    lq.ln_fwd(r1, w.n1_g, w.n1_b, t1, xh1, inv1);
    t1p = t1;
  }
  if (!lq.check()) return t1p;
  qkv_kernel<<<dim3((Nq + kRows - 1) / kRows, 1), kThreads, kGemmSmem, lq.s>>>(
      t1p, qpos, w.ca_w_in, w.ca_b_in, q, Nq, 1, kCols);
  if (!lq.check()) return t1p;
  cross_attention_kernel<<<dim3(H, B), kThreads, cross_attention_smem_bytes(L), lq.s>>>(
      q, kv, mask, ctx, Q, L);
  lq.check();
  return t1p;
}

}  // namespace
