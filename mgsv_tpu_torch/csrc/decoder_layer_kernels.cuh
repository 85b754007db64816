// Pieces of the post-norm DETR decoder layer shared by fused_decoder_layer.cu
// (the forward) and fused_decoder_layer_bwd.cu (its recompute and
// backward): the cross-attention of Q query rows over the L memory rows of
// their batch row, forward and backward, and the layer's forward launches.
//
// Layouts: query-side tensors are [B*Q, D] (row b Q + i), memory-side
// [B*L, D]; the cross-attention's k | v of the memory sit in one [B*L, 2D]
// buffer (k from memory + pos, v from memory, two GEMMs over all B*L rows);
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

  // the head's k and v rows (128 contiguous bytes each), 16 bytes per load
  const float* base = kv + (size_t)b * L * 2 * kCols + h * kHeadDim;
  for (int e = threadIdx.x; e < L * kHeadDim / 4; e += kThreads) {
    const int r = e / (kHeadDim / 4), c = 4 * (e % (kHeadDim / 4));
    const float4 kr = *reinterpret_cast<const float4*>(base + (size_t)r * 2 * kCols + c);
    const float4 vr = *reinterpret_cast<const float4*>(base + (size_t)r * 2 * kCols + kCols + c);
    float *kd = k_s + r * kPad + c, *vd = v_s + r * kPad + c;
    kd[0] = kr.x; kd[1] = kr.y; kd[2] = kr.z; kd[3] = kr.w;
    vd[0] = vr.x; vd[1] = vr.y; vd[2] = vr.z; vd[3] = vr.w;
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
// for Q and L up to kMaxL (the GEMM core sets its own at each launch).
inline cudaError_t decoder_layer_init() {
  cudaError_t err = layer_bwd_init(kMaxL);
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

// What decoder_layer_fwd writes.  Memory side: mp = mem + pos [B*L, D]
// and the cross-attention's k | v [B*L, 2D].  Query side, [B*Q, D] each:
// with self-attention its q | k | v sa_qkv [B*Q, 3D], its context sa_ctx,
// r1 = tgt + sa_ctx Wo^T + bo and t1 = LN1(r1); a = t1 + qpos (tgt + qpos
// while the self-attention runs), the cross-attention's q and ctx, r2 and
// t2 = LN2(r2), h1 [B*Q, F] = relu(t2 W1^T + b1), r3 = t2 + h1 W2^T + b2;
// where not null, each LayerNorm's xhat and 1 / std and out = LN3(r3).
struct DecoderActs {
  float *mp, *kv;
  float *sa_qkv, *sa_ctx, *r1, *t1, *a, *q, *ctx, *r2, *t2, *h1, *r3;
  float *xh1, *inv1, *xh2, *inv2, *xh3, *inv3, *out;
};

// The decoder layer's forward, lq over the B*Q query rows and lm over the
// B*L memory rows (one stream), every product on the GEMM core: mem + pos
// and the cross-attention's k (from it) and v (from mem), skipped
// when kv_ready (t.kv then holds the forward's); with self-attention tgt +
// qpos, q|k (from it) and v (from tgt), the float32 attention over the Q
// queries, the out-projection with the residual tgt, LN1; t1 + qpos and
// the cross-attention's q; cross_attention_kernel; the out-projection with
// the residual t1, LN2; FFN1 (bias, ReLU); FFN2 with the residual t2; LN3.
// Kernel #6 (fused_decoder_layer.cu) keeps out and k|v, the backward's
// recompute (fused_decoder_layer_bwd.cu) the LayerNorms' statistics: both
// run this one sequence.  Returns t1 (tgt without self-attention).
inline const float* decoder_layer_fwd(Launcher& lq, Launcher& lm, const DecoderWeights& w,
                                      const float* tgt, const float* mem, const float* mask,
                                      const float* pos, const float* qpos, int B, int Q, int L,
                                      int H, int F, bool self_attn, bool kv_ready,
                                      const DecoderActs& t) {
  const int D = kCols;
  const size_t dd = (size_t)D * D, nq = (size_t)lq.rows * D;
  if (!kv_ready) {
    lm.add(mem, pos, t.mp, (size_t)lm.rows * D);
    lm.rowgemm({t.mp, D, D, w.ca_w_in + dd, D, 0, w.ca_b_in + D, 0, -1, D, nullptr, 0, nullptr,
                0, t.kv, 2 * D},
               D);
    lm.rowgemm({mem, D, D, w.ca_w_in + 2 * dd, D, 0, w.ca_b_in + 2 * D, 0, -1, D, nullptr, 0,
                nullptr, 0, t.kv + D, 2 * D},
               D);
  }
  const float* t1 = tgt;
  if (self_attn) {
    lq.add(tgt, qpos, t.a, nq);
    lq.rowgemm({t.a, D, D, w.sa_w_in, D, 0, w.sa_b_in, 0, -1, D, nullptr, 0, nullptr, 0,
                t.sa_qkv, 3 * D},
               2 * D);
    lq.rowgemm({tgt, D, D, w.sa_w_in + 2 * dd, D, 0, w.sa_b_in + 2 * D, 0, -1, D, nullptr, 0,
                nullptr, 0, t.sa_qkv + 2 * D, 3 * D},
               D);
    lq.attention_fwd(t.sa_qkv, nullptr, t.sa_ctx, B, H, Q);
    lq.rowgemm({t.sa_ctx, D, D, w.sa_w_out, D, 0, w.sa_b_out, 0, -1, D, nullptr, 0, tgt, D,
                t.r1, D},
               D);
    lq.ln_fwd(t.r1, w.n1_g, w.n1_b, t.t1, t.xh1, t.inv1);
    t1 = t.t1;
  }
  lq.add(t1, qpos, t.a, nq);
  lq.rowgemm({t.a, D, D, w.ca_w_in, D, 0, w.ca_b_in, 0, -1, D, nullptr, 0, nullptr, 0, t.q, D},
             D);
  if (lq.check() && lm.check())
    cross_attention_kernel<<<dim3(H, B), kThreads, cross_attention_smem_bytes(L), lq.s>>>(
        t.q, t.kv, mask, t.ctx, Q, L);
  lq.rowgemm({t.ctx, D, D, w.ca_w_out, D, 0, w.ca_b_out, 0, -1, D, nullptr, 0, t1, D, t.r2, D},
             D);
  lq.ln_fwd(t.r2, w.n2_g, w.n2_b, t.t2, t.xh2, t.inv2);
  lq.rowgemm({t.t2, D, D, w.w1, D, 0, w.b1, kActRelu, -1, F, nullptr, 0, nullptr, 0, t.h1, F},
             F);
  lq.rowgemm({t.h1, F, F, w.w2, F, 0, w.b2, 0, -1, D, nullptr, 0, t.t2, D, t.r3, D}, D);
  lq.ln_fwd(t.r3, w.n3_g, w.n3_b, t.out, t.xh3, t.inv3);
  return t1;
}

}  // namespace
