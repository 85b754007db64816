// Backward of the fused post-norm DETR decoder layer, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// mgsv_tpu/ops/pallas/fused_decoder_layer.py::_train_bwd (kernel
// _bwd_kernel): from the layer's inputs and the output cotangent g it
// recomputes the forward (fused_decoder_layer.cu's launch sequence,
// decoder_layer_kernels.cuh::decoder_layer_fwd, keeping the LayerNorms'
// statistics) and returns dtgt, dqpos [B, Q, D], dmem, dpos [B, L, D] and
// the gradients of all the layer's weights (the mask gets none).  Given the
// forward's memory k|v, the recompute skips mem + pos and the two products
// over the B*L memory rows, the forward's largest, and the result is the
// same to the bit: the same launches on the same inputs wrote it.
//
// What bounds it on the card: at B=512, Q=10, L=152 the backward is about
// 61 GFLOP without the recompute, most of it the memory side: dk, dv give
// dWk = dk^T (mem + pos), dWv = dv^T mem and dmem = dk Wk + dv Wv, dpos =
// dk Wk, products over the B*L memory rows; the query side is small.  At
// Q=1 the bytes (memory, pos and their two [B, L, D] gradients) come close.
// The design, on the launches of layer_bwd_kernels.cuh:
//
//  * cross_attention_bwd_kernel recomputes the [Q, L] weights per (head,
//    batch row) in shared memory, in two sweeps (query rows: statistics and
//    dq; key rows: dk and dv), so every sum has one owner and no atomics
//    are needed; the self-attention's backward is the encoder's tensor-core
//    attention_bwd_tc_kernel over Q keys.
//  * Activation x weight products run on the wgmma core (wgmma_gemm.cuh,
//    3xTF32; bias / ReLU / gate / residual epilogues fused), over the B*Q
//    query rows or the B*L memory rows.
//  * Each weight gradient is a split-K product of the same core over
//    1024-row slices whose partials are summed in slice order
//    (reduce_kernel), bias and LayerNorm gradients column sums in the same
//    two passes: two calls on the same inputs are bit-identical.
//
// With t1 the self-attention block's output (tgt without it), a = t1 +
// qpos, q = a Wq^T + bq, t2 = LN2(t1 + ctx Wo^T + bo), h1 = relu(t2 W1^T +
// b1), out = LN3(t2 + h1 W2^T + b2):
//
//   dr3 = LN3'(g);  db2, dW2 = sums of dr3, dr3^T h1
//   dz1 = (dr3 W2) [h1 > 0];  db1, dW1 = sums of dz1, dz1^T t2
//   dt2 = dr3 + dz1 W1;  dr2 = LN2'(dt2);  dbo, dWo = sums of dr2, dr2^T ctx
//   dq, dk, dv = cross-attention backward of dctx = dr2 Wo
//   dWq = dq^T a, dWk = dk^T (mem + pos), dWv = dv^T mem (and the biases)
//   dmem = dk Wk + dv Wv;  dpos = dk Wk;  dt1 = dr2 + dq Wq
//   with self-attention: dr1 = LN1'(dt1), its out-projection and attention
//   backward give dsa_qkv; dtgt = dr1 + dsa_qkv W_in, dqpos = dq Wq +
//   dsa_qk W_qk; without it dtgt = dt1, dqpos = dq Wq.

#include "decoder_layer_kernels.cuh"

namespace {

// Query-side [B*Q, D] buffers of the backward, in workspace order.
constexpr int kQueryBufs = 21;

}  // namespace

// Floats of device workspace mgsv_fused_decoder_layer_bwd needs; kv_saved
// != 0: it is given the forward's k|v.
extern "C" size_t mgsv_fused_decoder_layer_bwd_workspace(int B, int Q, int L, int F,
                                                         int kv_saved) {
  const size_t nq = (size_t)B * Q, nm = (size_t)B * L, d = kCols, f = (size_t)F;
  const size_t zq = (nq + kChunk - 1) / kChunk, zm = (nm + kChunk - 1) / kChunk;
  const size_t partial = std::max<size_t>({zq * std::max<size_t>({f * d, 2 * d * d, 3 * d}),
                                           zm * std::max<size_t>(d * d, 2 * d)});
  return (kv_saved ? 1 : 2) * align4(nm * 2 * d) + align4(nm * d) + 2 * align4(nq * 3 * d) +
         kQueryBufs * align4(nq * d) + 3 * align4(nq) + 2 * align4(nq * f) + align4(partial);
}

// Once per device, before the first launch on it: dynamic shared memory.
extern "C" int mgsv_fused_decoder_layer_bwd_init() { return (int)decoder_layer_init(); }

// Backward of one decoder layer on `stream`: recomputes the forward from
// tgt, mem, mask, pos, qpos (and, where kv is not null, the forward's k|v
// [B, L, 2D] of mgsv_fused_decoder_layer_fwd on the same inputs), then
// writes dtgt, dqpos ([B, Q, D]), dmem, dpos ([B, L, D]) and the weights'
// gradients in the weights' layout and DecoderWeights' order (the
// self-attention's six null, and not written, when self_attn is 0).  ws:
// mgsv_fused_decoder_layer_bwd_workspace floats.  Every pointer 16-byte
// aligned.  Returns the first CUDA error (0 = ok).
extern "C" int mgsv_fused_decoder_layer_bwd(
    const float* tgt, const float* mem, const float* mask, const float* pos, const float* qpos,
    const float* g, const float* sa_w_in, const float* sa_b_in, const float* sa_w_out,
    const float* sa_b_out, const float* n1_g, const float* n1_b, const float* ca_w_in,
    const float* ca_b_in, const float* ca_w_out, const float* ca_b_out, const float* n2_g,
    const float* n2_b, const float* w1, const float* b1, const float* w2, const float* b2,
    const float* n3_g, const float* n3_b, float* dtgt, float* dmem, float* dpos, float* dqpos,
    float* dsa_w_in, float* dsa_b_in, float* dsa_w_out, float* dsa_b_out, float* dn1_g,
    float* dn1_b, float* dca_w_in, float* dca_b_in, float* dca_w_out, float* dca_b_out,
    float* dn2_g, float* dn2_b, float* dw1, float* db1, float* dw2, float* db2, float* dn3_g,
    float* dn3_b, const float* kv_saved, float* ws, int B, int Q, int L, int D, int H, int F,
    int self_attn, void* stream) {
  if (!decoder_shape_ok(B, Q, L, D, H, F)) return (int)cudaErrorInvalidValue;
  const DecoderWeights w{sa_w_in, sa_b_in, sa_w_out, sa_b_out, n1_g, n1_b,
                         ca_w_in, ca_b_in, ca_w_out, ca_b_out, n2_g, n2_b,
                         w1, b1, w2, b2, n3_g, n3_b};
  const int Nq = B * Q, Nm = B * L;
  const size_t nq = (size_t)Nq, nm = (size_t)Nm, d = kCols;
  float* cur = ws;
  auto take = [&](size_t count) { float* p = cur; cur += align4(count); return p; };
  const float* kv = kv_saved ? kv_saved : take(nm * 2 * d);
  float *dkv = take(nm * 2 * d), *mp = take(nm * d);
  float *sa_qkv = take(nq * 3 * d), *dsa_qkv = take(nq * 3 * d);
  float* qb[kQueryBufs];
  for (float*& p : qb) p = take(nq * d);
  float *sa_ctx = qb[0], *r1 = qb[1], *t1 = qb[2], *xh1 = qb[3], *q = qb[4], *ctx = qb[5],
        *r2 = qb[6], *t2 = qb[7], *xh2 = qb[8], *r3 = qb[9], *xh3 = qb[10], *dr3 = qb[11],
        *dt2 = qb[12], *dr2 = qb[13], *dctx = qb[14], *dq = qb[15], *dt1 = qb[16],
        *dr1 = qb[17], *dsa_ctx = qb[18], *a = qb[19], *tmp = qb[20];
  float *inv1 = take(nq), *inv2 = take(nq), *inv3 = take(nq);
  float *h1 = take(nq * F), *dz1 = take(nq * F);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout none{0u, 0u, 1.f};
  Launcher lq{s, Nq, Q, none, cur}, lm{s, Nm, L, none, cur};
  const bool sa = self_attn != 0;

  // ---- recompute the forward (#6's sequence; a ends as t1 + qpos)
  const float* t1p = decoder_layer_fwd(
      lq, lm, w, tgt, mem, mask, pos, qpos, B, Q, L, H, F, sa, kv_saved != nullptr,
      {mp, const_cast<float*>(kv), sa_qkv, sa_ctx, r1, t1, a, q, ctx, r2, t2, h1, r3, xh1, inv1,
       xh2, inv2, xh3, inv3, nullptr});

  // ---- LN3, the FFN and LN2
  lq.ln_bwd_sums(g, xh3, inv3, n3_g, dr3, dn3_g, dn3_b);
  lq.colsum(dr3, D, D, db2);
  lq.wgrad(dr3, D, D, h1, F, F, dw2);
  lq.rowgemm({dr3, D, D, w2, F, 1, nullptr, 0, -1, F, h1, F, nullptr, 0, dz1, F}, F);
  lq.colsum(dz1, F, F, db1);
  lq.wgrad(dz1, F, F, t2, D, D, dw1);
  lq.rowgemm({dz1, F, F, w1, D, 1, nullptr, 0, -1, D, nullptr, 0, dr3, D, dt2, D}, D);
  lq.ln_bwd_sums(dt2, xh2, inv2, n2_g, dr2, dn2_g, dn2_b);

  // ---- the cross-attention and its projections
  lq.colsum(dr2, D, D, dca_b_out);
  lq.wgrad(dr2, D, D, ctx, D, D, dca_w_out);
  lq.rowgemm({dr2, D, D, ca_w_out, D, 1, nullptr, 0, -1, D, nullptr, 0, nullptr, 0, dctx, D}, D);
  if (!lq.check()) return (int)lq.err;
  cross_attention_bwd_kernel<<<dim3(H, B), kThreads, cross_attention_bwd_smem_bytes(Q, L), s>>>(
      q, kv, mask, dctx, dq, dkv, Q, L);
  lq.colsum(dq, D, D, dca_b_in);
  lm.colsum(dkv, 2 * D, 2 * D, dca_b_in + D);
  lq.wgrad(dq, D, D, a, D, D, dca_w_in);
  if (kv_saved) lm.add(mem, pos, mp, nm * d);      // else the recompute wrote it
  lm.wgrad(dkv, 2 * D, D, mp, D, D, dca_w_in + d * d);
  lm.wgrad(dkv + D, 2 * D, D, mem, D, D, dca_w_in + 2 * d * d);
  const float* w_kv = ca_w_in + d * d;
  lm.rowgemm({dkv, 2 * D, 2 * D, w_kv, D, 1, nullptr, 0, -1, D, nullptr, 0, nullptr, 0, dmem, D},
             D);
  lm.rowgemm({dkv, 2 * D, D, w_kv, D, 1, nullptr, 0, -1, D, nullptr, 0, nullptr, 0, dpos, D}, D);

  if (!sa) {
    lq.rowgemm({dq, D, D, ca_w_in, D, 1, nullptr, 0, -1, D, nullptr, 0, dr2, D, dtgt, D}, D);
    lq.rowgemm({dq, D, D, ca_w_in, D, 1, nullptr, 0, -1, D, nullptr, 0, nullptr, 0, dqpos, D},
               D);
  } else {
    // ---- LN1 and the self-attention
    lq.rowgemm({dq, D, D, ca_w_in, D, 1, nullptr, 0, -1, D, nullptr, 0, dr2, D, dt1, D}, D);
    lq.ln_bwd_sums(dt1, xh1, inv1, n1_g, dr1, dn1_g, dn1_b);
    lq.colsum(dr1, D, D, dsa_b_out);
    lq.wgrad(dr1, D, D, sa_ctx, D, D, dsa_w_out);
    lq.rowgemm({dr1, D, D, sa_w_out, D, 1, nullptr, 0, -1, D, nullptr, 0, nullptr, 0, dsa_ctx, D},
               D);
    lq.attention_bwd(sa_qkv, dsa_ctx, nullptr, dsa_qkv, B, H, Q);
    lq.colsum(dsa_qkv, 3 * D, 3 * D, dsa_b_in);
    lq.add(tgt, qpos, a, nq * d);
    lq.wgrad(dsa_qkv, 3 * D, 2 * D, a, D, D, dsa_w_in);
    lq.wgrad(dsa_qkv + 2 * D, 3 * D, D, tgt, D, D, dsa_w_in + 2 * d * d);
    lq.rowgemm({dsa_qkv, 3 * D, 3 * D, sa_w_in, D, 1, nullptr, 0, -1, D, nullptr, 0, dr1, D,
                dtgt, D},
               D);
    lq.rowgemm({dq, D, D, ca_w_in, D, 1, nullptr, 0, -1, D, nullptr, 0, nullptr, 0, tmp, D}, D);
    lq.rowgemm({dsa_qkv, 3 * D, 2 * D, sa_w_in, D, 1, nullptr, 0, -1, D, nullptr, 0, tmp, D,
                dqpos, D},
               D);
  }
  lq.check();
  lm.check();
  return (int)(lq.err != cudaSuccess ? lq.err : lm.err);
}
