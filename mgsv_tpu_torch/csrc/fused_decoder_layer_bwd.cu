// Backward of the fused post-norm DETR decoder layer, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// mgsv_tpu/ops/pallas/fused_decoder_layer.py::_train_bwd (kernel
// _bwd_kernel): from the layer's inputs, the output cotangent g and the
// training forward's saved set it returns dtgt, dqpos [B, Q, D], dmem, dpos
// [B, L, D] and the gradients of all the layer's weights (the mask gets
// none).  The TPU kernel recomputes the forward, since a TPU core's VMEM is
// small; here the training forward (fused_decoder_layer.cu given `saved`)
// keeps the memory's k|v and the query side's activations in device memory
// (the DecoderSaved set of decoder_layer_kernels.cuh, 79 MB a layer at
// B=512, Q=10), and the backward recomputes only what it is not given: with
// the forward's k|v alone, the query side; with nothing, the whole forward.
// It runs the forward's own launch sequence (decoder_layer_fwd) to do so,
// so the three give the same bits.
//
// What bounds it on the card: at B=512, Q=10, L=152 the backward is about
// 61 GFLOP, most of it the memory side: dk, dv give dWk = dk^T (mem + pos),
// dWv = dv^T mem, dpos = dk Wk and dmem = dv Wv + dpos, products over the
// B*L memory rows; the query side is small.  At Q=1 the bytes (memory, pos,
// k|v, their gradients) come close.  The design:
//
//  * Activation x weight products run on the wgmma core (wgmma_gemm.cuh,
//    3xTF32; bias / ReLU gate / residual epilogues fused), over the B*Q
//    query rows or the B*L memory rows; dpos = dk Wk once, and dmem takes
//    it as the residual of dv Wv.
//  * Each weight gradient is a split-K product of the same core over
//    1024-row slices whose partials are summed in slice order, each bias
//    gradient summed in the same pass (PartialSumEpi), and a positional
//    embedding added to the product's B operand as its slices are
//    converted (PartialSumAddEpi): dWk | dWv in one product of mem (+ pos
//    for k's rows), the self-attention's q | k | v in one of tgt (+ qpos
//    for q's and k's rows), dWq of t1 (+ qpos).  No add and no column-sum
//    launches: two calls on the same inputs are bit-identical.
//  * Both attentions' backwards are attention_rows_bwd_kernel: given the
//    forward's row statistics and D_i = dctx_i . ctx_i, one pass over the
//    key rows, each read and written once as whole rows.
//
// With t1 the self-attention block's output (tgt without it), q = (t1 +
// qpos) Wq^T + bq, t2 = LN2(t1 + ctx Wo^T + bo), h1 = relu(t2 W1^T + b1),
// out = LN3(t2 + h1 W2^T + b2):
//
//   dr3 = LN3'(g);  db2, dW2 = sums of dr3, dr3^T h1
//   dz1 = (dr3 W2) [h1 > 0];  db1, dW1 = sums of dz1, dz1^T t2
//   dt2 = dr3 + dz1 W1;  dr2 = LN2'(dt2);  dbo, dWo = sums of dr2, dr2^T ctx
//   dq, dk, dv = cross-attention backward of dctx = dr2 Wo
//   dWq = dq^T (t1 + qpos), dWk = dk^T (mem + pos), dWv = dv^T mem (and the
//   biases);  dpos = dk Wk;  dmem = dv Wv + dpos;  dt1 = dr2 + dq Wq
//   with self-attention: dr1 = LN1'(dt1), its out-projection and attention
//   backward give dsa_qkv; dtgt = dr1 + dsa_qkv W_in, dqpos = dq Wq +
//   dsa_qk W_qk; without it dtgt = dt1, dqpos = dq Wq.

#include "decoder_layer_kernels.cuh"

namespace {

// Query-side [B*Q, D] gradient buffers of the backward, in workspace order.
constexpr int kGradBufs = 8;

}  // namespace

// Floats of device workspace mgsv_fused_decoder_layer_bwd needs; given: 2
// the forward's saved set, 1 its k|v alone, 0 nothing.
extern "C" size_t mgsv_fused_decoder_layer_bwd_workspace(int B, int Q, int L, int F, int given) {
  const size_t nq = (size_t)B * Q, nm = (size_t)B * L, d = kCols, f = (size_t)F;
  const size_t h = kCols / kHeadDim;
  const size_t zq = (nq + kChunk - 1) / kChunk, zm = (nm + kChunk - 1) / kChunk;
  const size_t partial = std::max<size_t>(zq * std::max<size_t>(f * d + 2 * f, 3 * d * d + 6 * d),
                                          zm * (2 * d * d + 4 * d));
  size_t floats = align4(nm * 2 * d) + align4(nq * 3 * d) + kGradBufs * align4(nq * d) +
                  align4(nq * f) + align4(partial);
  if (given < 2)     // the query side of the saved set, and r1, r2, r3
    floats += align4(nq * 3 * d) + 11 * align4(nq * d) + 3 * align4(nq) + align4(nq * f) +
              2 * align4(2 * h * nq);
  if (given < 1) floats += align4(nm * 2 * d);
  return floats;
}

// Once per device, before the first launch on it: dynamic shared memory.
extern "C" int mgsv_fused_decoder_layer_bwd_init() { return (int)decoder_layer_init(); }

// Backward of one decoder layer on `stream`, from tgt, mem, mask, pos, qpos
// and `saved` (the DecoderSaved pointers of mgsv_fused_decoder_layer_fwd
// on the same inputs) or, with saved null, by recomputing that set (taking
// the forward's k|v [B, L, 2D] where kv is not null): the same bits every
// way.  Writes dtgt, dqpos ([B, Q, D]), dmem, dpos ([B, L, D]) and the
// weights' gradients in the weights' layout and DecoderWeights' order (the
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
    float* dn3_b, const float* kv_saved, float* const* saved, float* ws, int B, int Q, int L,
    int D, int H, int F, int self_attn, void* stream) {
  if (!decoder_shape_ok(B, Q, L, D, H, F)) return (int)cudaErrorInvalidValue;
  const DecoderWeights w{sa_w_in, sa_b_in, sa_w_out, sa_b_out, n1_g, n1_b,
                         ca_w_in, ca_b_in, ca_w_out, ca_b_out, n2_g, n2_b,
                         w1, b1, w2, b2, n3_g, n3_b};
  const int Nq = B * Q, Nm = B * L;
  const size_t nq = (size_t)Nq, nm = (size_t)Nm, d = kCols, dd = d * d;
  float* cur = ws;
  auto take = [&](size_t count) { float* p = cur; cur += align4(count); return p; };
  DecoderActs t{};
  if (saved) {
    t = decoder_saved(saved);
  } else {
    t.sa_qkv = take(nq * 3 * d);
    t.sa_ctx = take(nq * d);
    t.t1 = take(nq * d);
    t.xh1 = take(nq * d);
    t.q = take(nq * d);
    t.ctx = take(nq * d);
    t.t2 = take(nq * d);
    t.xh2 = take(nq * d);
    t.xh3 = take(nq * d);
    t.r1 = take(nq * d);
    t.r2 = take(nq * d);
    t.r3 = take(nq * d);
    t.inv1 = take(nq);
    t.inv2 = take(nq);
    t.inv3 = take(nq);
    t.h1 = take(nq * F);
    t.sa_stats = reinterpret_cast<float2*>(take(2 * (size_t)H * nq));
    t.stats = reinterpret_cast<float2*>(take(2 * (size_t)H * nq));
    t.kv = kv_saved ? const_cast<float*>(kv_saved) : take(nm * 2 * d);
  }
  float *dkv = take(nm * 2 * d), *dsa_qkv = take(nq * 3 * d);
  float* gb[kGradBufs];
  for (float*& p : gb) p = take(nq * d);
  float *dr3 = gb[0], *dt2 = gb[1], *dr2 = gb[2], *dctx = gb[3], *dq = gb[4], *dt1 = gb[5],
        *dr1 = gb[6], *dsa_ctx = gb[7];
  float* dqq = dt2;          // dq Wq, once dt2 is spent
  float* dz1 = take(nq * F);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout none{nullptr, 0u, 1.f};
  Launcher lq{s, Nq, Q, none, cur}, lm{s, Nm, L, none, cur};
  const bool sa = self_attn != 0;

  // ---- without the saved set, the forward's sequence again (#6's)
  if (!saved)
    decoder_layer_fwd(lq, lm, w, tgt, mem, mask, pos, qpos, B, Q, L, H, F, sa,
                      kv_saved != nullptr, t);
  const float* t1 = sa ? t.t1 : tgt;

  // ---- LN3, the FFN and LN2
  lq.ln_bwd_sums(g, t.xh3, t.inv3, n3_g, dr3, dn3_g, dn3_b);
  lq.wgrad(dr3, D, D, t.h1, F, F, dw2, db2);
  lq.rowgemm({dr3, D, D, w2, F, 1, nullptr, 0, -1, F, t.h1, F, nullptr, 0, dz1, F}, F);
  lq.wgrad(dz1, F, F, t.t2, D, D, dw1, db1);
  lq.rowgemm({dz1, F, F, w1, D, 1, nullptr, 0, -1, D, nullptr, 0, dr3, D, dt2, D}, D);
  lq.ln_bwd_sums(dt2, t.xh2, t.inv2, n2_g, dr2, dn2_g, dn2_b);

  // ---- the cross-attention and its projections
  lq.wgrad(dr2, D, D, t.ctx, D, D, dca_w_out, dca_b_out);
  lq.rowgemm({dr2, D, D, ca_w_out, D, 1, nullptr, 0, -1, D, nullptr, 0, nullptr, 0, dctx, D}, D);
  if (lq.check() && lm.check())
    lq.keep_err(launch_attention_rows_bwd({t.q, t.kv, t.kv + D, D, 2 * D, dctx, t.ctx, t.stats,
                                           mask, dq, dkv, dkv + D, D, 2 * D, Q, L, 0},
                                          B, H, s));
  lq.wgrad(dq, D, D, t1, D, D, dca_w_in, dca_b_in, qpos, D, D);
  lm.wgrad(dkv, 2 * D, 2 * D, mem, D, D, dca_w_in + dd, dca_b_in + D, pos, D, D);
  lm.rowgemm({dkv, 2 * D, D, ca_w_in + dd, D, 1, nullptr, 0, -1, D, nullptr, 0, nullptr, 0, dpos,
              D},
             D);
  lm.rowgemm({dkv + D, 2 * D, D, ca_w_in + 2 * dd, D, 1, nullptr, 0, -1, D, nullptr, 0, dpos, D,
              dmem, D},
             D);

  if (!sa) {
    lq.rowgemm({dq, D, D, ca_w_in, D, 1, nullptr, 0, -1, D, nullptr, 0, dr2, D, dtgt, D, 0,
                nullptr, 0, dqpos},
               D);
  } else {
    // ---- LN1 and the self-attention
    lq.rowgemm({dq, D, D, ca_w_in, D, 1, nullptr, 0, -1, D, nullptr, 0, dr2, D, dt1, D, 0,
                nullptr, 0, dqq},
               D);
    lq.ln_bwd_sums(dt1, t.xh1, t.inv1, n1_g, dr1, dn1_g, dn1_b);
    lq.wgrad(dr1, D, D, t.sa_ctx, D, D, dsa_w_out, dsa_b_out);
    lq.rowgemm({dr1, D, D, sa_w_out, D, 1, nullptr, 0, -1, D, nullptr, 0, nullptr, 0, dsa_ctx, D},
               D);
    if (lq.check())
      lq.keep_err(launch_attention_rows_bwd(
          {t.sa_qkv, t.sa_qkv + D, t.sa_qkv + 2 * D, 3 * D, 3 * D, dsa_ctx, t.sa_ctx, t.sa_stats,
           nullptr, dsa_qkv, dsa_qkv + D, dsa_qkv + 2 * D, 3 * D, 3 * D, Q, Q, 0},
          B, H, s));
    lq.wgrad(dsa_qkv, 3 * D, 3 * D, tgt, D, D, dsa_w_in, dsa_b_in, qpos, D, 2 * D);
    lq.rowgemm({dsa_qkv, 3 * D, 3 * D, sa_w_in, D, 1, nullptr, 0, -1, D, nullptr, 0, dr1, D,
                dtgt, D},
               D);
    lq.rowgemm({dsa_qkv, 3 * D, 2 * D, sa_w_in, D, 1, nullptr, 0, -1, D, nullptr, 0, dqq, D,
                dqpos, D},
               D);
  }
  lq.check();
  lm.check();
  return (int)(lq.err != cudaSuccess ? lq.err : lm.err);
}
