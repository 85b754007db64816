// Fused post-norm DETR decoder layer, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// mgsv_tpu/ops/pallas/fused_decoder_layer.py::_fwd_call (kernel
// _fwd_kernel), which JAX's FusedDetrDecoderLayer runs.  In float32, with
// no dropout, per batch row:
//
//   t1  = LN1(tgt + SA(tgt + qpos, tgt + qpos, tgt))    (self-attention over
//         the Q queries, no mask; skipped without self-attention: t1 = tgt)
//   t2  = LN2(t1 + CA(t1 + qpos, mem + pos, mem, key mask))
//   out = LN3(t2 + W2 relu(W1 t2 + b1) + b2)
//
// What bounds it on the card: at B=512, Q=10, L=152, D=256, F=1024 a layer
// is about 30.6 GFLOP, and 20.4 of them are the cross-attention's k and v
// projections of the [B*L, D] memory, the same work at any Q; memory and pos
// are 2 x 79.7 MB.  At Q=10 the arithmetic bounds it (TF32 tensor cores),
// at Q=1 the bytes.  The TPU kernel projects k and v per batch row inside a
// grid step, which its own comment blames for its speed; here every product
// is a launch of the GEMM core of wgmma_gemm.cuh (persistent 128 x 128
// tiles fed by TMA, 3xTF32, bias / ReLU / residual fused on the
// accumulators), over all B*L memory rows or all B*Q query rows, as one
// sequence that the backward's recompute shares
// (decoder_layer_kernels.cuh::decoder_layer_fwd):
//
//  (a) mem + pos; k = (mem + pos) Wk^T + bk and v = mem Wv^T + bv into the
//      [B*L, 2D] k|v buffer, which the caller keeps: the backward takes it
//      instead of projecting the memory again;
//  (b) with self-attention: tgt + qpos, its q|k and v, the float32
//      attention over Q keys (attention_kernel, as the encoder layer's),
//      the out-projection with the residual tgt, LN1 (one warp per row);
//  (c) t1 + qpos and the cross-attention's q;
//  (d) cross_attention_kernel: one block per (head, batch row), the head's
//      k and v of the row's L memory rows in shared memory, one warp per
//      query; a masked key scores -1e9, so a row with no valid key gets
//      uniform weights, as JAX's NEG_INF does;
//  (e) the out-projection with the residual t1, LN2, FFN1 (bias, ReLU),
//      FFN2 with the residual t2, LN3 into out.
//
// The query-side activations and mem + pos live in a workspace the
// wrapper allocates (mgsv_fused_decoder_layer_workspace floats).

#include "decoder_layer_kernels.cuh"

// Floats of device workspace mgsv_fused_decoder_layer_fwd needs (D = 256).
extern "C" size_t mgsv_fused_decoder_layer_workspace(int B, int Q, int L, int F) {
  const size_t nq = (size_t)B * Q, nm = (size_t)B * L, d = kCols;
  return align4(nm * d) + align4(nq * 3 * d) + 9 * align4(nq * d) + align4(nq * F);
}

// Once per device, before the first launch on it: dynamic shared memory.
extern "C" int mgsv_fused_decoder_layer_init() { return (int)decoder_layer_init(); }

// One decoder layer on `stream`: tgt, qpos [B, Q, D], mem, pos [B, L, D],
// mask [B, L] (1 = valid) -> out [B, Q, D] and the memory's k|v, kv
// [B, L, 2D] (what mgsv_fused_decoder_layer_bwd may take).  Weights as
// DecoderWeights (the self-attention's null when self_attn is 0); ws:
// mgsv_fused_decoder_layer_workspace floats; every pointer 16-byte aligned.
// Returns the first CUDA error (0 = ok).
extern "C" int mgsv_fused_decoder_layer_fwd(
    const float* tgt, const float* mem, const float* mask, const float* pos, const float* qpos,
    const float* sa_w_in, const float* sa_b_in, const float* sa_w_out, const float* sa_b_out,
    const float* n1_g, const float* n1_b,
    const float* ca_w_in, const float* ca_b_in, const float* ca_w_out, const float* ca_b_out,
    const float* n2_g, const float* n2_b, const float* w1, const float* b1, const float* w2,
    const float* b2, const float* n3_g, const float* n3_b, float* out, float* kv, float* ws,
    int B, int Q, int L, int D, int H, int F, int self_attn, void* stream) {
  if (!decoder_shape_ok(B, Q, L, D, H, F)) return (int)cudaErrorInvalidValue;
  const size_t nq = (size_t)B * Q, nm = (size_t)B * L, d = kCols;
  float* cur = ws;
  auto take = [&](size_t count) { float* p = cur; cur += align4(count); return p; };
  DecoderActs t{};
  t.mp = take(nm * d);
  t.kv = kv;
  t.sa_qkv = take(nq * 3 * d);
  t.sa_ctx = take(nq * d);
  t.r1 = take(nq * d);
  t.t1 = take(nq * d);
  t.a = take(nq * d);
  t.q = take(nq * d);
  t.ctx = take(nq * d);
  t.r2 = take(nq * d);
  t.t2 = take(nq * d);
  t.r3 = take(nq * d);
  t.h1 = take(nq * F);
  t.out = out;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout none{0u, 0u, 1.f};
  Launcher lq{s, B * Q, Q, none, nullptr}, lm{s, B * L, L, none, nullptr};
  decoder_layer_fwd(lq, lm,
                    {sa_w_in, sa_b_in, sa_w_out, sa_b_out, n1_g, n1_b, ca_w_in, ca_b_in,
                     ca_w_out, ca_b_out, n2_g, n2_b, w1, b1, w2, b2, n3_g, n3_b},
                    tgt, mem, mask, pos, qpos, B, Q, L, H, F, self_attn != 0, false, t);
  lq.check();
  lm.check();
  return (int)(lq.err != cudaSuccess ? lq.err : lm.err);
}
