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
// grid step, which its own comment blames for its speed; here they are one
// GEMM over all B*L rows, [64 rows x 256 cols] tiles of 3xTF32 mma.sync
// (the encoder's packed-projection launch, qkv_kernel, at two parts), and
// the rest runs over the B*Q query rows:
//
//  (a) qkv_kernel: k = (mem + pos) Wk^T + bk and v = mem Wv^T + bv into a
//      [B*L, 2D] buffer;
//  (b) with self-attention: qkv_kernel over the query rows, the encoder's
//      attention_kernel over Q keys, the wgmma core's row product
//      (wgmma_gemm.cuh: out-projection with the residual fused) and
//      ln_fwd_kernel (LN1);
//  (c) qkv_kernel: the cross-attention's q from t1 + qpos;
//  (d) cross_attention_kernel: one block per (head, batch row), the head's
//      k and v of the row's L memory rows in shared memory, one warp per
//      query; a masked key scores -1e9, so a row with no valid key gets
//      uniform weights, as JAX's NEG_INF does;
//  (e) the encoder's ffn_kernel: out-projection, residual, LN2, the FFN in
//      256-wide slices of F held in shared memory, residual, LN3.
//
// The scratch (k|v, the query-side activations) lives in a workspace the
// wrapper allocates.  wgmma, TMA and fewer launches are later work.

#include "decoder_layer_kernels.cuh"

// Floats of device workspace mgsv_fused_decoder_layer_fwd needs.
extern "C" size_t mgsv_fused_decoder_layer_workspace(int B, int Q, int L) {
  const size_t nq = (size_t)B * Q, nm = (size_t)B * L, d = kCols;
  return align4(nm * 2 * d) + align4(nq * 3 * d) + 6 * align4(nq * d) + align4(nq);
}

// Once per device, before the first launch on it: dynamic shared memory.
extern "C" int mgsv_fused_decoder_layer_init() { return (int)decoder_layer_init(); }

// One decoder layer on `stream`: tgt, qpos [B, Q, D], mem, pos [B, L, D],
// mask [B, L] (1 = valid) -> out [B, Q, D].  Weights as DecoderWeights
// (the self-attention's null when self_attn is 0); ws:
// mgsv_fused_decoder_layer_workspace floats; every pointer 16-byte aligned.
// Returns the first CUDA error (0 = ok).
extern "C" int mgsv_fused_decoder_layer_fwd(
    const float* tgt, const float* mem, const float* mask, const float* pos, const float* qpos,
    const float* sa_w_in, const float* sa_b_in, const float* sa_w_out, const float* sa_b_out,
    const float* n1_g, const float* n1_b,
    const float* ca_w_in, const float* ca_b_in, const float* ca_w_out, const float* ca_b_out,
    const float* n2_g, const float* n2_b, const float* w1, const float* b1, const float* w2,
    const float* b2, const float* n3_g, const float* n3_b, float* out, float* ws, int B, int Q,
    int L, int D, int H, int F, int self_attn, void* stream) {
  if (!decoder_shape_ok(B, Q, L, D, H, F)) return (int)cudaErrorInvalidValue;
  const DecoderWeights w{sa_w_in, sa_b_in, sa_w_out, sa_b_out, n1_g, n1_b,
                         ca_w_in, ca_b_in, ca_w_out, ca_b_out, n2_g, n2_b,
                         w1, b1, w2, b2, n3_g, n3_b};
  const int Nq = B * Q;
  const size_t nq = (size_t)Nq, nm = (size_t)B * L, d = kCols;
  float* cur = ws;
  auto take = [&](size_t count) { float* p = cur; cur += align4(count); return p; };
  float* kv = take(nm * 2 * d);
  float* sa_qkv = take(nq * 3 * d);
  float *sa_ctx = take(nq * d), *r1 = take(nq * d), *t1 = take(nq * d), *xh1 = take(nq * d),
        *q = take(nq * d), *ctx = take(nq * d);
  float* inv1 = take(nq);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout none{0u, 0u, 1.f};
  Launcher lq{s, Nq, Q, none, nullptr}, lm{s, (int)nm, L, none, nullptr};
  const float* t1p = decoder_attention_fwd(lq, lm, w, tgt, mem, mask, pos, qpos, B, Q, L, H,
                                           self_attn != 0, kv, sa_qkv, sa_ctx, r1, t1, xh1,
                                           inv1, q, ctx);
  if (!lq.check()) return (int)lq.err;
  if (!lm.check()) return (int)lm.err;
  ffn_kernel<false, false><<<(Nq + kRows - 1) / kRows, kThreads, kFfnSmem, s>>>(
      t1p, ctx, ca_w_out, ca_b_out, n2_g, n2_b, w1, b1, w2, b2, n3_g, n3_b, out, Nq, Q, H, F,
      none);
  return (int)cudaGetLastError();
}
