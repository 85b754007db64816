// Backward of the fused post-norm DETR encoder layer, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// mgsv_tpu/ops/pallas/fused_encoder_layer_vjp.py::_bwd_pallas (kernel
// _bwd_kernel): from the layer's inputs, the dropout seed, the output
// cotangent g and the forward's activations it returns dx, dpos and all 12
// parameter gradients.  The TPU kernel recomputes the forward, since a TPU
// core's VMEM is small; here the training forward (fused_encoder_layer.cu
// given `saved`) keeps its activations in device memory (the EncoderSaved
// set of layer_bwd_kernels.cuh: a = x + pos, q|k|v, ctx, y1, the dropped
// h1, both LayerNorms' xhat and 1 / std and the attention rows' softmax
// statistics, 3,090 floats a row, 0.96 GB a layer at B=512, L=152), and the
// backward recomputes only when it is not given them, running the
// forward's own launch sequence (encoder_layer_fwd), so both give the same
// bits.  The four dropout masks are drawn again from philox.cuh at each use
// site with the forward's (seed, batch row, site), never stored; the ReLU
// gate is read from the dropped h1, as the TPU kernel does.
//
// What bounds it on the card: at B=512, L=152 the backward is about twice
// the forward's 134.5 GFLOP (0.27 ms of bf16 products at 989 TFLOP/s; at
// "f32" each product is three TF32 ones, 1.6 ms at 495); it reads the
// saved set (0.96 GB) and writes and reads its own cotangent rows
// (dq|dk|dv, six [B*L, D] and the [B*L, F] dz1: 1.04 GB each way), some
// 3.4 GB with x, pos, g, dx and dpos, 1.0 ms at 3.35 TB/s.  So the memory
// bounds it at "bf16" and the arithmetic at "f32", and the design (the
// launches of layer_bwd_kernels.cuh, which the temporal and decoder
// layers' backwards share) puts every product on Hopper's tensor cores and
// fuses what it can into their epilogues:
//
//  * Every activation x weight product of the backward (and of the
//    recompute), q|k|v included, is a launch of the wgmma core
//    (wgmma_gemm.cuh): 128 x 128 tiles fed by TMA through a ring of
//    shared-memory stages, persistent blocks, the bias / ReLU / dropout /
//    gate / residual epilogues on the accumulators.  dX = dY W reads W as
//    an MN-major operand, transposed in shared memory; nothing is
//    transposed in device memory.
//  * Each weight gradient dW = G^T H over all B*L rows is a split-K launch
//    of the same core (both operands MN-major, 1024-row slices) whose
//    per-slice partials reduce_kernel sums in slice order; bias and
//    LayerNorm gradients (column sums) take the same two passes.  No float
//    atomics: a step is reproducible from run to run.
//  * The [B, H, L, L] attention matrices never reach device memory: per
//    (head, batch row) the backward rebuilds them on the tensor cores
//    (attention_bwd_tc_kernel: mma.sync, 3xTF32 or bf16), one sweep over
//    query rows (dq) and one over key rows (dk, dv), so every sum has one
//    owner.  At "f32" it reads the forward's softmax statistics and takes
//    D_i = dctx_i . ctx_i; at "bf16" its first sweep takes the statistics
//    and D_i itself.
//
// With bf16 set (JAX's precision="bf16" of this VJP) every product, the
// weight gradients' included, takes bf16 operands (rounded as the GEMM
// core stages them) with float32 sums; LayerNorm, softmax, the dropout
// masks, the column sums and the split-K order stay float32 and unchanged.

#include "layer_bwd_kernels.cuh"

// Floats of device workspace mgsv_fused_encoder_layer_bwd needs at B*L rows
// and FFN width F (D = 256), given the forward's saved set (saved 1) or
// recomputing it (saved 0).
extern "C" size_t mgsv_fused_encoder_layer_bwd_workspace(int rows, int F, int saved) {
  const size_t n = (size_t)rows, d = kCols, z = (n + kChunk - 1) / kChunk;
  const size_t partial = std::max<size_t>({(size_t)F * d, 2 * d * d, 3 * d});
  size_t floats = align4(n * 3 * d) + 6 * align4(n * d) + align4(n * F) + align4(z * partial);
  if (!saved)        // a, qkv, ctx, r, y1, xh1, xh2, 1 / std twice, h1, the statistics
    floats += align4(n * 3 * d) + 6 * align4(n * d) + 2 * align4(n) + align4(n * F) +
              align4(2 * (kCols / kHeadDim) * n);
  return floats;
}

// Once per device, before the first launch on it: dynamic shared memory.
extern "C" int mgsv_fused_encoder_layer_bwd_init() {
  return (int)layer_bwd_init(kMaxL);
}

// Backward of one encoder layer on `stream`: from x, pos, mask, the
// dropout (seed, thresh, scale) and `saved` (the EncoderSaved pointers of
// mgsv_fused_encoder_layer_fwd on the same inputs and dropout) or, with
// saved null, by recomputing them: the same bits either way.  Writes dx,
// dpos ([B, L, D]) and the parameter gradients, in the layout of the
// weights (torch [out, in]).  ws: mgsv_fused_encoder_layer_bwd_workspace
// floats.  bf16 != 0: bf16 operands, float32 sums.  Every pointer 16-byte
// aligned.  Returns the first CUDA error (0 = ok).
extern "C" int mgsv_fused_encoder_layer_bwd(
    const float* x, const float* pos, const float* mask, const float* g_out,
    const float* w_in, const float* b_in, const float* w_out, const float* b_out,
    const float* g1, const float* be1, const float* w1, const float* b1,
    const float* w2, const float* b2, const float* g2, const float* be2,
    float* dx, float* dpos, float* dw_in, float* db_in, float* dw_out, float* db_out,
    float* dg1, float* dbe1, float* dw1, float* db1, float* dw2, float* db2,
    float* dg2, float* dbe2, float* const* saved, float* ws, int B, int L, int D, int H, int F,
    const unsigned* seed, unsigned thresh, float scale, int bf16, void* stream) {
  if (B < 1 || B > kMaxB || L < 1 || L > kMaxL || D != kCols || H * kHeadDim != D ||
      F < kCols || F % kCols != 0)
    return (int)cudaErrorInvalidValue;
  const int rows = B * L;
  const size_t n = (size_t)rows, d = kCols;
  float* cur = ws;
  auto take = [&](size_t count) { float* p = cur; cur += align4(count); return p; };
  EncoderActs t{};
  if (saved) {
    t = encoder_saved(saved);
  } else {
    t.a = take(n * d);
    t.qkv = take(n * 3 * d);
    t.ctx = take(n * d);
    t.r = take(n * d);
    t.y1 = take(n * d);
    t.xh1 = take(n * d);
    t.xh2 = take(n * d);
    t.inv1 = take(n);
    t.inv2 = take(n);
    t.h1 = take(n * F);
    t.stats = reinterpret_cast<float2*>(take(2 * (size_t)H * n));
  }
  float* dqkv = take(n * 3 * d);
  float *dr2 = take(n * d), *dh2 = take(n * d), *dy1 = take(n * d), *dr1 = take(n * d),
        *dout = take(n * d), *dctx = take(n * d);
  float* dz1 = take(n * F);
  Launcher k{static_cast<cudaStream_t>(stream), rows, L, Dropout{seed, thresh, scale}, cur};
  k.bf16 = bf16 != 0;

  // ---- without the saved set, the forward's sequence again (#1's)
  if (!saved)
    encoder_layer_fwd(k, x, pos, mask,
                      {w_in, b_in, w_out, b_out, g1, be1, w1, b1, w2, b2, g2, be2}, t, B, H, F);

  // ---- FFN and LN2
  k.ln_bwd_sums(g_out, t.xh2, t.inv2, g2, dr2, dg2, dbe2);
  k.dropout(dr2, dh2, D, H + 2);
  k.colsum(dh2, D, D, db2);
  k.wgrad(dh2, D, D, t.h1, F, F, dw2);
  k.rowgemm({dh2, D, D, w2, F, 1, nullptr, 0, H + 1, F, t.h1, F, nullptr, 0, dz1, F}, F);
  k.colsum(dz1, F, F, db1);
  k.wgrad(dz1, F, F, t.y1, D, D, dw1);
  k.rowgemm({dz1, F, F, w1, D, 1, nullptr, 0, -1, D, nullptr, 0, dr2, D, dy1, D}, D);

  // ---- LN1 and the attention output projection
  k.ln_bwd_sums(dy1, t.xh1, t.inv1, g1, dr1, dg1, dbe1);
  k.dropout(dr1, dout, D, H);
  k.colsum(dout, D, D, db_out);
  k.wgrad(dout, D, D, t.ctx, D, D, dw_out);
  k.rowgemm({dout, D, D, w_out, D, 1, nullptr, 0, -1, D, nullptr, 0, nullptr, 0, dctx, D}, D);

  // ---- attention and the input projections
  k.attention_bwd(t.qkv, dctx, mask, dqkv, B, H, L, t.ctx, t.stats);
  k.colsum(dqkv, 3 * D, 3 * D, db_in);
  k.wgrad(dqkv, 3 * D, 2 * D, t.a, D, D, dw_in);
  k.wgrad(dqkv + 2 * D, 3 * D, D, x, D, D, dw_in + (size_t)2 * D * D);
  // dpos = dq Wq + dk Wk; dx = dv Wv + dpos + dr1
  k.rowgemm({dqkv, 3 * D, 2 * D, w_in, D, 1, nullptr, 0, -1, D, nullptr, 0, nullptr, 0, dpos, D},
            D);
  k.rowgemm({dqkv + 2 * D, 3 * D, D, w_in + (size_t)2 * D * D, D, 1, nullptr, 0, -1, D, nullptr,
             0, dr1, D, dx, D, 0, dpos, D},
            D);
  k.check();
  return (int)k.err;
}
