// Fused post-norm DETR encoder layer, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// mgsv_tpu/ops/pallas/fused_encoder_layer.py::fused_encoder_layer
// (kernel _fused_layer_kernel), with its in-kernel dropout: the serving
// path runs it at rate 0, training at the configuration's rate (0.1).  Per
// batch row it computes
//
//   q, k = (x + pos) Wq^T + bq, (x + pos) Wk^T + bk;  v = x Wv^T + bv
//   ctx  = (drop_h(softmax_keys(q k^T / sqrt(dh), masked keys -> -1e9))) v   per head h
//   y1   = LN1(x + drop_H(ctx Wo^T + bo))
//   out  = LN2(y1 + drop_H+2(drop_H+1(relu(y1 W1^T + b1)) W2^T + b2))
//
// with every weight in torch's [out, in] layout (in_proj_weight rows q|k|v)
// and the masks drawn from philox.cuh (never stored; the backward,
// fused_encoder_layer_bwd.cu, draws them again).
//
// What bounds it on the card: at B=512, L=152, D=256, F=1024 one layer is
// 134.5 GFLOP, 85 % of it the five activation x weight products, against
// some 240 MB of inputs and output: the tensor cores' rate bounds it (0.27
// ms at TF32's 495 TFLOP/s, 0.14 ms at bf16's 989).  So every product runs
// on Hopper's tensor cores through wgmma, as one launch sequence
// (layer_bwd_kernels.cuh::encoder_layer_fwd) that #2 runs again only when
// it is given no saved set:
//
//  * x + pos; q|k and v, the out-projection (dropout, residual x) and both
//    FFN products (bias, ReLU, dropout; dropout, residual y1) are launches
//    of the GEMM core of wgmma_gemm.cuh: persistent 128 x 128 tiles fed by
//    TMA through a ring of shared-memory stages, the epilogue fused on the
//    accumulators.  LayerNorm is one warp per row.
//  * The attention runs one block per (head, batch row) with the [L, L]
//    weights in registers: at "bf16" on the tensor cores
//    (attention_fwd_tc_kernel, mma.sync m16n8k16), at "f32" on the CUDA
//    cores in float32 (attention_kernel of encoder_layer_kernels.cuh,
//    faster at L <= 256 than 3xTF32 on mma.sync).
//
// Unlike the first design (three launches, the [L, F] FFN hidden state
// kept in shared memory), the q|k|v, ctx, residual, y1 and [B*L, F] hidden
// activations pass through device memory: at B=512 some 1.2 GB written and
// read once, about 0.7 ms at 3.35 TB/s, which the products' speed on the
// wgmma core repays.  The wrapper allocates that workspace
// (mgsv_fused_encoder_layer_workspace floats) with torch.empty.  When a
// gradient will be taken, the wrapper passes tensors of its own for them
// (EncoderSaved, layer_bwd_kernels.cuh: a, q|k|v, ctx, y1, h1): the same
// launches then also keep both LayerNorms' xhat and 1 / std and the
// attention rows' softmax statistics, 3,090 floats a row at F = 1024 (0.96
// GB a layer at B=512, L=152), and the backward reads them instead of
// recomputing the forward.
//
// Precision "f32" (bf16 = 0): 3xTF32 products (float32 accuracy).
// Precision "bf16" (the JAX kernel's precision="bf16", which the model
// takes under a bf16 compute dtype): every product with bf16 operands
// (rounded as the GEMM core stages them, and as the attention stages its
// heads) and float32 sums; inputs, outputs, LayerNorm, softmax and the
// dropout masks stay float32, as in JAX.

#include "layer_bwd_kernels.cuh"

// Floats of device workspace mgsv_fused_encoder_layer_fwd needs at B*L rows
// and FFN width F (D = 256), with (saved 1) or without the saved set.
extern "C" size_t mgsv_fused_encoder_layer_workspace(int rows, int F, int saved) {
  const size_t n = (size_t)rows, d = kCols;
  if (saved) return align4(n * d);                       // r alone
  return 4 * align4(n * d) + align4(n * 3 * d) + align4(n * F);
}

// Once per device, before the first launch on it: lets the attention
// launches take their dynamic shared memory (for the longest L the layer
// takes).  Returns the first CUDA error (0 = ok).
extern "C" int mgsv_fused_encoder_layer_init() {
  return (int)encoder_fwd_init(kMaxL);
}

// One post-norm encoder layer on `stream`, dropout (seed, thresh, scale) as
// in philox.cuh (thresh 0: none), after mgsv_fused_encoder_layer_init
// on that device.  out is the [B, L, D] result, ws
// mgsv_fused_encoder_layer_workspace floats of scratch; `saved`, when not
// null, the EncoderSaved pointers (layer_bwd_kernels.cuh) the backward
// takes, written here.  Every pointer 16-byte aligned.  The shapes must be
// ones the Python wrapper accepts (its check_supported).  bf16 != 0: bf16
// operands, float32 sums.  Returns the first CUDA error (0 = ok).
extern "C" int mgsv_fused_encoder_layer_fwd(
    const float* x, const float* pos, const float* mask,
    const float* w_in, const float* b_in, const float* w_out, const float* b_out,
    const float* g1, const float* be1, const float* w1, const float* b1,
    const float* w2, const float* b2, const float* g2, const float* be2,
    float* ws, float* out, float* const* saved, int B, int L, int D, int H, int F,
    const unsigned* seed, unsigned thresh, float scale, int bf16, void* stream) {
  if (B < 1 || B > kMaxB || L < 1 || L > kMaxL || D != kCols || H * kHeadDim != D ||
      F < kCols || F % kCols != 0)
    return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)B * L, d = kCols;
  float* cur = ws;
  auto take = [&](size_t count) { float* p = cur; cur += align4(count); return p; };
  EncoderActs t{};
  if (saved) {
    t = encoder_saved(saved);
  } else {
    t.a = take(n * d);
    t.qkv = take(n * 3 * d);
    t.ctx = take(n * d);
    t.y1 = take(n * d);
    t.h1 = take(n * F);
  }
  t.r = take(n * d);
  t.out = out;
  Launcher k{static_cast<cudaStream_t>(stream), B * L, L, Dropout{seed, thresh, scale}, nullptr};
  k.bf16 = bf16 != 0;
  encoder_layer_fwd(k, x, pos, mask, {w_in, b_in, w_out, b_out, g1, be1, w1, b1, w2, b2, g2, be2},
                    t, B, H, F);
  k.check();
  return (int)k.err;
}
