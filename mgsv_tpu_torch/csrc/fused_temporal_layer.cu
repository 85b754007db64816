// Fused temporal-tower layer, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// mgsv_tpu/ops/pallas/fused_temporal_layer.py::_fwd_pallas (kernel
// _fwd_kernel), with its in-kernel dropout: training runs it at the
// configuration's rate (0.8), evaluation at rate 0.  Per batch row it
// computes the reference's Transformer_enhancement layer, whose residuals
// are taken after each norm:
//
//   y   = LN1(x)
//   q, k, v = y Wq^T + bq, y Wk^T + bk, y Wv^T + bv
//   ctx = (drop_h(softmax_keys(q k^T / sqrt(dh), masked keys -> -1e9))) v   per head h
//   u   = y + ctx Wo^T + bo                          (no dropout here)
//   z   = LN2(u)
//   out = z + drop_H+1(drop_H(gelu(z W1^T + b1)) W2^T + b2)   (no LayerNorm after)
//
// with every weight in torch's [out, in] layout (in_proj_weight rows q|k|v),
// the exact erf GELU, and the masks drawn from philox.cuh (never stored;
// the backward, fused_temporal_layer_bwd.cu, draws them again).
//
// What bounds it on the card: per batch row 8 L D^2 + 4 L^2 D + 4 L D F
// FLOP; at B=512, D=256, F=1024 that is 82.1 GFLOP for the audio tower
// (L=96) and 41.6 GFLOP for the video tower (L=50), 94 % of it the four
// activation x weight products, against some 100 MB of inputs and output:
// the tensor cores' rate bounds it (0.17 ms at TF32's 495 TFLOP/s).  So
// the products run on Hopper's tensor cores through wgmma, as one launch
// sequence that the backward's recompute shares
// (layer_bwd_kernels.cuh::temporal_layer_fwd):
//
//  * LN1 (one warp per row); the packed q|k|v product, the out-projection
//    (residual y) and both FFN products are launches of the GEMM core of
//    wgmma_gemm.cuh (persistent 128 x 128 tiles fed by TMA, 3xTF32, the
//    epilogue fused on the accumulators): FFN1 applies its bias, the GELU
//    and the dropout of site H there, FFN2 its bias, the dropout of site
//    H+1 and the residual z, and writes out.  LN2 between them.
//  * The attention runs one block per (head, batch row) on the CUDA cores
//    in float32 (attention_kernel of encoder_layer_kernels.cuh, faster at
//    L <= 300 than 3xTF32 on mma.sync), its per-head dropout sites drawn
//    where the weights are normalized.
//
// The y, q|k|v, ctx, u, z and [B*L, F] hidden activations pass through
// device memory (some 0.55 GB at the audio tower's B=512), a workspace the
// wrapper allocates (mgsv_fused_temporal_layer_workspace floats).  When a
// gradient will be taken, the wrapper passes tensors of its own for them
// (TemporalSaved, layer_bwd_kernels.cuh): the same launches then also
// keep both LayerNorms' xhat and 1 / std, the attention rows' softmax
// statistics and FFN1's pre-activation (a second store of its epilogue),
// and the backward (fused_temporal_layer_bwd.cu) reads them instead of
// recomputing the forward.
// Dropout is a compile-time part of the epilogues and of the attention, so
// the rate-0 evaluation compiles the mask code out.

#include "layer_bwd_kernels.cuh"

// Floats of device workspace mgsv_fused_temporal_layer_fwd needs at B*L rows
// and FFN width F (D = 256), with (saved 1) or without the saved set.
extern "C" size_t mgsv_fused_temporal_layer_workspace(int rows, int F, int saved) {
  const size_t n = (size_t)rows, d = kCols;
  if (saved) return align4(n * d);                       // u alone
  return 4 * align4(n * d) + align4(n * 3 * d) + align4(n * F);
}

// Once per device, before the first launch on it: lets the attention
// launches take their dynamic shared memory (for the longest L).  Returns
// the first CUDA error (0 = ok).
extern "C" int mgsv_fused_temporal_layer_init() { return (int)attention_init(kTemporalMaxL); }

// One temporal layer on `stream`, dropout (seed, thresh, scale) as in
// philox.cuh (thresh 0: none), after mgsv_fused_temporal_layer_init on that
// device.  out is the [B, L, D] result, ws mgsv_fused_temporal_layer_workspace
// floats of scratch; `saved`, when not null, the TemporalSaved pointers
// (layer_bwd_kernels.cuh) the backward takes, written here.  Every pointer
// 16-byte aligned.  Returns the first CUDA error (0 = ok).
extern "C" int mgsv_fused_temporal_layer_fwd(
    const float* x, const float* mask,
    const float* w_in, const float* b_in, const float* w_out, const float* b_out,
    const float* g1, const float* be1, const float* w1, const float* b1,
    const float* w2, const float* b2, const float* g2, const float* be2,
    float* ws, float* out, float* const* saved, int B, int L, int D, int H, int F,
    const unsigned* seed, unsigned thresh, float scale, void* stream) {
  if (!temporal_shape_ok(B, L, D, H, F)) return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)B * L, d = kCols;
  float* cur = ws;
  auto take = [&](size_t count) { float* p = cur; cur += align4(count); return p; };
  TemporalActs t{};
  if (saved) {
    t = temporal_saved(saved);
  } else {
    t.y = take(n * d);
    t.qkv = take(n * 3 * d);
    t.ctx = take(n * d);
    t.z = take(n * d);
    t.h1 = take(n * F);
  }
  t.u = take(n * d);
  t.out = out;
  Launcher k{static_cast<cudaStream_t>(stream), B * L, L, Dropout{seed, thresh, scale}, nullptr};
  temporal_layer_fwd(k, x, mask, {w_in, b_in, w_out, b_out, g1, be1, w1, b1, w2, b2, g2, be2}, t,
                     B, H, F);
  k.check();
  return (int)k.err;
}
