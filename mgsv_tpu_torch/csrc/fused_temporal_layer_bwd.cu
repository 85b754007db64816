// Backward of the fused temporal-tower layer, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// mgsv_tpu/ops/pallas/fused_temporal_layer.py::_bwd_pallas (kernel
// _bwd_kernel): from the layer's inputs, the dropout seed and the output
// cotangent g, it recomputes the forward (fused_temporal_layer.cu's launch
// sequence, layer_bwd_kernels.cuh::temporal_layer_fwd) and
// returns dx and all 12 parameter gradients.  The three dropout masks are
// drawn again from philox.cuh at each use site with the forward's (seed,
// batch row, site), never stored; the GELU's derivative Phi(a) + a phi(a)
// is taken at the stored pre-activation a = z W1^T + b1.
//
// What bounds it on the card: at B=512, D=256, F=1024 the backward is about
// twice the forward's 82.1 GFLOP (audio, L=96) and 41.6 GFLOP (video, L=50)
// of float32 work, run on the tensor cores in 3xTF32, plus the recompute;
// the per-row activations it keeps in device memory (q/k/v, ctx, y, z, the
// [B*L, F] pre-activation and dropped GELU output, LayerNorm statistics and
// their cotangents, about 1.5 GB at L=96) add a few GB of traffic, well
// under the arithmetic's time.  So the arithmetic bounds it.  It runs the
// launches of layer_bwd_kernels.cuh, as the DETR encoder layer's backward
// does: every product on the wgmma core (wgmma_gemm.cuh, 3xTF32), the
// [B, H, L, L] attention weights rebuilt per (head, batch row) on the
// tensor cores, and every weight gradient a split-K product over 1024-row
// slices whose partials are summed in slice order, so a step repeats bit
// for bit (no float atomics).
//
// With the forward's names (y = LN1(x), u = y + o, z = LN2(u), a = z W1^T +
// b1, h = drop_H(gelu(a)), out = z + drop_H+1(h W2^T + b2)):
//
//   dh2 = drop_H+1(g);  db2, dW2 = sums of dh2, dh2^T h
//   da  = drop_H(dh2 W2) gelu'(a);  db1, dW1 = sums of da, da^T z
//   dz  = g + da W1;  du = LN2'(dz);  dg2, dbe2 from dz
//   dbo, dWo = sums of du, du^T ctx;  dctx = du Wo
//   dqkv = attention backward of dctx;  db_in, dW_in = sums of dqkv, dqkv^T y
//   dy  = du + dqkv W_in;  dx = LN1'(dy);  dg1, dbe1 from dy

#include "layer_bwd_kernels.cuh"

// Floats of device workspace mgsv_fused_temporal_layer_bwd needs at B*L rows
// and FFN width F (D = 256).
extern "C" size_t mgsv_fused_temporal_layer_bwd_workspace(int rows, int F) {
  const size_t n = (size_t)rows, d = kCols, z = (n + kChunk - 1) / kChunk;
  const size_t partial = std::max<size_t>({(size_t)F * d, 3 * d * d});
  return 2 * align4(n * 3 * d) + 11 * align4(n * d) + 2 * align4(n) + 3 * align4(n * F) +
         align4(z * partial) +
         align4(2 * (kCols / kHeadDim) * n);   // the attention rows' softmax statistics
}

// Once per device, before the first launch on it: dynamic shared memory.
extern "C" int mgsv_fused_temporal_layer_bwd_init() {
  return (int)layer_bwd_init(kTemporalMaxL);
}

// Backward of one temporal layer on `stream`: recomputes the forward from
// x, mask and the dropout (seed, thresh, scale), then writes dx ([B, L, D])
// and the parameter gradients, in the layout of the weights (torch
// [out, in]).  ws: mgsv_fused_temporal_layer_bwd_workspace floats.  Every
// pointer 16-byte aligned.  Returns the first CUDA error (0 = ok).
extern "C" int mgsv_fused_temporal_layer_bwd(
    const float* x, const float* mask, const float* g_out,
    const float* w_in, const float* b_in, const float* w_out, const float* b_out,
    const float* g1, const float* be1, const float* w1, const float* b1,
    const float* w2, const float* b2, const float* g2, const float* be2,
    float* dx, float* dw_in, float* db_in, float* dw_out, float* db_out,
    float* dg1, float* dbe1, float* dw1, float* db1, float* dw2, float* db2,
    float* dg2, float* dbe2, float* ws, int B, int L, int D, int H, int F,
    unsigned seed, unsigned thresh, float scale, void* stream) {
  if (!temporal_shape_ok(B, L, D, H, F)) return (int)cudaErrorInvalidValue;
  const int rows = B * L;
  const size_t n = (size_t)rows, d = kCols;
  float* cur = ws;
  auto take = [&](size_t count) { float* p = cur; cur += align4(count); return p; };
  float* qkv = take(n * 3 * d);
  float* dqkv = take(n * 3 * d);
  float *y = take(n * d), *xh1 = take(n * d), *ctx = take(n * d), *u = take(n * d),
        *z = take(n * d), *xh2 = take(n * d), *dh2 = take(n * d), *dz = take(n * d),
        *du = take(n * d), *dctx = take(n * d), *dy = take(n * d);
  float* inv1 = take(n);
  float* inv2 = take(n);
  float2* stats = reinterpret_cast<float2*>(take(2 * (size_t)H * n));
  float* a1 = take(n * F);
  float* h1 = take(n * F);
  float* da1 = take(n * F);
  Launcher k{static_cast<cudaStream_t>(stream), rows, L, Dropout{seed, thresh, scale}, cur};

  // ---- recompute the forward (#5's sequence, keeping a1 and the statistics)
  temporal_layer_fwd(k, x, mask, {w_in, b_in, w_out, b_out, g1, be1, w1, b1, w2, b2, g2, be2},
                     {y, qkv, ctx, u, z, h1, xh1, inv1, xh2, inv2, a1, nullptr, stats}, B, H, F);

  // ---- the FFN
  k.dropout(g_out, dh2, D, H + 1);
  k.colsum(dh2, D, D, db2);
  k.wgrad(dh2, D, D, h1, F, F, dw2);
  k.rowgemm({dh2, D, D, w2, F, 1, nullptr, 0, H, F, a1, F, nullptr, 0, da1, F,
             /*gelu_gate=*/1}, F);
  k.colsum(da1, F, F, db1);
  k.wgrad(da1, F, F, z, D, D, dw1);
  k.rowgemm({da1, F, F, w1, D, 1, nullptr, 0, -1, D, nullptr, 0, g_out, D, dz, D}, D);

  // ---- LN2 and the attention output projection
  k.ln_bwd_sums(dz, xh2, inv2, g2, du, dg2, dbe2);
  k.colsum(du, D, D, db_out);
  k.wgrad(du, D, D, ctx, D, D, dw_out);
  k.rowgemm({du, D, D, w_out, D, 1, nullptr, 0, -1, D, nullptr, 0, nullptr, 0, dctx, D}, D);

  // ---- attention, the input projection and LN1
  k.attention_bwd(qkv, dctx, mask, dqkv, B, H, L, ctx, stats);
  k.colsum(dqkv, 3 * D, 3 * D, db_in);
  k.wgrad(dqkv, 3 * D, 3 * D, y, D, D, dw_in);
  k.rowgemm({dqkv, 3 * D, 3 * D, w_in, D, 1, nullptr, 0, -1, D, nullptr, 0, du, D, dy, D}, D);
  k.ln_bwd_sums(dy, xh1, inv1, g1, dx, dg1, dbe1);
  k.check();
  return (int)k.err;
}
