// Backward of the fused temporal-tower layer, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// mgsv_tpu/ops/pallas/fused_temporal_layer.py::_bwd_pallas (kernel
// _bwd_kernel): from the layer's inputs, the dropout seed, the output
// cotangent g and the forward's activations it returns dx and all 12
// parameter gradients.  The TPU kernel recomputes the forward, since a
// TPU core's VMEM is small; here the training forward
// (fused_temporal_layer.cu given `saved`) keeps its activations in device
// memory (the TemporalSaved set of layer_bwd_kernels.cuh: 4,114 floats a
// row, 0.81 GB for the audio tower at B=512), and the backward recomputes
// only when it is not given them, running the forward's own launch
// sequence (temporal_layer_fwd), so both give the same bits.  The three
// dropout masks are drawn again from philox.cuh at each use site with the
// forward's (seed, batch row, site), never stored; the GELU's derivative
// Phi(a) + a phi(a) is taken at the saved pre-activation a = z W1^T + b1.
//
// What bounds it on the card: at B=512, D=256, F=1024 the backward is
// twice the forward's 82.1 GFLOP (audio, L=96) and 41.6 GFLOP (video,
// L=50) of float32 work, run on the tensor cores in 3xTF32 (0.33 ms of
// TF32 products at L=96); reading the saved activations and writing and
// reading the gradients' own rows moves about 2 GB more (0.6 ms at the
// memory's rate).  It runs 18 launches (with the recompute 24): the
// output's dropout, every product on the wgmma core (wgmma_gemm.cuh,
// 3xTF32), each weight gradient a split-K product over 1024-row slices
// that also sums its bias gradient's column (PartialSumEpi), the partials
// summed in slice order, so a step repeats bit for bit (no float atomics);
// both LayerNorms' backwards; and the attention backward on wgmma
// (attention_bwd_wg.cuh) up to kWgaMaxL, beyond it on mma.sync
// (attention_bwd_tc_kernel).

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
#include "attention_bwd_wg.cuh"

// Floats of device workspace mgsv_fused_temporal_layer_bwd needs at B*L rows
// and FFN width F (D = 256), given the forward's saved set (saved 1) or
// recomputing it (saved 0).
extern "C" size_t mgsv_fused_temporal_layer_bwd_workspace(int rows, int F, int saved) {
  const size_t n = (size_t)rows, d = kCols, f = (size_t)F, z = (n + kChunk - 1) / kChunk;
  const size_t partial = z * std::max<size_t>(f * d + 2 * f, 3 * d * d + 6 * d);
  size_t floats = align4(n * 3 * d) + 5 * align4(n * d) + align4(n * f) + align4(partial);
  if (!saved)        // y, qkv, ctx, u, z, xh1, xh2, 1 / std twice, a1, h1, the statistics
    floats += align4(n * 3 * d) + 6 * align4(n * d) + 2 * align4(n) + 2 * align4(n * f) +
              align4(2 * (kCols / kHeadDim) * n);
  return floats;
}

// Once per device, before the first launch on it: dynamic shared memory.
extern "C" int mgsv_fused_temporal_layer_bwd_init() {
  cudaError_t err = layer_bwd_init(kTemporalMaxL);
  if (err == cudaSuccess) err = attention_bwd_wg_init();
  return (int)err;
}

// Backward of one temporal layer on `stream`: from x, mask, the dropout
// (seed, thresh, scale) and `saved` (the TemporalSaved pointers of
// mgsv_fused_temporal_layer_fwd on the same inputs and dropout) or, with
// saved null, by recomputing them: the same bits either way.  Writes dx
// ([B, L, D]) and the parameter gradients, in the layout of the weights
// (torch [out, in]).  ws: mgsv_fused_temporal_layer_bwd_workspace floats.
// Every pointer 16-byte aligned.  Returns the first CUDA error (0 = ok).
extern "C" int mgsv_fused_temporal_layer_bwd(
    const float* x, const float* mask, const float* g_out,
    const float* w_in, const float* b_in, const float* w_out, const float* b_out,
    const float* g1, const float* be1, const float* w1, const float* b1,
    const float* w2, const float* b2, const float* g2, const float* be2,
    float* dx, float* dw_in, float* db_in, float* dw_out, float* db_out,
    float* dg1, float* dbe1, float* dw1, float* db1, float* dw2, float* db2,
    float* dg2, float* dbe2, float* const* saved, float* ws, int B, int L, int D, int H, int F,
    const unsigned* seed, unsigned thresh, float scale, void* stream) {
  if (!temporal_shape_ok(B, L, D, H, F)) return (int)cudaErrorInvalidValue;
  const int rows = B * L;
  const size_t n = (size_t)rows, d = kCols;
  float* cur = ws;
  auto take = [&](size_t count) { float* p = cur; cur += align4(count); return p; };
  TemporalActs t{};
  if (saved) {
    t = temporal_saved(saved);
  } else {
    t.y = take(n * d);
    t.qkv = take(n * 3 * d);
    t.ctx = take(n * d);
    t.u = take(n * d);
    t.z = take(n * d);
    t.xh1 = take(n * d);
    t.xh2 = take(n * d);
    t.inv1 = take(n);
    t.inv2 = take(n);
    t.a1 = take(n * F);
    t.h1 = take(n * F);
    t.stats = reinterpret_cast<float2*>(take(2 * (size_t)H * n));
  }
  float* dqkv = take(n * 3 * d);
  float *dh2 = take(n * d), *dz = take(n * d), *du = take(n * d), *dctx = take(n * d),
        *dy = take(n * d);
  float* da1 = take(n * F);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Launcher k{s, rows, L, Dropout{seed, thresh, scale}, cur};

  // ---- without the saved set, the forward's sequence again (#5's)
  if (!saved)
    temporal_layer_fwd(k, x, mask, {w_in, b_in, w_out, b_out, g1, be1, w1, b1, w2, b2, g2, be2},
                       t, B, H, F);

  // ---- the FFN
  k.dropout(g_out, dh2, D, H + 1);
  k.rowgemm({dh2, D, D, w2, F, 1, nullptr, 0, H, F, t.a1, F, nullptr, 0, da1, F,
             /*gelu_gate=*/1},
            F);
  k.wgrad(dh2, D, D, t.h1, F, F, dw2, db2);
  k.wgrad(da1, F, F, t.z, D, D, dw1, db1);
  k.rowgemm({da1, F, F, w1, D, 1, nullptr, 0, -1, D, nullptr, 0, g_out, D, dz, D}, D);

  // ---- LN2 and the attention output projection
  k.ln_bwd_sums(dz, t.xh2, t.inv2, g2, du, dg2, dbe2);
  k.wgrad(du, D, D, t.ctx, D, D, dw_out, db_out);
  k.rowgemm({du, D, D, w_out, D, 1, nullptr, 0, -1, D, nullptr, 0, nullptr, 0, dctx, D}, D);

  // ---- attention (wgmma up to kWgaMaxL, else mma.sync), the input
  // projection and LN1
  if (L <= kWgaMaxL) {
    if (k.check())
      k.keep_err(launch_attention_bwd_wg(t.qkv, dctx, mask, t.ctx, t.stats, dqkv, B, H, L,
                                         k.drop, s));
  } else {
    k.attention_bwd(t.qkv, dctx, mask, dqkv, B, H, L, t.ctx, t.stats);
  }
  k.wgrad(dqkv, 3 * D, 3 * D, t.y, D, D, dw_in, db_in);
  k.rowgemm({dqkv, 3 * D, 3 * D, w_in, D, 1, nullptr, 0, -1, D, nullptr, 0, du, D, dy, D}, D);
  k.ln_bwd_sums(dy, t.xh1, t.inv1, g1, dx, dg1, dbe1);
  k.check();
  return (int)k.err;
}
