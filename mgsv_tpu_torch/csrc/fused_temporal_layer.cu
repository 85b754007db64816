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
// (L=96) and 41.6 GFLOP for the video tower (L=50), against some 100 MB of
// activations (x, out) and 150 MB more of this design's q/k/v and ctx
// scratch: several hundred FLOP per byte, so the arithmetic bounds it.  The
// GEMMs run on the tensor cores in 3xTF32 (tf32_tile.cuh: float32 accuracy),
// and the [L, L] weights and the [L, F] FFN hidden state never reach device
// memory.  Three kernels run back to back on the caller's stream:
//
//  (a) ln_qkv_kernel: LN1 of a 64-row tile in shared memory, then one
//      256-column part (q, k or v) of the packed projection, into a
//      [B*L, 3D] scratch buffer.
//  (b) attention_kernel (encoder_layer_kernels.cuh, as the DETR encoder
//      layer's): one block per (head, batch row) with the head's q, k, v in
//      shared memory; writes ctx [B, L, D].
//  (c) temporal_ffn_kernel: per 64 rows, LN1 again (cheaper than storing
//      y), out-projection + residual, LN2, the FFN in 256-wide slices of the
//      hidden dimension (each GELU slice, dropped out, kept in shared memory
//      and folded straight into the second GEMM's register accumulators),
//      dropout and the residual.
//
// Dropout is a template parameter of (b) and (c), so the rate-0 evaluation
// compiles the mask code out.

#include "temporal_layer.cuh"

namespace {

// (a) LN1, then [64 rows x 256 cols] of the packed projection.
__global__ void __launch_bounds__(kThreads, 1)
ln_qkv_kernel(const float* __restrict__ x, const float* __restrict__ g1,
              const float* __restrict__ be1, const float* __restrict__ w_in,
              const float* __restrict__ b_in, float* __restrict__ qkv, int rows) {
  extern __shared__ float4 smem4[];
  float* A = reinterpret_cast<float*>(smem4);   // [kRows][kLda]: y, then the output
  float* Ws = A + kTileFloats;                   // [2][kCols][kLdws]
  const int r0 = blockIdx.x * kRows, part = blockIdx.y;   // 0 q, 1 k, 2 v
  load_rows(A, x, nullptr, r0, rows);
  layer_norm_rows(A, g1, be1);
  Acc acc;
  zero(acc);
  gemm(acc, A, w_in, kCols, part * kCols, kCols, Ws);
  const float* bias = b_in + part * kCols;
  for_each_acc(acc, [&](int r, int c, float& v) { A[r * kLda + c] = v + bias[c]; });
  __syncthreads();
  store_rows(qkv, 3 * kCols, part * kCols, A, r0, rows);
}

// (c) One block per 64 rows: u = y + out-proj, z = LN2(u), the FFN in
// 256-wide slices, out = z + dropped FFN output.
template <bool kDrop>
__global__ void __launch_bounds__(kThreads, 1)
temporal_ffn_kernel(const float* __restrict__ x, const float* __restrict__ ctx,
                    const float* __restrict__ w_out, const float* __restrict__ b_out,
                    const float* __restrict__ g1, const float* __restrict__ be1,
                    const float* __restrict__ w1, const float* __restrict__ b1,
                    const float* __restrict__ w2, const float* __restrict__ b2,
                    const float* __restrict__ g2, const float* __restrict__ be2,
                    float* __restrict__ out, int rows, int L, int H, int F, Dropout drop) {
  extern __shared__ float4 smem4[];
  float* A = reinterpret_cast<float*>(smem4);  // ctx, then each GELU slice, then the output
  float* Y = A + kTileFloats;                   // y = LN1(x), then u, then z = LN2(u)
  float* Ws = Y + kTileFloats;                  // [2][kCols][kLdws]
  const int r0 = blockIdx.x * kRows;
  // mask value of (tile row r, site, element column c of a `width`-wide site)
  auto site_keep = [&](int r, int site, int width, int c) {
    if (!kDrop) return 1.f;
    const int gr = r0 + r;
    return keep(drop, gr / L, site, (gr % L) * width + c);
  };

  load_rows(Y, x, nullptr, r0, rows);
  layer_norm_rows(Y, g1, be1);
  load_rows(A, ctx, nullptr, r0, rows);
  Acc acc;
  zero(acc);
  gemm(acc, A, w_out, kCols, 0, kCols, Ws);
  for_each_acc(acc, [&](int r, int c, float& v) { Y[r * kLda + c] += v + b_out[c]; });
  __syncthreads();
  layer_norm_rows(Y, g2, be2);

  Acc acc2;
  zero(acc2);
  for (int f0 = 0; f0 < F; f0 += kCols) {
    zero(acc);
    gemm(acc, Y, w1, kCols, f0, kCols, Ws);
    for_each_acc(acc, [&](int r, int c, float& v) {
      A[r * kLda + c] = gelu(v + b1[f0 + c]) * site_keep(r, H, F, f0 + c);
    });
    __syncthreads();
    gemm(acc2, A, w2 + f0, F, 0, kCols, Ws);
  }
  for_each_acc(acc2, [&](int r, int c, float& v) {
    A[r * kLda + c] = (v + b2[c]) * site_keep(r, H + 1, kCols, c) + Y[r * kLda + c];
  });
  __syncthreads();
  store_rows(out, kCols, 0, A, r0, rows);
}

}  // namespace

// Once per device, before the first launch on it: lets each kernel take its
// dynamic shared memory (the attention kernel's for the longest L).
// Returns the first CUDA error (0 = ok).
extern "C" int mgsv_fused_temporal_layer_init() {
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(ln_qkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)kGemmSmem)) != cudaSuccess ||
      (err = attention_init(kTemporalMaxL)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(temporal_ffn_kernel<false>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)kFfnSmem)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(temporal_ffn_kernel<true>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)kFfnSmem)) != cudaSuccess)
    return (int)err;
  return 0;
}

// One temporal layer on `stream`, dropout (seed, thresh, scale) as in
// philox.cuh (thresh 0: none), after mgsv_fused_temporal_layer_init on that
// device.  qkv ([B, L, 3D]) and ctx ([B, L, D]) are scratch buffers, out the
// [B, L, D] result; every pointer 16-byte aligned.  Returns
// cudaGetLastError() (0 = ok).
extern "C" int mgsv_fused_temporal_layer_fwd(
    const float* x, const float* mask,
    const float* w_in, const float* b_in, const float* w_out, const float* b_out,
    const float* g1, const float* be1, const float* w1, const float* b1,
    const float* w2, const float* b2, const float* g2, const float* be2,
    float* qkv, float* ctx, float* out, int B, int L, int D, int H, int F,
    unsigned seed, unsigned thresh, float scale, void* stream) {
  if (!temporal_shape_ok(B, L, D, H, F)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout drop{seed, thresh, scale};
  const int rows = B * L, row_tiles = (rows + kRows - 1) / kRows;
  cudaError_t err;
  ln_qkv_kernel<<<dim3(row_tiles, 3), kThreads, kGemmSmem, s>>>(x, g1, be1, w_in, b_in, qkv,
                                                                 rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  launch_attention(qkv, mask, ctx, B, H, L, drop, s);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // rate 0 (evaluation) takes the instantiation without mask code
  auto* ffn = thresh != 0u ? temporal_ffn_kernel<true> : temporal_ffn_kernel<false>;
  ffn<<<row_tiles, kThreads, kFfnSmem, s>>>(x, ctx, w_out, b_out, g1, be1, w1, b1, w2, b2, g2,
                                            be2, out, rows, L, H, F, drop);
  return (int)cudaGetLastError();
}
