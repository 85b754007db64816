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
// What bounds it on the card: at B=256, L=152, D=256, F=1024 one layer is
// about 67 GFLOP of float32 work, most of it the FFN, against about 160 MB
// of activation traffic (x, pos, ctx, out) and 240 MB more for this
// design's q/k/v scratch: some 170 FLOP per byte, well above the float32
// ridge point, so the arithmetic rate bounds it.  The
// GEMMs therefore run on the tensor cores in 3xTF32 (each operand split
// into two tf32 halves, three mma.sync products per tile), which keeps
// float32 accuracy where plain tf32 would lose three decimal digits, and
// the design keeps the [L, L] scores and the [L, F] FFN hidden state
// out of device memory.  Three kernels run back to back on the caller's
// stream:
//
//  (a) qkv_kernel: [64 rows x 256 cols] tiles of the packed projection over
//      the flattened B*L rows, x+pos for q and k, x for v, into a [B*L, 3D]
//      scratch buffer.
//  (b) attention_kernel: one block per (head, batch row).  The head's q, k,
//      v ([L, 32] each) sit in shared memory; each warp takes two query rows
//      at a time, their scores one key per lane, and writes ctx [B, L, D].
//  (c) ffn_kernel: one block per 64 rows.  Out-proj, dropout, residual and
//      LN1; the FFN in four 256-wide slices of the hidden dimension, each
//      (dropped) ReLU slice kept in shared memory and folded straight into
//      the second GEMM's register accumulators; dropout, residual and LN2.
//
// With bf16 set (the JAX kernel's precision="bf16", which the model takes
// under a bf16 compute dtype) every product takes bf16 operands with float32
// sums: the GEMM tiles on mma.sync m16n8k16 (operands rounded as they are
// read from shared memory), the attention's q k^T and p v on the CUDA cores
// from operands rounded to bf16.  Inputs, outputs, LayerNorm, softmax and
// the dropout masks stay float32, as in JAX.  At that precision the bound
// is the bf16 tensor-core rate, twice TF32's, and the GEMMs do one product
// per tile in place of three.
//
// Weights stream from L2 through double-buffered shared-memory tiles filled
// with cp.async.  wgmma, TMA and a single fused launch are later work.  The
// launches live in encoder_layer_kernels.cuh, the tile machinery in
// tf32_tile.cuh.

#include "encoder_layer_kernels.cuh"

// Once per device, before the first launch on it: lets each kernel take its
// dynamic shared memory (the attention kernel's for the longest L it takes).
// Returns the first CUDA error (0 = ok).
extern "C" int mgsv_fused_encoder_layer_init() {
  cudaError_t err;
  if ((err = gemm_launches_init()) != cudaSuccess || (err = attention_init()) != cudaSuccess)
    return (int)err;
  return 0;
}

// One post-norm encoder layer on `stream`, dropout (seed, thresh, scale) as
// in philox.cuh (thresh 0: none), after mgsv_fused_encoder_layer_init
// on that device.  qkv ([B, L, 3D]) and ctx ([B, L, D]) are scratch
// buffers, out the [B, L, D] result; every pointer 16-byte aligned.  The
// shapes must be ones the Python wrapper accepts (its check_supported).
// bf16 != 0: bf16 operands, float32 sums.  Returns cudaGetLastError() (0 = ok).
extern "C" int mgsv_fused_encoder_layer_fwd(
    const float* x, const float* pos, const float* mask,
    const float* w_in, const float* b_in, const float* w_out, const float* b_out,
    const float* g1, const float* be1, const float* w1, const float* b1,
    const float* w2, const float* b2, const float* g2, const float* be2,
    float* qkv, float* ctx, float* out, int B, int L, int D, int H, int F,
    unsigned seed, unsigned thresh, float scale, int bf16, void* stream) {
  if (B < 1 || B > kMaxB || L < 1 || L > kMaxL || D != kCols || H * kHeadDim != D ||
      F < kCols || F % kCols != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout drop{seed, thresh, scale};
  const int rows = B * L, row_tiles = (rows + kRows - 1) / kRows;
  cudaError_t err;
  auto* qkv_k = bf16 ? qkv_kernel<true> : qkv_kernel<false>;
  qkv_k<<<dim3(row_tiles, 3), kThreads, kGemmSmem, s>>>(x, pos, w_in, b_in, qkv, rows, 2,
                                                        3 * kCols);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  launch_attention(qkv, mask, ctx, B, H, L, drop, s, bf16 != 0);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // rate 0 (the serving path) takes the instantiation without mask code
  auto* ffn = thresh != 0u ? (bf16 ? ffn_kernel<true, true> : ffn_kernel<true, false>)
                           : (bf16 ? ffn_kernel<false, true> : ffn_kernel<false, false>);
  ffn<<<row_tiles, kThreads, kFfnSmem, s>>>(x, ctx, w_out, b_out, g1, be1, w1, b1, w2, b2, g2,
                                            be2, out, rows, L, H, F, drop);
  return (int)cudaGetLastError();
}
