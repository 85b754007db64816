// Pieces of the temporal-tower layer shared by fused_temporal_layer.cu (the
// forward) and the backward launches (layer_bwd_kernels.cuh,
// fused_temporal_layer_bwd.cu): the exact (erf) GELU and its derivative,
// and the shapes the kernels take.
#pragma once

#include "encoder_layer_kernels.cuh"

namespace {

// The longer of the towers' sinusoidal tables (audio 300, video 250): no
// tower input is longer.  The attention shared memory of the forward (464 L
// bytes) and of the backward (608 L bytes) stays under 227 KB up to it.
constexpr int kTemporalMaxL = 300;

constexpr float kInvSqrt2 = 0.70710678118654752f;
constexpr float kInvSqrt2Pi = 0.39894228040143268f;

// gelu(a) = a Phi(a), torch's nn.GELU() (approximate='none').
__device__ __forceinline__ float gelu(float a) {
  return 0.5f * a * (1.f + erff(a * kInvSqrt2));
}

// d gelu / da = Phi(a) + a phi(a).
__device__ __forceinline__ float gelu_grad(float a) {
  return 0.5f * (1.f + erff(a * kInvSqrt2)) + a * kInvSqrt2Pi * expf(-0.5f * a * a);
}

// The shapes both kernels take (the wrapper's check_supported): D = 256 in
// heads of 32, F a multiple of 256, 1 <= L <= kTemporalMaxL, B <= kMaxB.
inline bool temporal_shape_ok(int B, int L, int D, int H, int F) {
  return B >= 1 && B <= kMaxB && L >= 1 && L <= kTemporalMaxL && D == kCols &&
         H * kHeadDim == D && F >= kCols && F % kCols == 0;
}

}  // namespace
