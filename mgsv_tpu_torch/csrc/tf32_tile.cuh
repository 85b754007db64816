// Shared 3xTF32 tensor-core tile machinery of the port's kernels (sm_90a).
//
// A block of 256 threads computes a [kRows = 64] x [kCols = 256] float32
// tile on the tensor cores (mma.sync m16n8k8 tf32, each operand split into
// two tf32 halves, three products per tile: float32 accuracy).  The "A"
// operand is a [64][K] tile in shared memory, K-minor; the "W" operand, the
// rows W[n][k] of a torch [N][K] weight (rows n >= nvalid read as zero), is
// staged K-slice by K-slice ([256][kKc]) from device memory with cp.async,
// double-buffered, so every copy moves 16 contiguous bytes (gemm).
//
// pack_bf16 and mma_bf16 (bf16 operands, float32 sums: the JAX kernels'
// precision="bf16") serve the tensor-core attention of
// layer_bwd_kernels.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;             // rows per block tile
constexpr int kCols = 256;            // output columns per GEMM pass
constexpr int kKc = 32;               // reduction depth per staged tile
constexpr int kLda = kCols + 4;       // activation tile row stride: 16 B rows, 4 mod 32 banks
constexpr int kLdws = kKc + 4;        // staged tile [kCols][kLdws], same two properties
constexpr int kWsFloats = kCols * kLdws;
constexpr int kTileFloats = kRows * kLda;
constexpr float kBigNeg = -1e9f;
constexpr float kLnEps = 1e-5f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Stage W[n0 + n][k0 .. k0 + kKc) (n < kCols; torch [N][K] layout, row
// stride ldw) into Ws[n][0 .. kKc), 16 bytes per copy: each row is one
// 128-byte global read.  Rows n0 + n >= nvalid are written as zeros.
__device__ __forceinline__ void stage_w(float* Ws, const float* __restrict__ W,
                                        int ldw, int n0, int k0, int nvalid = 1 << 30) {
  for (int e = threadIdx.x; e < kCols * kKc / 4; e += kThreads) {
    const int n = e / (kKc / 4), q = e % (kKc / 4);
    float* dst = Ws + n * kLdws + 4 * q;
    if (n0 + n < nvalid)
      cp_async16(dst, W + (size_t)(n0 + n) * ldw + k0 + 4 * q);
    else
      *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  cp_async_commit();
}

// 3xTF32: x = big + small with both halves exact in tf32, and
// a.b ~ a_small.b_big + a_big.b_small + a_big.b_big keeps float32 accuracy
// (the dropped small.small term is ~2^-22 relative) on the tensor cores.
__device__ __forceinline__ void split_tf32(float x, unsigned& big, unsigned& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
  const float rest = x - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(rest));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&p);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The block's [kRows x kCols] output is split over the 8 warps as 2 x 4
// warp tiles of 32 rows x 64 columns, each 2 x 8 m16n8 accumulator tiles.
using Acc = float[2][8][4];

// acc += A[.. x kKc] . Ws[.. x kKc]^T for this warp's tile.  A is row-major
// (element (row, k) at A[row * kLda + k]); Ws is [kCols][kLdws] K-minor.
// With g = lane / 4, t = lane % 4, fragment reads hit banks 4 g + t (row
// strides 4 mod 32): conflict-free.  The tensor cores add in float32 but
// truncate to the running sum's exponent, so the tile's products are summed
// from zero (small cross terms first) and only then added to acc with an
// ordinary rounded add.
__device__ __forceinline__ void mma_tile(Acc& acc, const float* A, const float* Ws) {
  constexpr int kSteps = kKc / 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = 32 * (warp & 1) + g, col0 = 64 * (warp >> 1) + g;
  auto a_at = [&](int row, int k) { return A[row * kLda + k]; };
  auto w_at = [&](int k, int n) { return Ws[n * kLdws + k]; };
  unsigned ab[2][kSteps][4], as[2][kSteps][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const int r = row0 + 16 * mi, k = 8 * s + t;
      split_tf32(a_at(r, k), ab[mi][s][0], as[mi][s][0]);            // row g,     k t
      split_tf32(a_at(r + 8, k), ab[mi][s][1], as[mi][s][1]);        // row g + 8, k t
      split_tf32(a_at(r, k + 4), ab[mi][s][2], as[mi][s][2]);        // row g,     k t + 4
      split_tf32(a_at(r + 8, k + 4), ab[mi][s][3], as[mi][s][3]);    // row g + 8, k t + 4
    }
#pragma unroll
  for (int ni = 0; ni < 8; ++ni) {
    unsigned bb[kSteps][2], bs[kSteps][2];
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const int n = col0 + 8 * ni, k = 8 * s + t;
      split_tf32(w_at(k, n), bb[s][0], bs[s][0]);                    // k t,     column g
      split_tf32(w_at(k + 4, n), bb[s][1], bs[s][1]);                // k t + 4, column g
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        mma_tf32(part, as[mi][s], bb[s][0], bb[s][1]);
        mma_tf32(part, ab[mi][s], bs[s][0], bs[s][1]);
      }
#pragma unroll
      for (int s = 0; s < kSteps; ++s) mma_tf32(part, ab[mi][s], bb[s][0], bb[s][1]);
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] += part[r];
    }
  }
}

// f(row, col, value) for each accumulator of this thread (row < kRows,
// col < kCols), in the m16n8 C-fragment layout.
template <class F>
__device__ __forceinline__ void for_each_acc(Acc& acc, F f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        f(32 * (warp & 1) + 16 * mi + g + 8 * (r >> 1),
          64 * (warp >> 1) + 8 * ni + 2 * t + (r & 1), acc[mi][ni][r]);
}

__device__ __forceinline__ void zero(Acc& acc) {
  for_each_acc(acc, [](int, int, float& v) { v = 0.f; });
}

// acc += A[kRows x K] (shared, row stride kLda) . W[n0 .. n0+kCols)[0 .. K)^T
// (torch [N][K] weight, row stride ldw; rows n >= nvalid read as zero), W
// staged K-slice by K-slice into one of Ws's two buffers: the next slice
// loads while this one computes.  Expects A written and the block
// synchronized; returns synchronized.  K is a multiple of kKc.
__device__ void gemm(Acc& acc, const float* A, const float* __restrict__ W,
                     int ldw, int n0, int K, float* Ws, int nvalid = 1 << 30) {
  const int nk = K / kKc;
  stage_w(Ws, W, ldw, n0, 0, nvalid);
  cp_async_wait_all();
  __syncthreads();
  for (int c = 0; c < nk; ++c) {
    if (c + 1 < nk) stage_w(Ws + ((c + 1) & 1) * kWsFloats, W, ldw, n0, (c + 1) * kKc, nvalid);
    mma_tile(acc, A + c * kKc, Ws + (c & 1) * kWsFloats);
    cp_async_wait_all();
    __syncthreads();
  }
}

// In-place LayerNorm over each row of a [kRows][kLda] tile (kCols values).
__device__ void layer_norm_rows(float* a, const float* __restrict__ g,
                                const float* __restrict__ beta) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < kRows; r += kWarps) {
    float* row = a + r * kLda;
    float v[kCols / 32];
    float s = 0.f;
#pragma unroll
    for (int t = 0; t < kCols / 32; ++t) {
      v[t] = row[lane + 32 * t];
      s += v[t];
    }
    const float mean = warp_sum(s) / kCols;
    float q = 0.f;
#pragma unroll
    for (int t = 0; t < kCols / 32; ++t) {
      const float d = v[t] - mean;
      q = fmaf(d, d, q);
    }
    const float inv = rsqrtf(warp_sum(q) / kCols + kLnEps);
#pragma unroll
    for (int t = 0; t < kCols / 32; ++t) {
      const int c = lane + 32 * t;
      row[c] = (v[t] - mean) * inv * g[c] + beta[c];
    }
  }
  __syncthreads();
}

// Load rows [r0, r0 + kRows) of a [rows][ld] tensor (kCols columns from
// column 0) into a [kRows][kLda] tile, adding `add` (same layout, when
// given) and zero-filling rows past the end.
__device__ void load_rows(float* A, const float* __restrict__ src,
                          const float* __restrict__ add, int r0, int rows, int ld = kCols) {
  for (int e = threadIdx.x; e < kRows * kCols / 4; e += kThreads) {
    const int r = e / (kCols / 4), c4 = e % (kCols / 4), gr = r0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gr < rows) {
      v = reinterpret_cast<const float4*>(src + (size_t)gr * ld)[c4];
      if (add != nullptr) {
        const float4 p = reinterpret_cast<const float4*>(add + (size_t)gr * ld)[c4];
        v.x += p.x; v.y += p.y; v.z += p.z; v.w += p.w;
      }
    }
    *reinterpret_cast<float4*>(A + r * kLda + 4 * c4) = v;
  }
  __syncthreads();
}

// Write rows [r0, r0 + kRows) of a [kRows][kLda] tile to a [rows][ld]
// tensor at column offset c0, 16 bytes per store, skipping rows past the end.
__device__ void store_rows(float* dst, int ld, int c0, const float* A, int r0, int rows) {
  for (int e = threadIdx.x; e < kRows * kCols / 4; e += kThreads) {
    const int r = e / (kCols / 4), c4 = e % (kCols / 4), gr = r0 + r;
    if (gr < rows)
      *reinterpret_cast<float4*>(dst + (size_t)gr * ld + c0 + 4 * c4) =
          *reinterpret_cast<const float4*>(A + r * kLda + 4 * c4);
  }
}

}  // namespace
