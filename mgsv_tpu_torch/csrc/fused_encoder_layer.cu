// Fused post-norm DETR encoder layer, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// mgsv_tpu/ops/pallas/fused_encoder_layer.py::fused_encoder_layer
// (kernel _fused_layer_kernel) at dropout rate 0, the serving path's
// deterministic forward.  Per batch row it computes
//
//   q, k = (x + pos) Wq^T + bq, (x + pos) Wk^T + bk;  v = x Wv^T + bv
//   ctx  = softmax_keys(q k^T / sqrt(dh), masked keys -> -1e9) v   per head
//   y1   = LN1(x + ctx Wo^T + bo)
//   out  = LN2(y1 + relu(y1 W1^T + b1) W2^T + b2)
//
// with every weight in torch's [out, in] layout (in_proj_weight rows q|k|v).
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
//  (c) ffn_kernel: one block per 64 rows.  Out-proj, residual and LN1; the
//      FFN in four 256-wide slices of the hidden dimension, each ReLU slice
//      kept in shared memory and folded straight into the second GEMM's
//      register accumulators; residual and LN2.
//
// Weights stream from L2 through double-buffered shared-memory tiles filled
// with cp.async.  wgmma, TMA and a single fused launch are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHeadDim = 32;          // one lane per head channel
constexpr int kPad = kHeadDim + 1;    // padded [L][kPad] rows: conflict-free columns
constexpr int kRows = 64;             // rows per GEMM block tile
constexpr int kCols = 256;            // output columns per GEMM pass = D
constexpr int kKc = 32;               // reduction depth per staged weight tile
constexpr int kLda = kCols + 4;       // activation tile row stride: 16 B rows, 4 mod 32 banks
constexpr int kLdws = kKc + 4;        // staged weight tile [kCols][kLdws], same two properties
constexpr int kWsFloats = kCols * kLdws;
constexpr int kMaxL = 256;            // longest sequence (attention shared memory: 116 KB)
constexpr int kMaxB = 65535;          // batch rows: grid y of the attention launch
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
// 128-byte global read.
__device__ __forceinline__ void stage_w(float* Ws, const float* __restrict__ W,
                                        int ldw, int n0, int k0) {
#pragma unroll
  for (int e = threadIdx.x; e < kCols * kKc / 4; e += kThreads) {
    const int n = e / (kKc / 4), q = e % (kKc / 4);
    cp_async16(Ws + n * kLdws + 4 * q, W + (size_t)(n0 + n) * ldw + k0 + 4 * q);
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

// The block's [kRows x kCols] output is split over the 8 warps as 2 x 4
// warp tiles of 32 rows x 64 columns, each 2 x 8 m16n8 accumulator tiles.
using Acc = float[2][8][4];

// acc += A[.. x kKc] . Ws[.. x kKc]^T for this warp's tile.  Fragment
// reads hit banks 4 g + t (g = lane / 4, t = lane % 4): conflict-free,
// because both row strides are 4 mod 32.  The tensor cores add in float32
// but truncate to the running sum's exponent, so the tile's products are
// summed from zero (small cross terms first) and only then added to acc
// with an ordinary rounded add: 12 truncating steps on a tile-sized sum
// instead of 3 K / 8 on the whole dot product.
__device__ __forceinline__ void mma_tile(Acc& acc, const float* A, const float* Ws) {
  constexpr int kSteps = kKc / 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const float* a_base = A + (32 * (warp & 1) + g) * kLda + t;
  const float* w_base = Ws + (64 * (warp >> 1) + g) * kLdws + t;
  unsigned ab[2][kSteps][4], as[2][kSteps][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const float* p = a_base + 16 * mi * kLda + 8 * s;
      split_tf32(p[0], ab[mi][s][0], as[mi][s][0]);              // row g,     k t
      split_tf32(p[8 * kLda], ab[mi][s][1], as[mi][s][1]);       // row g + 8, k t
      split_tf32(p[4], ab[mi][s][2], as[mi][s][2]);              // row g,     k t + 4
      split_tf32(p[8 * kLda + 4], ab[mi][s][3], as[mi][s][3]);   // row g + 8, k t + 4
    }
#pragma unroll
  for (int ni = 0; ni < 8; ++ni) {
    unsigned bb[kSteps][2], bs[kSteps][2];
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const float* q = w_base + 8 * ni * kLdws + 8 * s;
      split_tf32(q[0], bb[s][0], bs[s][0]);                      // k t,     column g
      split_tf32(q[4], bb[s][1], bs[s][1]);                      // k t + 4, column g
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

// acc += A[kRows x K] (shared, row stride kLda) . W[n0 .. n0+kCols)[0 .. K)^T.
// Expects A written and the block synchronized; returns synchronized.
// Ws holds two staged tiles: the next one loads while this one computes.
__device__ void gemm(Acc& acc, const float* A, const float* __restrict__ W,
                     int ldw, int n0, int K, float* Ws) {
  const int nk = K / kKc;
  stage_w(Ws, W, ldw, n0, 0);
  cp_async_wait_all();
  __syncthreads();
  for (int c = 0; c < nk; ++c) {
    if (c + 1 < nk) stage_w(Ws + ((c + 1) & 1) * kWsFloats, W, ldw, n0, (c + 1) * kKc);
    mma_tile(acc, A + c * kKc, Ws + (c & 1) * kWsFloats);
    cp_async_wait_all();
    __syncthreads();
  }
}

__device__ __forceinline__ void zero(Acc& acc) {
  for_each_acc(acc, [](int, int, float& v) { v = 0.f; });
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

// Load rows [r0, r0 + kRows) of a [rows][kCols] tensor into a [kRows][kLda]
// tile, adding `add` (when given) and zero-filling rows past the end.
__device__ void load_rows(float* A, const float* __restrict__ src,
                          const float* __restrict__ add, int r0, int rows) {
  for (int e = threadIdx.x; e < kRows * kCols / 4; e += kThreads) {
    const int r = e / (kCols / 4), c4 = e % (kCols / 4), gr = r0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gr < rows) {
      v = reinterpret_cast<const float4*>(src + (size_t)gr * kCols)[c4];
      if (add != nullptr) {
        const float4 p = reinterpret_cast<const float4*>(add + (size_t)gr * kCols)[c4];
        v.x += p.x; v.y += p.y; v.z += p.z; v.w += p.w;
      }
    }
    *reinterpret_cast<float4*>(A + r * kLda + 4 * c4) = v;
  }
  __syncthreads();
}

constexpr size_t kGemmSmem = sizeof(float) * (size_t)(kRows * kLda + 2 * kWsFloats);
constexpr size_t kFfnSmem = sizeof(float) * (size_t)(2 * kRows * kLda + 2 * kWsFloats);

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

__global__ void __launch_bounds__(kThreads, 1)
qkv_kernel(const float* __restrict__ x, const float* __restrict__ pos,
           const float* __restrict__ w_in, const float* __restrict__ b_in,
           float* __restrict__ qkv, int rows) {
  extern __shared__ float4 smem4[];
  float* A = reinterpret_cast<float*>(smem4);   // [kRows][kLda]: input, then output
  float* Ws = A + kRows * kLda;                  // [2][kCols][kLdws]
  const int r0 = blockIdx.x * kRows, part = blockIdx.y;   // 0 q, 1 k, 2 v
  load_rows(A, x, part < 2 ? pos : nullptr, r0, rows);
  Acc acc;
  zero(acc);
  gemm(acc, A, w_in, kCols, part * kCols, kCols, Ws);
  const float* bias = b_in + part * kCols;
  for_each_acc(acc, [&](int r, int c, float& v) { A[r * kLda + c] = v + bias[c]; });
  __syncthreads();
  store_rows(qkv, 3 * kCols, part * kCols, A, r0, rows);
}

// Softmax rows start 16-byte aligned and hold L rounded up to 4 floats.
__host__ __device__ constexpr int attention_rows_offset(int L) {
  return (3 * L * kPad + L + 3) & ~3;
}

__host__ __device__ constexpr size_t attention_smem_bytes(int L) {
  return sizeof(float) * (size_t)(attention_rows_offset(L) + 2 * kWarps * ((L + 3) & ~3));
}

__global__ void __launch_bounds__(kThreads)
attention_kernel(const float* __restrict__ qkv, const float* __restrict__ mask,
                 float* __restrict__ ctx, int L) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int h = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* q_s = smem;                 // [L][kPad], pre-scaled by 1/sqrt(dh)
  float* k_s = q_s + L * kPad;       // [L][kPad]
  float* v_s = k_s + L * kPad;       // [L][kPad]
  float* m_s = v_s + L * kPad;       // [L] key mask
  const int Lp = (L + 3) & ~3;
  float* p0 = smem + attention_rows_offset(L) + 2 * warp * Lp;   // this warp's two
  float* p1 = p0 + Lp;                                            // softmax rows

  const float scale = 1.0f / sqrtf((float)kHeadDim);
  const float* base = qkv + (size_t)b * L * 3 * kCols + h * kHeadDim;
  for (int e = threadIdx.x; e < L * kHeadDim; e += kThreads) {
    const int r = e / kHeadDim, c = e % kHeadDim;
    const float* row = base + (size_t)r * 3 * kCols + c;
    q_s[r * kPad + c] = row[0] * scale;
    k_s[r * kPad + c] = row[kCols];
    v_s[r * kPad + c] = row[2 * kCols];
  }
  for (int j = threadIdx.x; j < L; j += kThreads) m_s[j] = mask[(size_t)b * L + j];
  __syncthreads();

  for (int i0 = 2 * warp; i0 < L; i0 += 2 * kWarps) {
    const int i1 = i0 + 1 < L ? i0 + 1 : i0;
    float qa[kHeadDim], qb[kHeadDim];
#pragma unroll
    for (int c = 0; c < kHeadDim; ++c) {
      qa[c] = q_s[i0 * kPad + c];
      qb[c] = q_s[i1 * kPad + c];
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
    for (int j = lane; j < L; j += 32) {
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int c = 0; c < kHeadDim; ++c) {
        const float kv = k_s[j * kPad + c];
        s0 = fmaf(qa[c], kv, s0);
        s1 = fmaf(qb[c], kv, s1);
      }
      if (m_s[j] == 0.f) s0 = s1 = kBigNeg;
      p0[j] = s0;
      p1[j] = s1;
      mx0 = fmaxf(mx0, s0);
      mx1 = fmaxf(mx1, s1);
    }
    mx0 = warp_max(mx0);
    mx1 = warp_max(mx1);
    float sum0 = 0.f, sum1 = 0.f;
    for (int j = lane; j < L; j += 32) {
      const float e0 = expf(p0[j] - mx0), e1 = expf(p1[j] - mx1);
      p0[j] = e0;
      p1[j] = e1;
      sum0 += e0;
      sum1 += e1;
    }
    sum0 = warp_sum(sum0);
    sum1 = warp_sum(sum1);
    __syncwarp();
    float acc0 = 0.f, acc1 = 0.f;
    int j = 0;
    for (; j + 4 <= L; j += 4) {           // four keys per broadcast 16-byte read
      const float4 a = *reinterpret_cast<const float4*>(p0 + j);
      const float4 c = *reinterpret_cast<const float4*>(p1 + j);
      const float* v = v_s + j * kPad + lane;
      acc0 = fmaf(a.x, v[0], acc0);
      acc1 = fmaf(c.x, v[0], acc1);
      acc0 = fmaf(a.y, v[kPad], acc0);
      acc1 = fmaf(c.y, v[kPad], acc1);
      acc0 = fmaf(a.z, v[2 * kPad], acc0);
      acc1 = fmaf(c.z, v[2 * kPad], acc1);
      acc0 = fmaf(a.w, v[3 * kPad], acc0);
      acc1 = fmaf(c.w, v[3 * kPad], acc1);
    }
    for (; j < L; ++j) {
      const float vv = v_s[j * kPad + lane];
      acc0 = fmaf(p0[j], vv, acc0);
      acc1 = fmaf(p1[j], vv, acc1);
    }
    float* out = ctx + ((size_t)b * L + i0) * kCols + h * kHeadDim + lane;
    out[0] = acc0 / sum0;
    if (i1 != i0) out[kCols] = acc1 / sum1;
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kThreads, 1)
ffn_kernel(const float* __restrict__ x, const float* __restrict__ ctx,
           const float* __restrict__ w_out, const float* __restrict__ b_out,
           const float* __restrict__ g1, const float* __restrict__ be1,
           const float* __restrict__ w1, const float* __restrict__ b1,
           const float* __restrict__ w2, const float* __restrict__ b2,
           const float* __restrict__ g2, const float* __restrict__ be2,
           float* __restrict__ out, int rows, int F) {
  extern __shared__ float4 smem4[];
  float* A = reinterpret_cast<float*>(smem4);  // ctx, then each ReLU slice, then y1 + FFN
  float* Y = A + kRows * kLda;                  // x + out-proj, then LN1 output
  float* Ws = Y + kRows * kLda;                 // [2][kCols][kLdws]
  const int r0 = blockIdx.x * kRows;

  load_rows(A, ctx, nullptr, r0, rows);
  Acc acc;
  zero(acc);
  gemm(acc, A, w_out, kCols, 0, kCols, Ws);
  for_each_acc(acc, [&](int r, int c, float& v) { Y[r * kLda + c] = v + b_out[c]; });
  __syncthreads();
  for (int e = threadIdx.x; e < kRows * kCols / 4; e += kThreads) {
    const int r = e / (kCols / 4), c4 = e % (kCols / 4), gr = r0 + r;
    if (gr < rows) {
      float4* y = reinterpret_cast<float4*>(Y + r * kLda + 4 * c4);
      const float4 xv = reinterpret_cast<const float4*>(x + (size_t)gr * kCols)[c4];
      y->x += xv.x; y->y += xv.y; y->z += xv.z; y->w += xv.w;
    }
  }
  __syncthreads();
  layer_norm_rows(Y, g1, be1);

  Acc acc2;
  zero(acc2);
  for (int f0 = 0; f0 < F; f0 += kCols) {
    zero(acc);
    gemm(acc, Y, w1, kCols, f0, kCols, Ws);
    for_each_acc(acc, [&](int r, int c, float& v) {
      A[r * kLda + c] = fmaxf(v + b1[f0 + c], 0.f);
    });
    __syncthreads();
    gemm(acc2, A, w2 + f0, F, 0, kCols, Ws);
  }
  for_each_acc(acc2, [&](int r, int c, float& v) {
    A[r * kLda + c] = v + b2[c] + Y[r * kLda + c];
  });
  __syncthreads();
  layer_norm_rows(A, g2, be2);
  store_rows(out, kCols, 0, A, r0, rows);
}

}  // namespace

// Once per device, before the first launch on it: lets each kernel take its
// dynamic shared memory (the attention kernel's for the longest L it takes).
// Returns the first CUDA error (0 = ok).
extern "C" int mgsv_fused_encoder_layer_init() {
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(qkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)kGemmSmem)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(attention_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)attention_smem_bytes(kMaxL))) != cudaSuccess ||
      (err = cudaFuncSetAttribute(ffn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)kFfnSmem)) != cudaSuccess)
    return (int)err;
  return 0;
}

// One post-norm encoder layer on `stream`, after mgsv_fused_encoder_layer_init
// on that device.  qkv ([B, L, 3D]) and ctx ([B, L, D]) are scratch
// buffers, out the [B, L, D] result; every pointer 16-byte aligned.  The
// shapes must be ones the Python wrapper accepts (its check_supported).
// Returns cudaGetLastError() (0 = ok).
extern "C" int mgsv_fused_encoder_layer_fwd(
    const float* x, const float* pos, const float* mask,
    const float* w_in, const float* b_in, const float* w_out, const float* b_out,
    const float* g1, const float* be1, const float* w1, const float* b1,
    const float* w2, const float* b2, const float* g2, const float* be2,
    float* qkv, float* ctx, float* out, int B, int L, int D, int H, int F,
    void* stream) {
  if (B < 1 || B > kMaxB || L < 1 || L > kMaxL || D != kCols || H * kHeadDim != D ||
      F < kCols || F % kCols != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = B * L, row_tiles = (rows + kRows - 1) / kRows;
  cudaError_t err;
  qkv_kernel<<<dim3(row_tiles, 3), kThreads, kGemmSmem, s>>>(x, pos, w_in, b_in, qkv, rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  attention_kernel<<<dim3(H, B), kThreads, attention_smem_bytes(L), s>>>(qkv, mask, ctx, L);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ffn_kernel<<<row_tiles, kThreads, kFfnSmem, s>>>(x, ctx, w_out, b_out, g1, be1, w1, b1,
                                                   w2, b2, g2, be2, out, rows, F);
  return (int)cudaGetLastError();
}
