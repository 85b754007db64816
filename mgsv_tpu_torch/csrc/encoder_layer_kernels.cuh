// The float32 attention of the port's layers (attention_kernel, CUDA-core
// multiply-adds, one block per (head, batch row)), which
// Launcher::attention_fwd (layer_bwd_kernels.cuh) runs at precision "f32":
// in the encoder layer's forward sequence (#1 and #2's recompute), the
// temporal layer's (#5 and its backward's recompute) and the decoder
// layer's self-attention (#6).
// Dropout sites, drawn from philox.cuh with stream (batch row b, site):
// heads 0..H-1 the attention weights (element i L + j); the layers' other
// sites (H and up) are drawn in the GEMM core's epilogues.
#pragma once

#include <initializer_list>

#include "philox.cuh"
#include "tf32_tile.cuh"

namespace {

constexpr int kHeadDim = 32;          // one lane per head channel
constexpr int kPad = kHeadDim + 1;    // padded [L][kPad] rows: conflict-free columns
constexpr int kMaxL = 256;            // longest sequence (attention shared memory)
constexpr int kMaxB = 65535;          // batch rows: grid y of the attention launch

// The dropout mask values (k0, k1) of weights (i0, j) and (i1, j), lane's
// key j = jb + lane: with L a multiple of 4 every row starts a group of four
// mask words, so in each group of four lanes the first draws row i0's
// group and the second row i1's, and the four read them by shuffles (one
// Philox call per two lanes); else one per weight.  Every lane of the warp
// calls it; values for j >= L are not used.
__device__ __forceinline__ void row_pair_keep(const Dropout& drop, unsigned b, unsigned h, int L,
                                              int i0, int i1, int jb, float& k0, float& k1) {
  const int lane = threadIdx.x & 31, j = jb + lane;
  if ((L & 3) == 0) {
    const int sub = lane & 3, lead = lane & ~3;
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (sub < 2) w = philox4(drop.seed, b, h, (unsigned)((sub ? i1 : i0) * L + (j & ~3)) >> 2);
    uint4 w0, w1;
    w0.x = __shfl_sync(0xffffffffu, w.x, lead);
    w0.y = __shfl_sync(0xffffffffu, w.y, lead);
    w0.z = __shfl_sync(0xffffffffu, w.z, lead);
    w0.w = __shfl_sync(0xffffffffu, w.w, lead);
    w1.x = __shfl_sync(0xffffffffu, w.x, lead + 1);
    w1.y = __shfl_sync(0xffffffffu, w.y, lead + 1);
    w1.z = __shfl_sync(0xffffffffu, w.z, lead + 1);
    w1.w = __shfl_sync(0xffffffffu, w.w, lead + 1);
    k0 = word_of(w0, sub) >= drop.thresh ? drop.scale : 0.f;
    k1 = word_of(w1, sub) >= drop.thresh ? drop.scale : 0.f;
  } else if (j < L) {
    k0 = keep(drop, b, h, i0 * L + j);
    k1 = keep(drop, b, h, i1 * L + j);
  }
}

// Softmax rows start 16-byte aligned and hold L rounded up to 4 floats.
__host__ __device__ constexpr int attention_rows_offset(int L) {
  return (3 * L * kPad + L + 3) & ~3;
}

__host__ __device__ constexpr size_t attention_smem_bytes(int L) {
  return sizeof(float) * (size_t)(attention_rows_offset(L) + 2 * kWarps * ((L + 3) & ~3));
}

// One block per (head, batch row).  The head's q, k, v ([L, 32] each)
// sit in shared memory; each warp takes two query rows at a time, their
// scores one key per lane, and writes ctx [B, L, D] (and, given stats, each
// row's softmax max and sum [B, H, L], for a backward).  Dropout multiplies
// the normalized weights (after the softmax sum), as torch does.  kDrop
// false (rate 0, the serving path) compiles the mask code out.  A null mask
// means every key is valid.
template <bool kDrop>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const float* __restrict__ qkv, const float* __restrict__ mask,
                 float* __restrict__ ctx, int L, Dropout drop, float2* __restrict__ stats) {
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
  for (int j = threadIdx.x; j < L; j += kThreads)
    m_s[j] = mask != nullptr ? mask[(size_t)b * L + j] : 1.f;
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
    for (int jb = 0; jb < L; jb += 32) {   // every lane takes each step (row_pair_keep)
      const int j = jb + lane;
      float k0 = 1.f, k1 = 1.f;
      if constexpr (kDrop) row_pair_keep(drop, b, h, L, i0, i1, jb, k0, k1);
      if (j < L) {
        const float e0 = expf(p0[j] - mx0), e1 = expf(p1[j] - mx1);
        sum0 += e0;
        sum1 += e1;
        p0[j] = e0 * k0;
        p1[j] = e1 * k1;
      }
    }
    sum0 = warp_sum(sum0);
    sum1 = warp_sum(sum1);
    if (stats != nullptr && lane == 0) {
      float2* st = stats + ((size_t)b * gridDim.x + h) * L;
      st[i0] = make_float2(mx0, sum0);
      st[i1] = make_float2(mx1, sum1);
    }
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

// Both instantiations of attention_kernel: dynamic shared memory for
// sequences up to max_l.
inline cudaError_t attention_init(int max_l = kMaxL) {
  const int bytes = (int)attention_smem_bytes(max_l);
  cudaError_t err = cudaSuccess;
  for (auto* kernel : {attention_kernel<false>, attention_kernel<true>})
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  return err;
}

// Launches attention_kernel over B rows on `s`; rate 0 takes the
// instantiation without mask code.
inline void launch_attention(const float* qkv, const float* mask, float* ctx, int B, int H,
                             int L, const Dropout& drop, cudaStream_t s,
                             float2* stats = nullptr) {
  const dim3 grid(H, B);
  const size_t smem = attention_smem_bytes(L);
  auto* kernel = drop.thresh != 0u ? attention_kernel<true> : attention_kernel<false>;
  kernel<<<grid, kThreads, smem, s>>>(qkv, mask, ctx, L, drop, stats);
}

}  // namespace
