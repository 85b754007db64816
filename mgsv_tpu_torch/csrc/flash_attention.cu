// Non-causal attention with an optional key mask, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// mgsv_tpu/ops/pallas/flash_attention.py::flash_attention (kernel
// _flash_kernel), the attention of the frozen AST tower's 1,214-token
// blocks.  Per (batch b, head h) it computes
//
//   o = softmax_keys(q k^T scale + bias_b) v,   q [Lq, 64], k, v [Lk, 64]
//
// with bias_b[key] = 0 where key_mask[b, key] != 0 and -1e30 where it is 0
// (no mask: every key valid), and o = 0 on a row whose every key is masked,
// as the Pallas kernel does.  Inputs are float32 or bfloat16 and the output
// takes their type.  Float32 products run in 3xTF32 on the tensor cores
// (each operand split into two tf32 halves, three mma.sync products per
// tile: float32 accuracy, see tf32_tile.cuh); bfloat16 products run in
// bf16 mma.sync with float32 accumulation, p rounded to bf16 as the Pallas
// kernel's precision="bf16" does.  The softmax is float32 in both.
//
// What bounds it on the card: 4 Lq Lk 64 operations against (2 Lq + 2 Lk)
// 64 elements moved per (b, h): at L = 1214 some 600 operations per
// float32 byte, far above the ridge point, so the tensor cores' rate bounds
// it.  The Pallas kernel kept all of K and V of one (b, h) resident (2 x
// 311 KB in float32 at L = 1214), more than an SM's 227 KB of shared
// memory, and wrote a [block_q, L] score tile.  This design streams:
//
//  - one block of 4 warps per (64-row query tile, b h); each warp owns 16
//    query rows, holds them as mma A fragments in registers with the
//    softmax scale and log2(e) folded in (the softmax uses exp2);
//  - 64-key tiles of K and V (and the tile's key bias) are staged through
//    shared memory by cp.async, double-buffered, so the next tile loads
//    while this one computes;
//  - per tile the warp computes its [16 x 64] scores in registers, updates
//    a running row max and row sum in float32 (online softmax), rescales
//    its [16 x 64] output accumulators and adds p v, with p going from the
//    score accumulators straight into A fragments (no shared memory);
//  - [Lq, Lk] never reaches device memory.
//
// Keys past Lk are staged as zeros with bias -1e30, so they weigh exp2 of
// about -1e30 = 0 in any row that has a valid key.  The running max starts
// at -inf, and every score is finite (a masked one is -1e30), so the first
// tile's rescale is exp2(-inf) = 0, never NaN; a row that sees only masked
// keys ends with max -1e30 and is written as 0.  wgmma and TMA are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tf32_tile.cuh"

namespace {

constexpr int kHeadDim = 64;
constexpr int kQTile = 64;            // query rows per block: 16 per warp
constexpr int kKTile = 64;            // keys per staged tile
constexpr int kFaThreads = 128;
constexpr int kMaxGridY = 65535;
constexpr float kMaskBias = -1e30f;   // flash_attention.py NEG_INF
constexpr float kDeadMax = -0.5e30f;  // a row max at or below this saw no valid key

using bf16 = __nv_bfloat16;

// Shared-memory row strides (elements) of the staged K and V tiles.
// float: 68 floats (272 B: 16-byte rows, 4 mod 32 banks), so the score
// B-fragment reads (key g, dim t) hit banks 4 g + t and the p.v reads
// (key 2 t, dim g) banks 8 t + g: conflict-free.  bf16: 72 elements
// (144 B = 36 words, 4 mod 32): 32-bit score reads hit banks 4 g + t, and
// ldmatrix's eight 16-byte rows fall in distinct banks.
template <typename T> struct Ld;
template <> struct Ld<float> { static constexpr int v = 68; };
template <> struct Ld<bf16> { static constexpr int v = 72; };

template <typename T>
constexpr int kTileBytes = kKTile * Ld<T>::v * (int)sizeof(T);
// one stage: the K tile, the V tile and the tile's 64 key biases
template <typename T>
constexpr int kStageBytes = 2 * kTileBytes<T> + kKTile * (int)sizeof(float);
template <typename T>
constexpr int kSmemBytes = 2 * kStageBytes<T>;
static_assert(kTileBytes<float> % 16 == 0 && kTileBytes<bf16> % 16 == 0, "16-byte tiles");
static_assert(kStageBytes<float> % 16 == 0 && kStageBytes<bf16> % 16 == 0, "16-byte stages");

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* mask;   // [B, Lk] (1 = valid) or null
  void* o;
  long long sq_b, sq_h, sq_l;   // element strides; the head dimension is contiguous
  long long sk_b, sk_h, sk_l;
  long long sv_b, sv_h, sv_l;
  long long so_b, so_h, so_l;
  int H, Lq, Lk, bh0;
  float qscale;        // softmax scale times log2(e), folded into q by the caller
};

// Four 8 x 8 bf16 matrices, transposed: lane l gives the address of one
// 16-byte row (lanes 8 m .. 8 m + 7 the rows of matrix m).
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const bf16* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Stage keys [key0, key0 + kKTile) of one (b, h): K and V rows into Ks and
// Vs (row stride Ld<T>) with 16-byte cp.async copies, zeros past Lk, and
// each key's bias into bias[].  Commits one cp.async group.
template <typename T>
__device__ __forceinline__ void stage_kv(unsigned char* stage, const T* k, long long sk,
                                         const T* v, long long sv, const float* mask_row,
                                         int key0, int Lk) {
  constexpr int kChunk = 16 / sizeof(T);            // elements per copy
  constexpr int kPerRow = kHeadDim / kChunk;
  T* Ks = reinterpret_cast<T*>(stage);
  T* Vs = reinterpret_cast<T*>(stage + kTileBytes<T>);
  float* bias = reinterpret_cast<float*>(stage + 2 * kTileBytes<T>);
  for (int e = threadIdx.x; e < kKTile * kPerRow; e += kFaThreads) {
    const int r = e / kPerRow, c = (e % kPerRow) * kChunk, key = key0 + r;
    float* kd = reinterpret_cast<float*>(Ks + r * Ld<T>::v + c);
    float* vd = reinterpret_cast<float*>(Vs + r * Ld<T>::v + c);
    if (key < Lk) {
      cp_async16(kd, reinterpret_cast<const float*>(k + key * sk + c));
      cp_async16(vd, reinterpret_cast<const float*>(v + key * sv + c));
    } else {
      *reinterpret_cast<float4*>(kd) = make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(vd) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  if (threadIdx.x < kKTile) {
    const int key = key0 + threadIdx.x;
    const bool valid = key < Lk && (mask_row == nullptr || mask_row[key] != 0.f);
    bias[threadIdx.x] = valid ? 0.f : kMaskBias;
  }
  cp_async_commit();
}

// The warp's products in float32: 3xTF32 on mma.sync m16n8k8.  With
// g = lane / 4, t = lane % 4, score tile ni covers keys 8 ni .. 8 ni + 7 and
// its accumulator r sits at row g + 8 (r >> 1), key 8 ni + 2 t + (r & 1).
struct F32Mma {
  unsigned qb[8][4], qs[8][4];   // q's A fragments (big, small) per 8-deep step

  __device__ void load_q(const float* q, long long sl, int row0, int Lq, float qscale, int g,
                         int t) {
#pragma unroll
    for (int s = 0; s < 8; ++s)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = row0 + g + 8 * (i & 1), col = 8 * s + t + 4 * (i >> 1);
        const float x = row < Lq ? q[row * sl + col] * qscale : 0.f;
        split_tf32(x, qb[s][i], qs[s][i]);
      }
  }

  __device__ void scores(float (&sc)[8][4], const float* Ks, int g, int t) const {
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const float* kr = Ks + (8 * ni + g) * Ld<float>::v + t;
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        unsigned bb0, bs0, bb1, bs1;
        split_tf32(kr[8 * s], bb0, bs0);
        split_tf32(kr[8 * s + 4], bb1, bs1);
        mma_tf32(sc[ni], qs[s], bb0, bb1);
        mma_tf32(sc[ni], qb[s], bs0, bs1);
        mma_tf32(sc[ni], qb[s], bb0, bb1);
      }
    }
  }

  // o += p v.  The k index of a step is a relabelling of its 8 keys: k = t
  // is key 8 j + 2 t and k = t + 4 is key 8 j + 2 t + 1, so p's accumulators
  // are its A fragment as they stand and V is read at the same keys.  The
  // tile's products are summed from zero (small terms first) and then added
  // to o with a rounded float32 add, as tf32_tile.cuh's mma_tile does.
  __device__ void pv(float (&o)[8][4], const float (&p)[8][4], const float* Vs, int g,
                     int t) const {
    float part[8][4];
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) part[ni][r] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      unsigned ab[4], as[4];
      split_tf32(p[j][0], ab[0], as[0]);      // row g,     key 2 t
      split_tf32(p[j][2], ab[1], as[1]);      // row g + 8, key 2 t
      split_tf32(p[j][1], ab[2], as[2]);      // row g,     key 2 t + 1
      split_tf32(p[j][3], ab[3], as[3]);      // row g + 8, key 2 t + 1
      const float* vr = Vs + (8 * j + 2 * t) * Ld<float>::v + g;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        unsigned bb0, bs0, bb1, bs1;
        split_tf32(vr[8 * ni], bb0, bs0);
        split_tf32(vr[Ld<float>::v + 8 * ni], bb1, bs1);
        mma_tf32(part[ni], as, bb0, bb1);
        mma_tf32(part[ni], ab, bs0, bs1);
        mma_tf32(part[ni], ab, bb0, bb1);
      }
    }
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) o[ni][r] += part[ni][r];
  }

  __device__ static void store(float* o, float x0, float x1) {
    *reinterpret_cast<float2*>(o) = make_float2(x0, x1);
  }
};

// The warp's products in bfloat16: mma.sync m16n8k16, float32 accumulators
// in the same layout as F32Mma's.
struct Bf16Mma {
  unsigned qa[4][4];   // q's A fragments per 16-deep step, scaled and rounded to bf16

  __device__ void load_q(const bf16* q, long long sl, int row0, int Lq, float qscale, int g,
                         int t) {
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = row0 + g + 8 * (i & 1), col = 16 * s + 2 * t + 8 * (i >> 1);
        float x0 = 0.f, x1 = 0.f;
        if (row < Lq) {
          x0 = __bfloat162float(q[row * sl + col]) * qscale;
          x1 = __bfloat162float(q[row * sl + col + 1]) * qscale;
        }
        qa[s][i] = pack_bf16(x0, x1);
      }
  }

  __device__ void scores(float (&sc)[8][4], const bf16* Ks, int g, int t) const {
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const bf16* kr = Ks + (8 * ni + g) * Ld<bf16>::v + 2 * t;
#pragma unroll
      for (int s = 0; s < 4; ++s)
        mma_bf16(sc[ni], qa[s], *reinterpret_cast<const unsigned*>(kr + 16 * s),
                 *reinterpret_cast<const unsigned*>(kr + 16 * s + 8));
    }
  }

  // o += p v: step j takes keys 16 j .. 16 j + 15, whose p accumulators
  // (score tiles 2 j and 2 j + 1) are the A fragment once packed to bf16;
  // V's B fragments come transposed from shared memory by ldmatrix, two
  // 8-wide column tiles per call.
  __device__ void pv(float (&o)[8][4], const float (&p)[8][4], const bf16* Vs, int lane) const {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned a[4] = {pack_bf16(p[2 * j][0], p[2 * j][1]),
                             pack_bf16(p[2 * j][2], p[2 * j][3]),
                             pack_bf16(p[2 * j + 1][0], p[2 * j + 1][1]),
                             pack_bf16(p[2 * j + 1][2], p[2 * j + 1][3])};
      const bf16* vr = Vs + (16 * j + (lane & 15)) * Ld<bf16>::v + 8 * (lane >> 4);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        unsigned b[4];
        ldmatrix_x4_trans(b, vr + 16 * np);
        mma_bf16(o[2 * np], a, b[0], b[1]);
        mma_bf16(o[2 * np + 1], a, b[2], b[3]);
      }
    }
  }

  __device__ static void store(bf16* o, float x0, float x1) {
    *reinterpret_cast<unsigned*>(o) = pack_bf16(x0, x1);
  }
};

template <typename T, typename Mma>
__global__ void __launch_bounds__(kFaThreads) flash_fwd_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = a.bh0 + blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int row0 = blockIdx.x * kQTile + 16 * warp;
  const T* q = static_cast<const T*>(a.q) + b * a.sq_b + h * a.sq_h;
  const T* k = static_cast<const T*>(a.k) + b * a.sk_b + h * a.sk_h;
  const T* v = static_cast<const T*>(a.v) + b * a.sv_b + h * a.sv_h;
  const float* mask_row = a.mask != nullptr ? a.mask + (size_t)b * a.Lk : nullptr;

  const int ntiles = (a.Lk + kKTile - 1) / kKTile;
  stage_kv<T>(smem, k, a.sk_l, v, a.sv_l, mask_row, 0, a.Lk);

  Mma mma;
  mma.load_q(q, a.sq_l, row0, a.Lq, a.qscale, g, t);
  float o[8][4];
#pragma unroll
  for (int ni = 0; ni < 8; ++ni)
#pragma unroll
    for (int r = 0; r < 4; ++r) o[ni][r] = 0.f;
  // running max (log2 units) and this thread's share of the row sum, for
  // rows g and g + 8
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  cp_async_wait_all();
  __syncthreads();
  for (int c = 0; c < ntiles; ++c) {
    if (c + 1 < ntiles)
      stage_kv<T>(smem + ((c + 1) & 1) * kStageBytes<T>, k, a.sk_l, v, a.sv_l, mask_row,
                  (c + 1) * kKTile, a.Lk);
    const unsigned char* stage = smem + (c & 1) * kStageBytes<T>;
    const T* Ks = reinterpret_cast<const T*>(stage);
    const T* Vs = reinterpret_cast<const T*>(stage + kTileBytes<T>);
    const float* bias = reinterpret_cast<const float*>(stage + 2 * kTileBytes<T>);

    float p[8][4];
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) p[ni][r] = 0.f;
    mma.scores(p, Ks, g, t);
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const float2 bk = *reinterpret_cast<const float2*>(bias + 8 * ni + 2 * t);
      p[ni][0] += bk.x;
      p[ni][1] += bk.y;
      p[ni][2] += bk.x;
      p[ni][3] += bk.y;
      mx0 = fmaxf(mx0, fmaxf(p[ni][0], p[ni][1]));
      mx1 = fmaxf(mx1, fmaxf(p[ni][2], p[ni][3]));
    }
    const float n0 = fmaxf(m0, quad_max(mx0)), n1 = fmaxf(m1, quad_max(mx1));
    const float al0 = exp2f(m0 - n0), al1 = exp2f(m1 - n1);   // 0 on the first tile
    m0 = n0;
    m1 = n1;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      p[ni][0] = exp2f(p[ni][0] - n0);
      p[ni][1] = exp2f(p[ni][1] - n0);
      p[ni][2] = exp2f(p[ni][2] - n1);
      p[ni][3] = exp2f(p[ni][3] - n1);
      s0 += p[ni][0] + p[ni][1];
      s1 += p[ni][2] + p[ni][3];
      o[ni][0] *= al0;
      o[ni][1] *= al0;
      o[ni][2] *= al1;
      o[ni][3] *= al1;
    }
    l0 = l0 * al0 + s0;
    l1 = l1 * al1 + s1;
    if constexpr (sizeof(T) == 4)
      mma.pv(o, p, Vs, g, t);
    else
      mma.pv(o, p, Vs, lane);
    cp_async_wait_all();
    __syncthreads();
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const bool dead0 = m0 <= kDeadMax, dead1 = m1 <= kDeadMax;
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  T* out = static_cast<T*>(a.o) + b * a.so_b + h * a.so_h;
  const int r0 = row0 + g, r1 = row0 + g + 8;
#pragma unroll
  for (int ni = 0; ni < 8; ++ni) {
    const int col = 8 * ni + 2 * t;
    if (r0 < a.Lq)
      Mma::store(out + r0 * a.so_l + col, dead0 ? 0.f : o[ni][0] * inv0,
                 dead0 ? 0.f : o[ni][1] * inv0);
    if (r1 < a.Lq)
      Mma::store(out + r1 * a.so_l + col, dead1 ? 0.f : o[ni][2] * inv1,
                 dead1 ? 0.f : o[ni][3] * inv1);
  }
}

}  // namespace

// Once per device, before the first launch on it: lets both instantiations
// take their dynamic shared memory.  Returns the first CUDA error (0 = ok).
extern "C" int mgsv_flash_attention_init() {
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(flash_fwd_kernel<float, F32Mma>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kSmemBytes<float>)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(flash_fwd_kernel<bf16, Bf16Mma>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kSmemBytes<bf16>)) != cudaSuccess)
    return (int)err;
  return 0;
}

// o = attention(q, k, v) on `stream`, after mgsv_flash_attention_init on
// that device.  dtype 0 = float32, 1 = bfloat16 (q, k, v and o alike).
// Strides are in elements, for the [B, H, L, Dh] index order; the head
// dimension (Dh = 64) must be contiguous and every row start 16-byte
// aligned.  mask is a float32 [B, Lk] tensor (1 = valid) or null.  Returns
// cudaGetLastError() (0 = ok).
extern "C" int mgsv_flash_attention_fwd(
    int dtype, const void* q, const void* k, const void* v, const float* mask, void* o,
    long long sq_b, long long sq_h, long long sq_l, long long sk_b, long long sk_h,
    long long sk_l, long long sv_b, long long sv_h, long long sv_l, long long so_b,
    long long so_h, long long so_l, int B, int H, int Lq, int Lk, int Dh, float qscale,
    void* stream) {
  if (Dh != kHeadDim || B < 1 || H < 1 || Lq < 1 || Lk < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args a{q,    k,    v,    mask, o,    sq_b, sq_h, sq_l, sk_b, sk_h, sk_l, sv_b, sv_h,
         sv_l, so_b, so_h, so_l, H,    Lq,   Lk,   0,    qscale};
  const int bh = B * H, qtiles = (Lq + kQTile - 1) / kQTile;
  for (int bh0 = 0; bh0 < bh; bh0 += kMaxGridY) {   // grid y holds at most 65,535 (b, h)
    a.bh0 = bh0;
    const dim3 grid(qtiles, bh - bh0 < kMaxGridY ? bh - bh0 : kMaxGridY);
    if (dtype == 0)
      flash_fwd_kernel<float, F32Mma><<<grid, kFaThreads, kSmemBytes<float>, s>>>(a);
    else
      flash_fwd_kernel<bf16, Bf16Mma><<<grid, kFaThreads, kSmemBytes<bf16>, s>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
