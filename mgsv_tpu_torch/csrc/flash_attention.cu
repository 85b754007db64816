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
// takes their type.
//
// What bounds it on the card: 4 Lq Lk 64 operations against (2 Lq + 2 Lk)
// 64 elements moved per (b, h): at L = 1214 some 600 operations per
// float32 byte, far above the ridge point, so the tensor cores bound it.
// In bf16 the softmax is as costly as the products at head dim 64 (one
// exponential, one max, one add and one multiply-add per score, on units
// that run at a small fraction of the tensor cores' rate), so the two have
// to overlap.  The Pallas kernel kept all of K and V of one (b, h)
// resident, more than an SM's 227 KB at L = 1214; this design streams
// them:
//
//  * Persistent blocks, one per SM, walk work items (query tile, b h), the
//    query tiles of one (b, h) next to each other so that the blocks in
//    flight share K and V in L2.
//  * A producer warpgroup gives its registers to the consumers
//    (setmaxnreg), and one of its threads keeps a ring of K / V key tiles
//    in flight with TMA (cp.async.bulk.tensor on rank-4 maps of the
//    [B, H, L, 64] views, encoded from the caller's strides, so packed or
//    transposed q, k, v are read in place; an mbarrier per stage counts the
//    bytes) and loads each item's query tile once.
//  * Consumer warpgroups own 64 query rows each.  Per key tile: S = Q K^T
//    on wgmma, an online softmax in float32 (exp2, the scale and log2(e)
//    folded into one multiply-add), O += P V on wgmma with P taken from
//    the score accumulators as the register A operand.  Each warp releases
//    a stage with one mbarrier arrival.
//  * bfloat16: three consumer groups (192-row items) at 160 registers a
//    thread, 128-key tiles.  Q and K are read by wgmma m64n128k16 as TMA
//    wrote them (K-major, 128-byte swizzle) and V as an MN-major operand
//    (wgmma's transposed B), so no tile is touched by the threads.  The
//    groups take turns in a ring to issue their score products (named
//    barriers 2 + group), so that while one group's products run the
//    other two run their softmax: with three groups this overlaps more
//    than two groups that also overlap a group's softmax with its own next
//    products (FlashAttention-3's two schemes; measured on the H100, the
//    first is faster at head dim 64, where the second's registers do not
//    fit three groups).  A last tile with at most 64 valid keys (L = 1214
//    leaves 62) runs its softmax and P V over its first 64 keys only.  P
//    is rounded to bf16 before P V, as the Pallas kernel's
//    precision="bf16" does; sums are float32.
//  * float32: two consumer groups (128-row items) at 240 registers, 64-key
//    tiles in 3xTF32 (x = big + small, both tf32; three products
//    small.big + big.small + big.big keep float32 accuracy).
//    wgmma takes tf32 operands only K-major, so both groups convert each
//    staged K tile into big / small tiles and V's into transposed ones
//    [64 channels][64 keys]; within each group of 8 keys the transposed
//    tile stores key 2i at k position i and key 2i + 1 at i + 4, which is
//    where the score accumulators of a thread (columns 2t, 2t + 1) sit in
//    the register A fragment (k indices t, t + 4), so P needs no shuffle.
//    The conversion of tile j + 1 runs while tile j's score products are
//    on the tensor cores.  Q is scaled, split and held in registers for
//    the whole item.  Each tile's P V is summed from zero and then added to
//    O with a rounded float32 add (the tensor cores truncate a sum to the
//    running sum's exponent), as csrc/wgmma_gemm.cuh does.
//
// Keys past Lk arrive as TMA's zeros and take the -1e30 bias by index, as
// masked keys do.  The running max starts at -inf, and every score is
// finite, so the first tile's rescale is exp2(-inf) = 0, never NaN; a row
// that sees only masked keys keeps p = 0 and is written as 0.

#include "wgmma_gemm.cuh"

namespace {

constexpr int kHeadDim = 64;
constexpr float kMaskBias = -1e30f;   // flash_attention.py NEG_INF
constexpr float kDeadMax = -0.5e30f;  // a row max at or below this saw no valid key

using bf16 = __nv_bfloat16;

template <bool kBf16>
struct FaCfg {
  // consumer warpgroups of 64 query rows each, and one producer warpgroup;
  // each consumer's register budget after setmaxnreg (a sub-partition's
  // 512 a lane: 3 x 160 + 32, or 2 x 240 + 24)
  static constexpr int kGroups = kBf16 ? 3 : 2;
  static constexpr int kQRows = 64 * kGroups;              // query rows per work item
  static constexpr int kConsumers = 128 * kGroups;
  static constexpr int kThreads = kConsumers + 128;
  static constexpr int kN = kBf16 ? 128 : 64;              // keys per tile
  static constexpr int kStages = kBf16 ? 4 : 2;
  // bf16 reads Q from shared memory all through an item, so the next
  // item's Q loads into a second buffer; f32 holds Q in registers
  static constexpr int kQBufs = kBf16 ? 2 : 1;
  static constexpr int kElem = kBf16 ? 2 : 4;
  static constexpr int kQBytes = kQRows * kHeadDim * kElem;
  static constexpr int kKVBytes = kN * kHeadDim * kElem;   // one K or V tile: 16 KB
  static constexpr int kStageBytes = 2 * kKVBytes;
  // f32: K big, K small, V^T big, V^T small, twice (tile j + 1 converts
  // while tile j multiplies)
  static constexpr int kCvtBytes = kBf16 ? 0 : 4 * kKVBytes;
  static constexpr size_t kSmem = 1024 + (size_t)kQBufs * kQBytes +
                                  (size_t)kStages * kStageBytes + 2 * (size_t)kCvtBytes +
                                  sizeof(uint64_t) * (2 * kStages + 2 * kQBufs);
  static_assert(kSmem <= 232448, "shared memory of one block");
};

struct FaParams {
  CUtensorMap q, k, v;        // rank 4: (channel, row, head, batch)
  const float* mask;          // [B, Lk] (1 = valid) or null
  void* o;
  long long so_b, so_h, so_l; // element strides of o; channels contiguous
  int H, Lq, Lk, qtiles, items;
  float qscale;               // softmax scale times log2(e)
};

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma_gemm.cuh's mbar_wait with a bound: a wait that outlasts two
// seconds (which no tile of a correct launch needs) traps, so a fault in
// the pipeline ends the launch with an error instead of hanging the card.
__device__ __forceinline__ void fa_wait(uint32_t bar, unsigned parity) {
  uint32_t done = 0;
  uint64_t start = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && (polls & 1023u) == 0) {
      uint64_t now;
      asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
      if (polls == 0)
        start = now;
      else if (now - start > 2000000000ull)
        __trap();
    }
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// 2^x on the special-function unit (flushes denormal results to 0;
// 2^-inf = 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&p);
}

#define FA_D32                                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define FA_OUT32(d)                                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),      \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),           \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),        \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),        \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31])

// d (64 x 64) = A . B^T + (scale_d ? d : 0), A from registers (the m64k8
// tf32 fragment: a[i] at row g + 8 (i & 1), k t + 4 (i >> 1)), B a K-major
// tf32 tile in shared memory.
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[32], const unsigned (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " FA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : FA_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (64 x 64) += A . B, A from registers (the m64k16 bf16 fragment), B an
// MN-major bf16 tile in shared memory (wgmma's transposed B).
__device__ __forceinline__ void wgmma_bf16_rs_tb(float (&d)[32], const unsigned (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : FA_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// wgmma descriptor of a 128-byte-swizzled operand tile at addr: rows of
// 128 bytes, 8-row groups 1024 bytes apart (K-major: 8 rows of M or N;
// MN-major: 8 rows of K); the leading offset, which no tile here spans, is
// left at 16 bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return wg_desc(addr, 1024, 1);
}

// Float32: converts the staged K and V tile at `st` (each two 128-byte-
// swizzled [64 keys][32 channels] halves) into big / small tf32 tiles at
// `cvt`: K in the same layout, V transposed into two [64 channels][32 k]
// halves with the key order of the header.  ctid: 0..255 over both groups;
// a warp reads 32 channels of one key (distinct banks) and writes 32 rows'
// 16-byte chunks (8 distinct chunks per quarter warp).
__device__ __forceinline__ void convert_kv(const char* st, char* cvt, int ctid) {
  constexpr int kTile = FaCfg<false>::kKVBytes;   // 16 KB
  char* kb = cvt;
  char* ks = cvt + kTile;
  char* vb = cvt + 2 * kTile;
  char* vs = cvt + 3 * kTile;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int off = 16 * (ctid + 256 * i);
    const float4 x = *reinterpret_cast<const float4*>(st + off);
    const float4 b = make_float4(tf32_rna(x.x), tf32_rna(x.y), tf32_rna(x.z), tf32_rna(x.w));
    *reinterpret_cast<float4*>(kb + off) = b;
    *reinterpret_cast<float4*>(ks + off) = make_float4(
        tf32_rna(x.x - b.x), tf32_rna(x.y - b.y), tf32_rna(x.z - b.z), tf32_rna(x.w - b.w));
  }
  const char* vsrc = st + kTile;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int job = ctid + 256 * i;
    const int d = job & 63, c = job >> 6;          // channel; 16-byte chunk of k positions
    const int half = c >> 3, cc = c & 7;           // half: keys 32 half ..
    const int key0 = 32 * half + 8 * (cc >> 1) + (cc & 1);
    const int dc = d & 31;
    const char* col = vsrc + (d >> 5) * (kTile / 2) + (dc & 3) * 4;
    float x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = key0 + 2 * e;
      x[e] = *reinterpret_cast<const float*>(col + key * 128 + (((dc >> 2) ^ (key & 7)) << 4));
    }
    const float4 b = make_float4(tf32_rna(x[0]), tf32_rna(x[1]), tf32_rna(x[2]), tf32_rna(x[3]));
    const int off = half * (kTile / 2) + d * 128 + ((cc ^ (d & 7)) << 4);
    *reinterpret_cast<float4*>(vb + off) = b;
    *reinterpret_cast<float4*>(vs + off) = make_float4(
        tf32_rna(x[0] - b.x), tf32_rna(x[1] - b.y), tf32_rna(x[2] - b.z), tf32_rna(x[3] - b.w));
  }
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The online softmax of one thread's two rows (g and g + 8 of its warp's
// 16) over a tile of scores.
struct Rows {
  const float* mask_row;   // the batch row's key mask, or null
  int Lk;
  float sscale;            // score units to log2 units
  int t;                   // lane mod 4: columns 8 j + 2 t + e

  // sc (accumulators 4 j + 2 h + e: row h, key key0 + 8 j + 2 t + e) -> p
  // = exp2((s - m) sscale) with the running max m and sum l updated, and
  // alpha = exp2((m_old - m) sscale), the rescale of what came before.
  // Invalid keys (masked, or >= Lk) score -1e30.
  template <int kJ>
  __device__ __forceinline__ void softmax(float (&sc)[4 * kJ], float (&m)[2], float (&l)[2],
                                          float (&alpha)[2], int key0) const {
    if (mask_row != nullptr || key0 + 8 * kJ > Lk) {
#pragma unroll
      for (int j = 0; j < kJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = key0 + 8 * j + 2 * t + e;
          const bool valid = key < Lk && (mask_row == nullptr || mask_row[key] != 0.f);
          if (!valid) sc[4 * j + e] = sc[4 * j + 2 + e] = kMaskBias;
        }
    }
    // max and sum of each row in four interleaved partials: short chains
    float mx[2][4], sum[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        mx[h][u] = -INFINITY;
        sum[h][u] = 0.f;
      }
#pragma unroll
    for (int j = 0; j < kJ; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        mx[h][j & 3] = fmaxf(mx[h][j & 3], fmaxf(sc[4 * j + 2 * h], sc[4 * j + 2 * h + 1]));
    float nm[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float mn = fmaxf(m[h], quad_max(fmaxf(fmaxf(mx[h][0], mx[h][1]),
                                                 fmaxf(mx[h][2], mx[h][3]))));
      alpha[h] = fast_exp2((m[h] - mn) * sscale);   // 0 on the first tile
      m[h] = mn;
      // a row that has seen no valid key keeps p = 0: x sscale - mn sscale
      // in one FMA is not 0 at x = mn = -1e30 (the product's rounding)
      nm[h] = mn <= kDeadMax ? 0.f : -mn * sscale;
    }
#pragma unroll
    for (int j = 0; j < kJ; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[4 * j + 2 * h + e];
          x = fast_exp2(fmaf(x, sscale, nm[h]));
          sum[h][j & 3] += x;
        }
#pragma unroll
    for (int h = 0; h < 2; ++h)
      l[h] = l[h] * alpha[h] + ((sum[h][0] + sum[h][1]) + (sum[h][2] + sum[h][3]));
  }
};

// The consumer groups' turns to issue products, in a ring: group wg waits
// on named barrier 2 + wg, and passes the turn by arriving on the next
// group's.  The last group hands group 0 the first turn, and group 0 takes
// the last one after its work.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(2 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg, int groups) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 + (wg + 1) % groups) : "memory");
}

// o (the 64 x 64 output accumulators) *= alpha of each row
__device__ __forceinline__ void rescale(float (&o)[32], const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      o[4 * j + 2 * h] *= alpha[h];
      o[4 * j + 2 * h + 1] *= alpha[h];
    }
}

template <bool kBf16>
__global__ void __launch_bounds__(FaCfg<kBf16>::kThreads, 1)
    flash_fwd_kernel(const __grid_constant__ FaParams p) {
  using C = FaCfg<kBf16>;
  constexpr int kN = C::kN, kStages = C::kStages, kQBufs = C::kQBufs, kQRows = C::kQRows;
  constexpr int kGroups = C::kGroups;
  constexpr int kJ = kN / 8;                       // 8-column accumulator groups of S
  extern __shared__ uint8_t fa_smem_raw[];
  char* smem = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(fa_smem_raw) + 1023) & ~(uintptr_t)1023);
  char* qbuf = smem;
  char* stages = qbuf + kQBufs * C::kQBytes;
  char* cvt = stages + kStages * C::kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(cvt + 2 * C::kCvtBytes);
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;
  uint64_t* q_empty = q_full + kQBufs;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_addr(full + s), 1);
      mbar_init(smem_addr(empty + s), 4 * kGroups);   // one arrival per consumer warp
    }
    for (int s = 0; s < kQBufs; ++s) {
      mbar_init(smem_addr(q_full + s), 1);
      mbar_init(smem_addr(q_empty + s), 4 * kGroups);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int ntiles = (p.Lk + kN - 1) / kN;

  if (threadIdx.x >= C::kConsumers) {
    // producer warpgroup: it gives its registers to the consumers (FaCfg),
    // and one thread issues every load
    if constexpr (kGroups == 3)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 32;\n" ::: "memory");
    else
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == C::kConsumers) {
      int it = 0, qi = 0;
      for (int item = blockIdx.x; item < p.items; item += gridDim.x, ++qi) {
        const int bh = item / p.qtiles, q0 = (item % p.qtiles) * kQRows;
        const int b = bh / p.H, h = bh % p.H;
        const int qs = qi % kQBufs;
        fa_wait(smem_addr(q_empty + qs), ((unsigned)(qi / kQBufs) & 1u) ^ 1u);
        const uint32_t qbar = smem_addr(q_full + qs);
        const uint32_t qdst = smem_addr(qbuf + qs * C::kQBytes);
        mbar_expect_tx(qbar, C::kQBytes);
        if constexpr (kBf16) {
          tma_load_4d(qdst, &p.q, qbar, 0, q0, h, b);
        } else {
          tma_load_4d(qdst, &p.q, qbar, 0, q0, h, b);
          tma_load_4d(qdst + C::kQBytes / 2, &p.q, qbar, 32, q0, h, b);
        }
        for (int j = 0; j < ntiles; ++j, ++it) {
          const int s = it % kStages;
          fa_wait(smem_addr(empty + s), ((unsigned)(it / kStages) & 1u) ^ 1u);
          const uint32_t bar = smem_addr(full + s);
          mbar_expect_tx(bar, C::kStageBytes);
          const uint32_t dst = smem_addr(stages + s * C::kStageBytes);
          if constexpr (kBf16) {
            tma_load_4d(dst, &p.k, bar, 0, j * kN, h, b);
            tma_load_4d(dst + C::kKVBytes, &p.v, bar, 0, j * kN, h, b);
          } else {
            constexpr int kHalf = C::kKVBytes / 2;
            tma_load_4d(dst, &p.k, bar, 0, j * kN, h, b);
            tma_load_4d(dst + kHalf, &p.k, bar, 32, j * kN, h, b);
            tma_load_4d(dst + 2 * kHalf, &p.v, bar, 0, j * kN, h, b);
            tma_load_4d(dst + 3 * kHalf, &p.v, bar, 32, j * kN, h, b);
          }
        }
      }
    }
    return;
  }

  if constexpr (kGroups == 3)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 160;\n" ::: "memory");
  else
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  // consumers: group wg owns rows 64 wg .. 64 wg + 63 of the item's tile;
  // a thread's accumulators 4 j + 2 h + e sit at row 16 warp + g + 8 h,
  // column 8 j + 2 t + e
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  // one arrival per warp on the release barriers, after all its lanes
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_addr(bar));
  };
  // the item's softmax state: the mask and scale of its batch row
  auto rows_of = [&](int item) {
    const int b = item / p.qtiles / p.H;
    return Rows{p.mask != nullptr ? p.mask + (size_t)b * p.Lk : nullptr, p.Lk,
                kBf16 ? p.qscale : 1.f, t};   // f32 folds the scale into Q
  };
  // o / l into the item's rows (0 where no key was valid); every lane
  // takes part (the row sums' shuffles)
  auto store = [&](const float (&o)[32], const float (&m)[2], const float (&l)[2], int item) {
    const int bh = item / p.qtiles, q0 = (item % p.qtiles) * kQRows;
    const int b = bh / p.H, h = bh % p.H;
    const int r0 = q0 + 64 * wg + 16 * warp + g;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float lsum = quad_sum(l[hh]);
      const int row = r0 + 8 * hh;
      if (row >= p.Lq) continue;
      const float inv = m[hh] <= kDeadMax ? 0.f : 1.f / lsum;
      const size_t base = (size_t)b * p.so_b + (size_t)h * p.so_h + (size_t)row * p.so_l + 2 * t;
#pragma unroll
      for (int jd = 0; jd < 8; ++jd) {
        const float x0 = o[4 * jd + 2 * hh] * inv, x1 = o[4 * jd + 2 * hh + 1] * inv;
        const size_t at = base + 8 * jd;
        if constexpr (kBf16)
          *reinterpret_cast<unsigned*>(static_cast<bf16*>(p.o) + at) = pack_bf16x2(x0, x1);
        else
          *reinterpret_cast<float2*>(static_cast<float*>(p.o) + at) = make_float2(x0, x1);
      }
    }
  };
  const int nitems = (p.items - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  float o[32], m[2], l[2], alpha[2];

  if constexpr (kBf16) {
    auto stage = [&](int u) { return stages + (u % kStages) * C::kStageBytes; };
    auto to_bf16 = [](const float (&sc)[4 * kJ], unsigned (&pa)[kN / 16][4]) {
#pragma unroll
      for (int c = 0; c < kN / 16; ++c)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[c][r] = pack_bf16x2(sc[8 * c + 2 * r], sc[8 * c + 2 * r + 1]);
    };
    // a last tile with at most kN / 2 keys: its softmax and P V stop there
    const bool half_tail = ntiles > 1 && p.Lk - (ntiles - 1) * kN <= kN / 2;
    if (wg == kGroups - 1) turn_pass(wg, kGroups);
    int it = 0;
    for (int k = 0; k < nitems; ++k) {
      const int item = blockIdx.x + k * gridDim.x;
      const Rows rows = rows_of(item);
      fa_wait(smem_addr(q_full + (k & 1)), (unsigned)(k >> 1) & 1u);
      // the group's 64 rows of 128 bytes
      const uint32_t qa = smem_addr(qbuf + (k & 1) * C::kQBytes + wg * 64 * 128);
      auto issue_s = [&](float (&sc)[4 * kJ], int u) {
        fa_wait(smem_addr(full + u % kStages), (unsigned)(u / kStages) & 1u);
        const uint32_t ka = smem_addr(stage(u));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_bf16(sc, sw128_desc(qa + 32 * kk), sw128_desc(ka + 32 * kk), kk);
        wg_commit();
      };
      auto issue_pv = [&](const unsigned (&pa)[kN / 16][4], int u, bool half) {
        const uint32_t va = smem_addr(stage(u) + C::kKVBytes);
#pragma unroll
        for (int c = 0; c < kN / 32; ++c) wgmma_bf16_rs_tb(o, pa[c], sw128_desc(va + 2048 * c));
        if (!half) {
#pragma unroll
          for (int c = kN / 32; c < kN / 16; ++c)
            wgmma_bf16_rs_tb(o, pa[c], sw128_desc(va + 2048 * c));
        }
        wg_commit();
      };
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] = 0.f;
      m[0] = m[1] = -INFINITY;
      l[0] = l[1] = 0.f;
      float sc[4 * kJ];
      unsigned pa[kN / 16][4];
      for (int j = 0; j < ntiles; ++j, ++it) {
        turn_wait(wg);
        wg_fence();
        issue_s(sc, it);
        turn_pass(wg, kGroups);
        wg_wait<0>();
        if (j + 1 == ntiles) release(q_empty + (k & 1));
        if (j + 1 == ntiles && half_tail)
          rows.softmax<kJ / 2>(reinterpret_cast<float(&)[2 * kJ]>(sc), m, l, alpha, j * kN);
        else
          rows.softmax<kJ>(sc, m, l, alpha, j * kN);
        to_bf16(sc, pa);
        rescale(o, alpha);
        wg_fence();
        issue_pv(pa, it, j + 1 == ntiles && half_tail);
        wg_wait<0>();
        release(empty + it % kStages);
      }
      store(o, m, l, item);
    }
    if (wg == 0) turn_wait(wg);
  } else {
    int it = 0;
    for (int k = 0; k < nitems; ++k) {
      const int item = blockIdx.x + k * gridDim.x;
      const Rows rows = rows_of(item);
      fa_wait(smem_addr(q_full), (unsigned)k & 1u);
      // q's A fragments (big, small) per 8-channel k-step, scaled
      unsigned qb[8][4], qsm[8][4];
#pragma unroll
      for (int s8 = 0; s8 < 8; ++s8)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = 64 * wg + 16 * warp + g + 8 * (i & 1);
          const int dc = 8 * (s8 & 3) + t + 4 * (i >> 1);
          const float x = *reinterpret_cast<const float*>(
                              qbuf + (s8 >> 2) * (C::kQBytes / 2) + row * 128 +
                              (((dc >> 2) ^ (row & 7)) << 4) + (dc & 3) * 4) *
                          p.qscale;
          const float big = tf32_rna(x);
          qb[s8][i] = __float_as_uint(big);
          qsm[s8][i] = __float_as_uint(tf32_rna(x - big));
        }
      release(q_empty);
      // tile i converted by both groups into buffer i mod 2
      auto convert = [&](int i) {
        const int si = i % kStages;
        fa_wait(smem_addr(full + si), (unsigned)(i / kStages) & 1u);
        convert_kv(stages + si * C::kStageBytes, cvt + (i & 1) * C::kCvtBytes, threadIdx.x);
        release(empty + si);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      };
      auto desc = [](uint32_t base, int k8) {   // k-step k8 of a converted tile
        return sw128_desc(base + (k8 >> 2) * (C::kKVBytes / 2) + 32 * (k8 & 3));
      };
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] = 0.f;
      m[0] = m[1] = -INFINITY;
      l[0] = l[1] = 0.f;
      convert(it);
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
      for (int j = 0; j < ntiles; ++j, ++it) {
        const char* cv = cvt + (it & 1) * C::kCvtBytes;
        // ---- S = Q K^T: small cross terms first, summed from zero
        float sc[32];
        const uint32_t kb = smem_addr(cv), ks = smem_addr(cv + C::kKVBytes);
        wg_fence();
#pragma unroll
        for (int k8 = 0; k8 < 8; ++k8) {
          wgmma_tf32_rs(sc, qsm[k8], desc(kb, k8), k8);
          wgmma_tf32_rs(sc, qb[k8], desc(ks, k8), 1);
        }
#pragma unroll
        for (int k8 = 0; k8 < 8; ++k8) wgmma_tf32_rs(sc, qb[k8], desc(kb, k8), 1);
        wg_commit();
        if (j + 1 < ntiles) convert(it + 1);   // while these products run
        wg_wait<0>();
        rows.softmax<kJ>(sc, m, l, alpha, j * kN);
        rescale(o, alpha);
        // ---- O += P V: p's A fragment of keys 8 c ..: accumulators
        // 4 c + {0, 2, 1, 3}; the tile's sum from zero, then a rounded add
        unsigned pb[8][4], ps[8][4];
#pragma unroll
        for (int c = 0; c < 8; ++c)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float x = sc[4 * c + ((r & 1) << 1) + (r >> 1)];
            const float big = tf32_rna(x);
            pb[c][r] = __float_as_uint(big);
            ps[c][r] = __float_as_uint(tf32_rna(x - big));
          }
        const uint32_t vb = smem_addr(cv + 2 * C::kKVBytes), vs = smem_addr(cv + 3 * C::kKVBytes);
        float part[32];
        wg_fence();
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          wgmma_tf32_rs(part, ps[c], desc(vb, c), c);
          wgmma_tf32_rs(part, pb[c], desc(vs, c), 1);
        }
#pragma unroll
        for (int c = 0; c < 8; ++c) wgmma_tf32_rs(part, pb[c], desc(vb, c), 1);
        wg_commit();
        wg_wait<0>();
#pragma unroll
        for (int i = 0; i < 32; ++i) o[i] += part[i];
        // both groups are done with tile j's converted buffer and have
        // converted tile j + 1
        asm volatile("bar.sync 1, 256;\n" ::: "memory");
      }
      store(o, m, l, item);
    }
  }
}

// A rank-4 map (channel, row, head, batch) of one of q, k, v with a box of
// `rows` rows and the 128-byte swizzle (64 bf16 or 32 float32 channels).
bool encode_qkv(CUtensorMap* map, bool is_bf16, const void* ptr, int B, int H, int L,
                long long sb, long long sh, long long sl, int rows) {
  TensorMapEncodeFn enc = tensor_map_encoder();
  if (enc == nullptr) return false;
  const int es = is_bf16 ? 2 : 4;
  const cuuint64_t dims[4] = {(cuuint64_t)kHeadDim, (cuuint64_t)L, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sl * es, (cuuint64_t)sh * es, (cuuint64_t)sb * es};
  const cuuint32_t box[4] = {(cuuint32_t)(128 / es), (cuuint32_t)rows, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return enc(map, is_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
             4, const_cast<void*>(ptr), dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// Once per device, before the first launch on it: lets both instantiations
// take their dynamic shared memory.  Returns the first CUDA error (0 = ok).
extern "C" int mgsv_flash_attention_init() {
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(flash_fwd_kernel<false>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)FaCfg<false>::kSmem)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(flash_fwd_kernel<true>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)FaCfg<true>::kSmem)) != cudaSuccess)
    return (int)err;
  return 0;
}

// o = attention(q, k, v) on `stream`, after mgsv_flash_attention_init on
// that device.  dtype 0 = float32, 1 = bfloat16 (q, k, v and o alike).
// Strides are in elements, for the [B, H, L, Dh] index order; the head
// dimension (Dh = 64) must be contiguous, every base and stride 16-byte
// aligned.  mask is a float32 [B, Lk] tensor (1 = valid) or null.  Returns
// the launch's CUDA error (0 = ok; cudaErrorInvalidValue when a TMA map of
// q, k or v fails to encode).
extern "C" int mgsv_flash_attention_fwd(
    int dtype, const void* q, const void* k, const void* v, const float* mask, void* o,
    long long sq_b, long long sq_h, long long sq_l, long long sk_b, long long sk_h,
    long long sk_l, long long sv_b, long long sv_h, long long sv_l, long long so_b,
    long long so_h, long long so_l, int B, int H, int Lq, int Lk, int Dh, float qscale,
    void* stream) {
  if (Dh != kHeadDim || B < 1 || H < 1 || Lq < 1 || Lk < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const bool is_bf16 = dtype == 1;
  FaParams p;
  const int kv_rows = is_bf16 ? FaCfg<true>::kN : FaCfg<false>::kN;
  const int q_rows = is_bf16 ? FaCfg<true>::kQRows : FaCfg<false>::kQRows;
  if (!encode_qkv(&p.q, is_bf16, q, B, H, Lq, sq_b, sq_h, sq_l, q_rows) ||
      !encode_qkv(&p.k, is_bf16, k, B, H, Lk, sk_b, sk_h, sk_l, kv_rows) ||
      !encode_qkv(&p.v, is_bf16, v, B, H, Lk, sv_b, sv_h, sv_l, kv_rows))
    return (int)cudaErrorInvalidValue;
  p.mask = mask;
  p.o = o;
  p.so_b = so_b;
  p.so_h = so_h;
  p.so_l = so_l;
  p.H = H;
  p.Lq = Lq;
  p.Lk = Lk;
  p.qtiles = (Lq + q_rows - 1) / q_rows;
  const long long items = (long long)B * H * p.qtiles;
  if (items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  p.items = (int)items;
  p.qscale = qscale;
  // the device's SM count, once per device: the persistent grid
  static int sm_count[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (sm_count[dev] == 0 &&
      (err = cudaDeviceGetAttribute(&sm_count[dev], cudaDevAttrMultiProcessorCount, dev)) !=
          cudaSuccess)
    return (int)err;
  const unsigned grid = (unsigned)std::min<long long>(items, sm_count[dev]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    flash_fwd_kernel<true><<<grid, FaCfg<true>::kThreads, FaCfg<true>::kSmem, s>>>(p);
  else
    flash_fwd_kernel<false><<<grid, FaCfg<false>::kThreads, FaCfg<false>::kSmem, s>>>(p);
  return (int)cudaGetLastError();
}
