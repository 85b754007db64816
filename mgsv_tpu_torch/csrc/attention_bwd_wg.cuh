// The float32 attention backward of kernel #5's backward on wgmma, for the
// temporal towers' short sequences (L <= kWgaMaxL: the audio tower's 96
// snippets and the video tower's 50 frames).
//
// Per (head h, batch row b), from the forward's q, k, v (qkv [B, L, 3D]),
// its ctx and softmax statistics (max, sum) [B, H, L], and dctx [B, L, D],
// it writes dq | dk | dv into dqkv [B, L, 3D]:
//
//   p_ij = exp(s_ij - max_i) / sum_i,  s_ij = q_i . k_j / sqrt(32) (masked
//          key: -1e9),  m_ij the dropout mask of site h (element i L + j)
//   D_i  = dctx_i . ctx_i  (= sum_j p_ij m_ij dp_ij, dp_ij = dctx_i . v_j)
//   ds_ij = p_ij (dp_ij m_ij - D_i), 0 at masked keys (their scores are
//          constants)
//   dq_i = sum_j ds_ij k_j / sqrt(32),  dk_j = sum_i ds_ij q_i / sqrt(32),
//   dv_j = sum_i p_ij m_ij dctx_i.
//
// What bounds it: at B=512, L=96, H=8 the five [L, L, 32] products are
// 12.1 GFLOP, 36 GFLOP of tf32 products at float32 accuracy (3xTF32),
// 0.073 ms at the TF32 rate, against some 400 MB of inputs and outputs
// (q, k, v, dctx, ctx, dqkv), 0.12 ms at the memory's rate: the bytes.  The
// design, against the mma.sync kernel it replaces here
// (layer_bwd_kernels.cuh::attention_bwd_tc_kernel, which stays for longer
// sequences, for #2 and for #6's self-attention):
//
//  * The products run on wgmma m64n32k8 (tf32), 64 query (or key) rows a
//    warpgroup against chunks of 32 keys (or queries), in 3xTF32: each
//    staged value is split once into its big and small tf32 halves in
//    shared memory (128-byte-swizzled rows of 32 floats, wgmma_gemm.cuh's
//    tiles), not at every fragment load.  The statistics come from the
//    forward, so the chunks need no online softmax, and the two sweeps
//    (query rows for dq; key rows for dk and dv: each sum has one owner, no
//    atomics) are independent: the two consumer warpgroups run them side by
//    side.
//  * The second product of each sweep takes ds (or p m) as its A operand
//    straight from the first product's accumulators, in registers: a C
//    fragment's columns 2t, 2t + 1 stand at k t, t + 4 of the A fragment,
//    so the B tiles (k, q and dctx transposed, channels by positions) hold
//    the positions of each group of eight in the order 0 2 4 6 1 3 5 7.
//  * A block walks a run of (batch row, head) items, heads of one batch row
//    in turn.  While the warpgroups compute one item, a producer warp loads
//    the next one's q, k, v and dctx rows (four [L, 32] boxes) by TMA and
//    prepares its rows: the key mask, the forward's statistics, D_i, and
//    the dropout mask, drawn once per item into bits in shared memory.  The
//    warpgroups' own share of an item is the tf32 split of its boxes.
#pragma once

namespace {

constexpr int kWgaMaxL = 96;          // longest sequence taken (shared memory)
constexpr int kWgaThreads = 288;      // two consumer warpgroups and a producer warp

// Rows of one head tile: L rounded up to a 32-row chunk.  A warpgroup's
// 64-row operand may reach past them into the next tile of the layout,
// which holds finite values; those rows' results are never written.
__host__ __device__ constexpr int wga_rows(int L) { return (L + 31) & ~31; }
// rows of one staged (raw) box: L rounded up to 8 (1024-byte aligned)
__host__ __device__ constexpr int wga_raw_rows(int L) { return (L + 7) & ~7; }
// 64-row tiles of the M side
__host__ __device__ constexpr int wga_mtiles(int L) { return (L + 63) / 64; }

// An item's rows as the sweeps read them: the key mask (-1 past L, 64-row
// tiles' worth), each query row's softmax max, 1 / sum and D, and the
// dropout mask of weight e = i L + j as bit e mod 4 of byte e / 4.
struct WgaPrep {
  float *msk, *mx, *il, *dd;
  unsigned char* keep;
};

// The layout of one block's dynamic shared memory, in bytes from a
// 1024-byte-aligned base: 14 head tiles of R rows x 128 bytes (q, k, v,
// dctx as rows of 32 channels, then k, q, dctx transposed: 32 channel rows
// per chunk of 32 positions; each big, then small), four raw boxes, two
// WgaPrep (this item's and the next one's), and two mbarriers.
struct WgaLayout {
  int R, Rm;
  size_t tile, raw, prep, prep_bytes, bar, bytes;
  __host__ __device__ explicit WgaLayout(int L) : R(wga_rows(L)), Rm(64 * wga_mtiles(L)) {
    tile = (size_t)R * 128;
    raw = 14 * tile;
    prep = raw + 4 * (size_t)wga_raw_rows(L) * 128;
    prep_bytes = 4 * ((size_t)Rm + 3 * R) + (((size_t)L * L / 4 + 1 + 15) & ~(size_t)15);
    bar = prep + 2 * prep_bytes;
    bytes = bar + 16 + 1024;   // + the base's alignment
  }
  __device__ WgaPrep prep_of(char* sm, int k) const {
    char* base = sm + prep + k * prep_bytes;
    float* f = reinterpret_cast<float*>(base);
    return {f, f + Rm, f + Rm + R, f + Rm + 2 * R,
            reinterpret_cast<unsigned char*>(f + Rm + 3 * R)};
  }
};

// head tiles of the layout: natural X[row][channel] and transposed
// Xt[channel][position], each big then small
enum : int { kWgaQ = 0, kWgaK = 2, kWgaV = 4, kWgaO = 6, kWgaKt = 8, kWgaQt = 10, kWgaOt = 12 };

// wgmma m64n32k8 tf32, A and B from shared memory; d = A.B^T (+ d)
__device__ __forceinline__ void wgmma_n32_ss(float (&d)[16], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// the same with A from registers (tf32 bits, m16n8k8's fragment per warp)
__device__ __forceinline__ void wgmma_n32_rs(float (&d)[16], const unsigned (&a)[4], uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// Keeps the compiler from moving reads of wgmma results above the wait.
__device__ __forceinline__ void wga_pin(float (&d)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// Keeps A fragments live, unchanged, until the wait before it.
__device__ __forceinline__ void wga_pin(unsigned (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(a[i / 4][i % 4])::"memory");
}

// desc of rows [row0, row0 + 64) (A) or [row0, row0 + 32) (B) of a tile,
// k-step kk (8 floats = 32 bytes of each 128-byte row)
__device__ __forceinline__ uint64_t wga_desc(const char* tile, int row0, int kk) {
  return wg_desc(smem_addr(tile + (size_t)row0 * 128 + 32 * kk), 1024, 1);
}

// s = X[row0 .. +64) . Y[col0 .. +32)^T and dp = X2[..] . Y2[..]^T over the
// 32 channels, in 3xTF32 (small.big and big.small first, then big.big, all
// from zero), the two sums' wgmma taking turns
__device__ __forceinline__ void wga_dots(float (&s)[16], float (&dp)[16], const char* xb,
                                         const char* xs, const char* yb, const char* ys,
                                         const char* x2b, const char* x2s, const char* y2b,
                                         const char* y2s, int row0, int col0) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_n32_ss(s, wga_desc(xs, row0, kk), wga_desc(yb, col0, kk), kk);
    wgmma_n32_ss(dp, wga_desc(x2s, row0, kk), wga_desc(y2b, col0, kk), kk);
    wgmma_n32_ss(s, wga_desc(xb, row0, kk), wga_desc(ys, col0, kk), 1);
    wgmma_n32_ss(dp, wga_desc(x2b, row0, kk), wga_desc(y2s, col0, kk), 1);
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_n32_ss(s, wga_desc(xb, row0, kk), wga_desc(yb, col0, kk), 1);
    wgmma_n32_ss(dp, wga_desc(x2b, row0, kk), wga_desc(y2b, col0, kk), 1);
  }
}

// acc (+)= x . Yt_chunk over its 32 positions (the chunk's B tiles big yb,
// small ys; with `more` 0 acc starts from zero), x the C fragments of a
// 64 x 32 accumulator turned into A fragments: k-step j takes columns
// 8 j .. 8 j + 7, 2 t and 2 t + 1 standing at k t and t + 4 (the B tiles'
// permuted positions), split into ah, al.  Issued only: the caller commits,
// waits, and keeps ah and al unchanged until then.
__device__ __forceinline__ void wga_acc(float (&acc)[16], const float (&x)[16], const char* yb,
                                        const char* ys, unsigned (&ah)[4][4],
                                        unsigned (&al)[4][4], int more) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    split_tf32(x[4 * j], ah[j][0], al[j][0]);
    split_tf32(x[4 * j + 2], ah[j][1], al[j][1]);
    split_tf32(x[4 * j + 1], ah[j][2], al[j][2]);
    split_tf32(x[4 * j + 3], ah[j][3], al[j][3]);
  }
  wg_fence();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    wgmma_n32_rs(acc, al[j], wga_desc(yb, 0, j), j > 0 || more);
    wgmma_n32_rs(acc, ah[j], wga_desc(ys, 0, j), 1);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) wgmma_n32_rs(acc, ah[j], wga_desc(yb, 0, j), 1);
}

struct WgaParams {
  CUtensorMap qkv_map, dctx_map;   // [B L][3D] and [B L][D], boxes of 32 channels x L rows
  const float* dctx;            // [B, L, D]
  const float* mask;            // [B, L] (1 = valid)
  const float* ctx;             // [B, L, D]
  const float2* stats;          // [B, H, L]
  float* dqkv;                  // [B, L, 3D]
  int B, H, L;
  Dropout drop;
};

// One 64-row tile of a sweep: rows m0 .. m0 + 63 of X (queries: q, keys:
// k) and of X2 (dctx, or v) against chunks of 32 columns of Y (k, or q) and
// Y2 (v, or dctx): s = X Y^T and dp = X2 Y2^T per chunk, then the second
// products from registers: queries acc1 += ds . k (dq); keys acc1 += ds^T . q
// (dk) and acc2 += (p m)^T . dctx (dv).  kQueries is a compile-time
// argument, so every wgmma sits on a path all of the warpgroup takes; the
// register budget (168 a thread: ptxas counts the block in whole
// warpgroups) keeps one chunk's products in flight at a time.
template <bool kQueries>
__device__ __forceinline__ void wga_tile(char* const* tiles, int m0, int R, int L, int r0, int t,
                                         const WgaPrep& q, const Dropout& drop,
                                         float (&acc1)[16], float (&acc2)[16]) {
  const float scale = 1.0f / sqrtf((float)kHeadDim);
  const int x = kQueries ? kWgaQ : kWgaK, x2 = kQueries ? kWgaO : kWgaV;
  const int y = kQueries ? kWgaK : kWgaQ, y2 = kQueries ? kWgaV : kWgaO;
  for (int c0 = 0; c0 < R; c0 += 32) {
    float s[16], dp[16];
    wg_fence();
    wga_dots(s, dp, tiles[x], tiles[x + 1], tiles[y], tiles[y + 1], tiles[x2], tiles[x2 + 1],
             tiles[y2], tiles[y2 + 1], m0, c0);
    wg_commit();
    wg_wait_all();
    wga_pin(s);
    wga_pin(dp);
    // accumulator 4 j + 2 hh + e: row r0 + 8 hh, column c0 + 8 j + 2 t + e
    float ds[16], pm[16];
#pragma unroll
    for (int a = 0; a < 16; ++a) {
      const int rr = r0 + 8 * ((a >> 1) & 1), cc = c0 + 8 * (a >> 2) + 2 * t + (a & 1);
      const int i = kQueries ? rr : cc, j = kQueries ? cc : rr;   // query, key
      const float m = q.msk[j];
      float pv = 0.f, dv = 0.f;
      if (m >= 0.f && i < L) {
        const float pr = expf((m != 0.f ? s[a] * scale : kBigNeg) - q.mx[i]) * q.il[i];
        const int e = i * L + j;
        const float k = drop.thresh == 0u ? 1.f
                        : (q.keep[e >> 2] >> (e & 3)) & 1u ? drop.scale : 0.f;
        pv = pr * k;
        if (m != 0.f) dv = pr * (dp[a] * k - q.dd[i]);
      }
      pm[a] = pv;
      ds[a] = dv;
    }
    const size_t cb = (size_t)(c0 / 32) * 4096;
    const int more = c0 > 0;     // the first chunk starts the sums from zero
    unsigned ah[4][4], al[4][4];
    if constexpr (!kQueries) {
      wga_acc(acc2, pm, tiles[kWgaOt] + cb, tiles[kWgaOt + 1] + cb, ah, al, more);
      wg_commit();
      wg_wait_all();
      wga_pin(ah);
      wga_pin(al);
    }
    const int yt = kQueries ? kWgaKt : kWgaQt;
    wga_acc(acc1, ds, tiles[yt] + cb, tiles[yt + 1] + cb, ah, al, more);
    wg_commit();
    wg_wait_all();
    wga_pin(ah);
    wga_pin(al);
  }
  wga_pin(acc1);
  wga_pin(acc2);
}

__global__ void __launch_bounds__(kWgaThreads, 1)
attention_bwd_wg_kernel(const __grid_constant__ WgaParams p) {
  extern __shared__ uint8_t wga_smem_raw[];
  char* sm = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(wga_smem_raw) + 1023) & ~(uintptr_t)1023);
  const int L = p.L, H = p.H;
  const WgaLayout lay(L);
  const int R = lay.R;
  char* tiles[14];
#pragma unroll
  for (int i = 0; i < 14; ++i) tiles[i] = sm + i * lay.tile;
  char* raw = sm + lay.raw;
  const size_t raw_box = (size_t)wga_raw_rows(L) * 128;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + lay.bar);
  uint64_t* empty = full + 1;
  // this block's run of items (b, h), h fastest
  const int items = p.B * H;
  const int first = (int)((long)blockIdx.x * items / gridDim.x);
  const int last = (int)((long)(blockIdx.x + 1) * items / gridDim.x);
  // the warp's index, the same in all its lanes as the compiler sees it
  // (so the wgmma below sit on paths each warpgroup takes whole)
  const int warp_id = __shfl_sync(0xffffffffu, (int)threadIdx.x / 32, 0);
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(smem_addr(full), 33);     // the producer's expect_tx and its 32 lanes
    mbar_init(smem_addr(empty), 256);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // every tile row the products may read holds a finite value
  for (size_t e = threadIdx.x; e < lay.raw / 16; e += blockDim.x)
    reinterpret_cast<float4*>(sm)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  if (warp_id == 8) {
    // producer warp: item n's boxes by TMA, and its WgaPrep (n mod 2)
    // drawn here, while the warpgroups compute item n - 1; it starts once
    // they have staged item n - 1 (so item n - 2's sweeps are done)
    for (int it = first; it < last; ++it) {
      const int b = it / H, h = it % H, n = it - first;
      const size_t row0 = (size_t)b * L;
      mbar_wait(smem_addr(empty), ((unsigned)n & 1u) ^ 1u);
      if (lane == 0) {
        const uint32_t bar = smem_addr(full);
        mbar_expect_tx(bar, 4u * L * 128u);
        const int row = b * L;
        tma_load_3d(smem_addr(raw), &p.qkv_map, bar, h * kHeadDim, row, 0);
        tma_load_3d(smem_addr(raw + raw_box), &p.qkv_map, bar, kCols + h * kHeadDim, row, 0);
        tma_load_3d(smem_addr(raw + 2 * raw_box), &p.qkv_map, bar, 2 * kCols + h * kHeadDim, row,
                    0);
        tma_load_3d(smem_addr(raw + 3 * raw_box), &p.dctx_map, bar, h * kHeadDim, row, 0);
      }
      const WgaPrep q = lay.prep_of(sm, n & 1);
      for (int j = lane; j < lay.Rm; j += 32) q.msk[j] = j < L ? p.mask[row0 + j] : -1.f;
      for (int i = lane; i < R; i += 32) {
        float2 st = make_float2(0.f, 1.f);
        float d = 0.f;
        if (i < L) {
          st = p.stats[((size_t)b * H + h) * L + i];
          const float4* a = reinterpret_cast<const float4*>(p.dctx + (row0 + i) * kCols +
                                                            h * kHeadDim);
          const float4* c = reinterpret_cast<const float4*>(p.ctx + (row0 + i) * kCols +
                                                            h * kHeadDim);
#pragma unroll
          for (int u = 0; u < kHeadDim / 4; ++u) {      // D_i = dctx_i . ctx_i
            const float4 x = a[u], y = c[u];
            d = fmaf(x.x, y.x, d);
            d = fmaf(x.y, y.y, d);
            d = fmaf(x.z, y.z, d);
            d = fmaf(x.w, y.w, d);
          }
        }
        q.mx[i] = st.x;
        q.il[i] = 1.f / st.y;
        q.dd[i] = d;
      }
      if (p.drop.thresh != 0u)
        for (int g4 = lane; g4 < (L * L + 3) / 4; g4 += 32) {
          const uint4 w = philox4(p.drop.seed, b, h, g4);
          q.keep[g4] = (unsigned char)((w.x >= p.drop.thresh ? 1u : 0u) |
                                       (w.y >= p.drop.thresh ? 2u : 0u) |
                                       (w.z >= p.drop.thresh ? 4u : 0u) |
                                       (w.w >= p.drop.thresh ? 8u : 0u));
        }
      mbar_arrive(smem_addr(full));
    }
    return;
  }

  const int tid = threadIdx.x, wg = warp_id / 4, warp = warp_id % 4;
  const int g = lane >> 2, t = lane & 3;
  // value (row r, channel c) of raw box x, TMA's 128-byte swizzle
  auto raw_at = [&](int x, int r, int c) {
    return *reinterpret_cast<const float*>(raw + x * raw_box + r * 128 +
                                           (((c >> 2) ^ (r & 7)) << 4) + (c & 3) * 4);
  };

  for (int it = first; it < last; ++it) {
    const int b = it / H, h = it % H, n = it - first;
    const size_t row0 = (size_t)b * L;
    mbar_wait_bounded(smem_addr(full), (unsigned)n & 1u);

    // ---- stage: split the boxes into tf32 halves (the head tiles share
    // the boxes' swizzle, so each 16 bytes keeps its place), and the
    // transposes, a warp per position row, positions permuted in each
    // group of eight (0 2 4 6 1 3 5 7)
#pragma unroll 4
    for (int e = tid; e < 4 * L * 8; e += 256) {
      const int x = e / (L * 8), o = 16 * (e % (L * 8));
      const float4 v = *reinterpret_cast<const float4*>(raw + x * raw_box + o);
      const float4 big = make_float4(tf32_rna(v.x), tf32_rna(v.y), tf32_rna(v.z), tf32_rna(v.w));
      *reinterpret_cast<float4*>(tiles[2 * x] + o) = big;
      *reinterpret_cast<float4*>(tiles[2 * x + 1] + o) =
          make_float4(tf32_rna(v.x - big.x), tf32_rna(v.y - big.y), tf32_rna(v.z - big.z),
                      tf32_rna(v.w - big.w));
    }
#pragma unroll 3
    for (int e = tid; e < 3 * kHeadDim * (R / 4); e += 256) {
      const int ch = e % kHeadDim, q4 = (e / kHeadDim) % (R / 4), x = e / (kHeadDim * (R / 4));
      const int src = x == 0 ? 1 : x == 1 ? 0 : 3;          // Kt <- k, Qt <- q, Ot <- dctx
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int pos = 4 * q4 + u, k8 = pos & 7;
        const int r = (pos & ~7) + (k8 < 4 ? 2 * k8 : 2 * (k8 - 4) + 1);
        v[u] = r < L ? raw_at(src, r, ch) : 0.f;
      }
      const size_t cb = (size_t)(q4 / 8) * 4096;
      put_operand<false>(tiles[kWgaKt + 2 * x] + cb, tiles[kWgaKt + 2 * x + 1] + cb, ch, q4 % 8,
                         make_float4(v[0], v[1], v[2], v[3]));
    }
    mbar_arrive(smem_addr(empty));      // the boxes are read: the next item's may load
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, 256;\n" ::: "memory");

    // ---- the sweeps: of units u < 2T, warpgroup wg takes u = wg, wg + 2,
    // ...: u < T the query tile u (dq), else the key tile u - T (dk, dv)
    const WgaPrep q = lay.prep_of(sm, n & 1);
    const int T = wga_mtiles(L);
    for (int u = wg; u < 2 * T; u += 2) {
      const int m0 = 64 * (u < T ? u : u - T), r0 = m0 + 16 * warp + g;
      float acc1[16], acc2[16];
      if (u < T)
        wga_tile<true>(tiles, m0, R, L, r0, t, q, p.drop, acc1, acc2);
      else
        wga_tile<false>(tiles, m0, R, L, r0, t, q, p.drop, acc1, acc2);
      // rows r0, r0 + 8: dq (query tile) or dk, dv (key tile), channels 8 j + 2 t
      const float scale = 1.0f / sqrtf((float)kHeadDim);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = r0 + 8 * hh;
        if (r >= L) continue;
        float* out = p.dqkv + (row0 + r) * 3 * kCols + h * kHeadDim + 2 * t;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 v1 = make_float2(acc1[4 * j + 2 * hh] * scale,
                                        acc1[4 * j + 2 * hh + 1] * scale);
          if (u < T) {
            *reinterpret_cast<float2*>(out + 8 * j) = v1;
          } else {
            *reinterpret_cast<float2*>(out + kCols + 8 * j) = v1;
            *reinterpret_cast<float2*>(out + 2 * kCols + 8 * j) =
                make_float2(acc2[4 * j + 2 * hh], acc2[4 * j + 2 * hh + 1]);
          }
        }
      }
    }
    // both warpgroups' products of this item are done before the tiles change
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
  }
}

// The dynamic shared memory of attention_bwd_wg_kernel, for every L it takes.
inline cudaError_t attention_bwd_wg_init() {
  return cudaFuncSetAttribute(attention_bwd_wg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)WgaLayout(kWgaMaxL).bytes);
}

// Launches the kernel over B rows of L <= kWgaMaxL on `s`: one block per SM
// (or per item, if fewer), each a run of items.  Returns the launch's error.
inline cudaError_t launch_attention_bwd_wg(const float* qkv, const float* dctx, const float* mask,
                                           const float* ctx, const float2* stats, float* dqkv,
                                           int B, int H, int L, const Dropout& drop,
                                           cudaStream_t s) {
  WgaParams p;
  const Operand q{qkv, 3 * kCols, B * L, 3 * kCols}, d{dctx, kCols, B * L, kCols};
  if (!encode_map(&p.qkv_map, q, kHeadDim, L, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_map(&p.dctx_map, d, kHeadDim, L, CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  p.dctx = dctx;
  p.mask = mask;
  p.ctx = ctx;
  p.stats = stats;
  p.dqkv = dqkv;
  p.B = B;
  p.H = H;
  p.L = L;
  p.drop = drop;
  static int sm_count[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= 64) return err != cudaSuccess ? err : cudaErrorInvalidDevice;
  if (!sm_count[dev] &&
      (err = cudaDeviceGetAttribute(&sm_count[dev], cudaDevAttrMultiProcessorCount, dev)) !=
          cudaSuccess)
    return err;
  const int grid = std::min(B * H, sm_count[dev]);
  attention_bwd_wg_kernel<<<grid, kWgaThreads, WgaLayout(L).bytes, s>>>(p);
  return cudaGetLastError();
}

}  // namespace
