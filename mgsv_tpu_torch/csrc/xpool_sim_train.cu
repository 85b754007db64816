// X-Pool pooled cosine similarity for Hopper (sm_90a): the training
// forward and backward, and the evaluation forward.
//
// Replaces the Pallas TPU kernels of mgsv_tpu/ops/pallas/xpool_sim_vjp.py:
// _core_fwd (kernel _fwd_kernel) and _core_bwd (kernel _bwd_kernel), the
// custom VJP of _xpool_core; and of mgsv_tpu/ops/pallas/xpool_sim.py:
// xpool_sim_fused (kernel _xpool_sim_kernel), the corpus similarity of an
// evaluation, which is the same forward at dropout rate 0 (mgsv_xpool_sim_fwd
// with threshold 0 launches xpool_pair_kernel<false>, which has no dropout
// code compiled in).  For every (music m, video v) pair the pair stage
// (_pair_stage_fwd) computes
//
//   p    = softmax_s(q_v . k_m[s] / sqrt(D), masked snippets -> -1e9)   [S]
//   h    = LN2(p v_m Wout^T + bout)
//   o    = LN3(h + drop_(m,v)(h Wlin^T + blin))
//   sim  = <o / |o|, vhat_v>
//
// with weights in torch's [out, in] layout and the dropout mask of pair
// (m, v), channel d drawn from philox.cuh (stream (m, v), element d).
//
// What bounds it on the card: the arithmetic.  Wout acts linearly on a
// softmax-weighted sum before bout and LN2, so Wout (sum_s p_s v_ms) + bout
// = sum_s p_s u_ms + bout with u_m = v_m Wout^T: Wout is needed once per
// snippet of each track, not once per pair.  The least work is then, per
// pair, the scores and p u_m (4 S D), Wlin (2 D^2) and the cosine, plus
// 2 S D^2 per track: 66.7 GFLOP at V = M = 512, S = 96 (training) and 990
// GFLOP at V = M = 2,048 (an evaluation), 0.135 and 2.0 ms at the TF32
// rate, against inputs of a few MB.  Every product runs in 3xTF32 (x = big
// + small, both tf32; small.big + big.small + big.big keep float32
// accuracy), so the tensor cores do three times that.
//
// The forward (mgsv_xpool_sim_fwd), a group of tracks at a time so that its
// workspace stays under kFwdWsBytes whatever M is:
//
//  * u^T = Wout v_m^T, once per track, on the wgmma core of wgmma_gemm.cuh
//    (batched over the group's tracks), its epilogue writing the big and
//    small tf32 halves of u^T [D][S] per track, K-major for the p u_m
//    product; the halves of k and (once per call) of Wlin are split by two
//    elementwise kernels.  A track's rows of these depend on nothing else
//    in the group, so its similarities do not depend on how the tracks
//    are grouped or split between calls.
//  * The pair chain is one persistent kernel (xpool_pair_kernel): a tile is
//    one music x 128 videos, two consumer warpgroups of 64 pair rows each
//    and a producer warpgroup (setmaxnreg gives its registers to the
//    consumers) whose first thread keeps a ring of three 32 KB stages full
//    with TMA: 16-deep slices of q (raw) and of k_m's halves for the
//    scores, of u_m^T's halves for p u_m, of Wlin's halves for the linear
//    branch.  Each product is wgmma m64nNk8 .tf32 with A from registers and
//    B the staged halves (64-byte-swizzled K-major rows, as TMA wrote
//    them): nothing is converted in shared memory.  Only the inputs, the
//    per-track halves and one float per pair cross device memory; no
//    [pairs, D] tensor does (at V = M = 2,048 each would be 4.3 GB).
//  * On a tile: scores = q k_m^T (n = 128 snippets a chunk, two chunks above
//    128; A from the q slice in shared memory), each 16-deep slice summed
//    from zero and then added with a rounded add (the tensor cores truncate
//    a sum to the running sum's exponent); the masked softmax on the
//    accumulators (quad shuffles); p u_m + bout (n = 256), LN2; h Wlin^T
//    (n = 256), blin and the dropout, h, LN3 and the cosine with vhat, all
//    on the accumulators.
//  * Registers: a 64 x 256 float32 accumulator is 128 registers a thread,
//    of the 240 setmaxnreg gives a consumer.  The scores (64 x 128) keep
//    the per-slice sum from zero (64 + 64); p u_m and h Wlin^T sum all of
//    K = S and K = 256 in one accumulator (a second one would take the
//    other 128), which keeps each product under 170 registers.  Their error
//    stays far inside the 1e-4 bound: p u_m sums a convex combination, h
//    Wlin^T's truncation errors are divided by |o| (~16) in the cosine, and
//    the similarities agree with the plain version to 3e-7 - 5e-7 at the
//    training and evaluation shapes (chip_smoke.py, H100).  p and h do not
//    fit in registers beside the next product's accumulator, so each
//    thread parks its own in shared memory (64 KB a warpgroup, one region
//    for p, then h): a thread's accumulators of row
//    g + 8 h, columns 8 j + 2 t + e are its own A fragment of k-step j, at
//    k positions t + 4 e, so they are read back by the thread that wrote
//    them, and u_m^T's and Wlin's k order is permuted to match when their
//    halves are written (snippet or column 8 j + 2 t + e at k position
//    8 j + 4 e + t).
//  * Measured on an H100, the pair kernel runs at about 56 % of the 3xTF32
//    rate.  Its L2 reads (about 1.1 MB a tile, most of it Wlin's halves) do
//    not bound it: loading only the big halves does not move it
//    (scripts/exp_xpool_bytes_cuda.py).  The tensor cores idle while both
//    warpgroups run a tile's softmax and LayerNorms, which the shared
//    stages keep in step.
//
// The backward (mgsv_xpool_sim_bwd, float32 as JAX's _core_bwd) also takes
// Wout once per track: dWout = sum du_m^T v_m, dv_m = du_m Wout with du_m =
// sum_v p_mv^T dpre_mv: 2 x 66.7 GFLOP at V = M = 512.  It runs the pairs a
// chunk of G musics at a time (G V near kChunkPairs: 128 musics at V = 512),
// every product on the wgmma core of wgmma_gemm.cuh in 3xTF32 (batched over
// the chunk's musics where a product is per music: scores q k_m^T, p u_m,
// dpre u_m^T, p^T dpre, ds^T q, ds k_m), the row-wise steps (softmax, LN2,
// LN3 with the cosine, their backwards) one warp per pair row, and the
// linear branch's dropout in the Wlin product's epilogue.  Only a chunk's
// pair tensors ([G V, D] floats, about 67 MB each) are ever in device
// memory.  dq and dvhat sum over musics, the weight and vector gradients
// over pairs: each chunk sums its musics in order (dq, dvhat) or its rows in
// 1024-row slices (the GEMM core's split-K and the column sums), and the
// chunks' partials are summed in chunk order, so a step is reproducible from
// run to run (no atomics).  Ragged V, M and S are TMA's zero fill and the
// epilogues' bounds.

#include <algorithm>

#include "layer_bwd_kernels.cuh"

namespace {

constexpr int kVecs = 6;              // the vector gradients: dg3, db3, dblin, dg2, db2, dbout

bool bad_shape(int V, int M, int S, int D) {
  return V < 1 || M < 1 || M > 65535 || S < 1 || S > kCols || D != kCols;
}

__host__ __device__ constexpr int round8(int n) { return (n + 7) & ~7; }

// ---- the forward (xpool_sim_fwd, xpool_sim_eval)

constexpr int kFwdRows = 128;         // pair rows of a tile: one music, 128 videos
constexpr int kSc = 128;              // snippets per score chunk (the scores' wgmma n)
constexpr int kKs = 16;               // reduction depth of a staged slice: 64-byte rows
constexpr int kFwdStages = 3;
constexpr int kSliceBytes = kCols * kKs * 4;     // a [256][16] float32 slice: 16 KB
constexpr int kStageBytes = 2 * kSliceBytes;     // its big and small halves
constexpr int kQBytes = kFwdRows * kKs * 4;      // q's slice: 8 KB
constexpr int kKBytes = kSc * kKs * 4;           // each half of k_m's slice: 8 KB
constexpr int kPriv = kCols / 8;                 // float4s a thread parks: 2 rows x 64 columns
constexpr int kFwdThreads = 384;                 // two consumer warpgroups, one producer
constexpr size_t kFwdSmem = 1024 + (size_t)kFwdStages * kStageBytes +
                            (size_t)256 * kPriv * sizeof(float4) +
                            2 * kFwdStages * sizeof(uint64_t);
static_assert(kFwdSmem <= 232448, "shared memory of one block");
static_assert(kQBytes + 2 * kKBytes <= kStageBytes, "a score slice fits a stage");
// the forward's workspace: Wlin's halves, then k's and u^T's halves of a
// group of tracks
constexpr size_t kFwdWsBytes = (size_t)256 << 20;

struct FwdParams {
  CUtensorMap q, kb, ks, ub, us, wb, ws;    // rank 3 (inner, outer, track)
  const float *mask, *vhat, *bout, *g2, *b2, *blin, *g3, *b3;
  float* out;                               // [group tracks][V]
  int V, S, tiles, vtiles, m0;              // m0: the group's first music
  Dropout drop;
};

// One k-step's A fragment (m64k8 tf32: a[i] at row g + 8 (i & 1), k
// position t + 4 (i >> 1)) in its big and small tf32 halves.
struct Frag {
  unsigned b[4], s[4];
};

__device__ __forceinline__ void split_into(Frag& f, int i, float x) {
  const float big = tf32_rna(x);
  f.b[i] = __float_as_uint(big);
  f.s[i] = __float_as_uint(tf32_rna(x - big));
}

// The fragment of k-step j from a thread's accumulators (or what it parked
// of them) x = values 4 j .. 4 j + 3: (row g, column 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1) at k positions t, t + 4.
__device__ __forceinline__ void frag_of(Frag& f, float4 x) {
  split_into(f, 0, x.x);
  split_into(f, 1, x.z);
  split_into(f, 2, x.y);
  split_into(f, 3, x.w);
}

#define XP_D64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, " \
  "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, " \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

#define XP_OUT64(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
  "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), \
  "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), \
  "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
  "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), \
  "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), \
  "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), \
  "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), \
  "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), \
  "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), \
  "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

#define XP_D128 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, " \
  "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, " \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, " \
  "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, " \
  "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, " \
  "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, " \
  "%125, %126, %127}"

#define XP_OUT128(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
  "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), \
  "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), \
  "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
  "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), \
  "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), \
  "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), \
  "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), \
  "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), \
  "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), \
  "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), \
  "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), \
  "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), \
  "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), \
  "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), \
  "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), \
  "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), \
  "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), \
  "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), \
  "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), \
  "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), \
  "+f"(d[127])

// d (64 x N, N = 128 or 256) = A . B^T + (scale_d ? d : 0) over one
// k-step, A from registers, B a K-major tf32 tile in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const unsigned (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " XP_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : XP_OUT64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[128], const unsigned (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 " XP_D128
      ", {%128, %129, %130, %131}, %132, p, 1, 1;\n}\n"
      : XP_OUT128(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// wgmma descriptor of a staged K-major tile: rows of 16 floats (64 bytes)
// in the 64-byte swizzle, 8-row groups 512 bytes apart.
__device__ __forceinline__ uint64_t sw64_desc(uint32_t addr) { return wg_desc(addr, 512, 2); }

// acc (64 x N) += A . B^T over one staged 16-deep slice in 3xTF32: A's two
// k-steps in registers, B's big and small halves at bb and bs; small cross
// terms first.  from_zero: the slice sums from zero (scale-d 0 on its first
// product).  Issues and commits; the caller waits.
template <int N>
__device__ __forceinline__ void mma_slice(float (&acc)[N / 2], const Frag (&f)[2], uint32_t bb,
                                          uint32_t bs, bool from_zero) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    wgmma_rs(acc, f[kk].s, sw64_desc(bb + 32 * kk), from_zero && kk == 0 ? 0 : 1);
    wgmma_rs(acc, f[kk].b, sw64_desc(bs + 32 * kk), 1);
  }
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) wgmma_rs(acc, f[kk].b, sw64_desc(bb + 32 * kk), 1);
  wg_commit();
}

// LayerNorm, in place, of a thread's two rows of a 64 x 256 accumulator
// (x[4 j + 2 h + e] at row g + 8 h, column 8 j + 2 t + e; a row spans the
// quad): x = (x - mean) / std * gamma + beta.
__device__ __forceinline__ void ln_rows(float (&x)[128], const float* __restrict__ gamma,
                                        const float* __restrict__ beta, int t) {
  float mean[2], inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) s += x[4 * j + 2 * h] + x[4 * j + 2 * h + 1];
    mean[h] = quad_sum(s) / kCols;
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float d = x[4 * j + 2 * h + e] - mean[h];
        q = fmaf(d, d, q);
      }
    inv[h] = rsqrtf(quad_sum(q) / kCols + kLnEps);
  }
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int c = 8 * j + 2 * t;
    const float2 g = __ldg(reinterpret_cast<const float2*>(gamma + c));
    const float2 b = __ldg(reinterpret_cast<const float2*>(beta + c));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float& x0 = x[4 * j + 2 * h];
      float& x1 = x[4 * j + 2 * h + 1];
      x0 = (x0 - mean[h]) * inv[h] * g.x + b.x;
      x1 = (x1 - mean[h]) * inv[h] * g.y + b.y;
    }
  }
}

// sims of the pair rows of a group of tracks: tiles (music z, 128 videos
// from v0), z slowest, walked by persistent blocks.
template <bool kDrop>
__global__ void __launch_bounds__(kFwdThreads, 1)
xpool_pair_kernel(const __grid_constant__ FwdParams p) {
  extern __shared__ uint8_t xp_smem_raw[];
  char* smem = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(xp_smem_raw) + 1023) & ~(uintptr_t)1023);
  char* stages = smem;
  float4* parked = reinterpret_cast<float4*>(stages + kFwdStages * kStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(parked + 256 * kPriv);
  uint64_t* empty = full + kFwdStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(smem_addr(full + s), 1);
      mbar_init(smem_addr(empty + s), 8);     // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int nch = (p.S + kSc - 1) / kSc;   // score chunks
  const int np = (p.S + kKs - 1) / kKs;    // slices of p u_m

  if (threadIdx.x >= 256) {
    // producer warpgroup: it gives its registers to the consumers, and one
    // thread issues every load, in the order the consumers take them
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      int it = 0;
      auto stage = [&](unsigned bytes, uint32_t& bar) {
        const int s = it % kFwdStages;
        mbar_wait_bounded(smem_addr(empty + s), ((unsigned)(it / kFwdStages) & 1u) ^ 1u);
        bar = smem_addr(full + s);
        mbar_expect_tx(bar, bytes);
        ++it;
        return smem_addr(stages + s * kStageBytes);
      };
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        const int z = tile / p.vtiles, v0 = (tile % p.vtiles) * kFwdRows;
        uint32_t bar;
        for (int c = 0; c < nch; ++c)
          for (int i = 0; i < kCols / kKs; ++i) {
            const uint32_t dst = stage(kQBytes + 2 * kKBytes, bar);
            tma_load_3d(dst, &p.q, bar, kKs * i, v0, 0);
            tma_load_3d(dst + kQBytes, &p.kb, bar, kKs * i, kSc * c, z);
            tma_load_3d(dst + kQBytes + kKBytes, &p.ks, bar, kKs * i, kSc * c, z);
          }
        for (int i = 0; i < np; ++i) {
          const uint32_t dst = stage(kStageBytes, bar);
          tma_load_3d(dst, &p.ub, bar, kKs * i, 0, z);
          tma_load_3d(dst + kSliceBytes, &p.us, bar, kKs * i, 0, z);
        }
        for (int i = 0; i < kCols / kKs; ++i) {
          const uint32_t dst = stage(kStageBytes, bar);
          tma_load_3d(dst, &p.wb, bar, kKs * i, 0, 0);
          tma_load_3d(dst + kSliceBytes, &p.ws, bar, kKs * i, 0, 0);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  // consumers: group wg owns rows 64 wg .. 64 wg + 63 of the tile; a
  // thread's accumulators 4 j + 2 h + e sit at row 16 warp + g + 8 h, column
  // 8 j + 2 t + e
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  // what this thread parks: its float4 of k-step j at mine[128 j]
  float4* mine = parked + wg * kPriv * 128 + tid;
  auto release = [&](int it) {
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_addr(empty + it % kFwdStages));
  };
  auto wait_full = [&](int it) {
    mbar_wait_bounded(smem_addr(full + it % kFwdStages), (unsigned)(it / kFwdStages) & 1u);
    return stages + (it % kFwdStages) * kStageBytes;
  };
  // acc += (A . B^T over n staged [256][16] slices), A's k-steps 2 i, 2 i + 1
  // from what the thread parked; slice i + 1's fragments are built while
  // slice i multiplies, and a stage is released once its products are done
  auto stream = [&](float (&acc)[128], int n, int& it) {
    Frag f0[2], f1[2];
    auto step = [&](Frag (&f)[2], int i) {
      const uint32_t bb = smem_addr(wait_full(it));
      frag_of(f[0], mine[128 * (2 * i)]);
      frag_of(f[1], mine[128 * (2 * i + 1)]);
      mma_slice<256>(acc, f, bb, bb + kSliceBytes, false);
      if (i > 0) {
        wg_wait<1>();
        release(it - 1);
      }
      ++it;
    };
    for (int i = 0; i < n; i += 2) {
      step(f0, i);
      if (i + 1 < n) step(f1, i + 1);
    }
    wg_wait<0>();
    release(it - 1);
  };

  constexpr float scale = 1.f / 16;      // 1 / sqrt(D)
  static_assert(kCols == 256, "the scale above");
  int it = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const int z = tile / p.vtiles, v0 = (tile % p.vtiles) * kFwdRows;
    const int r0 = v0 + 64 * wg + 16 * warp + g;     // the thread's videos r0, r0 + 8
    const float* mask = p.mask + (size_t)z * p.S;

    // ---- scores = q k_m^T / sqrt(D), masked (-1e9), snippets past S at
    // -inf; parked a chunk of 128 snippets at a time
    float rmax[2] = {-INFINITY, -INFINITY};
    for (int c = 0; c < nch; ++c) {
      float acc[64], part[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;
      for (int i = 0; i < kCols / kKs; ++i, ++it) {
        const char* st = wait_full(it);
        // q's fragments from its raw slice ([128 rows][16] in the 64-byte
        // swizzle: 16-byte chunk k / 4 of row r at chunk ^ ((r / 2) mod 4))
        Frag f[2];
        const int ra = 64 * wg + 16 * warp + g;
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const int r = ra + 8 * (a & 1), k = 8 * kk + t + 4 * (a >> 1);
            split_into(f[kk], a, *reinterpret_cast<const float*>(
                                     st + r * 64 + (((k >> 2) ^ ((r >> 1) & 3)) << 4) + (k & 3) * 4));
          }
        const uint32_t kb = smem_addr(st + kQBytes);
        mma_slice<kSc>(part, f, kb, kb + kKBytes, true);
        wg_wait<0>();
#pragma unroll
        for (int i2 = 0; i2 < 64; ++i2) acc[i2] += part[i2];
        release(it);
      }
#pragma unroll
      for (int j = 0; j < kSc / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int s = kSc * c + 8 * j + 2 * t + e;
          const float mk = s < p.S ? __ldg(mask + s) : -1.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float& x = acc[4 * j + 2 * h + e];
            x = mk < 0.f ? -INFINITY : (mk != 0.f ? x * scale : kBigNeg);
            rmax[h] = fmaxf(rmax[h], x);
          }
        }
        mine[128 * (kSc / 8 * c + j)] =
            make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
    // ---- softmax over the snippets, in place
    {
      const int nj = nch * (kSc / 8);
      float mx[2], sum[2] = {0.f, 0.f};
      mx[0] = quad_max(rmax[0]);
      mx[1] = quad_max(rmax[1]);
      for (int j = 0; j < nj; ++j) {
        float4 x = mine[128 * j];
        x = make_float4(expf(x.x - mx[0]), expf(x.y - mx[0]), expf(x.z - mx[1]),
                        expf(x.w - mx[1]));
        sum[0] += x.x + x.y;
        sum[1] += x.z + x.w;
        mine[128 * j] = x;
      }
      const float r0s = 1.f / quad_sum(sum[0]), r1s = 1.f / quad_sum(sum[1]);
      for (int j = 0; j < nj; ++j) {
        const float4 x = mine[128 * j];
        mine[128 * j] = make_float4(x.x * r0s, x.y * r0s, x.z * r1s, x.w * r1s);
      }
    }

    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    // ---- pre = p u_m + bout; h = LN2(pre), parked in p's place
    stream(acc, np, it);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float2 b = __ldg(reinterpret_cast<const float2*>(p.bout + 8 * j + 2 * t));
      acc[4 * j] += b.x;
      acc[4 * j + 1] += b.y;
      acc[4 * j + 2] += b.x;
      acc[4 * j + 3] += b.y;
    }
    ln_rows(acc, p.g2, p.b2, t);
#pragma unroll
    for (int j = 0; j < 32; ++j)
      mine[128 * j] = make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);

    // ---- t3 = h + drop(h Wlin^T + blin); o = LN3(t3); sim = <o / |o|, vhat>
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    stream(acc, kCols / kKs, it);
    const int m = p.m0 + z;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = 8 * j + 2 * t;
      const float2 b = __ldg(reinterpret_cast<const float2*>(p.blin + c));
      const float4 hv = mine[128 * j];
      float kp[2][2] = {{1.f, 1.f}, {1.f, 1.f}};
      if constexpr (kDrop)
        pair_keep(p.drop, [&](int r, int c4) {
          return philox4(p.drop.seed, m, r, c4 >> 2);
        }, r0, r0 + 8, c, kp);
      acc[4 * j] = (acc[4 * j] + b.x) * kp[0][0] + hv.x;
      acc[4 * j + 1] = (acc[4 * j + 1] + b.y) * kp[0][1] + hv.y;
      acc[4 * j + 2] = (acc[4 * j + 2] + b.x) * kp[1][0] + hv.z;
      acc[4 * j + 3] = (acc[4 * j + 3] + b.y) * kp[1][1] + hv.w;
    }
    ln_rows(acc, p.g3, p.b3, t);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int v = r0 + 8 * h;
      const bool valid = v < p.V;
      const float* vh = p.vhat + (size_t)(valid ? v : 0) * kCols + 2 * t;
      float n2 = 0.f, dot = 0.f;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const float o0 = acc[4 * j + 2 * h], o1 = acc[4 * j + 2 * h + 1];
        const float2 w = __ldg(reinterpret_cast<const float2*>(vh + 8 * j));
        n2 = fmaf(o0, o0, fmaf(o1, o1, n2));
        dot = fmaf(o0, w.x, fmaf(o1, w.y, dot));
      }
      n2 = quad_sum(n2);
      dot = quad_sum(dot);
      if (valid && t == 0) p.out[(size_t)z * p.V + v] = dot * rsqrtf(fmaxf(n2, 1e-24f));
    }
  }
}

// big = rna_tf32(x), small = rna_tf32(x - big), 4 floats per thread
__global__ void split_tf32_kernel(const float4* __restrict__ x, float4* __restrict__ big,
                                  float4* __restrict__ small, size_t n4) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    const float4 v = x[i];
    const float4 b = make_float4(tf32_rna(v.x), tf32_rna(v.y), tf32_rna(v.z), tf32_rna(v.w));
    big[i] = b;
    small[i] = make_float4(tf32_rna(v.x - b.x), tf32_rna(v.y - b.y), tf32_rna(v.z - b.z),
                           tf32_rna(v.w - b.w));
  }
}

// The k position of column (or snippet) c in the register A fragments:
// column 8 j + 2 i + e at 8 j + 4 e + i.
__host__ __device__ constexpr int frag_pos(int c) { return (c & ~7) + ((c & 1) << 2) + ((c & 7) >> 1); }

// Wlin [256][256] -> its big and small halves, each row's columns at
// frag_pos: block n, thread c.
__global__ void split_wlin_kernel(const float* __restrict__ w, float* __restrict__ big,
                                  float* __restrict__ small) {
  const int n = blockIdx.x, c = threadIdx.x;
  const float x = w[n * kCols + c], b = tf32_rna(x);
  big[n * kCols + frag_pos(c)] = b;
  small[n * kCols + frag_pos(c)] = tf32_rna(x - b);
}

// The epilogue of u^T = Wout v_z^T (z: a track of the group; rows d,
// columns s): the big and small halves at [z][d][frag_pos(s)], row stride
// ld (S rounded up to 8; the snippets in [S, ld) are TMA's zeros).
struct UtEpi {
  float *big, *small;
  int ld;
  static constexpr bool kWarpKeep = false;
  struct In {};
  __device__ In load(int, int) const { return {}; }
  __device__ void operator()(int z, int d, int s, float x) const {
    const size_t at = ((size_t)z * kCols + d) * ld + frag_pos(s);
    const float b = tf32_rna(x);
    big[at] = b;
    small[at] = tf32_rna(x - b);
  }
  __device__ void pair(int z, int d, int s, float x0, float x1, In, const float (&)[2]) const {
    (*this)(z, d, s, x0);
    (*this)(z, d, s + 1, x1);
  }
};

// Floats of the forward's workspace per track of a group, and the tracks
// of a group: as many as keep the workspace under kFwdWsBytes, at least 1.
inline size_t fwd_track_floats(int S) {
  return 2 * (size_t)S * kCols + 2 * (size_t)kCols * round8(S);
}
inline int fwd_group(int M, int S) {
  const size_t room = kFwdWsBytes / sizeof(float) - 2 * (size_t)kCols * kCols;
  return (int)std::max<size_t>(1, std::min<size_t>(M, room / fwd_track_floats(S)));
}

// ---- the backward (xpool_sim_bwd): launches on the GEMM core of
// wgmma_gemm.cuh, music chunk by music chunk

// Pair rows per chunk: a chunk takes G = max(1, kChunkPairs / V) musics, so
// its pair tensors ([G V, D] floats) stay near 67 MB.
constexpr int kChunkPairs = 65536;

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

inline int chunk_musics(int V, int M) { return std::max(1, std::min(M, kChunkPairs / V)); }

// Scores of a chunk: out[z][v][s] = q_v . k_(m0 + z)s / sqrt(D), a masked
// snippet at -1e9 (row stride ld >= S).
struct ScoreEpi {
  float* out;
  const float* mask;     // [M, S] from music m0
  int V, S, ld;
  float scale;
  static constexpr bool kWarpKeep = false;
  struct In {};
  __device__ In load(int, int) const { return {}; }
  __device__ void operator()(int z, int r, int c, float v) const {
    out[((size_t)z * V + r) * ld + c] = mask[(size_t)z * S + c] != 0.f ? v * scale : kBigNeg;
  }
  __device__ void pair(int z, int r, int c, float v0, float v1, In, const float (&)[2]) const {
    (*this)(z, r, c, v0);
    (*this)(z, r, c + 1, v1);
  }
};

// out[z][r][c] = scale * value (+ bias[c]), row stride ld, batch stride
// rows * ld.
struct StoreEpi {
  float* out;
  const float* bias;
  int rows, ld;
  float scale;
  static constexpr bool kWarpKeep = false;
  struct In {};
  __device__ In load(int, int) const { return {}; }
  __device__ void operator()(int z, int r, int c, float v) const {
    out[((size_t)z * rows + r) * ld + c] = v * scale + (bias ? bias[c] : 0.f);
  }
  __device__ void pair(int z, int r, int c, float v0, float v1, In, const float (&)[2]) const {
    float2 o = make_float2(v0 * scale, v1 * scale);
    if (bias) {
      o.x += bias[c];
      o.y += bias[c + 1];
    }
    *reinterpret_cast<float2*>(out + ((size_t)z * rows + r) * ld + c) = o;
  }
};

// The linear branch of pair row r = (m - m0) V + v: t3 = h + drop_(m,v)(x + blin).
struct LinEpi {
  float* t3;
  const float *h, *blin;
  int V, m0;
  Dropout drop;
  static constexpr bool kWarpKeep = true;
  struct In {
    float2 h;
  };
  __device__ In load(int r, int c) const {
    return In{*reinterpret_cast<const float2*>(h + (size_t)r * kCols + c)};
  }
  __device__ void warp_keep(int, int r0, int r1, int c, float (&kp)[2][2]) const {
    if (drop.thresh == 0u) return;
    pair_keep(drop, [&](int r, int c4) {
      return philox4(drop.seed, m0 + r / V, r % V, c4 >> 2);
    }, r0, r1, c, kp);
  }
  __device__ void pair(int, int r, int c, float v0, float v1, const In& in,
                       const float (&kp)[2]) const {
    *reinterpret_cast<float2*>(t3 + (size_t)r * kCols + c) =
        make_float2((v0 + blin[c]) * kp[0] + in.h.x, (v1 + blin[c + 1]) * kp[1] + in.h.y);
  }
  __device__ void operator()(int, int, int, float) const {}   // D is even
};

// Softmax over the S snippets of each pair row (row stride ld), in place;
// one warp per row.
__global__ void softmax_rows_kernel(float* __restrict__ s, int rows, int S, int ld) {
  const int lane = threadIdx.x & 31, row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  float* x = s + (size_t)row * ld;
  float mx = -INFINITY;
  for (int c = lane; c < S; c += 32) mx = fmaxf(mx, x[c]);
  mx = warp_max(mx);
  float sum = 0.f;
  for (int c = lane; c < S; c += 32) {
    const float e = expf(x[c] - mx);
    x[c] = e;
    sum += e;
  }
  sum = warp_sum(sum);
  for (int c = lane; c < S; c += 32) x[c] /= sum;
}

// ds = p (dp - sum_s p dp), zero at masked snippets (their scores are
// constants), in place of dp; one warp per pair row.
__global__ void softmax_bwd_rows_kernel(const float* __restrict__ p, float* __restrict__ dp,
                                        const float* __restrict__ mask, int rows, int V, int S,
                                        int ld) {
  const int lane = threadIdx.x & 31, row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float* pr = p + (size_t)row * ld;
  float* d = dp + (size_t)row * ld;
  const float* mk = mask + (size_t)(row / V) * S;
  float dot = 0.f;
  for (int c = lane; c < S; c += 32) dot = fmaf(d[c], pr[c], dot);
  dot = warp_sum(dot);
  for (int c = lane; c < S; c += 32) d[c] = mk[c] != 0.f ? pr[c] * (d[c] - dot) : 0.f;
}

// The pair-row kernels' six column sums per block of kSumRows rows: the
// head kernel's three, then LN2's backward's three.
constexpr int kSumStride = kVecs * kCols;

// The head of pair rows r = (m - m0) V + v: from t3 = h + lin, o = LN3(t3),
// sim = <o / |o|, vhat_v>; then the backward of the cosine and of LN3 under
// the cotangent g[m][v]: gohat = g o / |o| (dvhat's term), do = g (vhat -
// sim o / |o|) / |o|, du3 = LN3'(do) and dlin = du3 * the pair's dropout
// mask; column sums do xhat3 (dg3), do (db3), dlin (dblin).
__global__ void __launch_bounds__(kThreads)
head_bwd_kernel(const float* __restrict__ t3, const float* __restrict__ vhat,
                const float* __restrict__ g, const float* __restrict__ g3,
                const float* __restrict__ b3, float* __restrict__ gohat,
                float* __restrict__ du3, float* __restrict__ dlin, float* __restrict__ part,
                int rows, int V, int m0, Dropout drop) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float acc[3][kVec] = {};
  constexpr int kWarpRows = kSumRows / kWarps;
  for (int i = 0; i < kWarpRows; ++i) {
    const int row = blockIdx.x * kSumRows + warp * kWarpRows + i;
    if (row >= rows) break;
    const int m = m0 + row / V, v = row % V;
    const size_t base = (size_t)row * kCols;
    float x[kVec], o[kVec], vh[kVec], s = 0.f;
#pragma unroll
    for (int t = 0; t < kVec; ++t) s += (x[t] = t3[base + lane + 32 * t]);
    const float mean = warp_sum(s) / kCols;
    float q = 0.f;
#pragma unroll
    for (int t = 0; t < kVec; ++t) {
      x[t] -= mean;
      q = fmaf(x[t], x[t], q);
    }
    const float inv3 = rsqrtf(warp_sum(q) / kCols + kLnEps);
    float n2 = 0.f, dot = 0.f;
#pragma unroll
    for (int t = 0; t < kVec; ++t) {
      const int c = lane + 32 * t;
      x[t] *= inv3;                                     // xhat3
      o[t] = x[t] * g3[c] + b3[c];
      vh[t] = vhat[(size_t)v * kCols + c];
      n2 = fmaf(o[t], o[t], n2);
      dot = fmaf(o[t], vh[t], dot);
    }
    const float inv_n = rsqrtf(fmaxf(warp_sum(n2), 1e-24f));
    const float sim = warp_sum(dot) * inv_n, gv = g[(size_t)m * V + v];
    float s1 = 0.f, s2 = 0.f, dog[kVec];
#pragma unroll
    for (int t = 0; t < kVec; ++t) {
      const int c = lane + 32 * t;
      const float oh = o[t] * inv_n;
      const float d = gv * (vh[t] - sim * oh) * inv_n;
      gohat[base + c] = gv * oh;
      acc[0][t] = fmaf(d, x[t], acc[0][t]);
      acc[1][t] += d;
      dog[t] = d * g3[c];
      s1 += dog[t];
      s2 = fmaf(dog[t], x[t], s2);
    }
    const float m1 = warp_sum(s1) / kCols, m2 = warp_sum(s2) / kCols;
#pragma unroll
    for (int t = 0; t < kVec; ++t) {
      const int c = lane + 32 * t;
      const float du = (dog[t] - m1 - x[t] * m2) * inv3;
      const float dl = du * keep(drop, m, v, c);
      du3[base + c] = du;
      dlin[base + c] = dl;
      acc[2][t] += dl;
    }
  }
  write_block_sums<3>(acc, part, kSumStride);
}

}  // namespace

extern "C" int mgsv_xpool_sim_init() {
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(xpool_pair_kernel<true>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)kFwdSmem)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(xpool_pair_kernel<false>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)kFwdSmem)) != cudaSuccess)
    return (int)err;
  return 0;
}

// Floats of device workspace mgsv_xpool_sim_fwd needs (at most
// kFwdWsBytes, or one track's more).
extern "C" size_t mgsv_xpool_sim_fwd_workspace(int V, int M, int S) {
  (void)V;
  return 2 * (size_t)kCols * kCols + (size_t)fwd_group(M, S) * fwd_track_floats(S);
}

// sims [M, V] of the pair stage on `stream`, dropout (seed, thresh, scale)
// as in philox.cuh (thresh 0: none, and the <false> instantiation without
// the mask code, as an evaluation takes it).  q, vhat [V, D]; k, v [M, S,
// D]; mask [M, S]; the 8 stage weights in torch layout; ws the workspace
// (mgsv_xpool_sim_fwd_workspace floats).  Per group of tracks: k's halves,
// u^T's halves on the GEMM core, then the pair kernel.  Returns the first
// CUDA error.
extern "C" int mgsv_xpool_sim_fwd(const float* q, const float* k, const float* v,
                                  const float* mask, const float* vhat, const float* wout,
                                  const float* bout, const float* g2, const float* b2,
                                  const float* wlin, const float* blin, const float* g3,
                                  const float* b3, float* out, float* ws, int V, int M, int S,
                                  int D, unsigned seed, unsigned thresh, float scale,
                                  void* stream) {
  if (bad_shape(V, M, S, D)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = fwd_group(M, S), S8 = round8(S);
  const size_t d = kCols;
  float *wb = ws, *wsm = wb + d * d, *kb = wsm + d * d, *ks = kb + (size_t)G * S * d;
  float *ub = ks + (size_t)G * S * d, *us = ub + (size_t)G * d * S8;
  static int sm_count[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (sm_count[dev] == 0 &&
      (err = cudaDeviceGetAttribute(&sm_count[dev], cudaDevAttrMultiProcessorCount, dev)) !=
          cudaSuccess)
    return (int)err;

  split_wlin_kernel<<<kCols, kCols, 0, st>>>(wlin, wb, wsm);
  FwdParams p;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_64B;
  if (!encode_map(&p.q, Operand{q, D, V, D}, kKs, kFwdRows, sw) ||
      !encode_map(&p.wb, Operand{wb, D, D, D}, kKs, kCols, sw) ||
      !encode_map(&p.ws, Operand{wsm, D, D, D}, kKs, kCols, sw))
    return (int)cudaErrorInvalidValue;
  p.vhat = vhat;
  p.bout = bout;
  p.g2 = g2;
  p.b2 = b2;
  p.blin = blin;
  p.g3 = g3;
  p.b3 = b3;
  p.V = V;
  p.S = S;
  p.vtiles = (V + kFwdRows - 1) / kFwdRows;
  p.drop = Dropout{seed, thresh, scale};
  for (int m0 = 0; m0 < M; m0 += G) {
    const int n = std::min(G, M - m0);
    const size_t kf = (size_t)n * S * d;
    split_tf32_kernel<<<(unsigned)std::min<size_t>((kf / 4 + kThreads - 1) / kThreads, 132 * 16),
                        kThreads, 0, st>>>(reinterpret_cast<const float4*>(k + (size_t)m0 * S * d),
                                           reinterpret_cast<float4*>(kb),
                                           reinterpret_cast<float4*>(ks), kf / 4);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    // u^T [n][D][S8] = Wout v_m^T, the track's snippets past S read as zeros
    err = wg_gemm<false, false, false>(Operand{wout, D, D, D},
                                       Operand{v + (size_t)m0 * S * d, D, S, D, (long)S * D, n},
                                       D, S8, D, n, 0, false, true, UtEpi{ub, us, S8}, st);
    if (err != cudaSuccess) return (int)err;
    if (!encode_map(&p.kb, Operand{kb, D, S, D, (long)S * D, n}, kKs, kSc, sw) ||
        !encode_map(&p.ks, Operand{ks, D, S, D, (long)S * D, n}, kKs, kSc, sw) ||
        !encode_map(&p.ub, Operand{ub, S8, D, S8, (long)D * S8, n}, kKs, kCols, sw) ||
        !encode_map(&p.us, Operand{us, S8, D, S8, (long)D * S8, n}, kKs, kCols, sw))
      return (int)cudaErrorInvalidValue;
    p.mask = mask + (size_t)m0 * S;
    p.out = out + (size_t)m0 * V;
    p.m0 = m0;
    p.tiles = n * p.vtiles;
    const unsigned grid = (unsigned)std::min(p.tiles, sm_count[dev]);
    if (thresh != 0u)
      xpool_pair_kernel<true><<<grid, kFwdThreads, kFwdSmem, st>>>(p);
    else
      xpool_pair_kernel<false><<<grid, kFwdThreads, kFwdSmem, st>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

// Floats of device workspace mgsv_xpool_sim_bwd needs.
extern "C" size_t mgsv_xpool_sim_bwd_workspace(int V, int M, int S) {
  const size_t G = chunk_musics(V, M), P = G * V, d = kCols, sp = round4(S);
  const size_t nc = (M + G - 1) / G, ms = (size_t)M * S;
  const size_t zp = (P + kChunk - 1) / kChunk, zm = (ms + kChunk - 1) / kChunk;
  const size_t partial = std::max(zp, zm) * d * d;
  const size_t blocks = nc * ((P + kSumRows - 1) / kSumRows);
  return 2 * align4(ms * d) +            // u = v Wout^T, du
         9 * align4(P * d) + align4(P) + // the chunk's pair tensors, LN2's 1/std
         2 * align4(P * sp) +            // p, then ds in place of dp
         2 * align4(nc * V * d) +        // dq, dvhat per chunk
         align4(nc * d * d) +            // dWlin per chunk
         align4(blocks * kVecs * d) +    // the six vectors' block sums
         align4(partial);                // the launches' split-K partials
}

// Gradients of sum(g * sims) with respect to q, k, v, vhat and the 8 stage
// weights (torch layout), on `stream`.  Returns the first CUDA error.
extern "C" int mgsv_xpool_sim_bwd(
    const float* q, const float* k, const float* v, const float* mask, const float* vhat,
    const float* wout, const float* bout, const float* g2, const float* b2,
    const float* wlin, const float* blin, const float* g3, const float* b3, const float* g,
    float* dq, float* dk, float* dv, float* dvhat, float* dwout, float* dbout, float* dg2,
    float* db2, float* dwlin, float* dblin, float* dg3, float* db3, float* ws, int V, int M,
    int S, int D, unsigned seed, unsigned thresh, float scale, void* stream) {
  if (bad_shape(V, M, S, D)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dropout drop{seed, thresh, scale};
  const int G = chunk_musics(V, M), Sp = round4(S), nc = (M + G - 1) / G;
  const size_t P = (size_t)G * V, d = kCols, ms = (size_t)M * S;
  float* cur = ws;
  auto take = [&](size_t n) { float* p = cur; cur += align4(n); return p; };
  float *u = take(ms * d), *du = take(ms * d);
  float *pre = take(P * d), *h = take(P * d), *xh2 = take(P * d), *t3 = take(P * d),
        *gohat = take(P * d), *du3 = take(P * d), *dlin = take(P * d), *dh = take(P * d),
        *dpre = take(P * d);
  float* dq_m = t3;    // each music's dq term, once t3 is consumed
  float* inv2 = take(P);
  float *pb = take(P * Sp), *dsb = take(P * Sp);
  float *dq_c = take((size_t)nc * V * d), *dvhat_c = take((size_t)nc * V * d);
  float* dwlin_c = take((size_t)nc * d * d);
  // [block][6][D]: per block of pair rows, dg3 | db3 | dblin then dg2 | db2 |
  // dbout (the row kernels' three sums each)
  float* vec_b = take((size_t)nc * ((P + kSumRows - 1) / kSumRows) * kVecs * d);
  float* partial = cur;
  const float rs = rsqrtf((float)kCols);
  cudaError_t err = cudaSuccess;
  auto ok = [&](cudaError_t e) {
    if (err == cudaSuccess) err = e != cudaSuccess ? e : cudaGetLastError();
    return err == cudaSuccess;
  };
  const Dropout none{0u, 0u, 1.f};
  Launcher per_track{st, M * S, 1, none, partial};

  // u = v Wout^T, once per track
  per_track.rowgemm({v, D, D, wout, D, 0, nullptr, 0, -1, D, nullptr, 0, nullptr, 0, u, D}, D);
  if (!ok(per_track.err)) return (int)err;

  int blocks = 0;                       // row blocks of the chunks so far
  for (int c = 0; c < nc; ++c) {
    const int m0 = c * G, g_n = std::min(G, M - m0), rows = g_n * V;
    Launcher k2{st, rows, 1, none, partial};
    const unsigned row_blocks = (rows + kWarps - 1) / kWarps;
    const int sum_blocks = (rows + kSumRows - 1) / kSumRows;
    float* vec = vec_b + (size_t)blocks * kVecs * d;
    blocks += sum_blocks;
    const float* k_c = k + (size_t)m0 * S * d;
    const float* u_c = u + (size_t)m0 * S * d;
    const Operand q_k{q, D, V, D};                       // q [V][D], K-major
    // scores and softmax: p [g_n][V][Sp]
    ok(wg_gemm<false, false, false>(q_k, Operand{k_c, D, S, D, (long)S * D, g_n}, V, S, D, g_n,
                                    0, false, true,
                                    ScoreEpi{pb, mask + (size_t)m0 * S, V, S, Sp, rs}, st));
    softmax_rows_kernel<<<row_blocks, kThreads, 0, st>>>(pb, rows, S, Sp);
    // pre = p u_m + bout; h = LN2(pre)
    const Operand p_k{pb, Sp, V, S, (long)V * Sp, g_n};  // p, K-major over snippets
    ok(wg_gemm<false, false, true>(p_k, Operand{u_c, D, S, D, (long)S * D, g_n}, V, D, S, g_n,
                                   0, true, true, StoreEpi{pre, bout, V, D, 1.f}, st));
    k2.ln_fwd(pre, g2, b2, h, xh2, inv2);
    // t3 = h + drop(h Wlin^T + blin)
    ok(wg_gemm<false, false, false>(Operand{h, D, rows, D}, Operand{wlin, D, D, D}, rows, D, D, 1,
                                    0, false, false, LinEpi{t3, h, blin, V, m0, drop}, st));
    if (!ok(k2.err)) return (int)err;
    head_bwd_kernel<<<sum_blocks, kThreads, 0, st>>>(t3, vhat, g, g3, b3, gohat, du3, dlin, vec,
                                                     rows, V, m0, drop);
    k2.wgrad(dlin, D, D, h, D, D, dwlin_c + (size_t)c * d * d);
    // dh = du3 + dlin Wlin; dpre = LN2'(dh)
    k2.rowgemm({dlin, D, D, wlin, D, 1, nullptr, 0, -1, D, nullptr, 0, du3, D, dh, D}, D);
    if (!ok(k2.err)) return (int)err;
    ln_bwd_sum_kernel<3><<<sum_blocks, kThreads, 0, st>>>(dh, xh2, inv2, g2, dpre, vec + 3 * d,
                                                          kSumStride, rows);
    // dp = dpre u_m^T, then ds in its place
    const Operand dpre_k{dpre, D, V, D, (long)V * D, g_n};
    ok(wg_gemm<false, false, false>(dpre_k, Operand{u_c, D, S, D, (long)S * D, g_n}, V, S, D, g_n,
                                    0, true, true, StoreEpi{dsb, nullptr, V, Sp, 1.f}, st));
    softmax_bwd_rows_kernel<<<row_blocks, kThreads, 0, st>>>(pb, dsb, mask + (size_t)m0 * S,
                                                             rows, V, S, Sp);
    // du_m = sum_v p^T dpre (a whole track's sum in one product)
    ok(wg_gemm<false, true, true>(Operand{pb, Sp, V, S, (long)V * Sp, g_n}, dpre_k, S, D, V, g_n,
                                  0, true, true,
                                  StoreEpi{du + (size_t)m0 * S * d, nullptr, S, D, 1.f}, st));
    // dk_m = sum_v ds^T q / sqrt(D)
    const Operand ds_t{dsb, Sp, V, S, (long)V * Sp, g_n};
    ok(wg_gemm<false, true, true>(ds_t, Operand{q, D, V, D}, S, D, V, g_n, 0, true, false,
                                  StoreEpi{dk + (size_t)m0 * S * d, nullptr, S, D, rs}, st));
    // dq's and dvhat's terms of each music, then their sums over the chunk
    // (music order)
    ok(wg_gemm<false, false, true>(Operand{dsb, Sp, V, S, (long)V * Sp, g_n},
                                   Operand{k_c, D, S, D, (long)S * D, g_n}, V, D, S, g_n, 0, true,
                                   true, StoreEpi{dq_m, nullptr, V, D, rs}, st));
    k2.partial = dq_m;
    k2.reduce(g_n, (size_t)V * d, dq_c + (size_t)c * V * d);
    k2.partial = gohat;
    k2.reduce(g_n, (size_t)V * d, dvhat_c + (size_t)c * V * d);
    k2.partial = partial;
    if (!ok(k2.err)) return (int)err;
  }

  // the sums over chunks, in chunk order; dWout and dv once per track
  Launcher fin{st, 1, 1, none, nullptr};
  fin.partial = dq_c;
  fin.reduce(nc, (size_t)V * d, dq);
  fin.partial = dvhat_c;
  fin.reduce(nc, (size_t)V * d, dvhat);
  fin.partial = dwlin_c;
  fin.reduce(nc, d * d, dwlin);
  if (fin.check())
    sum_blocks_kernel<kVecs><<<kVecs, kCols, 0, st>>>(
        vec_b, blocks, kSumStride, SumOut<kVecs>{{dg3, db3, dblin, dg2, db2, dbout}});
  per_track.wgrad(du, D, D, v, D, D, dwout);
  per_track.rowgemm({du, D, D, wout, D, 1, nullptr, 0, -1, D, nullptr, 0, nullptr, 0, dv, D}, D);
  ok(fin.err);
  ok(per_track.err);
  return (int)err;
}
