// A GEMM core for Hopper (sm_90a): wgmma tensor-core products fed by TMA.
//
//   C[z][m][n] = epilogue(sum_k A[z][m][k] B[z][n][k])
//
// One persistent block per SM walks 128 x 128 tiles of C with three roles:
// two consumer warpgroups (warps 0-7, 64 rows each, wgmma.mma_async m64n128
// with the accumulators in registers) and one producer warp (warp 8) whose
// first lane keeps a ring of shared-memory stages full with TMA loads
// (cp.async.bulk.tensor, completion counted on an mbarrier per stage; the
// consumers release a stage on a second mbarrier), running on into the
// next tile while the consumers run this one's epilogue.  Each stage holds
// a 32-deep float32 slice of A and of B, loaded from float32 tensors in
// device memory:
//
//  * K-major operands (k contiguous: activations [rows][K], torch weights
//    [N][K]) arrive in the 128-byte swizzle that wgmma reads;
//  * MN-major operands (m or n contiguous: a weight read as W[k][n] for
//    dX = dY W, both operands of a weight gradient dW = G^T H whose
//    reduction runs over rows) arrive as plain [32][128] tiles.
//
// The consumers convert each staged slice once, each warpgroup its own 64
// rows of A and 64 rows of B, into the operand tiles wgmma reads, K-major,
// transposing the MN-major ones on the way; the conversion of slice i + 1
// runs while slice i multiplies (two converted buffers).  The tensor cores
// truncate a float32 sum to the running sum's exponent, so each slice is
// summed from zero into a second set of accumulators and then added to the
// first with a rounded add, which keeps the sum at float32 accuracy:
//
//  * precision "f32" (3xTF32, wgmma .tf32, k = 8): x = big + small with
//    big = rna_tf32(x) and small = rna_tf32(x - big), in 128-byte-swizzled
//    rows of 32 floats; each k-step runs small.big + big.small + big.big,
//    which keeps float32 accuracy (the dropped small.small term is ~2^-22
//    relative).  wgmma takes 32-bit operands only K-major, so the transpose
//    happens here, in shared memory, and never in device memory.
//  * precision "bf16" (wgmma .bf16, k = 16): x rounded to the nearest bf16,
//    in 64-byte-swizzled rows of 32 bf16.  Rounding as the slice is read is
//    rounding as the value was written: JAX's precision="bf16" (bf16
//    operands, float32 sums), with no bf16 copy of any tensor in device
//    memory.
//
// Ragged edges are TMA's: rows, columns and k past a tensor's extent load
// as zeros, and the epilogue skips rows m >= M and columns n >= N.  A
// tile's z index is either a batch (each operand's third coordinate is z,
// or 0 for an operand shared by the batch) or a split of K (slice z covers
// k in [z kz, (z + 1) kz)): a weight gradient writes one partial per slice,
// summed afterwards in slice order, so two calls are bit-identical.
//
// The epilogue is a functor called on the registers, pair(z, m, n, v0, v1,
// inputs, mask) for columns n, n + 1 (n even) and (z, m, n, v) for a last
// odd column: bias, activations, dropout, gates and residuals are
// fused there.  Its type may also ask for a second tensor to be added to A
// or B as their slices are converted (EpiAddA, EpiAddB).  TMA descriptors
// hold device pointers, so the host encodes them (cuTensorMapEncodeTiled,
// looked up in libcuda.so.1 with dlopen: the library links no libcuda),
// keeps each by its pointer and geometry for later launches (MapCache), and
// passes them by value as __grid_constant__ kernel parameters.  A
// descriptor that fails to encode is an error of the launch; nothing falls
// back.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include <algorithm>
#include <initializer_list>
#include <mutex>
#include <type_traits>

namespace {

constexpr int kGemmBM = 128;              // tile rows (two warpgroups of 64)
constexpr int kGemmBN = 128;              // tile columns (wgmma n = 128)
constexpr int kGemmBK = 32;               // reduction depth per stage
constexpr int kGemmThreads = 288;         // 2 consumer warpgroups + 1 producer warp
constexpr int kGemmTileBytes = kGemmBM * kGemmBK * 4;   // one float32 slice: 16 KB

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Spin until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, unsigned parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// mbar_wait with a bound: a wait that outlasts two seconds (which no tile
// of a correct launch needs) traps, so a fault in a pipeline ends the launch
// with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait_bounded(uint32_t bar, unsigned parity) {
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

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major operand tile: start address,
// leading offset (unused by the swizzled K-major layouts), stride between
// 8-row groups, swizzle mode (1: 128 B, 2: 64 B).
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t sbo, uint64_t mode) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (mode << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// wait until at most N committed groups of this warpgroup's wgmmas are in
// flight
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d = A . B^T + (scale_d ? d : 0) over one k-step, the 64 x 128 warpgroup
// tile in registers.
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ float tf32_rna(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// Writes row r, logical 16-byte chunk c (k = 4c .. 4c + 3) of a converted
// operand tile: 3xTF32 big and small rows of 32 floats in the 128-byte
// swizzle (chunk c ^ (r mod 8)), or bf16 rows of 32 values in the 64-byte
// swizzle (bf16 chunk c / 2 ^ (r / 2 mod 4), half c mod 2).
template <bool kBf16>
__device__ __forceinline__ void put_operand(char* hi, char* lo, int r, int c, float4 x) {
  if constexpr (kBf16) {
    const __nv_bfloat162 p0 = __floats2bfloat162_rn(x.x, x.y), p1 = __floats2bfloat162_rn(x.z, x.w);
    uint2 v;
    v.x = *reinterpret_cast<const unsigned*>(&p0);
    v.y = *reinterpret_cast<const unsigned*>(&p1);
    *reinterpret_cast<uint2*>(hi + r * 64 + ((((c >> 1) ^ ((r >> 1) & 3))) << 4) + (c & 1) * 8) = v;
  } else {
    const float4 b = make_float4(tf32_rna(x.x), tf32_rna(x.y), tf32_rna(x.z), tf32_rna(x.w));
    const float4 s = make_float4(tf32_rna(x.x - b.x), tf32_rna(x.y - b.y), tf32_rna(x.z - b.z),
                                 tf32_rna(x.w - b.w));
    const int off = r * 128 + ((c ^ (r & 7)) << 4);
    *reinterpret_cast<float4*>(hi + off) = b;
    *reinterpret_cast<float4*>(lo + off) = s;
  }
}

// The identity on a staged value group (convert_slice's default).
struct NoOp {
  __device__ float4 operator()(int, float4 x) const { return x; }
};

// Group i (0..3) of thread tid (0..127 in the warpgroup wg) in a staged
// slice: row r of the tile and k = 4 c .. 4 c + 3 of the slice.  kT (a
// plain [32 k][128 rows] tile): row 64 wg + tid mod 64, c = tid / 64 + 2 i;
// else (128 rows of 32 floats in the 128-byte swizzle) the i-th of the
// warpgroup's 16-byte chunks from tid on, at byte off of the stage.
template <bool kT>
__device__ __forceinline__ void slice_group(int wg, int tid, int i, int& r, int& c, int& off) {
  const int item = tid + 128 * i;
  if constexpr (kT) {
    r = 64 * wg + (item & 63);
    c = item >> 6;
    off = 0;
  } else {
    off = 64 * wg * 128 + 16 * item;
    r = off >> 7;
    c = ((off >> 4) & 7) ^ (r & 7);
  }
}

// Converts rows [64 wg, 64 wg + 64) of one staged slice into the operand
// tile(s) at hi / lo, group i of the thread's four (slice_group) passed
// through op(i, x) first.
template <bool kBf16, bool kT, class Op = NoOp>
__device__ __forceinline__ void convert_slice(const char* stage, char* hi, char* lo, int wg,
                                              int tid, Op op = {}) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int r, c, off;
    slice_group<kT>(wg, tid, i, r, c, off);
    if constexpr (kT) {
      const float* src = reinterpret_cast<const float*>(stage) + (4 * c) * kGemmBM + r;
      put_operand<kBf16>(hi, lo, r, c,
                         op(i, make_float4(src[0], src[kGemmBM], src[2 * kGemmBM],
                                           src[3 * kGemmBM])));
    } else {
      put_operand<kBf16>(hi, lo, r, c, op(i, *reinterpret_cast<const float4*>(stage + off)));
    }
  }
}

// An epilogue type that declares kColSum true also takes the column sums
// of its MN-major A (sum over k of A[m][k]: the bias gradient beside a
// weight gradient), summed as A's slices are converted; the tiles of the
// first column block hand each thread's sum to epi.colsum(z, half, m, v),
// half = which of the two threads of row m it is.  A type that does not
// declare it takes none.
template <class E, class = void>
struct EpiColSum : std::false_type {};
template <class E>
struct EpiColSum<E, std::void_t<decltype(E::kColSum)>> : std::bool_constant<E::kColSum> {};

// An epilogue type that declares kAddA (kAddB) true adds a second tensor of
// A's (B's) shape to that operand as its slices are converted, so a sum
// such as memory + pos enters a product without a pass of its own:
// epi.add_a(n0) (epi.add_b(m0)) is the addend of the tiles whose columns
// (rows) start at n0 (m0), or null, and epi.add_a_ld() (add_b_ld()) its
// row stride.  The addend's slices arrive by TMA as a third tile of each
// stage, in its operand's layout (the ring then has two stages, not three),
// and the sum is rounded once, as an add kernel would round it.
template <class E, class = void>
struct EpiAddA : std::false_type {};
template <class E>
struct EpiAddA<E, std::void_t<decltype(E::kAddA)>> : std::bool_constant<E::kAddA> {};
template <class E, class = void>
struct EpiAddB : std::false_type {};
template <class E>
struct EpiAddB<E, std::void_t<decltype(E::kAddB)>> : std::bool_constant<E::kAddB> {};
template <class E>
constexpr bool kEpiAdds = EpiAddA<E>::value || EpiAddB<E>::value;

template <class Epi>
struct GemmParams {
  CUtensorMap a, b;        // 3-D maps: (inner, outer, batch)
  CUtensorMap add;         // EpiAddA / EpiAddB: the addend's, as its operand's
  int M, N, K, Z;
  int kz;                  // > 0: z splits K into slices of kz; else z is a batch index
  int za, zb;              // 1: the operand's batch coordinate is z; 0: shared
  Epi epi;
};

template <bool kBf16, bool kAdd = false>
struct GemmLayout {
  // bf16: 4 stages, two 16 KB converted buffers (A and B, 8 KB each);
  // 3xTF32: 3 stages, two 64 KB converted buffers (A big, A small, B big,
  // B small), 225 KB in all: the next slice converts while this one
  // multiplies.  With an addend a stage holds its tile too, and there are
  // two stages.
  static constexpr int kStages = kAdd ? 2 : kBf16 ? 4 : 3;
  static constexpr int kStageTiles = kAdd ? 3 : 2;
  static constexpr int kCvtTile = kBf16 ? kGemmTileBytes / 2 : kGemmTileBytes;
  static constexpr int kCvtBytes = kBf16 ? 2 * kCvtTile : 4 * kCvtTile;
  static constexpr size_t kSmem = 1024 + (size_t)kStages * kStageTiles * kGemmTileBytes +
                                  2 * (size_t)kCvtBytes + 2 * kStages * sizeof(uint64_t);
  static_assert(kSmem <= 232448, "shared memory of one block");
};

template <bool kBf16, bool kAT, bool kBT, class Epi>
__global__ void __launch_bounds__(kGemmThreads, 1)
wg_gemm_kernel(const __grid_constant__ GemmParams<Epi> p) {
  constexpr bool kAdd = kEpiAdds<Epi>, kAddA = EpiAddA<Epi>::value;
  static_assert(!(EpiAddA<Epi>::value && EpiAddB<Epi>::value), "one addend a product");
  using Lay = GemmLayout<kBf16, kAdd>;
  constexpr int kStages = Lay::kStages;
  constexpr int kStageBytes = Lay::kStageTiles * kGemmTileBytes;
  extern __shared__ uint8_t gemm_smem_raw[];
  char* smem = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(gemm_smem_raw) + 1023) & ~(uintptr_t)1023);
  char* stages = smem;
  char* cvt = stages + kStages * kStageBytes;   // [2][A big, (A small), B big, (B small)]
  uint64_t* full = reinterpret_cast<uint64_t*>(cvt + 2 * Lay::kCvtBytes);
  uint64_t* empty = full + kStages;

  const int tiles_m = (p.M + kGemmBM - 1) / kGemmBM, tiles_n = (p.N + kGemmBN - 1) / kGemmBN;
  const int ntiles = tiles_m * tiles_n * p.Z;
  // tile t -> (z, m tile, n tile), n fastest: the blocks in flight share
  // A's rows, read once from device memory; k slices of tile t: nk from
  // k_begin
  auto tile_of = [&](int t, int& z, int& m0, int& n0, int& k_begin, int& nk) {
    z = t / (tiles_m * tiles_n);
    const int rest = t % (tiles_m * tiles_n);
    m0 = (rest / tiles_n) * kGemmBM;
    n0 = (rest % tiles_n) * kGemmBN;
    k_begin = p.kz > 0 ? z * p.kz : 0;
    const int k_end = p.kz > 0 ? min(p.K, k_begin + p.kz) : p.K;
    nk = (k_end - k_begin + kGemmBK - 1) / kGemmBK;
  };
  // EpiAddA / EpiAddB: whether tile (m0, n0) takes the addend
  auto adds = [&](int m0, int n0) {
    if constexpr (EpiAddA<Epi>::value) return p.epi.add_a(n0) != nullptr;
    if constexpr (EpiAddB<Epi>::value) return p.epi.add_b(m0) != nullptr;
    return false;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_addr(full + s), 1);
      mbar_init(smem_addr(empty + s), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The block walks tiles blockIdx.x, blockIdx.x + gridDim.x, ...; the
  // ring's slice counter `it` runs on across tiles, so the producer loads
  // the next tile's first slices while the consumers run this one's
  // epilogue.
  if (threadIdx.x >= 256) {
    // producer warp: one lane issues every load
    if (threadIdx.x == 256) {
      int it = 0;
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
        int z, m0, n0, k_begin, nk;
        tile_of(t, z, m0, n0, k_begin, nk);
        const int za = p.za ? z : 0, zb = p.zb ? z : 0;
        const bool add = adds(m0, n0);
        for (int i = 0; i < nk; ++i, ++it) {
          const int s = it % kStages;
          const unsigned ph = (unsigned)(it / kStages) & 1u;
          mbar_wait(smem_addr(empty + s), ph ^ 1u);
          const uint32_t bar = smem_addr(full + s);
          mbar_expect_tx(bar, (add ? 3 : 2) * kGemmTileBytes);
          const int k = k_begin + i * kGemmBK;
          const uint32_t dst = smem_addr(stages + s * kStageBytes);
          if constexpr (kAT)
            tma_load_3d(dst, &p.a, bar, m0, k, za);
          else
            tma_load_3d(dst, &p.a, bar, k, m0, za);
          if constexpr (kBT)
            tma_load_3d(dst + kGemmTileBytes, &p.b, bar, n0, k, zb);
          else
            tma_load_3d(dst + kGemmTileBytes, &p.b, bar, k, n0, zb);
          if (add) {            // the addend, in its operand's coordinates
            const bool t = kAddA ? kAT : kBT;
            const int row = kAddA ? m0 : n0, zz = kAddA ? za : zb;
            tma_load_3d(dst + 2 * kGemmTileBytes, &p.add, bar, t ? row : k, t ? k : row, zz);
          }
        }
      }
    }
    return;
  }

  // consumers
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  constexpr uint32_t kRowBytes = kBf16 ? 64 : 128;
  constexpr uint64_t kMode = kBf16 ? 2 : 1;
  constexpr int kTiles = kBf16 ? 1 : 2;   // converted tiles per operand: big (, small)
  const int warp = tid >> 5, lane = tid & 31;
  const Epi epi = p.epi;       // in registers, not read through the parameter's address
  auto buf = [&](int i, int which) {      // which: 0 A big, 1 A small, 2 B big, 3 B small
    return cvt + (i & 1) * Lay::kCvtBytes + (which >> 1) * kTiles * Lay::kCvtTile +
           (which & 1) * Lay::kCvtTile;
  };
  // wgmma of converted slice i into part (summed from zero)
  auto mma = [&](float (&part)[64], int i) {
    const uint32_t ah = smem_addr(buf(i, 0) + 64 * wg * kRowBytes),
                   al = smem_addr(buf(i, 1) + 64 * wg * kRowBytes);
    const uint32_t bh = smem_addr(buf(i, 2)), bl = smem_addr(buf(i, 3));
    wg_fence();
    if constexpr (kBf16) {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        wgmma_bf16(part, wg_desc(ah + 32 * kk, 8 * kRowBytes, kMode),
                   wg_desc(bh + 32 * kk, 8 * kRowBytes, kMode), kk);
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_tf32(part, wg_desc(al + 32 * kk, 8 * kRowBytes, kMode),
                   wg_desc(bh + 32 * kk, 8 * kRowBytes, kMode), kk);
        wgmma_tf32(part, wg_desc(ah + 32 * kk, 8 * kRowBytes, kMode),
                   wg_desc(bl + 32 * kk, 8 * kRowBytes, kMode), 1);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_tf32(part, wg_desc(ah + 32 * kk, 8 * kRowBytes, kMode),
                   wg_desc(bh + 32 * kk, 8 * kRowBytes, kMode), 1);
    }
    wg_commit();
  };
  int it = 0;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    int z, m0, n0, k_begin, nk;
    tile_of(t, z, m0, n0, k_begin, nk);
    float acc[64], part[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;
    float colsum = 0.f;   // EpiColSum: this thread's row of A, summed over the tile's k
    const bool add = adds(m0, n0);
    // slice i converts (buffer i mod 2) while slice i - 1 multiplies; the
    // tensor cores truncate a float32 sum to the running sum's exponent,
    // so each slice is summed from zero (small cross terms first) and only
    // then added to acc with an ordinary rounded add
    for (int i = 0; i < nk; ++i, ++it) {
      const int s = it % kStages;
      mbar_wait(smem_addr(full + s), (unsigned)(it / kStages) & 1u);
      const char* st = stages + s * kStageBytes;
      // the addend's group at the same place of its staged tile
      const auto plus_add = [&](int g, float4 x) {
        constexpr bool kT = kAddA ? kAT : kBT;
        int r, c, off;
        slice_group<kT>(wg, tid, g, r, c, off);
        const char* at = st + 2 * kGemmTileBytes;
        float4 v;
        if constexpr (kT) {
          const float* src = reinterpret_cast<const float*>(at) + (4 * c) * kGemmBM + r;
          v = make_float4(src[0], src[kGemmBM], src[2 * kGemmBM], src[3 * kGemmBM]);
        } else {
          v = *reinterpret_cast<const float4*>(at + off);
        }
        x.x += v.x;
        x.y += v.y;
        x.z += v.z;
        x.w += v.w;
        return x;
      };
      if constexpr (EpiColSum<Epi>::value) {
        convert_slice<kBf16, kAT>(st, buf(it, 0), buf(it, 1), wg, tid, [&](int, float4 x) {
          colsum += x.x;
          colsum += x.y;
          colsum += x.z;
          colsum += x.w;
          return x;
        });
      } else if (kAddA && add) {
        convert_slice<kBf16, kAT>(st, buf(it, 0), buf(it, 1), wg, tid, plus_add);
      } else {
        convert_slice<kBf16, kAT>(st, buf(it, 0), buf(it, 1), wg, tid);
      }
      if (kAdd && !kAddA && add)
        convert_slice<kBf16, kBT>(st + kGemmTileBytes, buf(it, 2), buf(it, 3), wg, tid, plus_add);
      else
        convert_slice<kBf16, kBT>(st + kGemmTileBytes, buf(it, 2), buf(it, 3), wg, tid);
      mbar_arrive(smem_addr(empty + s));
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      if (i > 0) {
        wg_wait_all();
#pragma unroll
        for (int i2 = 0; i2 < 64; ++i2) acc[i2] += part[i2];
      }
      // both groups' conversions of slice i are visible, and both groups'
      // products of slice i - 1 are done (its buffer is free for i + 1)
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
      mma(part, it);
    }
    wg_wait_all();
#pragma unroll
    for (int i2 = 0; i2 < 64; ++i2) acc[i2] += part[i2];
    if constexpr (EpiColSum<Epi>::value) {
      const int m = m0 + 64 * wg + (tid & 63);
      if (n0 == 0 && m < p.M) epi.colsum(z, tid >> 6, m, colsum);
    }

    // epilogue on the registers: accumulators 4 j + 2 h + {0, 1} hold row
    // 16 warp + lane / 4 + 8 h, columns 8 j + 2 (lane mod 4) + {0, 1}; the
    // epilogue's inputs of 4 pairs are loaded before any is stored, so
    // their latencies overlap
    const int row0 = m0 + 64 * wg + 16 * warp + (lane >> 2), col0 = n0 + 2 * (lane & 3);
#pragma unroll
    for (int jb = 0; jb < 16; jb += 2) {
      typename Epi::In in[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row0 + 8 * h, c = col0 + 8 * (jb + j);
          if (r < p.M && c + 1 < p.N) in[j][h] = epi.load(r, c);
        }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        // an epilogue with a dropout mask draws it here, the whole warp
        // taking part (Epi::warp_keep), for both of the thread's rows
        float kp[2][2] = {{1.f, 1.f}, {1.f, 1.f}};
        if constexpr (Epi::kWarpKeep) epi.warp_keep(z, row0, row0 + 8, col0 + 8 * (jb + j), kp);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row0 + 8 * h, c = col0 + 8 * (jb + j);
          const int a = 4 * (jb + j) + 2 * h;
          if (r >= p.M || c >= p.N) continue;
          if (c + 1 < p.N)
            epi.pair(z, r, c, acc[a], acc[a + 1], in[j][h], kp[h]);
          else
            epi(z, r, c, acc[a]);
        }
      }
    }
    // the next tile's first conversion reuses buffer `it` mod 2 only after
    // both groups' last products here are done
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
  }
}

// ---- host side

typedef CUresult (*TensorMapEncodeFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                      const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                      const cuuint32_t*, CUtensorMapInterleave,
                                      CUtensorMapSwizzle, CUtensorMapL2promotion,
                                      CUtensorMapFloatOOBfill);

inline TensorMapEncodeFn tensor_map_encoder() {
  static TensorMapEncodeFn fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib ? reinterpret_cast<TensorMapEncodeFn>(dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

// A float32 operand in device memory: `outer` rows of `inner` contiguous
// values (row stride ld elements, a multiple of 4), `batch` such matrices
// bstride elements apart.  K-major operands have inner = K; MN-major ones
// inner = M (or N) and outer = K.
struct Operand {
  const float* p;
  long ld;
  int outer, inner;
  long bstride = 0;
  int batch = 1;
};

// Everything a map's encoding takes: a map stays valid for as long as the
// same geometry is asked of the same pointer.
struct MapKey {
  const void* p;
  cuuint64_t dims[3], strides[2];
  cuuint32_t box[2];
  int swizzle;
  bool operator==(const MapKey& o) const {
    return p == o.p && std::equal(dims, dims + 3, o.dims) &&
           std::equal(strides, strides + 2, o.strides) && box[0] == o.box[0] &&
           box[1] == o.box[1] && swizzle == o.swizzle;
  }
  size_t hash() const {
    size_t h = (size_t)p;
    for (cuuint64_t v : {dims[0], dims[1], dims[2], strides[0], strides[1], (cuuint64_t)box[0],
                         (cuuint64_t)box[1], (cuuint64_t)swizzle})
      h = (h ^ (size_t)v) * 0x100000001b3ull;
    return h;
  }
};

// The maps encoded so far, direct-mapped by MapKey (a miss encodes again):
// the launches of a layer's step ask for the same maps at every call, and
// a launch that finds its maps here spends no host time encoding them.
constexpr int kMapCache = 1024;
struct MapCache {
  std::mutex mu;
  MapKey key[kMapCache];
  CUtensorMap map[kMapCache];
  bool used[kMapCache];
};

// A 3-D map of the operand with a box of box_inner x box_outer values (one
// matrix of the batch) and the given swizzle.
inline bool encode_map(CUtensorMap* map, const Operand& o, int box_inner, int box_outer,
                       CUtensorMapSwizzle swizzle) {
  static MapCache cache;
  const MapKey key{o.p,
                   {(cuuint64_t)o.inner, (cuuint64_t)o.outer, (cuuint64_t)o.batch},
                   {(cuuint64_t)o.ld * 4,
                    (cuuint64_t)(o.batch > 1 ? o.bstride : (long)o.outer * o.ld) * 4},
                   {(cuuint32_t)box_inner, (cuuint32_t)box_outer},
                   (int)swizzle};
  const size_t slot = key.hash() % kMapCache;
  {
    std::lock_guard<std::mutex> lock(cache.mu);
    if (cache.used[slot] && cache.key[slot] == key) {
      *map = cache.map[slot];
      return true;
    }
  }
  TensorMapEncodeFn enc = tensor_map_encoder();
  if (enc == nullptr) return false;
  const cuuint32_t box[3] = {key.box[0], key.box[1], 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  if (enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(o.p), key.dims, key.strides,
          box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  std::lock_guard<std::mutex> lock(cache.mu);
  cache.key[slot] = key;
  cache.map[slot] = *map;
  cache.used[slot] = true;
  return true;
}

// A 3-D map of the operand with a box of one staged slice: K-major
// (32 k x 128 rows, 128-byte swizzle) or MN-major (128 x 32 k, plain).
inline bool encode_operand(CUtensorMap* map, const Operand& o, bool mn_major) {
  return mn_major ? encode_map(map, o, kGemmBM, kGemmBK, CU_TENSOR_MAP_SWIZZLE_NONE)
                  : encode_map(map, o, kGemmBK, kGemmBM, CU_TENSOR_MAP_SWIZZLE_128B);
}

// C = epi(A . B^T) over an M x N output per z < Z: kAT / kBT say
// the operand is MN-major.  kz > 0 splits K into slices of kz (a multiple
// of kGemmBK), one per z; else za / zb say which operands are batched by
// z.  Returns the launch's error (cudaErrorInvalidValue when a map fails
// to encode).
template <bool kBf16, bool kAT, bool kBT, class Epi>
cudaError_t wg_gemm(const Operand& A, const Operand& B, int M, int N, int K, int Z, int kz,
                    bool za, bool zb, const Epi& epi, cudaStream_t s) {
  if (M <= 0 || N <= 0 || Z <= 0) return cudaSuccess;
  GemmParams<Epi> p;
  if (!encode_operand(&p.a, A, kAT) || !encode_operand(&p.b, B, kBT))
    return cudaErrorInvalidValue;
  if constexpr (kEpiAdds<Epi>) {   // the addend: its operand's shape, its own pointer and stride
    constexpr bool kA = EpiAddA<Epi>::value;
    Operand o = kA ? A : B;
    if constexpr (kA) {
      o.p = epi.add_a(0);
      o.ld = epi.add_a_ld();
    } else {
      o.p = epi.add_b(0);
      o.ld = epi.add_b_ld();
    }
    if (!encode_operand(&p.add, o, kA ? kAT : kBT)) return cudaErrorInvalidValue;
  }
  p.M = M;
  p.N = N;
  p.K = K;
  p.Z = Z;
  p.kz = kz;
  p.za = za;
  p.zb = zb;
  p.epi = epi;
  auto* kernel = wg_gemm_kernel<kBf16, kAT, kBT, Epi>;
  constexpr size_t kSmem = GemmLayout<kBf16, kEpiAdds<Epi>>::kSmem;
  // once per device and instantiation: the shared-memory limit; and the
  // device's SM count (the persistent grid)
  static int ready[64], sm_count[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= 64) return err != cudaSuccess ? err : cudaErrorInvalidDevice;
  if (!ready[dev]) {
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)kSmem)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sm_count[dev], cudaDevAttrMultiProcessorCount, dev)) !=
            cudaSuccess)
      return err;
    ready[dev] = 1;
  }
  const int sms = sm_count[dev];
  const long tiles = (long)((M + kGemmBM - 1) / kGemmBM) * ((N + kGemmBN - 1) / kGemmBN) * Z;
  kernel<<<(unsigned)std::min<long>(tiles, sms), kGemmThreads, kSmem, s>>>(p);
  return cudaGetLastError();
}

// Epilogue of a weight gradient's slice z: P[z][m][n] = value.
struct PartialEpi {
  float* P;
  int M, N;
  static constexpr bool kWarpKeep = false;
  struct In {};
  __device__ In load(int, int) const { return {}; }
  __device__ void operator()(int z, int m, int n, float v) const {
    P[((size_t)z * M + m) * N + n] = v;
  }
  __device__ void pair(int z, int m, int n, float v0, float v1, In, const float (&)[2]) const {
    *reinterpret_cast<float2*>(P + ((size_t)z * M + m) * N + n) = make_float2(v0, v1);
  }
};

// PartialEpi, and the column sums of A (a bias gradient beside its weight
// gradient): Pb[z][half][m], the two halves of row m's sum over slice z.
struct PartialSumEpi : PartialEpi {
  float* Pb;
  static constexpr bool kColSum = true;
  __device__ void colsum(int z, int half, int m, float v) const {
    Pb[((size_t)z * 2 + half) * M + m] = v;
  }
};

// PartialSumEpi with an addend of B for the output rows m < rows (a
// multiple of the tile's 128): dW = G^T (H + add) there, G^T H below.
struct PartialSumAddEpi : PartialSumEpi {
  const float* add;
  long ld;
  int rows;
  static constexpr bool kAddB = true;
  __host__ __device__ const float* add_b(int m0) const { return m0 < rows ? add : nullptr; }
  __host__ __device__ long add_b_ld() const { return ld; }
};

}  // namespace
