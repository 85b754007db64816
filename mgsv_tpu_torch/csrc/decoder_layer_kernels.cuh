// Pieces of the post-norm DETR decoder layer shared by fused_decoder_layer.cu
// (the forward) and fused_decoder_layer_bwd.cu (its backward): the
// cross-attention of Q query rows over the L memory rows of their batch
// row, the attention backward that both of the layer's attentions run, the
// set of activations the training forward keeps for the backward, and the
// layer's forward launches.
//
// Layouts: query-side tensors are [B*Q, D] (row b Q + i), memory-side
// [B*L, D]; the cross-attention's k | v of the memory sit in one [B*L, 2D]
// buffer (k from memory + pos, v from memory, one GEMM over all B*L rows);
// every weight is in torch's [out, in] layout, in_proj_weight rows q|k|v.
#pragma once

#include "layer_bwd_kernels.cuh"

namespace {

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

__host__ __device__ constexpr size_t cross_attention_smem_bytes(int L) {
  return sizeof(float) * (size_t)(2 * L * kPad + round4(L) + kWarps * round4(L));
}

// One block per (head, batch row).  The head's k and v of the batch row's
// L memory rows ([L, 32] each) sit in shared memory; each warp takes one
// query row at a time: scores one key per lane (a masked key scores -1e9,
// so a row with no valid key gets uniform weights, as JAX's NEG_INF does),
// softmax, then p v with one lane per head channel.  ctx [B*Q, D]; given
// stats, each row's softmax max and sum of exp [B, H, Q] (for a backward).
__global__ void __launch_bounds__(kThreads)
cross_attention_kernel(const float* __restrict__ q, const float* __restrict__ kv,
                       const float* __restrict__ mask, float* __restrict__ ctx,
                       float2* __restrict__ stats, int Q, int L) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int h = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* k_s = smem;                  // [L][kPad]
  float* v_s = k_s + L * kPad;        // [L][kPad]
  float* m_s = v_s + L * kPad;        // [L] key mask
  float* p = m_s + round4(L) + warp * round4(L);   // this warp's softmax row
  const float scale = 1.0f / sqrtf((float)kHeadDim);

  // the head's k and v rows (128 contiguous bytes each), 16 bytes per load
  const float* base = kv + (size_t)b * L * 2 * kCols + h * kHeadDim;
  for (int e = threadIdx.x; e < L * kHeadDim / 4; e += kThreads) {
    const int r = e / (kHeadDim / 4), c = 4 * (e % (kHeadDim / 4));
    const float4 kr = *reinterpret_cast<const float4*>(base + (size_t)r * 2 * kCols + c);
    const float4 vr = *reinterpret_cast<const float4*>(base + (size_t)r * 2 * kCols + kCols + c);
    float *kd = k_s + r * kPad + c, *vd = v_s + r * kPad + c;
    kd[0] = kr.x; kd[1] = kr.y; kd[2] = kr.z; kd[3] = kr.w;
    vd[0] = vr.x; vd[1] = vr.y; vd[2] = vr.z; vd[3] = vr.w;
  }
  for (int j = threadIdx.x; j < L; j += kThreads) m_s[j] = mask[(size_t)b * L + j];
  __syncthreads();

  for (int i = warp; i < Q; i += kWarps) {
    const float* qrow = q + ((size_t)b * Q + i) * kCols + h * kHeadDim;
    float qi[kHeadDim];
#pragma unroll
    for (int c = 0; c < kHeadDim; ++c) qi[c] = qrow[c] * scale;
    float mx = -INFINITY;
    for (int j = lane; j < L; j += 32) {
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < kHeadDim; ++c) s = fmaf(qi[c], k_s[j * kPad + c], s);
      if (m_s[j] == 0.f) s = kBigNeg;
      p[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < L; j += 32) {
      const float e = expf(p[j] - mx);
      p[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    if (stats != nullptr && lane == 0)
      stats[((size_t)b * gridDim.x + h) * Q + i] = make_float2(mx, sum);
    __syncwarp();
    float acc = 0.f;
    for (int j = 0; j < L; ++j) acc = fmaf(p[j], v_s[j * kPad + lane], acc);
    ctx[((size_t)b * Q + i) * kCols + h * kHeadDim + lane] = acc / sum;
    __syncwarp();
  }
}

// ---- the attention backward of both attentions, by key rows

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

constexpr int kRowsChunk = 32;           // key rows a chunk: one per lane
// The most shared memory a block of attention_rows_bwd_kernel should take
// (a block with one head takes more when Q is large: 185 KB at Q = 256).
constexpr size_t kRowsBwdSmem = 110 * 1024;

// What attention_rows_bwd_kernel reads and writes: rows of q (ldq apart)
// and of k and v (ldkv apart) hold head h's 32 channels at columns 32 h;
// dctx and ctx are [B*Lq, D]; stats the forward's softmax max and sum of
// exp of each query row [B, H, Lq]; mask [B, Lk].
struct RowsBwd {
  const float *q, *k, *v;
  int ldq, ldkv;
  const float *dctx, *ctx;
  const float2* stats;
  const float* mask;
  float *dq, *dk, *dv;
  int lddq, lddkv;
  int Lq, Lk, G;           // G: heads a block, one warp each
};

// a staged chunk row: k | v of the block's G heads, padded by 16 bytes so
// that lanes reading consecutive rows hit distinct banks
__host__ __device__ constexpr int rows_bwd_stride(int G) { return 64 * G + 4; }
// two chunk buffers; per query row and head q, dctx, the dq sums, the
// chunk's p and ds, and (max, 1 / sum, D)
__host__ __device__ constexpr size_t rows_bwd_smem_bytes(int Lq, int G) {
  return sizeof(float) *
         ((size_t)2 * kRowsChunk * rows_bwd_stride(G) + (size_t)Lq * G * (5 * kHeadDim + 4));
}
// heads a block: the most (of 8, 4, 2, 1) whose shared memory stays within
// kRowsBwdSmem, at least one
inline int rows_bwd_group(int Lq, int H) {
  int G = H < 8 ? H : 8;
  while (G > 1 && (rows_bwd_smem_bytes(Lq, G) > kRowsBwdSmem || H % G)) G /= 2;
  return G;
}

// The backward of softmax attention, given the forward's row statistics,
// by key rows: one block per (batch row, group of G heads), one warp per
// head.  The block keeps its heads' slices of the Lq query rows in shared
// memory (q scaled by 1/sqrt(32), dctx, the dq sums) with each row's max,
// 1 / sum and D_i = dctx_i . ctx_i (= sum_j p_ij dp_ij, since ctx_i =
// sum_j p_ij v_j), and streams the Lk key rows through in chunks of 32,
// whole k | v rows of its heads at a time (16-byte cp.async, coalesced, the
// next chunk loading while this one is worked on).  A lane takes one key
// row j: first, holding k_j and v_j, it rebuilds p_ij = exp(s_ij - max_i)
// / sum_i and ds_ij = p_ij (dctx_i . v_j - D_i) for every query i (the
// queries independent of one another); then it sums dv_j = sum_i p_ij
// dctx_i and dk_j = sum_i ds_ij q_i; then lane c sums dq_ic += sum_j ds_ij
// k_jc over the chunk.  dk | dv leave through shared memory as whole rows;
// dq is written once at the end.  Every key row is read once and written
// once, no score is computed twice and every sum has one owner, in a fixed
// order: no atomics.  JAX's semantics: a masked key (kMask: mask 0)
// scores -1e9 (a row with no valid key gets uniform weights); it gets no
// dk and feeds no dq, since its score is a constant, but it does get dv.
template <bool kMask>
__global__ void __launch_bounds__(256, 1)
attention_rows_bwd_kernel(const RowsBwd a) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int G = a.G, RS = rows_bwd_stride(G), W = kHeadDim * G, nthreads = 32 * G;
  const int grp = blockIdx.x, b = blockIdx.y, H = gridDim.x * G;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, h = grp * G + w;
  const int Lq = a.Lq, Lk = a.Lk;
  float* buf = sm;                                   // [2][kRowsChunk][RS]
  float* qs = buf + 2 * kRowsChunk * RS;             // [Lq][W] q * scale
  float* dcs = qs + Lq * W;                          // [Lq][W] dctx
  float* dqa = dcs + Lq * W;                         // [Lq][W] sum_j ds_ij k_j
  float* pss = dqa + Lq * W;                         // [G][Lq][32] the chunk's p
  float* dss = pss + G * Lq * kRowsChunk;            // [G][Lq][32] the chunk's ds
  float4* st = reinterpret_cast<float4*>(dss + G * Lq * kRowsChunk);   // [G][Lq]
  const float scale = 1.0f / sqrtf((float)kHeadDim);
  const size_t qrow0 = (size_t)b * Lq, krow0 = (size_t)b * Lk;
  const int col0 = grp * W;                          // the group's first channel

  // rows [j0, j0 + n) of the group's k | v into buffer `slot`
  auto load_chunk = [&](int j0, int slot) {
    const int n = min(kRowsChunk, Lk - j0);
    float* dst = buf + slot * kRowsChunk * RS;
    for (int e = threadIdx.x; e < n * 16 * G; e += nthreads) {
      const int r = e / (16 * G), c4 = e % (16 * G);
      const bool is_v = c4 >= 8 * G;
      const float* src = (is_v ? a.v : a.k) + (krow0 + j0 + r) * a.ldkv + col0 +
                         4 * (is_v ? c4 - 8 * G : c4);
      cp_async16(dst + r * RS + 4 * c4, src);
    }
    cp_async_commit();
  };
  load_chunk(0, 0);

  for (int e = threadIdx.x; e < Lq * W; e += nthreads) {
    const int i = e / W, c = e % W;
    qs[e] = a.q[(qrow0 + i) * a.ldq + col0 + c] * scale;
    dcs[e] = a.dctx[(qrow0 + i) * kCols + col0 + c];
    dqa[e] = 0.f;
  }
  // warp w: head h's row statistics, a lane a query row; D_i summed in
  // the order dp_ij is below, so that a row whose one valid key j has ctx_i
  // = v_j gets ds_ij = 0 exactly, as autograd's softmax gives it
  for (int i = lane; i < Lq; i += 32) {
    const size_t o = (qrow0 + i) * kCols + h * kHeadDim;
    const float4 *dr = reinterpret_cast<const float4*>(a.dctx + o),
                 *cr = reinterpret_cast<const float4*>(a.ctx + o);
    float t0 = 0.f, t1 = 0.f;
#pragma unroll
    for (int c4 = 0; c4 < kHeadDim / 4; ++c4) {
      const float4 y = dr[c4], x = cr[c4];
      t0 = fmaf(y.x, x.x, t0);
      t1 = fmaf(y.y, x.y, t1);
      t0 = fmaf(y.z, x.z, t0);
      t1 = fmaf(y.w, x.w, t1);
    }
    const float2 s = a.stats[((size_t)b * H + h) * Lq + i];
    st[w * Lq + i] = make_float4(s.x, 1.f / s.y, t0 + t1, 0.f);
  }

  float* my_p = pss + w * Lq * kRowsChunk;           // this warp's [Lq][32]
  float* my_ds = dss + w * Lq * kRowsChunk;
  const int chunks = (Lk + kRowsChunk - 1) / kRowsChunk;
  for (int ch = 0; ch < chunks; ++ch) {
    const int j0 = ch * kRowsChunk, n = min(kRowsChunk, Lk - j0);
    if (ch + 1 < chunks) {
      load_chunk(j0 + kRowsChunk, (ch + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();           // this chunk (and, the first time, the query rows) visible
    float* kb = buf + (ch & 1) * kRowsChunk * RS;
    float* row = kb + lane * RS + w * kHeadDim;       // this lane's key row, head h
    const bool live = lane < n;
    const bool valid = live && (!kMask || a.mask[krow0 + j0 + lane] != 0.f);

    {  // p_ij and ds_ij for every query i
      float kj[kHeadDim], vj[kHeadDim];
#pragma unroll
      for (int c4 = 0; c4 < kHeadDim / 4; ++c4) {
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
        if (live) {
          x = *reinterpret_cast<const float4*>(row + 4 * c4);
          y = *reinterpret_cast<const float4*>(row + W + 4 * c4);
        }
        kj[4 * c4] = x.x; kj[4 * c4 + 1] = x.y; kj[4 * c4 + 2] = x.z; kj[4 * c4 + 3] = x.w;
        vj[4 * c4] = y.x; vj[4 * c4 + 1] = y.y; vj[4 * c4 + 2] = y.z; vj[4 * c4 + 3] = y.w;
      }
#pragma unroll 2
      for (int i = 0; i < Lq; ++i) {
        const float4* q4 = reinterpret_cast<const float4*>(qs + i * W + w * kHeadDim);
        const float4* d4 = reinterpret_cast<const float4*>(dcs + i * W + w * kHeadDim);
        float s0 = 0.f, s1 = 0.f, t0 = 0.f, t1 = 0.f;
#pragma unroll
        for (int c4 = 0; c4 < kHeadDim / 4; ++c4) {
          const float4 x = q4[c4], y = d4[c4];
          s0 = fmaf(x.x, kj[4 * c4], s0);
          s1 = fmaf(x.y, kj[4 * c4 + 1], s1);
          s0 = fmaf(x.z, kj[4 * c4 + 2], s0);
          s1 = fmaf(x.w, kj[4 * c4 + 3], s1);
          t0 = fmaf(y.x, vj[4 * c4], t0);
          t1 = fmaf(y.y, vj[4 * c4 + 1], t1);
          t0 = fmaf(y.z, vj[4 * c4 + 2], t0);
          t1 = fmaf(y.w, vj[4 * c4 + 3], t1);
        }
        const float4 sti = st[w * Lq + i];
        float p = 0.f, ds = 0.f;
        if (live) {
          p = expf((valid ? s0 + s1 : kBigNeg) - sti.x) * sti.y;
          if (valid) ds = p * (t0 + t1 - sti.z);
        }
        my_p[i * kRowsChunk + lane] = p;
        my_ds[i * kRowsChunk + lane] = ds;
      }
    }
    {  // dv_j = sum_i p_ij dctx_i and dk_j = scale sum_i ds_ij q_i (q staged
       // scaled), into this warp's slice of the chunk's rows
      float dk[kHeadDim], dv[kHeadDim];
#pragma unroll
      for (int c = 0; c < kHeadDim; ++c) dk[c] = dv[c] = 0.f;
      for (int i = 0; i < Lq; ++i) {
        const float4* q4 = reinterpret_cast<const float4*>(qs + i * W + w * kHeadDim);
        const float4* d4 = reinterpret_cast<const float4*>(dcs + i * W + w * kHeadDim);
        const float p = my_p[i * kRowsChunk + lane], ds = my_ds[i * kRowsChunk + lane];
#pragma unroll
        for (int c4 = 0; c4 < kHeadDim / 4; ++c4) {
          const float4 x = q4[c4], y = d4[c4];
          dv[4 * c4] = fmaf(p, y.x, dv[4 * c4]);
          dv[4 * c4 + 1] = fmaf(p, y.y, dv[4 * c4 + 1]);
          dv[4 * c4 + 2] = fmaf(p, y.z, dv[4 * c4 + 2]);
          dv[4 * c4 + 3] = fmaf(p, y.w, dv[4 * c4 + 3]);
          dk[4 * c4] = fmaf(ds, x.x, dk[4 * c4]);
          dk[4 * c4 + 1] = fmaf(ds, x.y, dk[4 * c4 + 1]);
          dk[4 * c4 + 2] = fmaf(ds, x.z, dk[4 * c4 + 2]);
          dk[4 * c4 + 3] = fmaf(ds, x.w, dk[4 * c4 + 3]);
        }
      }
      // lane c's k column of the chunk, for dq, before dk overwrites it
      float kc[kRowsChunk];
#pragma unroll
      for (int j = 0; j < kRowsChunk; ++j)
        kc[j] = j < n ? kb[j * RS + w * kHeadDim + lane] : 0.f;
      __syncwarp();
      if (live) {
#pragma unroll
        for (int c4 = 0; c4 < kHeadDim / 4; ++c4) {
          *reinterpret_cast<float4*>(row + 4 * c4) =
              make_float4(dk[4 * c4], dk[4 * c4 + 1], dk[4 * c4 + 2], dk[4 * c4 + 3]);
          *reinterpret_cast<float4*>(row + W + 4 * c4) =
              make_float4(dv[4 * c4], dv[4 * c4 + 1], dv[4 * c4 + 2], dv[4 * c4 + 3]);
        }
      }
      // dq: lane c sums ds_ij k_jc over the chunk's keys j, query by query
#pragma unroll 2
      for (int i = 0; i < Lq; ++i) {
        const float4* d4 = reinterpret_cast<const float4*>(my_ds + i * kRowsChunk);
        float u0 = 0.f, u1 = 0.f;
#pragma unroll
        for (int j4 = 0; j4 < kRowsChunk / 4; ++j4) {
          const float4 x = d4[j4];
          u0 = fmaf(x.x, kc[4 * j4], u0);
          u1 = fmaf(x.y, kc[4 * j4 + 1], u1);
          u0 = fmaf(x.z, kc[4 * j4 + 2], u0);
          u1 = fmaf(x.w, kc[4 * j4 + 3], u1);
        }
        dqa[i * W + w * kHeadDim + lane] += u0 + u1;
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < n * 16 * G; e += nthreads) {   // the rows out, whole
      const int r = e / (16 * G), c4 = e % (16 * G);
      const bool is_v = c4 >= 8 * G;
      float* dst = (is_v ? a.dv : a.dk) + (krow0 + j0 + r) * a.lddkv + col0 +
                   4 * (is_v ? c4 - 8 * G : c4);
      *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(kb + r * RS + 4 * c4);
    }
    __syncthreads();           // the buffer is free for the chunk after next
  }
  for (int e = threadIdx.x; e < Lq * W; e += nthreads) {
    const int i = e / W, c = e % W;
    a.dq[(qrow0 + i) * a.lddq + col0 + c] = dqa[e] * scale;
  }
}

// Launches attention_rows_bwd_kernel over B batch rows and H heads (a
// null mask: every key valid).
inline cudaError_t launch_attention_rows_bwd(RowsBwd a, int B, int H, cudaStream_t s) {
  a.G = rows_bwd_group(a.Lq, H);
  auto* kernel = a.mask ? attention_rows_bwd_kernel<true> : attention_rows_bwd_kernel<false>;
  kernel<<<dim3(H / a.G, B), 32 * a.G, rows_bwd_smem_bytes(a.Lq, a.G), s>>>(a);
  return cudaGetLastError();
}

// The decoder layer's weights, torch [out, in] layout; the self-attention's
// six are null without self-attention.
struct DecoderWeights {
  const float *sa_w_in, *sa_b_in, *sa_w_out, *sa_b_out, *n1_g, *n1_b;
  const float *ca_w_in, *ca_b_in, *ca_w_out, *ca_b_out, *n2_g, *n2_b;
  const float *w1, *b1, *w2, *b2, *n3_g, *n3_b;
};

// Dynamic shared memory of every launch the forward and backward take,
// for Q and L up to kMaxL (the GEMM core sets its own at each launch).
inline cudaError_t decoder_layer_init() {
  cudaError_t err = layer_bwd_init(kMaxL);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(cross_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)cross_attention_smem_bytes(kMaxL));
  for (auto* kernel : {attention_rows_bwd_kernel<true>, attention_rows_bwd_kernel<false>})
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)std::max(kRowsBwdSmem, rows_bwd_smem_bytes(kMaxL, 1)));
  return err;
}

inline bool decoder_shape_ok(int B, int Q, int L, int D, int H, int F) {
  return B >= 1 && B <= kMaxB && Q >= 1 && Q <= kMaxL && L >= 1 && L <= kMaxL && D == kCols &&
         H * kHeadDim == D && F >= kCols && F % kCols == 0;
}

// What decoder_layer_fwd writes.  Memory side: the cross-attention's k | v
// [B*L, 2D].  Query side, [B*Q, D] each: with self-attention its q | k | v
// sa_qkv [B*Q, 3D], its context sa_ctx, r1 = tgt + sa_ctx Wo^T + bo and t1
// = LN1(r1); the cross-attention's q = (t1 + qpos) Wq^T + bq and ctx, r2
// and t2 = LN2(r2), h1 [B*Q, F] = relu(t2 W1^T + b1), r3 = t2 + h1 W2^T +
// b2; where not null, each LayerNorm's xhat and 1 / std, each attention's
// softmax max and sum of exp per query row [B, H, Q] (sa_stats, stats) and
// out = LN3(r3).
struct DecoderActs {
  float* kv;
  float *sa_qkv, *sa_ctx, *r1, *t1, *q, *ctx, *r2, *t2, *h1, *r3;
  float *xh1, *inv1, *xh2, *inv2, *xh3, *inv3, *out;
  float2 *sa_stats, *stats;
};

// What kernel #6's training forward keeps for its backward, in the order
// both C entries take the pointers and the wrapper allocates the tensors
// (ops/cuda/fused_decoder_layer.py::SAVED): the memory's k | v and every
// query-side activation the backward reads (without self-attention the
// six of its block are null).  3,875 floats a query row with
// self-attention at D = 256, F = 1024, H = 8, and 512 a memory row.
enum DecoderSaved : int { kDecKv, kDecSaQkv, kDecSaCtx, kDecSaStats, kDecT1, kDecXh1, kDecInv1,
                          kDecQ, kDecCtx, kDecStats, kDecT2, kDecXh2, kDecInv2, kDecH1,
                          kDecXh3, kDecInv3 };

inline DecoderActs decoder_saved(float* const* s) {
  DecoderActs t{};
  t.kv = s[kDecKv];
  t.sa_qkv = s[kDecSaQkv];
  t.sa_ctx = s[kDecSaCtx];
  t.sa_stats = reinterpret_cast<float2*>(s[kDecSaStats]);
  t.t1 = s[kDecT1];
  t.xh1 = s[kDecXh1];
  t.inv1 = s[kDecInv1];
  t.q = s[kDecQ];
  t.ctx = s[kDecCtx];
  t.stats = reinterpret_cast<float2*>(s[kDecStats]);
  t.t2 = s[kDecT2];
  t.xh2 = s[kDecXh2];
  t.inv2 = s[kDecInv2];
  t.h1 = s[kDecH1];
  t.xh3 = s[kDecXh3];
  t.inv3 = s[kDecInv3];
  return t;
}

// The decoder layer's forward, lq over the B*Q query rows and lm over the
// B*L memory rows (one stream), every product on the GEMM core, each sum
// with a positional embedding taken in its product's loads of A (no add
// launches): the cross-attention's k | v in one product of memory (+ pos
// for k's columns), skipped when kv_ready (t.kv then holds the
// forward's); with self-attention its q | k | v in one product of tgt (+
// qpos for q's and k's columns), the float32 attention over the Q queries,
// the out-projection with the residual tgt, LN1; the cross-attention's q
// from t1 + qpos; cross_attention_kernel; the out-projection with the
// residual t1, LN2; FFN1 (bias, ReLU); FFN2 with the residual t2; LN3.
// Kernel #6 (fused_decoder_layer.cu) keeps out (and, for a gradient, the
// DecoderSaved set), the backward's recompute (fused_decoder_layer_bwd.cu)
// that set: both run this one sequence, so the two give the same bits.
inline void decoder_layer_fwd(Launcher& lq, Launcher& lm, const DecoderWeights& w,
                              const float* tgt, const float* mem, const float* mask,
                              const float* pos, const float* qpos, int B, int Q, int L, int H,
                              int F, bool self_attn, bool kv_ready, const DecoderActs& t) {
  const int D = kCols;
  const size_t dd = (size_t)D * D;
  if (!kv_ready)
    lm.rowgemm({mem, D, D, w.ca_w_in + dd, D, 0, w.ca_b_in + D, 0, -1, D, nullptr, 0, nullptr,
                0, t.kv, 2 * D, 0, nullptr, 0, nullptr, pos, D, D},
               2 * D);
  const float* t1 = tgt;
  if (self_attn) {
    lq.rowgemm({tgt, D, D, w.sa_w_in, D, 0, w.sa_b_in, 0, -1, D, nullptr, 0, nullptr, 0,
                t.sa_qkv, 3 * D, 0, nullptr, 0, nullptr, qpos, D, 2 * D},
               3 * D);
    lq.attention_fwd(t.sa_qkv, nullptr, t.sa_ctx, B, H, Q, t.sa_stats);
    lq.rowgemm({t.sa_ctx, D, D, w.sa_w_out, D, 0, w.sa_b_out, 0, -1, D, nullptr, 0, tgt, D,
                t.r1, D},
               D);
    lq.ln_fwd(t.r1, w.n1_g, w.n1_b, t.t1, t.xh1, t.inv1);
    t1 = t.t1;
  }
  lq.rowgemm({t1, D, D, w.ca_w_in, D, 0, w.ca_b_in, 0, -1, D, nullptr, 0, nullptr, 0, t.q, D, 0,
              nullptr, 0, nullptr, qpos, D, D},
             D);
  if (lq.check() && lm.check())
    cross_attention_kernel<<<dim3(H, B), kThreads, cross_attention_smem_bytes(L), lq.s>>>(
        t.q, t.kv, mask, t.ctx, t.stats, Q, L);
  lq.rowgemm({t.ctx, D, D, w.ca_w_out, D, 0, w.ca_b_out, 0, -1, D, nullptr, 0, t1, D, t.r2, D},
             D);
  lq.ln_fwd(t.r2, w.n2_g, w.n2_b, t.t2, t.xh2, t.inv2);
  lq.rowgemm({t.t2, D, D, w.w1, D, 0, w.b1, kActRelu, -1, F, nullptr, 0, nullptr, 0, t.h1, F},
             F);
  lq.rowgemm({t.h1, F, F, w.w2, F, 0, w.b2, 0, -1, D, nullptr, 0, t.t2, D, t.r3, D}, D);
  lq.ln_fwd(t.r3, w.n3_g, w.n3_b, t.out, t.xh3, t.inv3);
}

}  // namespace
