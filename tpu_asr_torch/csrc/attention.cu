// Relative-position multi-head self-attention sublayer, forward and
// backward: q/k/v projections with biases, content scores (q + u) . k,
// position scores (q + v) . P[t - s] with P = PE @ W_pos, key-padding bias,
// softmax, dropout on the probabilities (training), value contraction and
// the per-head output projection summed over heads. The linear_out bias is
// added by the caller.
//
// Replaces tpu_asr/ops/pallas_attention.py::_block_fwd_kernel (and its
// _block_scores, with its in-kernel dropout), launched by
// fused_relpos_attention_block, and ::_block_bwd_kernel, launched by
// fused_relpos_attention_block_bwd (see the backward's note further down);
// and, with the same kernels, the per-head attention of
// fused_relpos_attention (::_attn_fwd_kernel and ::_attn_bwd_kernel, see
// the note before tat_relpos_attention).
//
// What bounds it on an H100: at B=32, T=376, D=176, 4 heads, dk=44 the
// products are small (3 GFLOP of projections, 4.8 GFLOP of scores and
// values, 0.7 GFLOP of output projection per layer), so it is bound by how
// many instructions each multiply-add costs, and by never writing the
// (B, H, T, T) score tensor: that tensor alone would be 72 MB per layer
// in fp32.
//
// Design, three launches, deterministic (no atomics):
//   1. projections: one tiled GEMM launch whose blockIdx.z picks the job -
//      x Wq + (bq + u) and x Wq + (bq + v) (one product, two epilogues),
//      x Wk + bk, x Wv + bv, and PE Wpos - written per head (B, H, T, dk)
//      and (H, 2T-1, dk) in the working type. bf16: proj_mma_kernel, 128 x 64
//      tiles of mma.sync (gemm.cuh); fp32: proj_kernel, SIMT.
//   2. the core: per (batch row, head, block of queries), flash-style over
//      key tiles with an online softmax, so scores never leave the block.
//      In training the normaliser sums the undropped probabilities, the
//      value product takes the dropped ones (stream b * H + h + seed, idx
//      t * Tp + s, Tp = T rounded up to 128, as the TPU kernel draws them),
//      and the row's log-sum-exp is saved for the backward. The rel-shift
//      contracts over dk = 44 per score, where the TPU kernel's sin/cos
//      rotation factorisation contracts over D = 176. A local window
//      (left, right) sets the scores of keys with s - t < -left or
//      s - t > right to -1e30, as the TPU kernel's _local_mask does
//      (-1 on a side: unlimited), in the block sublayer (att_context_size,
//      NeMo's rel_pos_local_attn) and the per-head attention alike. The
//      TPU kernel masks the whole T x T tile; the bf16 core visits only
//      the key tiles the window reaches (core_mma_kernel<.., kWin>), and
//      the bf16 backward only the (query tile, key tile) pairs the core
//      visited, so a window of W keys costs about T (W + 128) score pairs
//      a head instead of T^2. The fp32 kernels (the check dtype) visit
//      every tile and mask.
//      bf16: core_mma_kernel on the tensor cores (see core_mma.cuh).
//      fp32: core_kernel, 32 queries x 32-key tiles of plain SIMT, whose
//      body is attention_core.cuh's core_tile (layer.cu runs it too): the
//      tile's 63 relative positions are staged once and lane j of row r
//      reads row (j - r + 31); shared-memory rows use a stride whose
//      float4 count is odd, so the per-lane float4 reads are conflict-free.
//   3. the projection launch again: context (B*T, D) @ Wo^T.
// Packed segments (serving and training, data/packing.py): with a (B, T)
// segment map the core also sets to -1e30 every score whose key lies in
// another segment than its query, where the window is applied, as the TPU
// kernel's _block_scores does with its `seg` operands, and the backward
// does the same (as _block_bwd_kernel's with_seg). The TPU kernels mask the
// whole T x T tile; here the bf16 core visits only the key tiles that can
// hold a key of one of its queries' segments (see core_mma_kernel), and the
// bf16 backward visits exactly the (query tile, key tile) pairs the core
// visited (dq_mma_kernel, dkv_mma_kernel), so the work falls from T^2 to
// about the sum of the segments' squares a row; the fp32 kernels (the
// check dtype) visit every tile.
// fp32 accumulation; operands in fp32 or bf16 (template), rounded to the
// working type where the TPU kernel rounds them.

#include <cuda_runtime.h>

#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "attention_core.cuh"
#include "core_mma.cuh"
#include "gemm.cuh"
#include "mma.cuh"

namespace {

// One product C = A @ W^T (+ bias) of a projection launch.
struct Job {
  const void* a;      // (m, K) in T: activations or the position table
  const void* w;      // (N, K) in T: PyTorch Linear layout
  const float* bias;  // (N) or null
  const float* bias2; // (N) or null: second epilogue into out2
  void* out;
  void* out2;
  int m;
  int layout;         // 0: (m, N); 1: (B, H, T, dk); 2: (H, m, dk)
};
struct Jobs {
  Job job[4];
};

constexpr int kTile = 64;
constexpr int kChunk = 16;

// Output n of row m of a job, through its layout, + bias (and + bias2 into
// out2).
template <typename T>
__device__ __forceinline__ void proj_store(const Job& jb, int m, int n, int N,
                                           int t_len, int heads, int dk,
                                           float v) {
  size_t idx;
  if (jb.layout == 0) {
    idx = (size_t)m * N + n;
  } else {
    const int hh = n / dk, dd = n - hh * dk;
    if (jb.layout == 1) {
      const int b = m / t_len, t = m - b * t_len;
      idx = (((size_t)b * heads + hh) * t_len + t) * dk + dd;
    } else {
      idx = ((size_t)hh * jb.m + m) * dk + dd;
    }
  }
  ((T*)jb.out)[idx] = from_f<T>(jb.bias ? v + jb.bias[n] : v);
  if (jb.bias2) ((T*)jb.out2)[idx] = from_f<T>(v + jb.bias2[n]);
}

template <typename T>
__global__ void __launch_bounds__(256) proj_kernel(Jobs jobs, int K, int N,
                                                   int t_len, int heads,
                                                   int dk) {
  const Job jb = jobs.job[blockIdx.z];
  const int m0 = blockIdx.x * kTile, n0 = blockIdx.y * kTile;
  if (m0 >= jb.m) return;
  __shared__ float As[kChunk][kTile + 4];
  __shared__ float Ws[kChunk][kTile + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kChunk) {
    for (int i = tid; i < kTile * kChunk; i += 256) {
      const int r = i / kChunk, kk = i - r * kChunk, k = k0 + kk;
      const int m = m0 + r, n = n0 + r;
      float av = 0.f, wv = 0.f;
      if (k < K) {
        if (m < jb.m) av = to_f(((const T*)jb.a)[(size_t)m * K + k]);
        if (n < N) wv = to_f(((const T*)jb.w)[(size_t)n * K + k]);
      }
      As[kk][r] = av;
      Ws[kk][r] = wv;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kChunk; ++kk) {
      float a[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = Ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= jb.m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) proj_store<T>(jb, m, n, N, t_len, heads, dk, acc[i][j]);
    }
  }
}

// bf16 projections on the tensor cores: the same jobs and epilogue as
// proj_kernel, each block a 128 x 64 tile of gemm.cuh (K = D must be a
// multiple of 8; at K = 176 the 96-wide tile, 166 registers, keeps fewer
// blocks resident than its reuse of x is worth); the grid is (M tiles,
// N tiles, jobs).
__global__ void __launch_bounds__(128) proj_mma_kernel(Jobs jobs, int K,
                                                       int N, int t_len,
                                                       int heads, int dk) {
  extern __shared__ __align__(16) char smem[];
  const Job jb = jobs.job[blockIdx.z];
  const int m0 = blockIdx.x * kGM, n0 = blockIdx.y * gemm_cols<4>();
  if (m0 >= jb.m) return;
  PlainRows<bf16> a((const bf16*)jb.a, jb.m, K, m0, threadIdx.x / 4,
                    threadIdx.x % 4);
  gemm_tile<4>(smem, a, (const bf16*)jb.w, N, K, m0, n0,
               [&](int m, int n, float v) {
                 if (m < jb.m && n < N)
                   proj_store<bf16>(jb, m, n, N, t_len, heads, dk, v);
               });
}

// One projection launch over `n_jobs` jobs of at most m_max rows: the SIMT
// tile for fp32 (the check dtype), the tensor-core tile for bf16.
template <typename T>
cudaError_t project(const Jobs& jobs, int n_jobs, int m_max, int K, int N,
                    int t_len, int heads, int dk, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    constexpr int smem = gemm_smem<4>();
    cudaError_t err = cudaFuncSetAttribute(
        proj_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((m_max + kGM - 1) / kGM,
                    (N + gemm_cols<4>() - 1) / gemm_cols<4>(), n_jobs);
    proj_mma_kernel<<<grid, 128, smem, stream>>>(jobs, K, N, t_len, heads,
                                                 dk);
  } else {
    const dim3 grid((m_max + kTile - 1) / kTile, (N + kTile - 1) / kTile,
                    n_jobs);
    proj_kernel<T><<<grid, 256, 0, stream>>>(jobs, K, N, t_len, heads, dk);
  }
  return cudaGetLastError();
}

template <typename T, bool kSeg, int kC>
__global__ void __launch_bounds__(256) core_kernel(
    const T* __restrict__ qu, const T* __restrict__ qv,  // (B, H, T, dk)
    const T* __restrict__ kk, const T* __restrict__ vv,  // (B, H, T, dk)
    const T* __restrict__ pos,                           // (H, 2T-1, dk)
    const float* __restrict__ key_bias,                  // (B, T)
    T* __restrict__ ctx, HeadLayout cl,                  // per-row layout cl
    float* __restrict__ lse,                             // (B, H, T) or null
    int t_len, int heads, int dk, float scale, uint32_t seed,
    uint32_t b_stride, uint32_t thresh, float dscale, int tp, int left,
    int right, const int* __restrict__ seg) {
  extern __shared__ float4 smem4[];
  const int bh = blockIdx.y, b = bh / heads;
  const uint32_t stream = seed + b_stride * (uint32_t)b +
                          (uint32_t)(bh - b * heads);
  core_tile<T, kSeg, kC>(reinterpret_cast<float*>(smem4), qu, qv, kk, vv,
                         pos, key_bias, ctx, cl, lse, bh, blockIdx.x * kBQ,
                         t_len, heads, dk, scale, stream, thresh, dscale, tp,
                         left, right, seg);
}

// Per-row layouts (HeadLayout) of (B, T, H dk) and (B, H, T, dk).
HeadLayout rows_layout(int t_len, int heads, int dk) {
  return {(long long)t_len * heads * dk, dk, (long long)heads * dk};
}
HeadLayout heads_layout(int t_len, int heads, int dk) {
  return {(long long)heads * t_len * dk, (long long)t_len * dk, dk};
}

template <int DKP, bool kSeg, bool kWin>
__global__ void __launch_bounds__(128) core_mma_kernel(
    const bf16* __restrict__ qu, const bf16* __restrict__ qv,  // (B,H,T,dk)
    const bf16* __restrict__ kk, const bf16* __restrict__ vv,  // (B,H,T,dk)
    const bf16* __restrict__ pos,                              // (H,2T-1,dk)
    const float* __restrict__ key_bias,                        // (B, T)
    bf16* __restrict__ ctx, HeadLayout cl,
    float* __restrict__ lse,                                   // or null
    int t_len, int heads, int dk, float scale, uint32_t seed,
    uint32_t b_stride, uint32_t thresh, float dscale, int tp, int left,
    int right, const int* __restrict__ seg) {           // kSeg: (B, T)
  extern __shared__ __align__(16) char smem_raw[];
  core_mma_tile<DKP, kSeg, kWin>(smem_raw, qu, qv, kk, vv, pos, key_bias,
                                 ctx, cl, lse, blockIdx.y, blockIdx.x * kMQ,
                                 t_len, heads, dk, scale, seed, b_stride,
                                 thresh, dscale, tp, left, right, seg);
}

template <int DKP>
cudaError_t launch_core_mma(const void* qu, const void* qv, const void* k,
                            const void* v, const void* p,
                            const float* key_bias, void* ctx, HeadLayout cl,
                            float* lse, int batch, int t_len, int heads,
                            int dk, uint32_t seed, uint32_t b_stride,
                            uint32_t thresh, float dscale, int tp, int left,
                            int right, const int* seg, cudaStream_t stream) {
  const int smem = (int)CoreMma<DKP>::kSmem;
  // a limited side narrows the key tiles (kWin); (-1, -1) keeps the
  // full-context kernels
  const bool lim = left >= 0 || right >= 0;
  auto* kernel = seg ? (lim ? core_mma_kernel<DKP, true, true>
                            : core_mma_kernel<DKP, true, false>)
                     : (lim ? core_mma_kernel<DKP, false, true>
                            : core_mma_kernel<DKP, false, false>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t_len + kMQ - 1) / kMQ, batch * heads);
  kernel<<<grid, 128, smem, stream>>>(
      (const bf16*)qu, (const bf16*)qv, (const bf16*)k, (const bf16*)v,
      (const bf16*)p, key_bias, (bf16*)ctx, cl, lse, t_len, heads, dk,
      1.f / sqrtf((float)dk), seed, b_stride, thresh, dscale, tp, left,
      right, seg);
  return cudaGetLastError();
}

// The core over every (batch row, head): head h of batch row b draws the
// dropout stream seed + b_stride * b + h; `seg` (B, T) or null is the
// packed-segment map; (left, right) the window. fp32 (the check dtype) runs
// core_kernel, SIMT over 32-query blocks, two column slots a lane up to
// dk = 64 and four up to 128, every key tile visited and the window
// masked; bf16 core_mma_kernel on the tensor cores (dk % 4 == 0), its rows
// padded to DKP = 16, 32, 48, 64 or 128, the key tiles narrowed to the
// window's.
template <typename T>
cudaError_t launch_core(const void* qu, const void* qv, const void* k,
                        const void* v, const void* p, const float* key_bias,
                        void* ctx, HeadLayout cl, float* lse, int batch,
                        int t_len, int heads, int dk, uint32_t seed,
                        uint32_t b_stride, uint32_t thresh, float dscale,
                        int tp, int left, int right, const int* seg,
                        cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    auto* fn = dk <= 16   ? launch_core_mma<16>
               : dk <= 32 ? launch_core_mma<32>
               : dk <= 48 ? launch_core_mma<48>
               : dk <= 64 ? launch_core_mma<64>
                          : launch_core_mma<128>;
    return fn(qu, qv, k, v, p, key_bias, ctx, cl, lse, batch, t_len, heads,
              dk, seed, b_stride, thresh, dscale, tp, left, right, seg,
              stream);
  } else {
    const size_t smem = core_smem(dk);
    auto* kernel = dk <= 64 ? (seg ? core_kernel<T, true, 2>
                                   : core_kernel<T, false, 2>)
                            : (seg ? core_kernel<T, true, 4>
                                   : core_kernel<T, false, 4>);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((t_len + kBQ - 1) / kBQ, batch * heads);
    kernel<<<grid, 256, smem, stream>>>(
        (const T*)qu, (const T*)qv, (const T*)k, (const T*)v, (const T*)p,
        key_bias, (T*)ctx, cl, lse, t_len, heads, dk,
        1.f / sqrtf((float)dk), seed, b_stride, thresh, dscale, tp, left,
        right, seg);
    return cudaGetLastError();
  }
}

template <typename T>
int run(const void* x, const void* wq, const void* wk, const void* wv,
        const void* wpos, const void* wo, const float* cu, const float* cv,
        const float* bk, const float* bv, const void* pe,
        const float* key_bias, void* qu, void* qv, void* k, void* v, void* p,
        void* ctx, void* out, float* lse, const int* seg, int batch,
        int t_len, int d, int heads, int left, int right, uint32_t seed,
        uint32_t thresh, float dscale, int tp, cudaStream_t stream) {
  const int dk = d / heads, rows = batch * t_len, n_pos = 2 * t_len - 1;
  Jobs proj{};
  proj.job[0] = {x, wq, cu, cv, qu, qv, rows, 1};
  proj.job[1] = {x, wk, bk, nullptr, k, nullptr, rows, 1};
  proj.job[2] = {x, wv, bv, nullptr, v, nullptr, rows, 1};
  proj.job[3] = {pe, wpos, nullptr, nullptr, p, nullptr, n_pos, 2};
  cudaError_t err = project<T>(proj, 4, rows > n_pos ? rows : n_pos, d, d,
                               t_len, heads, dk, stream);
  if (err != cudaSuccess) return (int)err;

  err = launch_core<T>(qu, qv, k, v, p, key_bias, ctx,
                       rows_layout(t_len, heads, dk), lse, batch, t_len,
                       heads, dk, seed, (uint32_t)heads, thresh, dscale, tp,
                       left, right, seg, stream);
  if (err != cudaSuccess) return (int)err;

  Jobs outp{};
  outp.job[0] = {ctx, wo, nullptr, nullptr, out, nullptr, rows, 0};
  return (int)project<T>(outp, 1, rows, d, d, t_len, heads, dk, stream);
}


// ---------------------------------------------------------------------------
// Backward. Replaces tpu_asr/ops/pallas_attention.py::_block_bwd_kernel,
// which recomputes the whole sublayer per batch row in VMEM and emits dx and
// every weight and bias gradient. What bounds it here: the score tile is
// recomputed twice (once per key-tile pass, once per query-tile pass), each
// time three dk-long products per score, and the position gradient needs
// the scores' gradient skewed along the diagonals. At B=32, T=376, D=88,
// 2 heads the products are ~8 GFLOP, 8 us at the bf16 tensor rate; the
// exp and dropout hash per score and the skew round trips remain.
//
// Launches, all deterministic (fixed-order sums, no atomics):
//   1. dctx = g Wo, per head (B, H, T, dk), in T (proj_mma_kernel in bf16).
//   2. the dq pass, per (batch row, head, block of queries), over key
//      tiles: recomputes the scores, p = exp(score - lse), applies the
//      forward's dropout mask, dS = p (keep * dP / (1 - rate) - D) / sqrt(dk)
//      with dP = dctx . v and D = dctx . ctx (the flash identity, which
//      holds with dropout because ctx is the dropped product). It
//      accumulates dq_u = dS K, dq_v = dS P[t - s] and the block's window
//      of the position gradient dP[r] = sum_{t - s = r} dS[t, s] q_v[t],
//      written to a per-block partial. bf16: dq_mma_kernel (below); fp32:
//      dq_kernel, 32 queries x 32-key tiles of SIMT, each thread owning
//      fixed (diagonal, d) cells of the tile's 63 diagonals in a
//      shared-memory window as long as T.
//   3. the dkv pass, per (batch row, head, block of keys), over query
//      tiles: dv = P_dropped^T dctx and dk = dS^T q_u. bf16: dkv_mma_kernel;
//      fp32: dkv_kernel (keys on warps, queries on lanes).
//   4. dpos_kernel: sums the per-block position partials over batch rows
//      and query blocks into dP (2T - 1, D).
//   5. dx = [dq_u | dq_v | dk | dv] [Wq; Wq; Wk; Wv] (proj_mma_kernel in
//      bf16).
//   6. weight gradients split over rows + sum_parts_kernel:
//      [dq_u | dq_v | dk | dv]^T [x | 1] gives dWq (two halves), dWk, dWv
//      and every bias gradient (the column of ones); g^T ctx gives dWo;
//      dP^T PE gives dW_pos. bf16: wgrad_mma_kernel on gemm.cuh's
//      transposed tiles; fp32: wgrad_kernel, SIMT.
// fp32 is the check dtype and stays SIMT throughout.
// Packed segments: every pass recomputes exactly the scores its forward
// summed, so a valid query's p sums to 1. A guard query (segment 0) scores
// -1e30 on every key it visits and its lse rounds to -1e30, so it gets
// p = 1 on each of them: the gradients hold for a cotangent that is zero
// on guard rows, as the encoder gives one (every layer zeroes them).
// fp32, ragged dk = 44: shared rows use the forward's odd-float4 stride
// with zeros past dk, so every dot product runs over whole float4s.
// ---------------------------------------------------------------------------

template <typename T, bool kSeg, int kC>
__global__ void __launch_bounds__(256) dq_kernel(
    const T* __restrict__ qu, const T* __restrict__ qv,  // (B, H, T, dk)
    const T* __restrict__ kk, const T* __restrict__ vv,  // (B, H, T, dk)
    const T* __restrict__ pos,                           // (H, 2T-1, dk)
    const float* __restrict__ key_bias,                  // (B, T)
    const float* __restrict__ lse,                       // (B, H, T)
    const T* __restrict__ dctx,                          // (B, H, T, dk)
    const T* __restrict__ ctx, HeadLayout cl,            // per-row layout cl
    T* __restrict__ grads, HeadLayout gl, long long gc,  // 4 grads, gl + c gc
    float* __restrict__ dsum,                            // (B, H, T)
    float* __restrict__ dpart,  // (B, H, n_qt, win, dk)
    int t_len, int heads, int dk, float scale, uint32_t seed, uint32_t b_stride,
    uint32_t thresh, float dscale, int tp, int win, int left, int right,
    const int* __restrict__ seg) {  // kSeg: (B, T) segment map
  extern __shared__ float4 smem4[];
  const int ks = row_stride(dk);
  float* Qu = reinterpret_cast<float*>(smem4);  // kBQ x ks
  float* Qv = Qu + kBQ * ks;                    // kBQ x ks
  float* Dc = Qv + kBQ * ks;                    // kBQ x ks: dctx rows
  float* Ks = Dc + kBQ * ks;                    // kBS x ks
  float* Vs = Ks + kBS * ks;                    // kBS x ks
  float* Ps = Vs + kBS * ks;                    // (kBQ + kBS - 1) x ks
  float* dS = Ps + (kBQ + kBS - 1) * ks;        // kBQ x (kBS + 1)
  float* acc = dS + kBQ * (kBS + 1);            // win x dk

  const int bh = blockIdx.y, b = bh / heads, hh = bh - b * heads;
  const int q0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_pos = 2 * t_len - 1;
  const size_t head_off = (size_t)bh * t_len * dk;
  const T* pos_h = pos + (size_t)hh * n_pos * dk;
  const uint32_t stream = seed + b_stride * (uint32_t)b + (uint32_t)hh;

  stage_rows(Qu, qu + head_off, q0, kBQ, t_len, dk, ks);
  stage_rows(Qv, qv + head_off, q0, kBQ, t_len, dk, ks);
  stage_rows(Dc, dctx + head_off, q0, kBQ, t_len, dk, ks);
  for (int i = threadIdx.x; i < win * dk; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();

  const int* seg_row = kSeg ? seg + (size_t)b * t_len : nullptr;
  // lane l holds columns l + 32 c, c < kC, of dq_u and dq_v
  float dsr[kRows], lser[kRows], dqu[kRows][kC], dqv[kRows][kC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = warp * kRows + r, t = q0 + row;
    float dd = 0.f;
    if (t < t_len) {
      const T* cr = ctx + cl.at(b, hh, t);
#pragma unroll
      for (int c = 0; c < kC; ++c)
        if (lane + 32 * c < dk)
          dd += Dc[row * ks + lane + 32 * c] * to_f(cr[lane + 32 * c]);
    }
    dsr[r] = warp_sum(dd);
    lser[r] = t < t_len ? lse[(size_t)bh * t_len + t] : 0.f;
    if (t < t_len && lane == 0) dsum[(size_t)bh * t_len + t] = dsr[r];
#pragma unroll
    for (int c = 0; c < kC; ++c) dqu[r][c] = dqv[r][c] = 0.f;
  }

  for (int s0 = 0; s0 < t_len; s0 += kBS) {
    __syncthreads();  // the previous tile's rows, dS and acc are consumed
    stage_rows(Ks, kk + head_off, s0, kBS, t_len, dk, ks);
    stage_rows(Vs, vv + head_off, s0, kBS, t_len, dk, ks);
    stage_rows(Ps, pos_h, (t_len - 1) - (q0 - s0 + kBS - 1), kBQ + kBS - 1,
               n_pos, dk, ks);
    __syncthreads();

    const int s = s0 + lane;
    const float kb = s < t_len ? key_bias[(size_t)b * t_len + s] : 0.f;
    const int seg_k = kSeg && s < t_len ? seg_row[s] : 0;
    float sc[kRows], dp[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) sc[r] = dp[r] = 0.f;
    const float4* krow = reinterpret_cast<const float4*>(Ks + lane * ks);
    const float4* vrow = reinterpret_cast<const float4*>(Vs + lane * ks);
    for (int d4 = 0; d4 < ks / 4; ++d4) {
      const float4 k4 = krow[d4], v4 = vrow[d4];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int row = warp * kRows + r;
        const float4 a = reinterpret_cast<const float4*>(Qu + row * ks)[d4];
        const float4 c = reinterpret_cast<const float4*>(Qv + row * ks)[d4];
        const float4 g = reinterpret_cast<const float4*>(Dc + row * ks)[d4];
        const float4 p = reinterpret_cast<const float4*>(
            Ps + (lane - row + kBS - 1) * ks)[d4];
        sc[r] += a.x * k4.x + a.y * k4.y + a.z * k4.z + a.w * k4.w +
                 c.x * p.x + c.y * p.y + c.z * p.z + c.w * p.w;
        dp[r] += g.x * v4.x + g.y * v4.y + g.z * v4.z + g.w * v4.w;
      }
    }
    float ds[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = warp * kRows + r, t = q0 + row;
      float v = 0.f;
      if (t < t_len && s < t_len) {
        float x = sc[r] * scale + kb;
        if (!in_window(t, s, left, right)) x = -1e30f;
        if (kSeg && seg_k != seg_row[t]) x = -1e30f;
        const float p = expf(x - lser[r]);
        float kf = 1.f;
        if (thresh)
          kf = dropout_keep(stream, (uint32_t)t * (uint32_t)tp + (uint32_t)s,
                            thresh)
                   ? dscale
                   : 0.f;
        v = p * (dp[r] * kf - dsr[r]) * scale;
      }
      ds[r] = v;
      dS[row * (kBS + 1) + lane] = v;
    }
    for (int j = 0; j < kBS; ++j) {
      float kc[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c)
        kc[c] = lane + 32 * c < dk ? Ks[j * ks + lane + 32 * c] : 0.f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int row = warp * kRows + r;
        const float g = __shfl_sync(0xffffffffu, ds[r], j);
        const float* prow = Ps + (j - row + kBS - 1) * ks;
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          dqu[r][c] = fmaf(g, kc[c], dqu[r][c]);
          dqv[r][c] = fmaf(g, lane + 32 * c < dk ? prow[lane + 32 * c] : 0.f,
                           dqv[r][c]);
        }
      }
    }
    __syncthreads();  // dS complete
    // diagonal j = row - col + 31 of this tile -> window cell s0 + 62 - j
    for (int i = threadIdx.x; i < (kBQ + kBS - 1) * dk; i += blockDim.x) {
      const int j = i / dk, dd = i - j * dk;
      const int r_lo = j > kBS - 1 ? j - (kBS - 1) : 0;
      const int r_hi = j < kBQ - 1 ? j : kBQ - 1;
      float v = 0.f;
      for (int r = r_lo; r <= r_hi; ++r)
        v = fmaf(dS[r * (kBS + 1) + r - j + kBS - 1], Qv[r * ks + dd], v);
      acc[(s0 + kBQ + kBS - 2 - j) * dk + dd] += v;
    }
  }
  __syncthreads();
  float* part = dpart + ((size_t)bh * gridDim.x + blockIdx.x) * win * dk;
  for (int i = threadIdx.x; i < win * dk; i += blockDim.x) part[i] = acc[i];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int t = q0 + warp * kRows + r;
    if (t >= t_len) continue;
    T* dst = grads + gl.at(b, hh, t);
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      if (lane + 32 * c >= dk) continue;
      dst[lane + 32 * c] = from_f<T>(dqu[r][c]);
      dst[gc + lane + 32 * c] = from_f<T>(dqv[r][c]);
    }
  }
}

template <typename T, bool kSeg, int kC>
__global__ void __launch_bounds__(256) dkv_kernel(
    const T* __restrict__ qu, const T* __restrict__ qv,  // (B, H, T, dk)
    const T* __restrict__ kk, const T* __restrict__ vv,  // (B, H, T, dk)
    const T* __restrict__ pos,                           // (H, 2T-1, dk)
    const float* __restrict__ key_bias,                  // (B, T)
    const float* __restrict__ lse,                       // (B, H, T)
    const T* __restrict__ dctx,                          // (B, H, T, dk)
    const float* __restrict__ dsum,                      // (B, H, T)
    T* __restrict__ grads, HeadLayout gl, long long gc,  // 4 grads, gl + c gc
    int t_len, int heads, int dk, float scale, uint32_t seed, uint32_t b_stride,
    uint32_t thresh, float dscale, int tp, int left, int right,
    const int* __restrict__ seg) {  // kSeg: (B, T) segment map
  extern __shared__ float4 smem4[];
  const int ks = row_stride(dk);
  float* Ks = reinterpret_cast<float*>(smem4);  // kBS x ks: this block's keys
  float* Vs = Ks + kBS * ks;                    // kBS x ks
  float* Qu = Vs + kBS * ks;                    // kBQ x ks
  float* Qv = Qu + kBQ * ks;                    // kBQ x ks
  float* Dc = Qv + kBQ * ks;                    // kBQ x ks
  float* Ps = Dc + kBQ * ks;                    // (kBQ + kBS - 1) x ks

  const int bh = blockIdx.y, b = bh / heads, hh = bh - b * heads;
  const int s0 = blockIdx.x * kBS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_pos = 2 * t_len - 1;
  const size_t head_off = (size_t)bh * t_len * dk;
  const T* pos_h = pos + (size_t)hh * n_pos * dk;
  const uint32_t stream = seed + b_stride * (uint32_t)b + (uint32_t)hh;

  stage_rows(Ks, kk + head_off, s0, kBS, t_len, dk, ks);
  stage_rows(Vs, vv + head_off, s0, kBS, t_len, dk, ks);
  const int* seg_row = kSeg ? seg + (size_t)b * t_len : nullptr;
  // lane l holds columns l + 32 c, c < kC, of dk and dv
  float kbr[kRows], dkk[kRows][kC], dvv[kRows][kC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int s = s0 + warp * kRows + r;
    kbr[r] = s < t_len ? key_bias[(size_t)b * t_len + s] : 0.f;
#pragma unroll
    for (int c = 0; c < kC; ++c) dkk[r][c] = dvv[r][c] = 0.f;
  }

  for (int q0 = 0; q0 < t_len; q0 += kBQ) {
    __syncthreads();
    stage_rows(Qu, qu + head_off, q0, kBQ, t_len, dk, ks);
    stage_rows(Qv, qv + head_off, q0, kBQ, t_len, dk, ks);
    stage_rows(Dc, dctx + head_off, q0, kBQ, t_len, dk, ks);
    stage_rows(Ps, pos_h, (t_len - 1) - (q0 - s0 + kBS - 1), kBQ + kBS - 1,
               n_pos, dk, ks);
    __syncthreads();

    const int t = q0 + lane;  // this lane's query
    const bool tin = t < t_len;
    const float lse_t = tin ? lse[(size_t)bh * t_len + t] : 0.f;
    const float d_t = tin ? dsum[(size_t)bh * t_len + t] : 0.f;
    const int seg_t = kSeg && tin ? seg_row[t] : 0;
    float sc[kRows], dp[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) sc[r] = dp[r] = 0.f;
    const float4* qurow = reinterpret_cast<const float4*>(Qu + lane * ks);
    const float4* qvrow = reinterpret_cast<const float4*>(Qv + lane * ks);
    const float4* dcrow = reinterpret_cast<const float4*>(Dc + lane * ks);
    for (int d4 = 0; d4 < ks / 4; ++d4) {
      const float4 a = qurow[d4], c = qvrow[d4], g = dcrow[d4];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int row = warp * kRows + r;
        const float4 k4 = reinterpret_cast<const float4*>(Ks + row * ks)[d4];
        const float4 v4 = reinterpret_cast<const float4*>(Vs + row * ks)[d4];
        const float4 p = reinterpret_cast<const float4*>(
            Ps + (kBS - 1 - lane + row) * ks)[d4];
        sc[r] += a.x * k4.x + a.y * k4.y + a.z * k4.z + a.w * k4.w +
                 c.x * p.x + c.y * p.y + c.z * p.z + c.w * p.w;
        dp[r] += g.x * v4.x + g.y * v4.y + g.z * v4.z + g.w * v4.w;
      }
    }
    float pd[kRows], ds[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int s = s0 + warp * kRows + r;
      pd[r] = ds[r] = 0.f;
      if (tin && s < t_len) {
        float x = sc[r] * scale + kbr[r];
        if (!in_window(t, s, left, right)) x = -1e30f;
        if (kSeg && seg_row[s] != seg_t) x = -1e30f;
        const float p = expf(x - lse_t);
        float kf = 1.f;
        if (thresh)
          kf = dropout_keep(stream, (uint32_t)t * (uint32_t)tp + (uint32_t)s,
                            thresh)
                   ? dscale
                   : 0.f;
        pd[r] = to_f(from_f<T>(p * kf));
        ds[r] = p * (dp[r] * kf - d_t) * scale;
      }
    }
    for (int j = 0; j < kBQ; ++j) {
      float gj[kC], uj[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const bool in = lane + 32 * c < dk;
        gj[c] = in ? Dc[j * ks + lane + 32 * c] : 0.f;
        uj[c] = in ? Qu[j * ks + lane + 32 * c] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pj = __shfl_sync(0xffffffffu, pd[r], j);
        const float sj = __shfl_sync(0xffffffffu, ds[r], j);
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          dvv[r][c] = fmaf(pj, gj[c], dvv[r][c]);
          dkk[r][c] = fmaf(sj, uj[c], dkk[r][c]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int s = s0 + warp * kRows + r;
    if (s >= t_len) continue;
    T* dst = grads + gl.at(b, hh, s);
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      if (lane + 32 * c >= dk) continue;
      dst[2 * gc + lane + 32 * c] = from_f<T>(dkk[r][c]);
      dst[3 * gc + lane + 32 * c] = from_f<T>(dvv[r][c]);
    }
  }
}

// dP[prow, h * dk + d] = sum over batch rows and query blocks of the dq
// kernels' window partials, in that order; query block qt's window cell w
// is P row T - qb - qb qt + w (qb: the block's queries, 32 for dq_kernel,
// 64 for dq_mma_kernel). blockIdx.y sums batch rows b_per y .. into
// dpos + y (2T - 1) H dk (the bf16 path splits the batch so that enough
// loads are in flight, and sum_parts_kernel adds the groups in order).
__global__ void dpos_kernel(const float* __restrict__ dpart,
                            float* __restrict__ dpos, int batch, int heads,
                            int dk, int t_len, int n_qt, int win, int qb,
                            int b_per) {
  const int n_pos = 2 * t_len - 1, d_model = heads * dk;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_pos * d_model) return;
  const int prow = i / d_model, c = i - prow * d_model;
  const int hh = c / dk, dd = c - hh * dk;
  const int b_lo = blockIdx.y * b_per, b_hi = min(batch, b_lo + b_per);
  float s = 0.f;
  for (int b = b_lo; b < b_hi; ++b)
    for (int qt = 0; qt < n_qt; ++qt) {
      const int w = prow - (t_len - qb - qb * qt);
      if (w < 0 || w >= win) continue;
      s += dpart[((((size_t)b * heads + hh) * n_qt + qt) * win + w) * dk + dd];
    }
  dpos[(size_t)blockIdx.y * n_pos * d_model + i] = s;
}

// part[split][n][k] = sum over this split's rows m of a[m, n] * x[m, k],
// with x[m, kx] = 1 when `ones` (so the last column holds sum_m a[m, n]).
template <typename TA, typename TX>
__global__ void __launch_bounds__(256) wgrad_kernel(
    const TA* __restrict__ a, int n, const TX* __restrict__ xx, int kx,
    int ones, int m_rows, int rows_per_split, float* __restrict__ part) {
  __shared__ float As[kChunk][kTile + 4];
  __shared__ float Xs[kChunk][kTile + 4];
  const int n0 = blockIdx.x * kTile, k0 = blockIdx.y * kTile;
  const int kout = kx + ones;
  const int m_lo = blockIdx.z * rows_per_split;
  const int m_hi = min(m_rows, m_lo + rows_per_split);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int m0 = m_lo; m0 < m_hi; m0 += kChunk) {
    for (int i = tid; i < kTile * kChunk; i += 256) {
      const int mm = i / kTile, c = i - mm * kTile, m = m0 + mm;
      const bool in = m < m_hi;
      As[mm][c] = (in && n0 + c < n) ? to_f(a[(size_t)m * n + n0 + c]) : 0.f;
      const int k = k0 + c;
      Xs[mm][c] = !in ? 0.f
                  : k < kx ? to_f(xx[(size_t)m * kx + k])
                           : (k == kx && ones ? 1.f : 0.f);
    }
    __syncthreads();
#pragma unroll
    for (int mm = 0; mm < kChunk; ++mm) {
      float av[4], xv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[mm][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) xv[j] = Xs[mm][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], xv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = part + (size_t)blockIdx.z * n * kout;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int nn = n0 + ty + 16 * i;
    if (nn >= n) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + tx + 16 * j;
      if (k < kout) out[(size_t)nn * kout + k] = acc[i][j];
    }
  }
}

template <typename TO>
__global__ void sum_parts_kernel(const float* __restrict__ part,
                                 TO* __restrict__ out, int n_parts, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int p = 0; p < n_parts; ++p) s += part[(size_t)p * n + i];
  out[i] = from_f<TO>(s);
}

constexpr int kSplitRows = 512;  // rows per weight-gradient partial

// bf16 weight gradients on the tensor cores: one 128 x 64 tile of
// part[split] = a^T [x | 1] (gemm.cuh's gemm_tn_tile) per block, the rows
// of a split reduced in order.
__global__ void __launch_bounds__(128) wgrad_mma_kernel(
    const bf16* __restrict__ a, int n, const bf16* __restrict__ xx, int kx,
    int ones, int m_rows, int rows_per_split, float* __restrict__ part) {
  extern __shared__ __align__(16) char smem[];
  const int kout = kx + ones;
  const int m_lo = blockIdx.z * rows_per_split;
  const int m_hi = min(m_rows, m_lo + rows_per_split);
  float* out = part + (size_t)blockIdx.z * n * kout;
  gemm_tn_tile(smem, a, n, xx, kx, ones != 0, m_lo, m_hi, blockIdx.x * 128,
               blockIdx.y * 64, [&](int i, int j, float v) {
                 if (i < n && j < kout) out[(size_t)i * kout + j] = v;
               });
}

// out (n, kx + ones) = a^T [x | 1] over m_rows rows, split over rows into
// partials summed in split order (deterministic): fp32 (the check dtype)
// on wgrad_kernel, bf16 on wgrad_mma_kernel (n % 8 == 0, kx % 8 == 0).
template <typename T>
cudaError_t wgrad(const void* a, int n, const void* x, int kx, int ones,
                  int m_rows, float* part, float* out, cudaStream_t stream) {
  const int splits = (m_rows + kSplitRows - 1) / kSplitRows;
  const int kout = kx + ones;
  if constexpr (sizeof(T) == 2) {
    cudaError_t err = cudaFuncSetAttribute(
        wgrad_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kTNSmem);
    if (err != cudaSuccess) return err;
    const dim3 grid((n + 127) / 128, (kout + 63) / 64, splits);
    wgrad_mma_kernel<<<grid, 128, kTNSmem, stream>>>(
        (const bf16*)a, n, (const bf16*)x, kx, ones, m_rows, kSplitRows,
        part);
  } else {
    const dim3 grid((n + kTile - 1) / kTile, (kout + kTile - 1) / kTile,
                    splits);
    wgrad_kernel<T, T><<<grid, 256, 0, stream>>>(
        (const T*)a, n, (const T*)x, kx, ones, m_rows, kSplitRows, part);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int total = n * kout;
  sum_parts_kernel<float><<<(total + 255) / 256, 256, 0, stream>>>(
      part, out, splits, total);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The bf16 backward on the tensor cores: dq_mma_kernel and dkv_mma_kernel,
// 4 warps of 16 query rows per block, with core_mma_kernel's staging
// (8-byte cp.async into rows padded to DKP at an odd 16-byte stride) and
// its scores: the content term Qu K^T and the
// position term through the skew tile G (G = Qv P_win^T read back at
// G[r][j - r + 15]), each a product on mma.sync.m16n8k16.
// ---------------------------------------------------------------------------

// DKP = 128 (conformer-XLarge): a warp's dq_u and dq_v (or dk and dv)
// accumulators are 128 registers a thread, and its qa / qb / qd fragments
// would be 96 more, past the 255 a thread may have. So at DKP > 64 (kQS)
// the query rows stay in shared memory (dq_mma_kernel stages Qu and dctx
// beside Qv; dkv_mma_kernel has them in its query tile) and
// bwd_scores_qs loads each k step's fragments where the products take
// them, and takes the tile's keys in two halves. dq's shared
// memory would then be 280,576 bytes with K, V and P double-buffered, above
// the 232,448 a block may have, so at kQS it single-buffers them (kBufs):
// 210,944 bytes, one block an SM, and the next key tile is staged once
// the current one is consumed, under the position-gradient ring's work.
template <int DKP>
struct BwdMma {
  static constexpr bool kQS = CoreMma<DKP>::kQInSmem;
  static constexpr int kBufs = kQS ? 1 : 2;   // K, V, P tile buffers (dq)
  static constexpr int kQRows = kQS ? 3 : 1;  // dq's staged query row sets
  static constexpr int kSE = DKP + 8;       // staged row stride (bf16)
  static constexpr int kGPS = kGW + 8;      // skewed dS row stride (bf16)
  static constexpr int kAS = DKP + 4;       // position-gradient ring (fp32)
  static constexpr int kPS = kMS + 8;       // dropped p / dS tile (bf16)
  static constexpr int kTile = (2 * kMS + kMP) * kSE;   // K, V, P rows
  static constexpr int kQTile = (3 * kMQ + kMP) * kSE;  // Qu, dctx, Qv, P
  // the dkv pass's dropped p and dS tiles fit in the consumed Qv and P rows
  // of the current query tile where DKP >= 48
  static constexpr bool kAliasPD = (kMQ + kMP) * kSE >= 2 * kMQ * kPS;
  static constexpr size_t kSkew = sizeof(float) * 4 * 16 * kGS;
  // dq: K, V, P double-buffered, the block's Qv rows, the position-
  // gradient ring and the skew tiles (G' aliases G); 112,640 bytes at
  // DKP = 48, two blocks per SM (at kQS see above)
  static constexpr size_t kDqSmem =
      sizeof(bf16) * (kBufs * (size_t)kTile + (size_t)kQRows * kMQ * kSE) +
      sizeof(float) * (size_t)kMP * kAS + kSkew;
  // dkv: K, V, one query tile, the skew tiles (and the p and dS tiles
  // unless aliased); 71,680 bytes at DKP = 48, so three blocks (168
  // registers a thread) share an SM: more warps in flight than a second,
  // prefetched query tile would buy (0.0705 against 0.1116 ms)
  static constexpr size_t kDkvSmem =
      sizeof(bf16) * ((size_t)2 * kMS * kSE + (size_t)kQTile) + kSkew +
      (kAliasPD ? 0 : sizeof(bf16) * 2 * (size_t)kMQ * kPS);
};

// Scores of a warp's 16 query rows tw .. tw + 15 against the 64 keys
// s0 .. of a staged tile (K rows Kt, V rows Vt, the warp's 80 position rows
// Pw), as core_mma_kernel computes them, and their gradients: into ds
// p (keep dP / (1 - rate) - D) / sqrt(dk) with p = exp(score - lse) and
// dP = dctx . v, into pd the dropped probabilities keep p / (1 - rate);
// zero outside the valid rows and keys. With kSeg a key whose segment
// (seg_row[s]) differs from its query's (seg_q, the thread's two rows)
// scores -1e30, as the forward's core has it. Accumulator layout (n8 tile n
// of keys, element e): row g + 8 (e / 2), key 8 n + 2 t4 + e % 2.
template <int DKP, bool kSeg>
__device__ __forceinline__ void bwd_scores(
    const uint32_t (&qa)[DKP / 16][4], const uint32_t (&qb)[DKP / 16][4],
    const uint32_t (&qd)[DKP / 16][4], const bf16* Kt, const bf16* Vt,
    const bf16* Pw, float* G, int tw, int s0, int t_len,
    const float* __restrict__ kb_row, const float (&lse_r)[2],
    const float (&dsum_r)[2], float scale, int left, int right,
    uint32_t stream, uint32_t thresh, float dscale, int tp,
    const int* __restrict__ seg_row, const int (&seg_q)[2],
    float (&ds)[kMS / 8][4], float (&pd)[kMS / 8][4]) {
  constexpr int kSE = DKP + 8, kKS = DKP / 16;
  const int lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  const int b_row = lane % 8 + (lane / 16) * 8;
  const int b_col = ((lane / 8) % 2) * 8;
  {
    float ga[kGW / 8][4];
#pragma unroll
    for (int n = 0; n < kGW / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) ga[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks)
#pragma unroll
      for (int nn = 0; nn < kGW / 16; ++nn) {
        uint32_t bq[4];
        ldmatrix_x4(bq, Pw + (16 * nn + b_row) * kSE + ks * 16 + b_col);
        mma_bf16(ga[2 * nn], qb[ks], bq[0], bq[1]);
        mma_bf16(ga[2 * nn + 1], qb[ks], bq[2], bq[3]);
      }
    __syncwarp();  // the previous tile's skew reads are done
#pragma unroll
    for (int n = 0; n < kGW / 8; ++n) {
      const int c = 8 * n + 2 * t4;
      G[g * kGS + c] = ga[n][0];
      G[g * kGS + c + 1] = ga[n][1];
      G[(g + 8) * kGS + c] = ga[n][2];
      G[(g + 8) * kGS + c + 1] = ga[n][3];
    }
    __syncwarp();
  }
#pragma unroll
  for (int n = 0; n < kMS / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) ds[n][e] = pd[n][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < kKS; ++ks)
#pragma unroll
    for (int nn = 0; nn < kMS / 16; ++nn) {
      uint32_t bk[4], bv[4];
      ldmatrix_x4(bk, Kt + (16 * nn + b_row) * kSE + ks * 16 + b_col);
      mma_bf16(ds[2 * nn], qa[ks], bk[0], bk[1]);
      mma_bf16(ds[2 * nn + 1], qa[ks], bk[2], bk[3]);
      ldmatrix_x4(bv, Vt + (16 * nn + b_row) * kSE + ks * 16 + b_col);
      mma_bf16(pd[2 * nn], qd[ks], bv[0], bv[1]);
      mma_bf16(pd[2 * nn + 1], qd[ks], bv[2], bv[3]);
    }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = g + 8 * hr, t = tw + r;
#pragma unroll
    for (int n = 0; n < kMS / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int jc = 8 * n + 2 * t4 + e, s = s0 + jc;
        float dsv = 0.f, pdv = 0.f;
        if (t < t_len && s < t_len) {
          float x = (ds[n][2 * hr + e] + G[r * kGS + jc - r + 15]) * scale +
                    kb_row[s];
          if (!in_window(t, s, left, right)) x = -1e30f;
          if constexpr (kSeg) {
            if (seg_row[s] != seg_q[hr]) x = -1e30f;
          }
          const float p = expf(x - lse_r[hr]);
          float kf = 1.f;
          if (thresh)
            kf = dropout_keep(stream,
                              (uint32_t)t * (uint32_t)tp + (uint32_t)s,
                              thresh)
                     ? dscale
                     : 0.f;
          pdv = p * kf;
          dsv = p * (pd[n][2 * hr + e] * kf - dsum_r[hr]) * scale;
        }
        ds[n][2 * hr + e] = dsv;
        pd[n][2 * hr + e] = pdv;
      }
  }
}

// bwd_scores at DKP = 128 (BwdMma::kQS): the warp's query fragments come from
// the staged Qu, Qv and dctx rows su, sv, sd (rows 16 warp ..), loaded a k
// step at a time; the position products run in two passes of 48 and 32
// window columns, and the tile's 64 keys in four parts of 16, each rounded
// to bf16 pairs as soon as it is complete: dsb[n][hr] and pdb[n][hr] hold
// elements (2 hr, 2 hr + 1) of bwd_scores' ds[n] and pd[n]. So little
// fp32 state is live beside the warp's 128 accumulators of dq_u and dq_v
// (or dk and dv), where the whole tile's spilled in the segment mode.
// Every consumer takes them as bf16, rounded as bwd_scores' callers round
// them.
template <int DKP, bool kSeg>
__device__ __forceinline__ void bwd_scores_qs(
    const bf16* su, const bf16* sv, const bf16* sd, const bf16* Kt,
    const bf16* Vt, const bf16* Pw, float* G, int tw, int s0, int t_len,
    const float* __restrict__ kb_row, const float (&lse_r)[2],
    const float (&dsum_r)[2], float scale, int left, int right,
    uint32_t stream, uint32_t thresh, float dscale, int tp,
    const int* __restrict__ seg_row, const int (&seg_q)[2],
    uint32_t (&dsb)[kMS / 8][2], uint32_t (&pdb)[kMS / 8][2]) {
  constexpr int kSE = DKP + 8, kKS = DKP / 16;
  constexpr int kGP = 3;   // 16-column blocks of the first position pass
  constexpr int kNP = 2;   // n8 tiles (16 keys) of a part
  const int lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  const int warp = threadIdx.x / 32;
  const int b_row = lane % 8 + (lane / 16) * 8;
  const int b_col = ((lane / 8) % 2) * 8;
#pragma unroll
  for (int gp = 0; gp < 2; ++gp) {
    const int lo = gp ? kGP : 0, hi = gp ? kGW / 16 : kGP;
    float ga[2 * kGP][4];
#pragma unroll
    for (int n = 0; n < 2 * kGP; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) ga[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
      uint32_t qb[4];
      frag_rows<DKP>(qb, sv, warp, lane, ks);
#pragma unroll
      for (int nn = lo; nn < hi; ++nn) {
        uint32_t bq[4];
        ldmatrix_x4(bq, Pw + (16 * nn + b_row) * kSE + ks * 16 + b_col);
        mma_bf16(ga[2 * (nn - lo)], qb, bq[0], bq[1]);
        mma_bf16(ga[2 * (nn - lo) + 1], qb, bq[2], bq[3]);
      }
    }
    if (gp == 0) __syncwarp();  // the previous tile's skew reads are done
#pragma unroll
    for (int n = 2 * lo; n < 2 * hi; ++n) {
      const int c = 8 * n + 2 * t4;
      G[g * kGS + c] = ga[n - 2 * lo][0];
      G[g * kGS + c + 1] = ga[n - 2 * lo][1];
      G[(g + 8) * kGS + c] = ga[n - 2 * lo][2];
      G[(g + 8) * kGS + c + 1] = ga[n - 2 * lo][3];
    }
  }
  __syncwarp();
#pragma unroll
  for (int pt = 0; pt < kMS / 8 / kNP; ++pt) {
    float ds[kNP][4], pd[kNP][4];
#pragma unroll
    for (int n = 0; n < kNP; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[n][e] = pd[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
      uint32_t qa[4], qd[4];
      frag_rows<DKP>(qa, su, warp, lane, ks);
      frag_rows<DKP>(qd, sd, warp, lane, ks);
#pragma unroll
      for (int m = 0; m < kNP / 2; ++m) {
        const int nn = kNP / 2 * pt + m;
        uint32_t bk[4], bv[4];
        ldmatrix_x4(bk, Kt + (16 * nn + b_row) * kSE + ks * 16 + b_col);
        mma_bf16(ds[2 * m], qa, bk[0], bk[1]);
        mma_bf16(ds[2 * m + 1], qa, bk[2], bk[3]);
        ldmatrix_x4(bv, Vt + (16 * nn + b_row) * kSE + ks * 16 + b_col);
        mma_bf16(pd[2 * m], qd, bv[0], bv[1]);
        mma_bf16(pd[2 * m + 1], qd, bv[2], bv[3]);
      }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = g + 8 * hr, t = tw + r;
#pragma unroll
      for (int m = 0; m < kNP; ++m) {
        float dsv[2] = {0.f, 0.f}, pdv[2] = {0.f, 0.f};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int jc = 8 * (kNP * pt + m) + 2 * t4 + e, s = s0 + jc;
          if (t < t_len && s < t_len) {
            float x = (ds[m][2 * hr + e] + G[r * kGS + jc - r + 15]) * scale +
                      kb_row[s];
            if (!in_window(t, s, left, right)) x = -1e30f;
            if constexpr (kSeg) {
              if (seg_row[s] != seg_q[hr]) x = -1e30f;
            }
            const float p = expf(x - lse_r[hr]);
            float kf = 1.f;
            if (thresh)
              kf = dropout_keep(stream,
                                (uint32_t)t * (uint32_t)tp + (uint32_t)s,
                                thresh)
                       ? dscale
                       : 0.f;
            pdv[e] = p * kf;
            dsv[e] = p * (pd[m][2 * hr + e] * kf - dsum_r[hr]) * scale;
          }
        }
        dsb[kNP * pt + m][hr] = pack_bf16(dsv[0], dsv[1]);
        pdb[kNP * pt + m][hr] = pack_bf16(pdv[0], pdv[1]);
      }
    }
  }
}

// A fragments (m16 x k16, row-major) of rows 16 w .. of a staged tile.
template <int DKP>
__device__ __forceinline__ void load_rows(uint32_t (&f)[DKP / 16][4],
                                          const bf16* tile, int warp,
                                          int lane) {
#pragma unroll
  for (int ks = 0; ks < DKP / 16; ++ks)
    ldmatrix_x4(f[ks], tile + (16 * warp + lane % 16) * (DKP + 8) + ks * 16 +
                           (lane / 16) * 8);
}

// The A fragments (m16 x k16, row-major) of rows tw .. tw + 15 of a head,
// row t at m + at(t), read from global memory (dk % 4 == 0: each pair of
// columns is one aligned 4-byte word).
template <int DKP, class At>
__device__ __forceinline__ void rows_global(uint32_t (&f)[DKP / 16][4],
                                            const bf16* m, At at, int tw,
                                            int t_len, int dk) {
  const int lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int ks = 0; ks < DKP / 16; ++ks)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int t = tw + g + 8 * (q & 1), c = 16 * ks + 2 * t4 + 8 * (q >> 1);
      f[ks][q] = t < t_len && c < dk
                     ? *reinterpret_cast<const uint32_t*>(m + at(t) + c)
                     : 0u;
    }
}

// D = dctx . ctx of the thread's rows tw + g, tw + g + 8 from the A
// fragments of dctx (qd) and ctx, summed over the four lanes of a row; lane
// t4 = 0 writes them to dsum_out.
template <int DKP>
__device__ __forceinline__ void row_dsum(const uint32_t (&qd)[DKP / 16][4],
                                         const uint32_t (&qc)[DKP / 16][4],
                                         float* dsum_out, int bh, int tw,
                                         int t_len, float (&dsum_r)[2]) {
  const int lane = threadIdx.x % 32, g = lane / 4;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float s = 0.f;
#pragma unroll
    for (int ks = 0; ks < DKP / 16; ++ks)
#pragma unroll
      for (int q = hr; q < 4; q += 2) {
        const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(
            &qd[ks][q]);
        const __nv_bfloat162 c = *reinterpret_cast<const __nv_bfloat162*>(
            &qc[ks][q]);
        s += __bfloat162float(a.x) * __bfloat162float(c.x) +
             __bfloat162float(a.y) * __bfloat162float(c.y);
      }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    dsum_r[hr] = s;
    const int t = tw + g + 8 * hr;
    if (lane % 4 == 0 && t < t_len) dsum_out[(size_t)bh * t_len + t] = s;
  }
}

// dq_u = dS K and dq_v = dS P[t - s] per (batch row, head, 64 queries)
// over 64-key tiles, and the block's position-gradient window: dS is
// written into a per-warp skewed tile G' (G'[r][j - r + 15] = dS[r][j],
// zero elsewhere, over the warp's G), so that dq_v = G' P_win and the
// warp's 80 window rows of dP are G'^T Qv, each a product on the tensor
// cores. The window of key tile j is the block's rows 64 j .. 64 j + 127,
// eight 16-row slabs, and warp w's 80 rows are slabs 3 - w .. 7 - w: warp
// w sums slabs w and w + 4 over the warps that cover them, in warp order,
// into a 128-row ring (fixed order, no atomics). Slab w + 4 of tile j is
// slab w of tile j + 1, so each warp owns its ring rows, and slab w is
// complete after tile j: the warp writes it to the block's partial
// (dpart, window row W = P row T - 64 - q0 + W). The query rows' A
// fragments come straight from global memory (the block stages only Qv,
// the B operand of the other warps' slabs), which keeps the block at
// 112,640 bytes of shared memory and two blocks per SM at DKP = 48. At
// DKP = 128 (BwdMma::kQS) it stages Qu and dctx too, takes its scores from
// bwd_scores_qs, and single-buffers the key tiles (see BwdMma).
// Packed segments (kSeg, seg (B, T)): the block walks only the key tiles
// j_lo .. j_hi - 1 of its forward's span (seg_span), and a key of another
// segment scores -1e30 (bwd_scores). A skipped tile adds exactly zero: its
// pairs were never in the forward's sum. Its window rows still belong to
// the partial that dpos_kernel sums whole, so the rows outside 64 j_lo ..
// 64 j_hi + 63 are written as zeros. A local window (kWin) narrows the
// key tiles to the forward's (window_tiles, intersected with the span),
// with the same zeros.
template <int DKP, bool kSeg, bool kWin>
__global__ void __launch_bounds__(128) dq_mma_kernel(
    const bf16* __restrict__ qu, const bf16* __restrict__ qv,  // (B,H,T,dk)
    const bf16* __restrict__ kk, const bf16* __restrict__ vv,  // (B,H,T,dk)
    const bf16* __restrict__ pos,                              // (H,2T-1,dk)
    const float* __restrict__ key_bias,                        // (B, T)
    const float* __restrict__ lse,                             // (B, H, T)
    const bf16* __restrict__ dctx,                             // (B,H,T,dk)
    const bf16* __restrict__ ctx, HeadLayout cl,
    bf16* __restrict__ grads, HeadLayout gl, long long gc,
    float* __restrict__ dsum,                                  // (B, H, T)
    float* __restrict__ dpart,  // (B, H, n_qt, win, dk)
    int t_len, int heads, int dk, float scale, uint32_t seed,
    uint32_t b_stride, uint32_t thresh, float dscale, int tp, int win,
    int left, int right, const int* __restrict__ seg) {  // kSeg: (B, T)
  using S = BwdMma<DKP>;
  constexpr int kSE = S::kSE, kKS = DKP / 16, kND = DKP / 8;
  constexpr int kGPS = S::kGPS, kAS = S::kAS;
  constexpr bool kQS = S::kQS;
  extern __shared__ __align__(16) char smem_raw[];
  bf16* tiles = reinterpret_cast<bf16*>(smem_raw);  // kBufs x (K, V, P rows)
  bf16* Qvs = tiles + S::kBufs * S::kTile;            // the block's Qv rows
  bf16* Qus = Qvs + kMQ * kSE;                        // kQS: Qu rows,
  bf16* Dcs = Qus + kMQ * kSE;                        // and dctx rows
  // the position-gradient window ring
  float* acc = reinterpret_cast<float*>(Qvs + S::kQRows * kMQ * kSE);
  float* Gall = acc + kMP * kAS;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  float* G = Gall + warp * 16 * kGS;
  bf16* Gp = reinterpret_cast<bf16*>(G);  // G' once the scores are read

  const int bh = blockIdx.y, b = bh / heads, hh = bh - b * heads;
  const int q0 = blockIdx.x * kMQ, tw = q0 + 16 * warp;
  const uint32_t stream = seed + b_stride * (uint32_t)b + (uint32_t)hh;
  const int n_pos = 2 * t_len - 1;
  const size_t head_off = (size_t)bh * t_len * dk;
  const bf16* pos_h = pos + (size_t)hh * n_pos * dk;
  const float* kb_row = key_bias + (size_t)b * t_len;
  const int n_tiles = (t_len + kMS - 1) / kMS;

  auto stage_tile = [&](int j, int buf) {
    bf16* kt = tiles + buf * S::kTile;
    const int s0 = j * kMS;
    stage_async<DKP>(kt, kk + head_off, s0, kMS, t_len, dk);
    stage_async<DKP>(kt + kMS * kSE, vv + head_off, s0, kMS, t_len, dk);
    stage_async<DKP>(kt + 2 * kMS * kSE, pos_h, t_len - kMQ - q0 + s0, kMP,
                     n_pos, dk);
  };
  // the key tiles j_lo .. j_hi - 1 to visit: all, or the forward's span
  // and window
  int j_lo = 0, j_hi = n_tiles;
  const int* seg_row = kSeg ? seg + (size_t)b * t_len : nullptr;
  int seg_q[2] = {0, 0};
  if constexpr (kSeg) {
    __shared__ int span[4];
    seg_span(seg_row, q0, t_len, span, j_lo, j_hi);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int t = tw + g + 8 * hr;
      seg_q[hr] = t < t_len ? seg_row[t] : 0;
    }
  }
  if constexpr (kWin) {
    int w_lo, w_hi;
    window_tiles(q0, left, right, n_tiles, w_lo, w_hi);
    j_lo = max(j_lo, w_lo);
    j_hi = min(j_hi, w_hi);
  }
  if (!(kSeg || kWin) || j_lo < j_hi) {
    stage_async<DKP>(Qvs, qv + head_off, q0, kMQ, t_len, dk);
    if constexpr (kQS) {
      stage_async<DKP>(Qus, qu + head_off, q0, kMQ, t_len, dk);
      stage_async<DKP>(Dcs, dctx + head_off, q0, kMQ, t_len, dk);
    }
    stage_tile(j_lo, 0);
    cp_async_commit();
  }
  for (int i = tid; i < kMP * kAS; i += blockDim.x) acc[i] = 0.f;

  // the warp's query rows as A fragments, straight from global memory
  // (at kQS only dctx, for D, and bwd_scores loads them from the staged
  // rows)
  uint32_t qa[kKS][4], qb[kKS][4], qd[kKS][4];
  float lse_r[2], dsum_r[2];
  {
    const long long hrow = (long long)head_off;
    auto head_at = [&](int t) { return hrow + (long long)t * dk; };
    if constexpr (!kQS) {
      rows_global<DKP>(qa, qu, head_at, tw, t_len, dk);
      rows_global<DKP>(qb, qv, head_at, tw, t_len, dk);
    }
    rows_global<DKP>(qd, dctx, head_at, tw, t_len, dk);
    uint32_t qc[kKS][4];
    rows_global<DKP>(qc, ctx, [&](int t) { return cl.at(b, hh, t); }, tw,
                     t_len, dk);
    row_dsum<DKP>(qd, qc, dsum, bh, tw, t_len, dsum_r);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int t = tw + g + 8 * hr;
      lse_r[hr] = t < t_len ? lse[(size_t)bh * t_len + t] : 0.f;
    }
  }
  float dqu[kND][4], dqv[kND][4];
#pragma unroll
  for (int n = 0; n < kND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqu[n][e] = dqv[n][e] = 0.f;
  float* part = dpart + ((size_t)bh * gridDim.x + blockIdx.x) * win * dk;
  if constexpr (kSeg || kWin) {  // the window rows no visited tile reaches
    for (int i = tid; i < kMS * j_lo * dk; i += blockDim.x) part[i] = 0.f;
    for (int i = kMS * (j_hi + 1) * dk + tid; i < win * dk; i += blockDim.x)
      part[i] = 0.f;
    __syncthreads();  // the zeroed ring, where no tile is visited
  }

  for (int j = j_lo; j < j_hi; ++j) {
    if constexpr (kQS) {  // one buffer: tile j was staged after tile j - 1
      cp_async_wait<0>();
    } else if (j + 1 < j_hi) {
      stage_tile(j + 1, (j + 1 - j_lo) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile j (and at j = j_lo the zeroed ring) landed
    const bf16* Kt = tiles + (S::kBufs == 2 ? (j - j_lo) & 1 : 0) * S::kTile;
    const bf16* Vt = Kt + kMS * kSE;
    const bf16* Pw = Vt + kMS * kSE + (kMQ - 16 - 16 * warp) * kSE;
    if constexpr (kQS) {
      // the same steps on dS already rounded to bf16 pairs
      uint32_t dsb[kMS / 8][2], pdb[kMS / 8][2];
      bwd_scores_qs<DKP, kSeg>(Qus, Qvs, Dcs, Kt, Vt, Pw, G, tw, j * kMS,
                               t_len, kb_row, lse_r, dsum_r, scale, left,
                               right, stream, thresh, dscale, tp, seg_row,
                               seg_q, dsb, pdb);
#pragma unroll
      for (int kc = 0; kc < kMS / 16; ++kc) {
        const uint32_t pa[4] = {dsb[2 * kc][0], dsb[2 * kc][1],
                                dsb[2 * kc + 1][0], dsb[2 * kc + 1][1]};
#pragma unroll
        for (int dd = 0; dd < kND / 2; ++dd) {
          uint32_t kb[4];
          ldmatrix_x4_trans(
              kb, Kt + (16 * kc + lane % 8 + ((lane / 8) % 2) * 8) * kSE +
                      16 * dd + (lane / 16) * 8);
          mma_bf16(dqu[2 * dd], pa, kb[0], kb[1]);
          mma_bf16(dqu[2 * dd + 1], pa, kb[2], kb[3]);
        }
      }
      __syncwarp();  // every lane has read its scores' G
      for (int i = lane; i < 16 * kGPS / 2; i += 32)
        reinterpret_cast<uint32_t*>(Gp)[i] = 0u;
      __syncwarp();
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = g + 8 * hr;
#pragma unroll
        for (int n = 0; n < kMS / 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            Gp[r * kGPS + 8 * n + 2 * t4 + e - r + 15] =
                reinterpret_cast<const bf16*>(&dsb[n][hr])[e];
      }
      __syncwarp();
    } else {
      float ds[kMS / 8][4], pd[kMS / 8][4];
      bwd_scores<DKP, kSeg>(qa, qb, qd, Kt, Vt, Pw, G, tw, j * kMS, t_len,
                            kb_row, lse_r, dsum_r, scale, left, right, stream,
                            thresh, dscale, tp, seg_row, seg_q, ds, pd);

      // dq_u += dS K: dS rounded to bf16 as the A operand, K through
      // ldmatrix.trans (k = key, n = d)
#pragma unroll
      for (int kc = 0; kc < kMS / 16; ++kc) {
        const uint32_t pa[4] = {
            pack_bf16(ds[2 * kc][0], ds[2 * kc][1]),
            pack_bf16(ds[2 * kc][2], ds[2 * kc][3]),
            pack_bf16(ds[2 * kc + 1][0], ds[2 * kc + 1][1]),
            pack_bf16(ds[2 * kc + 1][2], ds[2 * kc + 1][3])};
#pragma unroll
        for (int dd = 0; dd < kND / 2; ++dd) {
          uint32_t kb[4];
          ldmatrix_x4_trans(
              kb, Kt + (16 * kc + lane % 8 + ((lane / 8) % 2) * 8) * kSE +
                      16 * dd + (lane / 16) * 8);
          mma_bf16(dqu[2 * dd], pa, kb[0], kb[1]);
          mma_bf16(dqu[2 * dd + 1], pa, kb[2], kb[3]);
        }
      }

      // dS into the skewed tile G', over G
      __syncwarp();  // every lane has read its scores' G
      for (int i = lane; i < 16 * kGPS / 2; i += 32)
        reinterpret_cast<uint32_t*>(Gp)[i] = 0u;
      __syncwarp();
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = g + 8 * hr;
#pragma unroll
        for (int n = 0; n < kMS / 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            Gp[r * kGPS + 8 * n + 2 * t4 + e - r + 15] =
                __float2bfloat16(ds[n][2 * hr + e]);
      }
      __syncwarp();
    }

    // dq_v += G' P_win (k = window row, n = d)
#pragma unroll
    for (int kc = 0; kc < kGW / 16; ++kc) {
      uint32_t pa[4];
      ldmatrix_x4(pa, Gp + (lane % 16) * kGPS + kc * 16 + (lane / 16) * 8);
#pragma unroll
      for (int dd = 0; dd < kND / 2; ++dd) {
        uint32_t pb[4];
        ldmatrix_x4_trans(
            pb, Pw + (16 * kc + lane % 8 + ((lane / 8) % 2) * 8) * kSE +
                    16 * dd + (lane / 16) * 8);
        mma_bf16(dqv[2 * dd], pa, pb[0], pb[1]);
        mma_bf16(dqv[2 * dd + 1], pa, pb[2], pb[3]);
      }
    }

    __syncthreads();  // every warp's G' is written; tile j is consumed
    if constexpr (kQS) {  // the next tile into the one buffer
      if (j + 1 < j_hi) {
        stage_tile(j + 1, 0);
        cp_async_commit();
      }
    }

    // the block window's slabs m = warp and warp + 4 (rows 64 j + 16 m ..):
    // the sum over the warps w' whose window covers them of G'_w'^T Qv_w'
    // (slab m - 3 + w' of w'), in w' order. Slab warp + 4 is slab warp of
    // the next tile, so each warp owns its ring rows and slab warp is
    // complete here.
    if constexpr (kQS) {
      // the same sums a half of the columns at a time, so that a half's 32
      // accumulators sit beside dq_u and dq_v (244-246 registers; the
      // whole slab's at once took 254-255 of the 255 a thread may have)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = warp + 4 * half;
#pragma unroll
        for (int ch = 0; ch < 2; ++ch) {
          float o[kND / 2][4];
#pragma unroll
          for (int n = 0; n < kND / 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
#pragma unroll
          for (int wq = 0; wq < 4; ++wq) {
            const int kq = m - 3 + wq;
            if (kq < 0 || kq >= kGW / 16) continue;
            const bf16* gq =
                reinterpret_cast<const bf16*>(Gall + wq * 16 * kGS);
            uint32_t pa[4];
            ldmatrix_x4_trans(pa, gq + (lane % 8 + (lane / 16) * 8) * kGPS +
                                      16 * kq + ((lane / 8) % 2) * 8);
#pragma unroll
            for (int dd = 0; dd < kND / 4; ++dd) {
              uint32_t qb4[4];
              ldmatrix_x4_trans(
                  qb4, Qvs + (16 * wq + lane % 8 + ((lane / 8) % 2) * 8) *
                                 kSE +
                           16 * (kND / 4 * ch + dd) + (lane / 16) * 8);
              mma_bf16(o[2 * dd], pa, qb4[0], qb4[1]);
              mma_bf16(o[2 * dd + 1], pa, qb4[2], qb4[3]);
            }
          }
#pragma unroll
          for (int n = 0; n < kND / 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int w = kMS * j + 16 * m + g + (e / 2) * 8;
              acc[(w & (kMP - 1)) * kAS + 8 * (kND / 2 * ch + n) + 2 * t4 +
                  (e % 2)] += o[n][e];
            }
        }
      }
    } else {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = warp + 4 * half;
        float o[kND][4];
#pragma unroll
        for (int n = 0; n < kND; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
#pragma unroll
        for (int wq = 0; wq < 4; ++wq) {
          const int kq = m - 3 + wq;
          if (kq < 0 || kq >= kGW / 16) continue;
          const bf16* gq = reinterpret_cast<const bf16*>(Gall + wq * 16 * kGS);
          uint32_t pa[4];
          ldmatrix_x4_trans(pa, gq + (lane % 8 + (lane / 16) * 8) * kGPS +
                                    16 * kq + ((lane / 8) % 2) * 8);
#pragma unroll
          for (int dd = 0; dd < kND / 2; ++dd) {
            uint32_t qb4[4];
            ldmatrix_x4_trans(
                qb4, Qvs + (16 * wq + lane % 8 + ((lane / 8) % 2) * 8) * kSE +
                         16 * dd + (lane / 16) * 8);
            mma_bf16(o[2 * dd], pa, qb4[0], qb4[1]);
            mma_bf16(o[2 * dd + 1], pa, qb4[2], qb4[3]);
          }
        }
#pragma unroll
        for (int n = 0; n < kND; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int w = kMS * j + 16 * m + g + (e / 2) * 8;
            acc[(w & (kMP - 1)) * kAS + 8 * n + 2 * t4 + (e % 2)] += o[n][e];
          }
      }
    }
    __syncwarp();
    // slab warp (rows 64 j + 16 warp ..) to the partial, and zeroed
    for (int r = 0; r < 16; ++r) {
      const int w = kMS * j + 16 * warp + r;
      for (int dd = lane; dd < dk; dd += 32) {
        float* a = acc + (w & (kMP - 1)) * kAS + dd;
        part[(size_t)w * dk + dd] = *a;
        *a = 0.f;
      }
    }
  }
  __syncwarp();
  for (int r = 0; r < 16; ++r) {
    const int w = kMS * j_hi + 16 * warp + r;
    for (int dd = lane; dd < dk; dd += 32)
      part[(size_t)w * dk + dd] = acc[(w & (kMP - 1)) * kAS + dd];
  }

#pragma unroll
  for (int n = 0; n < kND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = tw + g + (e / 2) * 8, c = 8 * n + 2 * t4 + (e % 2);
      if (t >= t_len || c >= dk) continue;
      bf16* dst = grads + gl.at(b, hh, t);
      dst[c] = __float2bfloat16(dqu[n][e]);
      dst[gc + c] = __float2bfloat16(dqv[n][e]);
    }
}

// dk = dS^T Qu and dv = P_dropped^T dctx per (batch row, head, 64 keys)
// over 64-query tiles: each warp recomputes its 16 query rows' scores
// against the block's keys (bwd_scores, the forward's orientation, so the
// skew is the forward's), the block's dropped p and dS go to shared memory
// as bf16 (the dropped p rounded as the forward's P V takes it), and warp
// w accumulates keys 16 w .. 16 w + 15 over the tile's 64 queries through
// ldmatrix.trans, in query order. Packed segments (kSeg, seg (B, T)): the
// block visits query tile i only where the forward's core visited this key
// tile for it (seg_span of tile i), for any map, so each skipped pair adds
// exactly zero; a key of another segment scores -1e30 (bwd_scores). A
// local window (kWin): the block walks the query tiles that reach its
// keys, queries k0 - right .. k0 + kMS - 1 + left, and of those visits
// tile i only where the forward's core visited this key tile for it
// (window_tiles of tile i), as with segments.
template <int DKP, bool kSeg, bool kWin>
__global__ void __launch_bounds__(128) dkv_mma_kernel(
    const bf16* __restrict__ qu, const bf16* __restrict__ qv,  // (B,H,T,dk)
    const bf16* __restrict__ kk, const bf16* __restrict__ vv,  // (B,H,T,dk)
    const bf16* __restrict__ pos,                              // (H,2T-1,dk)
    const float* __restrict__ key_bias,                        // (B, T)
    const float* __restrict__ lse,                             // (B, H, T)
    const bf16* __restrict__ dctx,                             // (B,H,T,dk)
    const float* __restrict__ dsum,                            // (B, H, T)
    bf16* __restrict__ grads, HeadLayout gl, long long gc, int t_len,
    int heads, int dk, float scale, uint32_t seed, uint32_t b_stride,
    uint32_t thresh, float dscale, int tp, int left, int right,
    const int* __restrict__ seg) {  // kSeg: (B, T)
  using S = BwdMma<DKP>;
  constexpr int kSE = S::kSE, kND = DKP / 8, kPS = S::kPS;
  constexpr bool kQS = S::kQS;
  extern __shared__ __align__(16) char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + kMS * kSE;
  bf16* Qt = Vs + kMS * kSE;  // the query tile: Qu, dctx, Qv kMQ, P kMP rows
  float* Gall = reinterpret_cast<float*>(Qt + S::kQTile);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  float* G = Gall + warp * 16 * kGS;

  const int bh = blockIdx.y, b = bh / heads, hh = bh - b * heads;
  const int k0 = blockIdx.x * kMS;
  const uint32_t stream = seed + b_stride * (uint32_t)b + (uint32_t)hh;
  const int n_pos = 2 * t_len - 1;
  const size_t head_off = (size_t)bh * t_len * dk;
  const bf16* pos_h = pos + (size_t)hh * n_pos * dk;
  const float* kb_row = key_bias + (size_t)b * t_len;
  const int n_tiles = (t_len + kMQ - 1) / kMQ;

  auto stage_q = [&](int i) {
    const int q0 = i * kMQ;
    stage_async<DKP>(Qt, qu + head_off, q0, kMQ, t_len, dk);
    stage_async<DKP>(Qt + kMQ * kSE, dctx + head_off, q0, kMQ, t_len, dk);
    stage_async<DKP>(Qt + 2 * kMQ * kSE, qv + head_off, q0, kMQ, t_len, dk);
    stage_async<DKP>(Qt + 3 * kMQ * kSE, pos_h, t_len - kMQ - q0 + k0, kMP,
                     n_pos, dk);
  };
  stage_async<DKP>(Ks, kk + head_off, k0, kMS, t_len, dk);
  stage_async<DKP>(Vs, vv + head_off, k0, kMS, t_len, dk);
  const int* seg_row = kSeg ? seg + (size_t)b * t_len : nullptr;
  if constexpr (kSeg || kWin)
    cp_async_commit();  // drained at the end if unvisited

  float dkk[kND][4], dvv[kND][4];
#pragma unroll
  for (int n = 0; n < kND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dkk[n][e] = dvv[n][e] = 0.f;

  int i_lo = 0, i_hi = n_tiles;
  if constexpr (kWin) {
    if (right >= 0) i_lo = max(k0 - right, 0) / kMQ;
    if (left >= 0) i_hi = min(n_tiles, (k0 + kMS - 1 + left) / kMQ + 1);
  }
  for (int i = i_lo; i < i_hi; ++i) {
    int seg_q[2] = {0, 0};
    if constexpr (kWin) {
      int w_lo, w_hi;
      window_tiles(i * kMQ, left, right, n_tiles, w_lo, w_hi);
      if ((int)blockIdx.x < w_lo || (int)blockIdx.x >= w_hi) continue;
    }
    if constexpr (kSeg) {
      __shared__ int span[4];
      int j_lo, j_hi;
      seg_span(seg_row, i * kMQ, t_len, span, j_lo, j_hi);
      if ((int)blockIdx.x < j_lo || (int)blockIdx.x >= j_hi) continue;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int t = i * kMQ + 16 * warp + g + 8 * hr;
        seg_q[hr] = t < t_len ? seg_row[t] : 0;
      }
    }
    stage_q(i);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();  // query tile i (and at i = 0 the keys) landed
    const bf16* Dt = Qt + kMQ * kSE;
    const bf16* Pw = Qt + 3 * kMQ * kSE + (kMQ - 16 - 16 * warp) * kSE;
    const int tw = i * kMQ + 16 * warp;
    // the warp's fragments (at kQS bwd_scores loads them k step by k step)
    uint32_t qa[DKP / 16][4], qb[DKP / 16][4], qd[DKP / 16][4];
    if constexpr (!kQS) {
      load_rows<DKP>(qa, Qt, warp, lane);
      load_rows<DKP>(qb, Qt + 2 * kMQ * kSE, warp, lane);
      load_rows<DKP>(qd, Dt, warp, lane);
    }
    float lse_r[2], dsum_r[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int t = tw + g + 8 * hr;
      lse_r[hr] = t < t_len ? lse[(size_t)bh * t_len + t] : 0.f;
      dsum_r[hr] = t < t_len ? dsum[(size_t)bh * t_len + t] : 0.f;
    }
    float ds[kMS / 8][4], pd[kMS / 8][4];
    uint32_t dsb[kMS / 8][2], pdb[kMS / 8][2];  // kQS: bf16 pairs
    if constexpr (kQS)
      bwd_scores_qs<DKP, kSeg>(Qt, Qt + 2 * kMQ * kSE, Dt, Ks, Vs, Pw, G, tw,
                               k0, t_len, kb_row, lse_r, dsum_r, scale, left,
                               right, stream, thresh, dscale, tp, seg_row,
                               seg_q, dsb, pdb);
    else
      bwd_scores<DKP, kSeg>(qa, qb, qd, Ks, Vs, Pw, G, tw, k0, t_len, kb_row,
                            lse_r, dsum_r, scale, left, right, stream,
                            thresh, dscale, tp, seg_row, seg_q, ds, pd);
    // the tile's dropped p and dS, over its consumed Qv and P rows once
    // every warp has read them (where they fit)
    bf16* PD = S::kAliasPD
                   ? Qt + 2 * kMQ * kSE
                   : reinterpret_cast<bf16*>(Gall + 4 * 16 * kGS);
    bf16* DS = PD + kMQ * kPS;
    if (S::kAliasPD) __syncthreads();
    if constexpr (kQS) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = 16 * warp + g + 8 * hr;
#pragma unroll
        for (int n = 0; n < kMS / 8; ++n) {
          const int c = 8 * n + 2 * t4;
          *reinterpret_cast<uint32_t*>(PD + r * kPS + c) = pdb[n][hr];
          *reinterpret_cast<uint32_t*>(DS + r * kPS + c) = dsb[n][hr];
        }
      }
    } else {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = 16 * warp + g + 8 * hr;
#pragma unroll
        for (int n = 0; n < kMS / 8; ++n) {
          const int c = 8 * n + 2 * t4;
          *reinterpret_cast<uint32_t*>(PD + r * kPS + c) =
              pack_bf16(pd[n][2 * hr], pd[n][2 * hr + 1]);
          *reinterpret_cast<uint32_t*>(DS + r * kPS + c) =
              pack_bf16(ds[n][2 * hr], ds[n][2 * hr + 1]);
        }
      }
    }
    __syncthreads();  // the tile's p and dS are complete

    // keys 16 w ..: A = P_dropped^T / dS^T (k = query), B = dctx / Qu rows
#pragma unroll
    for (int kc = 0; kc < kMQ / 16; ++kc) {
      uint32_t ap[4], as[4];
      const int arow = (16 * kc + lane % 8 + (lane / 16) * 8) * kPS +
                       16 * warp + ((lane / 8) % 2) * 8;
      ldmatrix_x4_trans(ap, PD + arow);
      ldmatrix_x4_trans(as, DS + arow);
#pragma unroll
      for (int dd = 0; dd < kND / 2; ++dd) {
        const int brow = (16 * kc + lane % 8 + ((lane / 8) % 2) * 8) * kSE +
                         16 * dd + (lane / 16) * 8;
        uint32_t bd[4], bu[4];
        ldmatrix_x4_trans(bd, Dt + brow);
        mma_bf16(dvv[2 * dd], ap, bd[0], bd[1]);
        mma_bf16(dvv[2 * dd + 1], ap, bd[2], bd[3]);
        ldmatrix_x4_trans(bu, Qt + brow);
        mma_bf16(dkk[2 * dd], as, bu[0], bu[1]);
        mma_bf16(dkk[2 * dd + 1], as, bu[2], bu[3]);
      }
    }
    __syncthreads();  // query tile i, p and dS are consumed
  }
  if constexpr (kSeg || kWin) cp_async_wait<0>();

#pragma unroll
  for (int n = 0; n < kND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int s = k0 + 16 * warp + g + (e / 2) * 8;
      const int c = 8 * n + 2 * t4 + (e % 2);
      if (s >= t_len || c >= dk) continue;
      bf16* dst = grads + gl.at(b, hh, s);
      dst[2 * gc + c] = __float2bfloat16(dkk[n][e]);
      dst[3 * gc + c] = __float2bfloat16(dvv[n][e]);
    }
}

constexpr int kDposGroups = 8;  // batch groups of the bf16 dP sum

// The bf16 score gradients: dq_mma_kernel (which also writes D into dsum),
// dkv_mma_kernel, and dpos_kernel summing the window partials over groups
// of batch rows into `part`, whose groups sum_parts_kernel adds into dP
// (2T - 1, H dk) in bf16. `seg` (B, T) or null: the packed-segment map,
// which selects the kernels' segment mode; a limited side of the window
// (left, right) selects their narrowed tiles (kWin).
template <int DKP>
cudaError_t score_grads_mma(const void* qu, const void* qv, const void* k,
                            const void* v, const void* p,
                            const float* key_bias, const float* lse,
                            const void* dctx, const void* ctx, HeadLayout cl,
                            void* grads, HeadLayout gl, long long gc,
                            float* dsum, float* dpart, void* dpos,
                            float* part, int batch,
                            int t_len, int heads, int dk, uint32_t seed,
                            uint32_t b_stride, uint32_t thresh, float dscale,
                            int tp, int left, int right, const int* seg,
                            cudaStream_t stream) {
  using S = BwdMma<DKP>;
  const int n_pos = 2 * t_len - 1, d = heads * dk;
  const int n_qt = (t_len + kMQ - 1) / kMQ, n_kt = (t_len + kMS - 1) / kMS;
  const int win = kMS * (n_kt + 1);
  const float scale = 1.f / sqrtf((float)dk);
  const bool lim = left >= 0 || right >= 0;
  auto* dq = seg ? (lim ? dq_mma_kernel<DKP, true, true>
                        : dq_mma_kernel<DKP, true, false>)
                 : (lim ? dq_mma_kernel<DKP, false, true>
                        : dq_mma_kernel<DKP, false, false>);
  auto* dkv = seg ? (lim ? dkv_mma_kernel<DKP, true, true>
                         : dkv_mma_kernel<DKP, true, false>)
                  : (lim ? dkv_mma_kernel<DKP, false, true>
                         : dkv_mma_kernel<DKP, false, false>);
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(dq,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)S::kDqSmem)) != cudaSuccess)
    return err;
  dq<<<dim3(n_qt, batch * heads), 128, S::kDqSmem, stream>>>(
      (const bf16*)qu, (const bf16*)qv, (const bf16*)k, (const bf16*)v,
      (const bf16*)p, key_bias, lse, (const bf16*)dctx, (const bf16*)ctx, cl,
      (bf16*)grads, gl, gc, dsum, dpart, t_len, heads, dk, scale, seed,
      b_stride, thresh, dscale, tp, win, left, right, seg);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = cudaFuncSetAttribute(dkv,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)S::kDkvSmem)) != cudaSuccess)
    return err;
  dkv<<<dim3(n_kt, batch * heads), 128, S::kDkvSmem, stream>>>(
      (const bf16*)qu, (const bf16*)qv, (const bf16*)k, (const bf16*)v,
      (const bf16*)p, key_bias, lse, (const bf16*)dctx, dsum, (bf16*)grads,
      gl, gc, t_len, heads, dk, scale, seed, b_stride, thresh, dscale, tp,
      left, right, seg);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int b_per = (batch + kDposGroups - 1) / kDposGroups;
  const int groups = (batch + b_per - 1) / b_per;
  const int total = n_pos * d;
  dpos_kernel<<<dim3((total + 255) / 256, groups), 256, 0, stream>>>(
      dpart, part, batch, heads, dk, t_len, n_qt, win, kMQ, b_per);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  sum_parts_kernel<bf16><<<(total + 255) / 256, 256, 0, stream>>>(
      part, (bf16*)dpos, groups, total);
  return cudaGetLastError();
}

size_t dq_smem(int dk, int win) {
  const int ks = row_stride(dk);
  return sizeof(float) * ((size_t)ks * (3 * kBQ + 2 * kBS + kBQ + kBS - 1) +
                          kBQ * (kBS + 1) + (size_t)win * dk);
}

// The fp32 score gradients (the check dtype): dq_kernel, dkv_kernel and
// dpos_kernel, SIMT. With `seg` (B, T) the segment mode: every key tile is
// visited, as core_kernel<T, true> visits them, and a key of another
// segment scores -1e30; a window masks in the same way, without narrowing
// the tiles.
template <typename T>
cudaError_t score_grads_simt(const void* qu, const void* qv, const void* k,
                        const void* v, const void* p, const float* key_bias,
                        const float* lse, const void* dctx, const void* ctx,
                        HeadLayout cl, void* grads, HeadLayout gl,
                        long long gc, float* dsum, float* dpart, float* dpos,
                        int batch, int t_len, int heads, int dk,
                        uint32_t seed, uint32_t b_stride, uint32_t thresh,
                        float dscale, int tp, int left, int right,
                        const int* seg, cudaStream_t stream) {
  const int n_pos = 2 * t_len - 1, d = heads * dk;
  const int n_qt = (t_len + kBQ - 1) / kBQ, win = n_qt * kBQ + kBS - 1;
  const float scale = 1.f / sqrtf((float)dk);
  const size_t smem_q = dq_smem(dk, win);
  // two column slots a lane up to dk = 64, four up to 128
  const bool wide = dk > 64;
  auto* dq = wide ? (seg ? dq_kernel<T, true, 4> : dq_kernel<T, false, 4>)
                  : (seg ? dq_kernel<T, true, 2> : dq_kernel<T, false, 2>);
  auto* dkv = wide ? (seg ? dkv_kernel<T, true, 4> : dkv_kernel<T, false, 4>)
                   : (seg ? dkv_kernel<T, true, 2>
                          : dkv_kernel<T, false, 2>);
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(dq,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem_q)) != cudaSuccess)
    return err;
  dq<<<dim3(n_qt, batch * heads), 256, smem_q, stream>>>(
      (const T*)qu, (const T*)qv, (const T*)k, (const T*)v, (const T*)p,
      key_bias, lse, (const T*)dctx, (const T*)ctx, cl, (T*)grads, gl, gc,
      dsum, dpart, t_len, heads, dk, scale, seed, b_stride, thresh, dscale, tp,
      win, left, right, seg);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int ks = row_stride(dk);
  const size_t smem_kv =
      sizeof(float) * (size_t)ks * (2 * kBS + 3 * kBQ + kBQ + kBS - 1);
  if ((err = cudaFuncSetAttribute(dkv,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem_kv)) != cudaSuccess)
    return err;
  dkv<<<dim3((t_len + kBS - 1) / kBS, batch * heads), 256, smem_kv,
        stream>>>(
      (const T*)qu, (const T*)qv, (const T*)k, (const T*)v, (const T*)p,
      key_bias, lse, (const T*)dctx, dsum, (T*)grads, gl, gc, t_len, heads,
      dk, scale, seed, b_stride, thresh, dscale, tp, left, right, seg);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  dpos_kernel<<<(n_pos * d + 255) / 256, 256, 0, stream>>>(
      dpart, dpos, batch, heads, dk, t_len, n_qt, win, kBQ, batch);
  return cudaGetLastError();
}

// The four per-head gradients into grads (component c of row (b, h, t) at
// gl.at(b, h, t) + c * gc) and dP (2T - 1, H dk) into dpos (fp32, or bf16
// in the bf16 path), from dctx (B, H, T, dk) and ctx (layout cl): bf16 on
// the tensor cores (score_grads_mma), fp32 on the SIMT kernels; `seg`
// (B, T) or null selects the segment mode.
template <typename T>
cudaError_t score_grads(const void* qu, const void* qv, const void* k,
                        const void* v, const void* p, const float* key_bias,
                        const float* lse, const void* dctx, const void* ctx,
                        HeadLayout cl, void* grads, HeadLayout gl,
                        long long gc, float* dsum, float* dpart, float* dpos,
                        float* part, int batch, int t_len, int heads, int dk,
                        uint32_t seed, uint32_t b_stride, uint32_t thresh,
                        float dscale, int tp, int left, int right,
                        const int* seg, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    auto* fn = dk <= 16   ? score_grads_mma<16>
               : dk <= 32 ? score_grads_mma<32>
               : dk <= 48 ? score_grads_mma<48>
               : dk <= 64 ? score_grads_mma<64>
                          : score_grads_mma<128>;
    return fn(qu, qv, k, v, p, key_bias, lse, dctx, ctx, cl, grads, gl, gc,
              dsum, dpart, dpos, part, batch, t_len, heads, dk, seed,
              b_stride, thresh, dscale, tp, left, right, seg, stream);
  } else {
    return score_grads_simt<T>(qu, qv, k, v, p, key_bias, lse, dctx, ctx, cl,
                               grads, gl, gc, dsum, dpart, dpos, batch, t_len,
                               heads, dk, seed, b_stride, thresh, dscale, tp,
                               left, right, seg, stream);
  }
}

template <typename T>
int run_bwd(const void* g, const void* x, const void* wo_t, const void* wcat,
            const void* qu, const void* qv, const void* k, const void* v,
            const void* p, const float* key_bias, const float* lse,
            const void* ctx, const void* pe, void* dctx, void* grads,
            float* dsum, float* dpart, float* dpos, void* dx, float* part,
            float* dw_all, float* dwo, float* dwpos, const int* seg,
            int batch, int t_len, int d, int heads, int left, int right,
            uint32_t seed, uint32_t thresh, float dscale, int tp,
            cudaStream_t stream) {
  const int dk = d / heads, rows = batch * t_len, n_pos = 2 * t_len - 1;
  Jobs dc{};
  dc.job[0] = {g, wo_t, nullptr, nullptr, dctx, nullptr, rows, 1};
  cudaError_t err = project<T>(dc, 1, rows, d, d, t_len, heads, dk, stream);
  if (err != cudaSuccess) return (int)err;

  err = score_grads<T>(qu, qv, k, v, p, key_bias, lse, dctx, ctx,
                       rows_layout(t_len, heads, dk), grads,
                       rows_layout(t_len, 4 * heads, dk), d, dsum, dpart,
                       dpos, part, batch, t_len, heads, dk, seed,
                       (uint32_t)heads, thresh, dscale, tp, left, right, seg,
                       stream);
  if (err != cudaSuccess) return (int)err;

  Jobs dxj{};
  dxj.job[0] = {grads, wcat, nullptr, nullptr, dx, nullptr, rows, 0};
  if ((err = project<T>(dxj, 1, rows, 4 * d, d, t_len, heads, dk,
                        stream)) != cudaSuccess)
    return (int)err;

  if ((err = wgrad<T>(grads, 4 * d, x, d, 1, rows, part, dw_all,
                      stream)) != cudaSuccess ||
      (err = wgrad<T>(g, d, ctx, d, 0, rows, part, dwo, stream)) !=
          cudaSuccess)
    return (int)err;
  return (int)wgrad<T>(dpos, d, pe, d, 0, n_pos, part, dwpos, stream);
}

// ---------------------------------------------------------------------------
// Per-head attention. Replaces tpu_asr/ops/pallas_attention.py::
// _attn_fwd_kernel and ::_attn_bwd_kernel (launched by
// fused_relpos_attention): the caller hands in q_u = q + u, q_v = q + v, k
// and v per head, (B, H, T, dk), and the context comes back per head. The
// same hand-written kernels as the block sublayer run it: proj_kernel for
// P = PE W_pos^T, core_kernel for the scores, softmax, dropout and value
// product (the TPU kernel instead contracts a sin/cos rotation of
// q_v W_pos against constant tables); in the backward dq_kernel,
// dkv_kernel and dpos_kernel, and wgrad_kernel for dW_pos = dP^T PE, with
// the gradients written per head. The TPU kernel's per-batch dWev/dWod
// partials become the dP window partials that dpos_kernel sums in order.
// ---------------------------------------------------------------------------

template <typename T>
int run_heads(const void* qu, const void* qv, const void* k, const void* v,
              const void* wpos, const void* pe, const float* key_bias,
              void* p, void* ctx, float* lse, int batch, int t_len, int d,
              int heads, int left, int right, uint32_t seed, uint32_t b_stride,
              uint32_t thresh, float dscale, int tp, cudaStream_t stream) {
  const int dk = d / heads, n_pos = 2 * t_len - 1;
  Jobs proj{};
  proj.job[0] = {pe, wpos, nullptr, nullptr, p, nullptr, n_pos, 2};
  cudaError_t err =
      project<T>(proj, 1, n_pos, d, d, t_len, heads, dk, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_core<T>(qu, qv, k, v, p, key_bias, ctx,
                             heads_layout(t_len, heads, dk), lse, batch,
                             t_len, heads, dk, seed, b_stride, thresh,
                             dscale, tp, left, right, nullptr, stream);
}

template <typename T>
int run_heads_bwd(const void* g, const void* qu, const void* qv,
                  const void* k, const void* v, const void* p,
                  const float* key_bias, const float* lse, const void* ctx,
                  const void* pe, void* grads, float* dsum, float* dpart,
                  float* dpos, float* part, float* dwpos, int batch,
                  int t_len, int d, int heads, int left, int right,
                  uint32_t seed, uint32_t b_stride, uint32_t thresh,
                  float dscale, int tp, cudaStream_t stream) {
  const int dk = d / heads, n_pos = 2 * t_len - 1;
  const HeadLayout hl = heads_layout(t_len, heads, dk);
  cudaError_t err = score_grads<T>(
      qu, qv, k, v, p, key_bias, lse, g, ctx, hl, grads, hl,
      (long long)batch * heads * t_len * dk, dsum, dpart, dpos, part, batch,
      t_len, heads, dk, seed, b_stride, thresh, dscale, tp, left, right,
      nullptr, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)wgrad<T>(dpos, d, pe, d, 0, n_pos, part, dwpos, stream);
}

}  // namespace

// The wrapper guarantees: contiguous tensors on one device; x, weights, the
// position table pe and scratch in one dtype (fp32 or bf16); biases and the
// key bias in fp32; dk = d / heads <= 128, and in bf16 d % 8 == 0 and
// dk % 4 == 0; scratch q_u, q_v, k, v sized
// (B, H, T, dk), p (H, 2T-1, dk), ctx and out (B, T, d); lse (B, H, T) fp32
// or null; seg (B, T) int32 packed-segment map or null (under autograd the
// backward takes the same map, tat_attention_bwd). Keys outside the window
// (left, right) score -1e30; -1 is unlimited. Dropout on the
// probabilities when thresh > 0: stream seed + b * H + h, idx t * tp + s,
// kept values scaled by dscale.
extern "C" int tat_attention(int bf16, const void* x, const void* wq,
                             const void* wk, const void* wv, const void* wpos,
                             const void* wo, const void* cu, const void* cv,
                             const void* bk, const void* bv, const void* pe,
                             const void* key_bias, void* qu, void* qv,
                             void* k, void* v, void* p, void* ctx, void* out,
                             void* lse, const void* seg, int batch, int t_len,
                             int d, int heads, int left, int right,
                             unsigned int seed, unsigned int thresh,
                             float dscale, int tp, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float *cu_ = (const float*)cu, *cv_ = (const float*)cv,
              *bk_ = (const float*)bk, *bv_ = (const float*)bv,
              *kb_ = (const float*)key_bias;
  const int* seg_ = (const int*)seg;
  return bf16 ? run<__nv_bfloat16>(x, wq, wk, wv, wpos, wo, cu_, cv_, bk_,
                                   bv_, pe, kb_, qu, qv, k, v, p, ctx, out,
                                   (float*)lse, seg_, batch, t_len, d, heads,
                                   left, right, seed, thresh, dscale, tp, s)
              : run<float>(x, wq, wk, wv, wpos, wo, cu_, cv_, bk_, bv_, pe,
                           kb_, qu, qv, k, v, p, ctx, out, (float*)lse, seg_,
                           batch, t_len, d, heads, left, right, seed, thresh,
                           dscale, tp, s);
}

// Backward of tat_attention from its saved forward (x, q_u, q_v, k, v, p,
// ctx, lse; the same dropout arguments) and the cotangent g (B, T, d) in
// the working dtype. wo_t = Wo^T (d, d) and wcat = [Wq; Wq; Wk; Wv]^T
// (d, 4d) in the working dtype; pe (2T-1, d) in the working dtype. Scratch:
// dctx (B, H, T, dk) and grads (B, T, 4d) in the working dtype, dsum
// (B, H, T), dpart (fp32: (B, H, ceil(T/32), 32 ceil(T/32) + 31, dk);
// bf16: (B, H, ceil(T/64), 64 (ceil(T/64) + 1), dk)), dpos (2T-1, d; fp32,
// holding bf16 in the bf16 path), part (at least ceil(B T / 512) * 4d *
// (d + 1), and in bf16 groups * (2T-1) * d with groups =
// ceil(B / ceil(B / 8))) fp32. Outputs: dx (B, T, d) in the working dtype;
// fp32 dw_all (4d, d + 1) = [dq_u | dq_v | dk | dv]^T [x | 1], dwo (d, d),
// dwpos (d, d). seg: the forward's (B, T) int32 packed-segment map, or
// null; (left, right): the forward's window.
extern "C" int tat_attention_bwd(
    int bf16, const void* g, const void* x, const void* wo_t,
    const void* wcat, const void* qu, const void* qv, const void* k,
    const void* v, const void* p, const void* key_bias, const void* lse,
    const void* ctx, const void* pe, void* dctx, void* grads, void* dsum,
    void* dpart, void* dpos, void* dx, void* part, void* dw_all, void* dwo,
    void* dwpos, const void* seg, int batch, int t_len, int d, int heads,
    int left, int right, unsigned int seed, unsigned int thresh,
    float dscale, int tp, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  auto F = [](const void* q) { return (float*)q; };
  const int* seg_ = (const int*)seg;
  return bf16 ? run_bwd<__nv_bfloat16>(
                    g, x, wo_t, wcat, qu, qv, k, v, p, F(key_bias), F(lse),
                    ctx, pe, dctx, grads, F(dsum), F(dpart), F(dpos), dx,
                    F(part), F(dw_all), F(dwo), F(dwpos), seg_, batch, t_len,
                    d, heads, left, right, seed, thresh, dscale, tp, s)
              : run_bwd<float>(g, x, wo_t, wcat, qu, qv, k, v, p,
                               F(key_bias), F(lse), ctx, pe, dctx, grads,
                               F(dsum), F(dpart), F(dpos), dx, F(part),
                               F(dw_all), F(dwo), F(dwpos), seg_, batch,
                               t_len, d, heads, left, right, seed, thresh,
                               dscale, tp, s);
}

// Per-head attention (fused_relpos_attention). The wrapper guarantees:
// contiguous tensors on one device; q_u, q_v, k, v (B, H, T, dk), w_pos
// (d, d) and the scratch p (H, 2T-1, dk) and ctx (B, H, T, dk) in one dtype
// (fp32 or bf16) with pe (2T-1, d); key_bias (B, T) fp32; d = H dk,
// dk <= 128, and in bf16 d % 8 == 0 and dk % 4 == 0; lse (B, H, T) fp32 or
// null. Keys outside the window (left, right) score -1e30; -1 is
// unlimited. Dropout when thresh > 0: stream seed + b_stride * b + h, idx
// t * tp + s: b_stride = H gives every head its own stream, b_stride = 0
// the streams 0 .. H - 1 in every batch row.
extern "C" int tat_relpos_attention(int bf16, const void* qu, const void* qv,
                                    const void* k, const void* v,
                                    const void* wpos, const void* pe,
                                    const void* key_bias, void* p, void* ctx,
                                    void* lse, int batch, int t_len, int d,
                                    int heads, int left, int right,
                                    unsigned int seed, unsigned int b_stride,
                                    unsigned int thresh, float dscale, int tp,
                                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* kb = (const float*)key_bias;
  return bf16 ? run_heads<__nv_bfloat16>(qu, qv, k, v, wpos, pe, kb, p, ctx,
                                         (float*)lse, batch, t_len, d, heads,
                                         left, right, seed, b_stride, thresh,
                                         dscale, tp, s)
              : run_heads<float>(qu, qv, k, v, wpos, pe, kb, p, ctx,
                                 (float*)lse, batch, t_len, d, heads, left,
                                 right, seed, b_stride, thresh, dscale, tp, s);
}

// Backward of tat_relpos_attention from its saved forward (q_u, q_v, k, v,
// p, ctx, lse; the same window and dropout arguments) and the cotangent g
// (B, H, T, dk) in the working dtype; pe (2T-1, d) in the working dtype.
// Outputs: grads (4, B, H, T, dk) = dq_u, dq_v, dk, dv in the working
// dtype; fp32 dwpos (d, d). Scratch as tat_attention_bwd's: dsum, dpart,
// dpos, and part (at least ceil((2T-1) / 512) * d * d, and in bf16
// groups * (2T-1) * d).
extern "C" int tat_relpos_attention_bwd(
    int bf16, const void* g, const void* qu, const void* qv, const void* k,
    const void* v, const void* p, const void* key_bias, const void* lse,
    const void* ctx, const void* pe, void* grads, void* dsum, void* dpart,
    void* dpos, void* part, void* dwpos, int batch, int t_len, int d,
    int heads, int left, int right, unsigned int seed, unsigned int b_stride,
    unsigned int thresh, float dscale, int tp, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  auto F = [](const void* q) { return (float*)q; };
  return bf16 ? run_heads_bwd<__nv_bfloat16>(
                    g, qu, qv, k, v, p, F(key_bias), F(lse), ctx, pe, grads,
                    F(dsum), F(dpart), F(dpos), F(part), F(dwpos), batch,
                    t_len, d, heads, left, right, seed, b_stride, thresh,
                    dscale, tp, s)
              : run_heads_bwd<float>(
                    g, qu, qv, k, v, p, F(key_bias), F(lse), ctx, pe, grads,
                    F(dsum), F(dpart), F(dpos), F(part), F(dwpos), batch,
                    t_len, d, heads, left, right, seed, b_stride, thresh,
                    dscale, tp, s);
}
