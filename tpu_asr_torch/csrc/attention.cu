// Relative-position multi-head self-attention sublayer, forward (eval):
// q/k/v projections with biases, content scores (q + u) . k, position
// scores (q + v) . P[t - s] with P = PE @ W_pos, key-padding bias, softmax,
// value contraction and the per-head output projection summed over heads.
// The linear_out bias is added by the caller.
//
// Replaces tpu_asr/ops/pallas_attention.py::_block_fwd_kernel (and its
// _block_scores), launched by fused_relpos_attention_block.
//
// What bounds it on an H100: at B=32, T=376, D=176, 4 heads, dk=44 the
// products are small (3 GFLOP of projections, 4.8 GFLOP of scores and
// values, 0.7 GFLOP of output projection per layer), so it is bound by how
// many operand loads each multiply-add costs, and by never writing the
// (B, H, T, T) score tensor: that tensor alone would be 72 MB per layer
// in fp32.
//
// Design, three launches, deterministic (no atomics):
//   1. proj_kernel: one tiled GEMM launch whose blockIdx.z picks the job -
//      x Wq + (bq + u) and x Wq + (bq + v) (one product, two epilogues),
//      x Wk + bk, x Wv + bv, and PE Wpos - written per head (B, H, T, dk)
//      and (H, 2T-1, dk) in the working type.
//   2. core_kernel: per (batch row, head, 32 queries), flash-style over
//      32-key tiles with an online softmax, so scores never leave the block.
//      The rel-shift is a gather: the tile's 63 relative positions t - s
//      are staged once, and lane j of row r reads row (j - r + 31). This
//      replaces the TPU kernel's sin/cos rotation factorisation, which
//      contracts over D = 176 per score instead of dk = 44. Shared-memory
//      rows use a stride whose float4 count is odd, so the per-lane float4
//      reads of K and P rows are conflict-free.
//   3. proj_kernel again: context (B*T, D) @ Wo^T, every output summed over
//      all heads by one thread.
// Plain SIMT with fp32 accumulation; operands in fp32 or bf16 (template),
// rounded to the working type where the TPU kernel rounds them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// One product C = A @ W^T (+ bias) of a projection launch.
struct Job {
  const void* a;      // (m, K): activations in T, or the fp32 position table
  const void* w;      // (N, K) in T: PyTorch Linear layout
  const float* bias;  // (N) or null
  const float* bias2; // (N) or null: second epilogue into out2
  void* out;
  void* out2;
  int m;
  int a_fp32;         // A is fp32 and is rounded through T as it is loaded
  int layout;         // 0: (m, N); 1: (B, H, T, dk); 2: (H, m, dk)
};
struct Jobs {
  Job job[4];
};

constexpr int kTile = 64;
constexpr int kChunk = 16;

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
        if (m < jb.m)
          av = jb.a_fp32
                   ? to_f(from_f<T>(((const float*)jb.a)[(size_t)m * K + k]))
                   : to_f(((const T*)jb.a)[(size_t)m * K + k]);
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
      if (n >= N) continue;
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
      const float v = acc[i][j];
      ((T*)jb.out)[idx] = from_f<T>(jb.bias ? v + jb.bias[n] : v);
      if (jb.bias2) ((T*)jb.out2)[idx] = from_f<T>(v + jb.bias2[n]);
    }
  }
}

constexpr int kBQ = 32;  // queries per block: 8 warps x 4 rows
constexpr int kBS = 32;  // keys per tile: one per lane
constexpr int kRows = 4; // query rows per warp

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Row stride (floats) of the shared tiles: a multiple of 4 holding dk, with
// an odd number of float4s.
__host__ __device__ __forceinline__ int row_stride(int dk) {
  int s = (dk + 3) / 4 * 4;
  return (s / 4) % 2 ? s : s + 4;
}

template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* src,
                                           int first, int n_rows,
                                           int valid_rows, int dk, int ks) {
  // dst[r * ks + d] = src[(first + r) * dk + d], zero outside the source;
  // one warp per row, lanes along d
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < n_rows; r += blockDim.x / 32) {
    const int row = first + r;
    const bool ok = row >= 0 && row < valid_rows;
    const T* s = src + (size_t)row * dk;
    for (int d = lane; d < ks; d += 32)
      dst[r * ks + d] = (ok && d < dk) ? to_f(s[d]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(256) core_kernel(
    const T* __restrict__ qu, const T* __restrict__ qv,  // (B, H, T, dk)
    const T* __restrict__ kk, const T* __restrict__ vv,  // (B, H, T, dk)
    const T* __restrict__ pos,                           // (H, 2T-1, dk)
    const float* __restrict__ key_bias,                  // (B, T)
    T* __restrict__ ctx,                                 // (B, T, H * dk)
    int t_len, int heads, int dk, float scale) {
  extern __shared__ float4 smem4[];
  const int ks = row_stride(dk);
  float* Qu = reinterpret_cast<float*>(smem4);  // kBQ x ks
  float* Qv = Qu + kBQ * ks;                    // kBQ x ks
  float* Ks = Qv + kBQ * ks;                    // kBS x ks
  float* Vs = Ks + kBS * ks;                    // kBS x ks
  float* Ps = Vs + kBS * ks;                    // (kBQ + kBS - 1) x ks

  const int bh = blockIdx.y, b = bh / heads, hh = bh - b * heads;
  const int q0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_pos = 2 * t_len - 1;
  const size_t head_off = (size_t)bh * t_len * dk;
  const T* pos_h = pos + (size_t)hh * n_pos * dk;

  stage_rows(Qu, qu + head_off, q0, kBQ, t_len, dk, ks);
  stage_rows(Qv, qv + head_off, q0, kBQ, t_len, dk, ks);

  float m_i[kRows], l_i[kRows], o0[kRows], o1[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m_i[r] = -INFINITY;
    l_i[r] = o0[r] = o1[r] = 0.f;
  }
  const bool has0 = lane < dk, has1 = lane + 32 < dk;

  for (int s0 = 0; s0 < t_len; s0 += kBS) {
    __syncthreads();  // the previous tile is consumed
    stage_rows(Ks, kk + head_off, s0, kBS, t_len, dk, ks);
    stage_rows(Vs, vv + head_off, s0, kBS, t_len, dk, ks);
    // local row l holds relative position t - s = q0 - s0 + 31 - l, which
    // is P row (T - 1) - (t - s)
    stage_rows(Ps, pos_h, (t_len - 1) - (q0 - s0 + kBS - 1), kBQ + kBS - 1,
               n_pos, dk, ks);
    __syncthreads();

    const int s = s0 + lane;
    const float kb = s < t_len ? key_bias[(size_t)b * t_len + s] : 0.f;
    float sc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) sc[r] = 0.f;
    const float4* krow = reinterpret_cast<const float4*>(Ks + lane * ks);
    for (int d4 = 0; d4 < ks / 4; ++d4) {
      const float4 k4 = krow[d4];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int row = warp * kRows + r;
        const float4 a = reinterpret_cast<const float4*>(Qu + row * ks)[d4];
        const float4 c = reinterpret_cast<const float4*>(Qv + row * ks)[d4];
        const float4 p = reinterpret_cast<const float4*>(
            Ps + (lane - row + kBS - 1) * ks)[d4];
        float v = sc[r];
        v = fmaf(a.x, k4.x, v);
        v = fmaf(a.y, k4.y, v);
        v = fmaf(a.z, k4.z, v);
        v = fmaf(a.w, k4.w, v);
        v = fmaf(c.x, p.x, v);
        v = fmaf(c.y, p.y, v);
        v = fmaf(c.z, p.z, v);
        v = fmaf(c.w, p.w, v);
        sc[r] = v;
      }
    }

    float pw[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float x = s < t_len ? sc[r] * scale + kb : -INFINITY;
      const float m_new = fmaxf(m_i[r], warp_max(x));
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float p = expf(x - m_use);
      const float corr = expf(m_i[r] - m_use);
      l_i[r] = l_i[r] * corr + warp_sum(p);
      m_i[r] = m_new;
      o0[r] *= corr;
      o1[r] *= corr;
      pw[r] = to_f(from_f<T>(p));  // the value product takes T operands
    }
    for (int j = 0; j < kBS; ++j) {
      const float v0 = has0 ? Vs[j * ks + lane] : 0.f;
      const float v1 = has1 ? Vs[j * ks + lane + 32] : 0.f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float p = __shfl_sync(0xffffffffu, pw[r], j);
        o0[r] = fmaf(p, v0, o0[r]);
        o1[r] = fmaf(p, v1, o1[r]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int t = q0 + warp * kRows + r;
    if (t >= t_len) continue;
    T* dst = ctx + ((size_t)b * t_len + t) * heads * dk + hh * dk;
    const float inv = 1.f / l_i[r];
    if (has0) dst[lane] = from_f<T>(o0[r] * inv);
    if (has1) dst[lane + 32] = from_f<T>(o1[r] * inv);
  }
}

template <typename T>
int run(const void* x, const void* wq, const void* wk, const void* wv,
        const void* wpos, const void* wo, const float* cu, const float* cv,
        const float* bk, const float* bv, const void* pe,
        const float* key_bias, void* qu, void* qv, void* k, void* v, void* p,
        void* ctx, void* out, int batch, int t_len, int d, int heads,
        cudaStream_t stream) {
  const int dk = d / heads, rows = batch * t_len, n_pos = 2 * t_len - 1;
  Jobs proj{};
  proj.job[0] = {x, wq, cu, cv, qu, qv, rows, 0, 1};
  proj.job[1] = {x, wk, bk, nullptr, k, nullptr, rows, 0, 1};
  proj.job[2] = {x, wv, bv, nullptr, v, nullptr, rows, 0, 1};
  proj.job[3] = {pe, wpos, nullptr, nullptr, p, nullptr, n_pos, 1, 2};
  const int m_max = rows > n_pos ? rows : n_pos;
  const dim3 grid1((m_max + kTile - 1) / kTile, (d + kTile - 1) / kTile, 4);
  proj_kernel<T><<<grid1, 256, 0, stream>>>(proj, d, d, t_len, heads, dk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int ks = row_stride(dk);
  const size_t smem =
      sizeof(float) * (size_t)ks * (2 * kBQ + 2 * kBS + kBQ + kBS - 1);
  err = cudaFuncSetAttribute(core_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid2((t_len + kBQ - 1) / kBQ, batch * heads);
  core_kernel<T><<<grid2, 256, smem, stream>>>(
      (const T*)qu, (const T*)qv, (const T*)k, (const T*)v, (const T*)p,
      key_bias, (T*)ctx, t_len, heads, dk, 1.f / sqrtf((float)dk));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  Jobs outp{};
  outp.job[0] = {ctx, wo, nullptr, nullptr, out, nullptr, rows, 0, 0};
  const dim3 grid3((rows + kTile - 1) / kTile, (d + kTile - 1) / kTile, 1);
  proj_kernel<T><<<grid3, 256, 0, stream>>>(outp, d, d, t_len, heads, dk);
  return (int)cudaGetLastError();
}

}  // namespace

// The wrapper guarantees: contiguous tensors on one device; x, weights and
// scratch in one dtype (fp32 or bf16); biases, the position table and the
// key bias in fp32; dk = d / heads <= 64; scratch q_u, q_v, k, v sized
// (B, H, T, dk), p (H, 2T-1, dk), ctx and out (B, T, d).
extern "C" int tat_attention(int bf16, const void* x, const void* wq,
                             const void* wk, const void* wv, const void* wpos,
                             const void* wo, const void* cu, const void* cv,
                             const void* bk, const void* bv, const void* pe,
                             const void* key_bias, void* qu, void* qv,
                             void* k, void* v, void* p, void* ctx, void* out,
                             int batch, int t_len, int d, int heads,
                             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float *cu_ = (const float*)cu, *cv_ = (const float*)cv,
              *bk_ = (const float*)bk, *bv_ = (const float*)bv,
              *kb_ = (const float*)key_bias;
  return bf16 ? run<__nv_bfloat16>(x, wq, wk, wv, wpos, wo, cu_, cv_, bk_,
                                   bv_, pe, kb_, qu, qv, k, v, p, ctx, out,
                                   batch, t_len, d, heads, s)
              : run<float>(x, wq, wk, wv, wpos, wo, cu_, cv_, bk_, bv_, pe,
                           kb_, qu, qv, k, v, p, ctx, out, batch, t_len, d,
                           heads, s);
}
