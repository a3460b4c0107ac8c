// The whole deterministic (eval) Conformer layer in one cooperative launch:
//   x1 = x + 0.5 FFN1(LN(x))        FFN(y) = silu(y W1^T + b1) W2^T + b2
//   x2 = x1 + MHSA(LN(x1)) Wo^T + bo                rel-pos attention, window
//   x3 = x2 + conv(LN(x2))                          pointwise 1 + GLU, x mask,
//                                                   depthwise k, folded BN or
//                                                   LN, SiLU, pointwise 2
//   x4 = x3 + 0.5 FFN2(LN(x3))
//   out = LN(x4) x mask
// with flax's LayerNorm (E[x^2] - E[x]^2, eps 1e-6, no clip) everywhere.
//
// Replaces tpu_asr/ops/pallas_layer.py::_layer_kernel, launched by
// ops/cuda_layer.py::fused_conformer_layer. Like it, it has no gradient.
//
// What bounds it on an H100: at B=32, T'=376 (M = 12,032 rows), D=176,
// 4 heads, d_ff 704, k=31 one layer is about 22 GFLOP (FFN halves 11.9,
// q/k/v/o 3.0, scores and values 4.8, pointwise 2.2) against 8.5 MB of bf16
// x in and out and 1.4 MB of weights: operations, 0.022 ms at the bf16
// tensor rate, if the intermediates stay on chip.
//
// Design. The TPU kernel runs one program per batch row with the whole row
// in VMEM; an SM has 227 KB of shared memory, less than one row at T'=376
// in fp32 with its K, V and GLU output, and B=32 programs would fill 32 of
// 132 SMs. So one cooperative launch of as many 256-thread blocks as fit on
// the card at once walks tiles in grid-stride loops, in four phases
// separated by three grid-wide barriers:
//   A, per 32 rows: FFN1 -> LN -> q_u = q + (bq + u), q_v = q + (bq + v),
//      k, v per head (B, H, T, dk) in the working type; and, per 32 rows of
//      the (2T - 1, D) position table, P = PE Wpos^T (H, 2T-1, dk).
//   B, per (batch row, head, 32 queries): attention_core.cuh's core_tile,
//      the core of attention.cu: scores, key bias, window, softmax, value
//      product -> context (B, T, D) in the working type.
//   C, per 32 rows: context Wo^T + bo + x1 -> x2 (fp32, in place of x1);
//      LN -> pointwise 1 (two halves) -> GLU x row mask -> glu (fp32).
//   D, per 32 rows: the depthwise taps read the tile's rows and k - 1 halo
//      rows of glu (frames outside [0, T) read zero) -> + bd -> folded-BN
//      affine or LN -> SiLU -> pointwise 2 + b2c + x2 -> FFN2 -> final LN
//      x row mask -> out.
// The intermediates live in a workspace the wrapper allocates: x1/x2 and
// glu in fp32 (the TPU kernel keeps the residual stream in fp32), q_u, q_v,
// k, v, P and the context in the working type; about 40 MB at B=32 in bf16,
// most of it in the 50 MB L2. Products are rowtile.cuh's tile_product (plain
// SIMT, fp32 accumulation) with operands in the working type, rounded where
// the TPU kernel rounds them to bf16 (LN outputs, the SiLU outputs, q/k/v,
// P, the attention weights and the context); everything else stays fp32.
// The grid barrier is a counter in device memory: under a cooperative
// launch every block is resident, so spinning on it cannot deadlock.

#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include "attention_core.cuh"
#include "rowtile.cuh"

namespace {

struct LayerArgs {
  const void* x;          // (B, T, D) in T
  void* out;              // (B, T, D) in T
  const float* key_bias;  // (B, T): 0 valid, -1e30 padded
  const float* pe;        // (2T - 1, D) relative sinusoid table
  const float *s1, *sb1;  // FFN1: LN, (F, D), (F), (D, F), (D)
  const void* w11;
  const float* bb11;
  const void* w12;
  const float* bb12;
  const float *sa, *sab;  // attention: LN, Wq, Wk, Wv, Wpos, Wo (D, D)
  const void *wq, *wk, *wv, *wpos, *wo;
  const float *cu, *cv, *bk, *bv, *bo;  // bq + u, bq + v, bk, bv, bo (D)
  const float *sc, *scb;  // conv: LN, pointwise 1 (2D, D), (2D)
  const void* w1;
  const float* b1;
  const float *wd, *bd;   // depthwise (k, D) fp32, (D)
  const float *nw, *nb;   // folded BN or LN scale and bias (D)
  const void* w2c;        // pointwise 2 (D, D), (D)
  const float* b2c;
  const float *s2, *sb2;  // FFN2
  const void* w21;
  const float* bb21;
  const void* w22;
  const float* bb22;
  const float *sf, *sfb;  // final LN
  float* xs;              // (B T, D) fp32: x1, then x2
  float* glu;             // (B T, D) fp32
  void *qu, *qv, *k, *v;  // (B, H, T, dk) in T
  void* p;                // (H, 2T - 1, dk) in T
  void* ctx;              // (B, T, D) in T
  unsigned int* bar;      // 2 counters, zero before the launch
  int batch, t_len, d, heads, dff, ksize, pad_l, layer_norm, left, right;
};

// Floats of the row phases' scratch region H: the FFN's (32, d_ff) hidden
// tile, the (32, D) pointwise-1 half, or the depthwise's 32 + k - 1 rows.
__host__ __device__ __forceinline__ int h_floats(int d, int dff, int ksize) {
  int h = kRT * dff;
  if ((kRT + ksize - 1) * d > h) h = (kRT + ksize - 1) * d;
  if (kRT * d > h) h = kRT * d;
  return h;
}

// Shared memory (bytes) of the launch: the larger of the row phases (X, Y,
// H, the staged weight chunk) and the attention core.
__host__ __device__ __forceinline__ size_t layer_smem(int d, int dff,
                                                      int ksize, int dk) {
  const size_t rows =
      sizeof(float) * ((size_t)2 * kRT * d + h_floats(d, dff, ksize) +
                       (size_t)kKC * kWS);
  const size_t core = core_smem(dk);
  return rows > core ? rows : core;
}

// All blocks of the grid wait here until every block has arrived. bar[0]
// counts arrivals, bar[1] the generation; the last block to arrive resets
// the count and starts the next generation.
__device__ void grid_barrier(unsigned int* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int gen = atomicAdd(bar + 1, 0u);
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (atomicAdd(bar + 1, 0u) == gen) __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

__device__ __forceinline__ float silu(float h) { return h / (1.f + expf(-h)); }
__device__ __forceinline__ float sigmoid(float h) {
  return 1.f / (1.f + expf(-h));
}

// X[r * d + c] = src[(m0 + r) * d + c] as fp32, zero past m_rows.
template <typename S>
__device__ void load_rows(float* X, const S* src, int m0, int m_rows, int d) {
  for (int i = threadIdx.x; i < kRT * d; i += blockDim.x) {
    const int r = i / d, m = m0 + r;
    X[i] = m < m_rows ? to_f(src[(size_t)m * d + (i - r * d)]) : 0.f;
  }
}

// X += 0.5 (silu(LN(X) W1^T + b1) W2^T + b2) on the tile's 32 rows.
template <typename T>
__device__ void ffn_half(float* X, float* Y, float* H, float* WS,
                         const float* lnw, const float* lnb, const T* w1,
                         const float* b1, const T* w2, const float* b2,
                         int d, int dff) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();
  ln_rows<T, float>(X, lnw, lnb, 0, kRT, d, Y, nullptr, nullptr);
  float acc[kRows][4];
  for (int n0 = 0; n0 < dff; n0 += kNC) {
    tile_product<T, false>(acc, Y, d, w1, n0, dff, d, WS);
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + lane + 32 * j;
        if (c < dff)
          H[(warp * kRows + i) * dff + c] = rnd<T>(silu(acc[i][j] + b1[c]));
      }
  }
  for (int n0 = 0; n0 < d; n0 += kNC) {
    tile_product<T, false>(acc, H, dff, w2, n0, d, dff, WS);
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + lane + 32 * j;
        if (c < d) {
          float* x = X + (warp * kRows + i) * d + c;
          *x = *x + 0.5f * (acc[i][j] + b2[c]);
        }
      }
  }
  __syncthreads();
}

template <typename T>
__device__ void phase_a_rows(const LayerArgs& a, float* X, float* Y, float* H,
                             float* WS, int m0) {
  const int d = a.d, M = a.batch * a.t_len, dk = d / a.heads;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();
  load_rows(X, (const T*)a.x, m0, M, d);
  ffn_half<T>(X, Y, H, WS, a.s1, a.sb1, (const T*)a.w11, a.bb11,
              (const T*)a.w12, a.bb12, d, a.dff);
  for (int i = threadIdx.x; i < kRT * d; i += blockDim.x) {
    const int m = m0 + i / d;
    if (m < M) a.xs[(size_t)m0 * d + i] = X[i];
  }
  ln_rows<T, float>(X, a.sa, a.sab, 0, kRT, d, Y, nullptr, nullptr);
  float acc[kRows][4];
  // job 0: q_u and q_v from one product; 1: k; 2: v
  for (int job = 0; job < 3; ++job) {
    const T* w = (const T*)(job == 0 ? a.wq : job == 1 ? a.wk : a.wv);
    for (int n0 = 0; n0 < d; n0 += kNC) {
      tile_product<T, false>(acc, Y, d, w, n0, d, d, WS);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int m = m0 + warp * kRows + i;
        if (m >= M) continue;
        const int b = m / a.t_len, t = m - b * a.t_len;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = n0 + lane + 32 * j;
          if (c >= d) continue;
          const int hh = c / dk, dd = c - hh * dk;
          const size_t at = (((size_t)b * a.heads + hh) * a.t_len + t) * dk +
                            dd;
          const float v = acc[i][j];
          if (job == 0) {
            ((T*)a.qu)[at] = from_f<T>(v + a.cu[c]);
            ((T*)a.qv)[at] = from_f<T>(v + a.cv[c]);
          } else if (job == 1) {
            ((T*)a.k)[at] = from_f<T>(v + a.bk[c]);
          } else {
            ((T*)a.v)[at] = from_f<T>(v + a.bv[c]);
          }
        }
      }
    }
  }
}

// P rows p0 .. p0 + 31 = PE rows (rounded to T) Wpos^T, per head.
template <typename T>
__device__ void phase_a_pos(const LayerArgs& a, float* Y, float* WS, int p0) {
  const int d = a.d, n_pos = 2 * a.t_len - 1, dk = d / a.heads;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();
  for (int i = threadIdx.x; i < kRT * d; i += blockDim.x) {
    const int m = p0 + i / d;
    Y[i] = m < n_pos ? rnd<T>(a.pe[(size_t)p0 * d + i]) : 0.f;
  }
  float acc[kRows][4];
  for (int n0 = 0; n0 < d; n0 += kNC) {
    tile_product<T, false>(acc, Y, d, (const T*)a.wpos, n0, d, d, WS);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int m = p0 + warp * kRows + i;
      if (m >= n_pos) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + lane + 32 * j;
        if (c >= d) continue;
        const int hh = c / dk, dd = c - hh * dk;
        ((T*)a.p)[((size_t)hh * n_pos + m) * dk + dd] = from_f<T>(acc[i][j]);
      }
    }
  }
}

template <typename T>
__device__ void phase_c(const LayerArgs& a, float* X, float* Y, float* H,
                        float* WS, int m0) {
  const int d = a.d, M = a.batch * a.t_len;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();
  load_rows(Y, (const T*)a.ctx, m0, M, d);
  load_rows(X, a.xs, m0, M, d);
  float acc[kRows][4];
  for (int n0 = 0; n0 < d; n0 += kNC) {
    tile_product<T, false>(acc, Y, d, (const T*)a.wo, n0, d, d, WS);
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + lane + 32 * j;
        if (c < d) {
          float* x = X + (warp * kRows + i) * d + c;
          *x = *x + acc[i][j] + a.bo[c];
        }
      }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kRT * d; i += blockDim.x) {
    const int m = m0 + i / d;
    if (m < M) a.xs[(size_t)m0 * d + i] = X[i];
  }
  ln_rows<T, float>(X, a.sc, a.scb, 0, kRT, d, Y, nullptr, nullptr);
  const T* w1 = (const T*)a.w1;
  for (int n0 = 0; n0 < d; n0 += kNC) {
    tile_product<T, false>(acc, Y, d, w1, n0, d, d, WS);  // linear half
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + lane + 32 * j;
        if (c < d) H[(warp * kRows + i) * d + c] = acc[i][j] + a.b1[c];
      }
  }
  for (int n0 = 0; n0 < d; n0 += kNC) {
    tile_product<T, false>(acc, Y, d, w1 + (size_t)d * d, n0, d, d, WS);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = warp * kRows + i, m = m0 + row;
      if (m >= M) continue;
      const float keep = a.key_bias[m] > -0.5f ? 1.f : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + lane + 32 * j;
        if (c >= d) continue;
        a.glu[(size_t)m * d + c] =
            H[row * d + c] * sigmoid(acc[i][j] + a.b1[d + c]) * keep;
      }
    }
  }
}

template <typename T>
__device__ void phase_d(const LayerArgs& a, float* X, float* Y, float* H,
                        float* WS, int m0) {
  const int d = a.d, M = a.batch * a.t_len, k = a.ksize;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();
  // H holds glu rows m0 - pad_l .. m0 + 31 + k - 1 - pad_l
  const int g0 = m0 - a.pad_l;
  for (int i = threadIdx.x; i < (kRT + k - 1) * d; i += blockDim.x) {
    const int r = i / d, m = g0 + r;
    H[i] = (m >= 0 && m < M) ? a.glu[(size_t)m * d + (i - r * d)] : 0.f;
  }
  load_rows(X, a.xs, m0, M, d);
  __syncthreads();
  for (int i = threadIdx.x; i < kRT * d; i += blockDim.x) {
    const int r = i / d, c = i - r * d, m = m0 + r;
    const int t = m % a.t_len;
    float acc = 0.f;
    for (int j = 0; j < k; ++j) {
      const int tt = t + j - a.pad_l;
      if (tt >= 0 && tt < a.t_len) acc += H[(r + j) * d + c] * a.wd[j * d + c];
    }
    Y[i] = acc + a.bd[c];
  }
  __syncthreads();
  // norm -> SiLU, rounded to T: one warp per row
  for (int i = 0; i < kRows; ++i) {
    const int row = warp * kRows + i;
    float* y = Y + row * d;
    float mu = 0.f, r = 1.f;
    if (a.layer_norm) {
      float s = 0.f, s2 = 0.f;
      for (int c = lane; c < d; c += 32) {
        s += y[c];
        s2 += y[c] * y[c];
      }
      s = warp_sum(s);
      s2 = warp_sum(s2);
      mu = s / d;
      r = rsqrtf(s2 / d - mu * mu + 1e-6f);
    }
    for (int c = lane; c < d; c += 32) {
      const float h = a.layer_norm ? (y[c] - mu) * r * a.nw[c] + a.nb[c]
                                   : y[c] * a.nw[c] + a.nb[c];
      y[c] = rnd<T>(silu(h));
    }
  }
  float acc[kRows][4];
  for (int n0 = 0; n0 < d; n0 += kNC) {
    tile_product<T, false>(acc, Y, d, (const T*)a.w2c, n0, d, d, WS);
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + lane + 32 * j;
        if (c < d) {
          float* x = X + (warp * kRows + i) * d + c;
          *x = *x + acc[i][j] + a.b2c[c];
        }
      }
  }
  ffn_half<T>(X, Y, H, WS, a.s2, a.sb2, (const T*)a.w21, a.bb21,
              (const T*)a.w22, a.bb22, d, a.dff);
  ln_rows<T, float>(X, a.sf, a.sfb, 0, kRT, d, Y, nullptr, nullptr);
  __syncthreads();
  for (int i = threadIdx.x; i < kRT * d; i += blockDim.x) {
    const int m = m0 + i / d;
    if (m >= M) continue;
    ((T*)a.out)[(size_t)m0 * d + i] =
        from_f<T>(a.key_bias[m] > -0.5f ? Y[i] : 0.f);
  }
}

template <typename T>
__global__ void __launch_bounds__(256, 1) layer_kernel(LayerArgs a) {
  extern __shared__ float4 smem4[];
  float* X = reinterpret_cast<float*>(smem4);  // kRT x d: residual rows
  float* Y = X + kRT * a.d;                    // kRT x d: operand rows
  float* H = Y + kRT * a.d;                    // h_floats
  float* WS = H + h_floats(a.d, a.dff, a.ksize);  // kKC x kWS
  const int M = a.batch * a.t_len, n_pos = 2 * a.t_len - 1;
  const int row_tiles = (M + kRT - 1) / kRT;
  const int pos_tiles = (n_pos + kRT - 1) / kRT;

  for (int i = blockIdx.x; i < row_tiles + pos_tiles; i += gridDim.x) {
    if (i < row_tiles)
      phase_a_rows<T>(a, X, Y, H, WS, i * kRT);
    else
      phase_a_pos<T>(a, Y, WS, (i - row_tiles) * kRT);
  }
  grid_barrier(a.bar);

  const int dk = a.d / a.heads, q_tiles = (a.t_len + kBQ - 1) / kBQ;
  const HeadLayout cl = {(long long)a.t_len * a.d, dk, a.d};
  for (int i = blockIdx.x; i < a.batch * a.heads * q_tiles; i += gridDim.x) {
    const int bh = i / q_tiles;
    core_tile<T>(X, (const T*)a.qu, (const T*)a.qv, (const T*)a.k,
                 (const T*)a.v, (const T*)a.p, a.key_bias, (T*)a.ctx, cl,
                 nullptr, bh, (i - bh * q_tiles) * kBQ, a.t_len, a.heads, dk,
                 1.f / sqrtf((float)dk), 0u, 0u, 1.f, 0, a.left, a.right);
  }
  grid_barrier(a.bar);

  for (int i = blockIdx.x; i < row_tiles; i += gridDim.x)
    phase_c<T>(a, X, Y, H, WS, i * kRT);
  grid_barrier(a.bar);

  for (int i = blockIdx.x; i < row_tiles; i += gridDim.x)
    phase_d<T>(a, X, Y, H, WS, i * kRT);
}

template <typename T>
int run_layer(const LayerArgs& a, cudaStream_t stream) {
  const size_t smem = layer_smem(a.d, a.dff, a.ksize, a.d / a.heads);
  cudaError_t err = cudaFuncSetAttribute(
      layer_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, layer_kernel<T>, 256, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  LayerArgs args = a;
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel((const void*)layer_kernel<T>,
                                    dim3(sms * per_sm), dim3(256), params,
                                    smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// The wrapper guarantees: contiguous tensors on one device; x, out, the
// weight matrices (PyTorch Linear layout) and the scratch q_u, q_v, k, v
// (B, H, T, dk), p (H, 2T-1, dk) and ctx (B, T, D) in one dtype (fp32 or
// bf16); pe (2T-1, D), key_bias (B, T), every vector, wd (k, D), xs and glu
// (B T, D) in fp32; bar two zeroed uint32; D = H dk, dk <= 64; layer_smem
// <= 227 KB. `ptrs` holds the n_ptrs = 49 pointers in LayerArgs order.
extern "C" int tat_conformer_layer(int bf16, void** ptrs, int n_ptrs,
                                   int batch, int t_len, int d, int heads,
                                   int dff, int ksize, int pad_l,
                                   int layer_norm, int left, int right,
                                   void* stream) {
  static_assert(offsetof(LayerArgs, batch) % sizeof(void*) == 0,
                "LayerArgs: pointers first");
  constexpr int kPtrs = (int)(offsetof(LayerArgs, batch) / sizeof(void*));
  if (n_ptrs != kPtrs) return (int)cudaErrorInvalidValue;
  LayerArgs a;
  memcpy(&a, ptrs, sizeof(void*) * kPtrs);
  a.batch = batch;
  a.t_len = t_len;
  a.d = d;
  a.heads = heads;
  a.dff = dff;
  a.ksize = ksize;
  a.pad_l = pad_l;
  a.layer_norm = layer_norm;
  a.left = left;
  a.right = right;
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? run_layer<__nv_bfloat16>(a, s) : run_layer<float>(a, s);
}
