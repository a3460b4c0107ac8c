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
// The bound on an H100: at B=32, T'=376 (M = 12,032 rows), D=176, 4 heads,
// d_ff 704, k=31 one layer is 22.1 GFLOP (FFN halves 11.9, q/k/v/o 3.0,
// scores and values 4.8, pointwise 2.2, the depthwise taps 0.13, P = PE
// Wpos^T 0.05) against 8.5 MB of bf16 x in and out, the mask and 1.4 MB of
// weights: 0.022 ms at the bf16 tensor rate, 0.003 ms of bytes, so
// operations, if the intermediates stay on chip.
//
// What bounded the SIMT kernel (layer_kernel, the first port; 4.92 ms of
// device time in bf16 at that shape on an NVIDIA H100 80GB HBM3 at 700 W,
// 4.5 TFLOP/s): every product is rowtile.cuh's tile_product, plain fp32
// FMAs on weights staged 32 deep through shared memory with a block barrier
// a chunk; its fp32 row tiles and (32, d_ff) hidden tile take 151,680 B at
// D=176, one 8-warp block an SM; its attention phase is the SIMT core_tile.
//
// bf16 (layer_mma_kernel, below): every product on mma.sync.m16n8k16 (bf16
// operands, fp32 sums) in 128-thread blocks, two an SM at D=176:
//   - rows: a block takes 64 frames of one batch row, a warp 16 of them
//     with every column, so a warp's LayerNorms and epilogues need no
//     block barrier: the LayerNorm statistics come from the accumulators (a
//     quad shuffle) and its output is rounded to bf16 into the warp's rows
//     of the A tile, read back by ldmatrix. The residual stream stays fp32
//     in a workspace each thread reads and writes at its own accumulator
//     positions.
//   - B operands: the wrapper stores each matrix once per weight version
//     in mma fragment order, k-step-major, so one k-step of a product is
//     one contiguous piece; a ring of 6 slots in shared memory (`Stream`)
//     brings the pieces in by cp.async for the block's 4 warps, 5 pieces
//     ahead and across the products of a tile, and a warp reads a fragment
//     as 8 bytes a lane. Reading B straight from L2 in each warp (conv.cu's
//     way) was slower here: 4 warps each fetch every weight, one k-step
//     ahead, in registers that spilled (PERF.md has the numbers).
//   - FFN halves: d_ff in chunks of 64; a chunk's hidden values (16 x 64 a
//     warp) get b1 and SiLU, are rounded to bf16 in registers and are the
//     A fragments of the second product, o += h W2[:, chunk]^T, so no
//     (rows, d_ff) tile exists anywhere. W1 is stored chunk by chunk, two
//     k-steps a stage.
//   - attention: core_mma.cuh's core_mma_tile, the tensor-core core of the
//     block sublayer, per (batch row, head, 64 queries); q_u, q_v, k, v, P
//     and the context pass through the workspace in bf16, in its layouts.
//   - conv module: pointwise 1 with W1's rows interleaved by 8 channels
//     (linear, then gate), GLU x mask in the epilogue; the depthwise taps in
//     fp32 SIMT, a thread per (channel, 16 frames) with the taps in
//     registers (k <= 33), reading the GLU rows and their halo from the
//     workspace; the norm, SiLU, rounded to bf16 into pointwise 2's A tile.
// Phases, three grid barriers (the attention needs every head's q, k, v
// and P, the context every head, the depthwise its neighbours' GLU rows):
//   A: key bias from the mask; FFN1, x1, LN, q_u/q_v/k/v; P.
//   B: the attention core.
//   C: W_o + bo + x1 -> x2, LN, pointwise 1, GLU x mask.
//   D: depthwise, norm, SiLU, pointwise 2 + b2c + x2 -> x3, FFN2, final LN
//      x mask -> out.
// Shared memory at D=176: the A tile (23,552 B), the ring (33,792 B) and
// the fp32 depthwise tile (45,056 B), 102,400 B; the attention core's
// 93,184 B live in the same bytes. 227 registers, no spill.
// Shapes: D % 8 == 0, D <= 176 (accumulators of a warp's 16 rows x D),
// dk % 4 == 0 with 32 < dk <= 48 (the core's DKP 48 template), k <= 33;
// the wrapper sends other bf16 shapes to layer_kernel<bf16>
// (ops/cuda_layer.py::layer_route).
// What bounds it now (tpu_asr_torch/layer_ablation.py on an NVIDIA H100
// 80GB HBM3): not the tensor cores (without the products' instructions it
// runs 6% faster) but each warp's
// serial work between them: B fragments read from shared memory once per
// 16 rows, the stage barriers, the LayerNorms and epilogues, with only 8
// warps an SM; and the 192 row tiles of the serve shape on 132 SMs.
//
// SIMT (layer_kernel<T>, the check dtype fp32 and those bf16 shapes): one
// cooperative launch of as many 256-thread blocks as fit on the card walks
// tiles in grid-stride loops, in the same four phases:
//   A, per 32 rows: key bias, FFN1 -> LN -> q_u = q + (bq + u),
//      q_v = q + (bq + v), k, v per head (B, H, T, dk) in the working type;
//      and, per 32 rows of the (2T - 1, D) position table, P = PE Wpos^T
//      (H, 2T-1, dk).
//   B, per (batch row, head, 32 queries): attention_core.cuh's core_tile:
//      scores, key bias, window, softmax, value product -> context (B, T, D)
//      in the working type.
//   C, per 32 rows: context Wo^T + bo + x1 -> x2 (fp32, in place of x1);
//      LN -> pointwise 1 (two halves) -> GLU x row mask -> glu (fp32).
//   D, per 32 rows: the depthwise taps read the tile's rows and k - 1 halo
//      rows of glu (frames outside [0, T) read zero) -> + bd -> folded-BN
//      affine or LN -> SiLU -> pointwise 2 + b2c + x2 -> FFN2 -> final LN
//      x row mask -> out.
// Products are rowtile.cuh's tile_product (plain SIMT, fp32 accumulation)
// with operands in the working type.
//
// Both: the intermediates live in one workspace the wrapper allocates
// (`Workspace`): x1/x2 and glu in fp32 (the TPU kernel keeps the residual
// stream in fp32), q_u, q_v, k, v, P and the context in the working type;
// about 40 MB at B=32 in bf16, most of it in the 50 MB L2. Operands are
// rounded where the TPU kernel rounds them to bf16 (LN outputs, the SiLU
// outputs, q/k/v, P, the attention weights and the context); everything
// else stays fp32. The grid barrier is a counter in the workspace, zeroed
// before the launch: under a cooperative launch every block is resident,
// so spinning on it cannot deadlock. No sum uses atomics: two calls are
// bit-equal.

#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include "attention_core.cuh"
#include "core_mma.cuh"
#include "rowtile.cuh"

namespace {

// The workspace, in this order, each piece 256-byte aligned (es: bytes of
// the working type): the barrier's 2 counters, key_bias (B T) fp32, xs and
// glu (B T, D) fp32, q_u, q_v, k, v (B, H, T, dk), ctx (B, T, D) and P
// (H, 2T - 1, dk) in the working type. ops/cuda_layer.py::workspace_bytes
// is the same sum.
struct Workspace {
  size_t bar, key_bias, xs, glu, qu, qv, k, v, ctx, p, total;
};

Workspace workspace(size_t es, int batch, int t_len, int d) {
  auto up = [](size_t n) { return (n + 255) / 256 * 256; };
  const size_t m = (size_t)batch * t_len, md = m * d;
  Workspace w;
  size_t o = 0;
  auto take = [&](size_t& at, size_t n) {
    at = o;
    o += up(n);
  };
  take(w.bar, 8);
  take(w.key_bias, 4 * m);
  take(w.xs, 4 * md);
  take(w.glu, 4 * md);
  take(w.qu, es * md);
  take(w.qv, es * md);
  take(w.k, es * md);
  take(w.v, es * md);
  take(w.ctx, es * md);
  take(w.p, es * (size_t)(2 * t_len - 1) * d);
  w.total = o;
  return w;
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

// ---------------------------------------------------------------------------
// SIMT: layer_kernel<T>
// ---------------------------------------------------------------------------

struct LayerArgs {
  // weights: 36 pointers in ops/cuda_layer.py::_SIMT_KEYS order
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
  // the call
  const void* x;          // (B, T, D) in T
  void* out;              // (B, T, D) in T
  const uint8_t* mask;    // (B, T) 0/1
  const float* pe;        // (2T - 1, D) relative sinusoid table
  float* key_bias;        // (B, T): 0 valid, -1e30 padded (phase A)
  float* xs;              // (B T, D) fp32: x1, then x2
  float* glu;             // (B T, D) fp32
  void *qu, *qv, *k, *v;  // (B, H, T, dk) in T
  void* p;                // (H, 2T - 1, dk) in T
  void* ctx;              // (B, T, D) in T
  unsigned int* bar;      // 2 counters, zero before the launch
  int batch, t_len, d, heads, dff, ksize, pad_l, layer_norm, left, right;
};
constexpr int kSimtWeights = 36;
static_assert(offsetof(LayerArgs, x) == kSimtWeights * sizeof(void*),
              "LayerArgs: the weights first");

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
  for (int i = threadIdx.x; i < kRT && m0 + i < M; i += blockDim.x)
    a.key_bias[m0 + i] = a.mask[m0 + i] ? 0.f : -1e30f;
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

// The SMs of the current device and the blocks an SM of `kernel` with
// `smem` bytes of dynamic shared memory (at least 1), after allowing that
// much; looked up again only when the kernel, device or smem differs from
// the last call's, since the launch path asks on every call.
template <class Kernel>
cudaError_t occupancy(Kernel kernel, int threads, size_t smem, int* sms,
                      int* per_sm) {
  static const void* kernel_seen = nullptr;
  static int dev_seen = -1, sms_seen = 0, per_sm_seen = 0;
  static size_t smem_seen = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if ((const void*)kernel != kernel_seen || dev != dev_seen ||
      smem != smem_seen) {
    if ((err = cudaFuncSetAttribute(
             kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             (int)smem)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms_seen,
                                      cudaDevAttrMultiProcessorCount, dev)) !=
            cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm_seen, kernel, threads, smem)) != cudaSuccess)
      return err;
    if (per_sm_seen < 1) return cudaErrorInvalidConfiguration;
    kernel_seen = (const void*)kernel;
    dev_seen = dev;
    smem_seen = smem;
  }
  *sms = sms_seen;
  *per_sm = per_sm_seen;
  return cudaSuccess;
}

template <typename T>
int run_layer(const LayerArgs& a, int* blocks, cudaStream_t stream) {
  const size_t smem = layer_smem(a.d, a.dff, a.ksize, a.d / a.heads);
  int sms = 0, per_sm = 0;
  cudaError_t err = occupancy(layer_kernel<T>, 256, smem, &sms, &per_sm);
  if (err != cudaSuccess) return (int)err;
  if (blocks) {  // occupancy query only
    *blocks = per_sm;
    return 0;
  }
  LayerArgs args = a;
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel((const void*)layer_kernel<T>,
                                    dim3(sms * per_sm), dim3(256), params,
                                    smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bf16 on the tensor cores: layer_mma_kernel
// ---------------------------------------------------------------------------

constexpr int kLT = kMQ;         // rows a tile: 4 warps x 16 (the core's)
constexpr int kLThreads = 128;
constexpr int kFC = 64;          // d_ff chunk: 8 n8 tiles of W1, 4 k-steps
constexpr int kTaps = 33;        // depthwise taps held in registers
constexpr int kStages = 6;       // slots of the B ring

__host__ __device__ __forceinline__ int pad8(int n) { return (n + 7) / 8 * 8; }
__host__ __device__ __forceinline__ int pad16(int n) {
  return (n + 15) / 16 * 16;
}
__host__ __device__ __forceinline__ int pad64(int n) {
  return (n + 63) / 64 * 64;
}
// Row stride (bf16 values) of the A tile: pad16(d) + 8, an odd number of
// 16-byte units, so the 8 rows an ldmatrix reads fall in distinct banks.
__host__ __device__ __forceinline__ int a_stride(int d) {
  return pad16(d) + 8;
}
// A slot of the B ring: the widest stage, NT tiles of 256 bytes (or the
// FFN's 16).
template <int NT>
__host__ __device__ __forceinline__ int slot_bytes() {
  return 256 * (NT > 16 ? NT : 16);
}
// Shared memory of the row phases: the A tile, the B ring and the fp32
// depthwise tile, in that order.
template <int NT>
__host__ __device__ __forceinline__ size_t rows_smem(int d) {
  return sizeof(bf16) * kLT * a_stride(d) + kStages * slot_bytes<NT>() +
         sizeof(float) * kLT * d;
}
template <int NT, int DKP>
size_t mma_smem(int d) {
  const size_t rows = rows_smem<NT>(d), core = CoreMma<DKP>::kSmem;
  return rows > core ? rows : core;
}

struct MmaArgs {
  // weights: 34 pointers in ops/cuda_layer.py::_MMA_KEYS order; the
  // matrices fragment-packed (below), d_ff padded to a multiple of 64
  const float *s1, *sb1;
  const uint2* w11;       // (F, D)
  const float* b11;       // (pad64(F)), zero past F
  const uint2* w12;       // (D, F)
  const float* b12;
  const float *sa, *sab;
  const uint2 *wqkv, *wpos, *wo;  // Wq, Wk, Wv stacked; (D, D) each
  const float *cu, *cv, *bk, *bv, *bo;
  const float *sc, *scb;
  const uint2* w1;        // (2 pad8(D), D): rows interleaved by 8 channels
  const float* b1;        // (2D): linear, then gate
  const float *wd, *bd;   // (k, D) fp32, (D)
  const float *nw, *nb;
  const uint2* w2c;
  const float* b2c;
  const float *s2, *sb2;
  const uint2* w21;
  const float* b21;       // padded as b11
  const uint2* w22;
  const float* b22;
  const float *sf, *sfb;
  // the call
  const bf16* x;
  bf16* out;
  const uint8_t* mask;
  const float* pe;
  float *key_bias, *xs, *glu;
  bf16 *qu, *qv, *k, *v, *ctx, *p;
  unsigned int* bar;
  int batch, t_len, d, heads, dff, ksize, pad_l, layer_norm, left, right;
};
constexpr int kMmaWeights = 34;
static_assert(offsetof(MmaArgs, x) == kMmaWeights * sizeof(void*),
              "MmaArgs: the weights first");

// SiLU and the sigmoid with the fast exponential and division: the results
// are rounded to bf16 (SiLU) or enter the fp32 GLU product (sigmoid), far
// below the bf16 rounding of the operands around them.
__device__ __forceinline__ float fast_silu(float h) {
  return __fdividef(h, 1.f + __expf(-h));
}
__device__ __forceinline__ float fast_sigmoid(float h) {
  return __fdividef(1.f, 1.f + __expf(-h));
}

// Fragment-packed weights. A matrix W (N, K), the B operand of C = A W^T,
// is stored zero-padded to (pad8(N), pad16(K)) as tiles of 8 rows and 16
// columns in k-step-major order (tile (j, s) at s * N/8 + j), each 32 uint2:
// lane 4 g + t of tile (j, s) holds W[8 j + g][16 s + 2 t, + 1] in .x and
// W[8 j + g][16 s + 2 t + 8, + 9] in .y, its m16n8k16 B fragment. The
// tiles of one k-step are contiguous, and a warp reads a fragment as 256
// contiguous bytes (ops/cuda_layer.py::frag_pack).

// One stage of B: `tiles` fragment tiles (256 bytes each) from src.
struct Piece {
  const uint2* src;
  int tiles;
};

// The order of a phase's stages, computed as they are issued with no
// division (every thread of the block walks it):
// Rows: `reps` products of ks k-steps each, a stage a k-step; product p
// takes tiles j0 + p jstep .. of each k-step (nj of them, none from n_valid
// on) of a fragment-packed matrix with n_tiles tiles a k-step.
struct Rows {
  const uint2* w;
  int n_tiles, j0, nj, jstep, n_valid, ks, reps;
  int p = 0, s = 0;
  __device__ bool done() const { return p >= reps; }
  __device__ Piece next() {
    const int j = j0 + p * jstep;
    const Piece pc{w + ((size_t)s * n_tiles + j) * 32, min(nj, n_valid - j)};
    if (++s == ks) {
      s = 0;
      ++p;
    }
    return pc;
  }
};

// Ffn: an FFN half's nc chunks of 64 hidden units. W1 is stored
// chunk-major (ops/cuda_layer.py::frag_pack_chunks): chunk c is its own
// fragment-packed (64, pad16(D)) matrix of ksd k-steps of 8 tiles, so two
// k-steps are one contiguous stage. A chunk is W1's (ksd + 1) / 2 stages of
// two k-steps (the last of one when ksd is odd), then W2's k-steps 4c ..
// 4c + 3 of its nd tiles, a stage each.
struct Ffn {
  const uint2 *w1, *w2;
  int ksd, nd, nc;
  int c = 0, r = 0;
  __device__ bool done() const { return c >= nc; }
  __device__ Piece next() {
    const int p1 = (ksd + 1) >> 1;
    const Piece pc =
        r < p1 ? Piece{w1 + ((size_t)c * ksd + 2 * r) * 8 * 32,
                       ksd - 2 * r > 1 ? 16 : 8}
               : Piece{w2 + (size_t)(4 * c + r - p1) * nd * 32, nd};
    if (++r == p1 + 4) {
      r = 0;
      ++c;
    }
    return pc;
  }
};

// First's stages, then second's; then empty stages.
template <class A, class B>
struct Then {
  A first;
  B second;
  __device__ Piece next() {
    return !first.done()    ? first.next()
           : !second.done() ? second.next()
                            : Piece{nullptr, 0};
  }
};

// The B operands of a block's products, streamed through a ring of
// kStages slots of shared memory by cp.async, shared by the block's 4 warps:
// a stage lands while the products of the kStages - 2 stages before it run.
// Every thread of the block calls next() for each stage, in plan order; the
// barrier in next() also frees the slot the copy issued there refills.
template <class Plan>
struct Stream {
  char* ring;
  int slot;  // bytes a slot
  Plan plan;
  int in, out;  // the slots of the next copy and of the next stage read
  __device__ Stream(char* ring_, int slot_, Plan plan_)
      : ring(ring_), slot(slot_), plan(plan_), in(0), out(0) {
    for (int s = 0; s < kStages - 1; ++s) issue();
  }
  __device__ void issue() {
    const Piece pc = plan.next();
    char* dst = ring + in * slot;
    const char* src = reinterpret_cast<const char*>(pc.src);
    for (int o = 16 * threadIdx.x; o < 256 * pc.tiles; o += 16 * kLThreads)
      cp_async16(dst + o, src + o, true);
    cp_async_commit();
    in = in + 1 == kStages ? 0 : in + 1;
  }
  // This lane's fragment of tile 0 of the next stage (tile j at + 32 j).
  __device__ const uint2* next() {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const uint2* b = reinterpret_cast<const uint2*>(ring + out * slot);
    out = out + 1 == kStages ? 0 : out + 1;
    issue();
    return b + threadIdx.x % 32;
  }
  // Every copy landed and every warp is past its last stage.
  __device__ void finish() {
    cp_async_wait<0>();
    __syncthreads();
  }
};

template <class Plan>
__device__ __forceinline__ Stream<Plan> stream(char* ring, int slot,
                                               Plan plan) {
  return Stream<Plan>(ring, slot, plan);
}

// acc[j] += A W^T for this warp's 16 rows of the A tile `a` (row stride sa)
// over ks k-steps, tile j of each the stream's next stage. All NT tiles are
// multiplied, with no branch in the loop: tiles from the stage's count on
// read what the slot holds (a slot has room for NT) into accumulators whose
// columns lie at or past D, which every epilogue and LayerNorm skips or
// zeroes.
template <int NT, class S>
__device__ __forceinline__ void tile_mma(float (&acc)[NT][4], const bf16* a,
                                         int sa, S& st, int ks) {
  const int lane = threadIdx.x % 32;
  const bf16* al = a + (lane % 16) * sa + (lane / 16) * 8;
  for (int s = 0; s < ks; ++s) {
    const uint2* b = st.next();
    uint32_t af[4];
    ldmatrix_x4(af, al + 16 * s);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const uint2 f = b[32 * j];
      mma_bf16(acc[j], af, f.x, f.y);
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// o = silu(A W1^T + b1) W2^T for this warp's 16 rows, d_ff in chunks of
// 64 (the stream's stages in Ffn's order): a chunk's hidden values,
// rounded to bf16 in registers, are the A fragments of the second product
// (the m16n8 accumulators of two n8 tiles are one m16n8k16 A fragment), so
// no (rows, d_ff) tile exists. ksd: k-steps of W1 (pad16(D) / 16), fp: d_ff
// padded to 64, nd: n8 tiles of W2's rows.
template <int NT, class S>
__device__ __forceinline__ void ffn_mma(float (&o)[NT][4], const bf16* a,
                                        int sa, S& st,
                                        const float* __restrict__ b1,
                                        int ksd, int fp, int nd) {
  const int lane = threadIdx.x % 32, t = lane % 4;
  const bf16* al = a + (lane % 16) * sa + (lane / 16) * 8;
  zero(o);
  for (int c = 0; c < fp / kFC; ++c) {
    float h[8][4];
    zero(h);
    const uint2* b = nullptr;
    for (int s = 0; s < ksd; ++s) {
      if (!(s & 1)) b = st.next();
      const uint2* bs = b + (s & 1) * 8 * 32;
      uint32_t af[4];
      ldmatrix_x4(af, al + 16 * s);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint2 f = bs[32 * j];
        mma_bf16(h[j], af, f.x, f.y);
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t hf[4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = 2 * q + u;
        const float2 bb =
            __ldg(reinterpret_cast<const float2*>(b1 + kFC * c + 8 * j +
                                                  2 * t));
        hf[2 * u] = pack_bf16(fast_silu(h[j][0] + bb.x),
                              fast_silu(h[j][1] + bb.y));
        hf[2 * u + 1] = pack_bf16(fast_silu(h[j][2] + bb.x),
                                  fast_silu(h[j][3] + bb.y));
      }
      const uint2* b = st.next();
#pragma unroll
      for (int j = 0; j < NT; ++j) {  // past nd: as in tile_mma
        const uint2 f = b[32 * j];
        mma_bf16(o[j], hf, f.x, f.y);
      }
    }
  }
}

// Mean and 1 / std of rows g and g + 8 of this warp's 16 from their values
// in accumulator layout (columns < d): flax's E[x^2] - E[x]^2, eps 1e-6.
template <int NT>
__device__ __forceinline__ void acc_stats(const float (&v)[NT][4], int d,
                                          float (&mu)[2], float (&rs)[2]) {
  const int t = threadIdx.x % 4;
  float s[2] = {0.f, 0.f}, q[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (8 * j + 2 * t + (e & 1) < d) {
        s[e >> 1] += v[j][e];
        q[e >> 1] += v[j][e] * v[j][e];
      }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      s[h] += __shfl_xor_sync(0xffffffffu, s[h], o);
      q[h] += __shfl_xor_sync(0xffffffffu, q[h], o);
    }
    mu[h] = s[h] / d;
    rs[h] = rsqrtf(q[h] / d - mu[h] * mu[h] + 1e-6f);
  }
}

// LN(v) lw + lb rounded to bf16 into this warp's rows `a` of the A tile,
// zero in columns d .. pad16(d) - 1.
template <int NT>
__device__ __forceinline__ void acc_ln_to_tile(const float (&v)[NT][4],
                                               const float* __restrict__ lw,
                                               const float* __restrict__ lb,
                                               int d, bf16* a, int sa) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  float mu[2], rs[2];
  acc_stats(v, d, mu, rs);
  __syncwarp();  // this warp's reads of its rows are done
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = 8 * j + 2 * t;
    if (col >= pad16(d)) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float y0 = 0.f, y1 = 0.f;
      if (col < d) {
        y0 = (v[j][2 * h] - mu[h]) * rs[h] * lw[col] + lb[col];
        y1 = (v[j][2 * h + 1] - mu[h]) * rs[h] * lw[col + 1] + lb[col + 1];
      }
      *reinterpret_cast<uint32_t*>(a + (g + 8 * h) * sa + col) =
          pack_bf16(y0, y1);
    }
  }
  __syncwarp();
}

// LN of rows t_first .. t_first + 15 of one batch row of x (bf16, row
// stride d <= 8 NT; zero rows from t_len on), rounded to bf16 into this
// warp's rows of the A tile: the 16 rows' loads first, then a row at a
// time, the lanes on column pairs.
template <int NT>
__device__ __forceinline__ void x_ln_to_tile(const bf16* __restrict__ xb,
                                             int t_first, int t_len, int d,
                                             const float* __restrict__ lw,
                                             const float* __restrict__ lb,
                                             bf16* a, int sa) {
  constexpr int kP = (8 * NT + 63) / 64;  // column pairs a lane holds
  const int lane = threadIdx.x % 32, dp = pad16(d);
  __nv_bfloat162 v[16][kP];
#pragma unroll
  for (int r = 0; r < 16; ++r)
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      const int c = 2 * lane + 64 * p;
      v[r][p] = t_first + r < t_len && c < d
                    ? *reinterpret_cast<const __nv_bfloat162*>(
                          xb + (size_t)(t_first + r) * d + c)
                    : __floats2bfloat162_rn(0.f, 0.f);
    }
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    float s = 0.f, q = 0.f;
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      const float2 f = __bfloat1622float2(v[r][p]);
      s += f.x + f.y;
      q += f.x * f.x + f.y * f.y;
    }
    s = warp_sum(s);
    q = warp_sum(q);
    const float mu = s / d, rs = rsqrtf(q / d - mu * mu + 1e-6f);
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      const int c = 2 * lane + 64 * p;
      if (c >= dp) continue;
      float y0 = 0.f, y1 = 0.f;
      if (c < d) {
        const float2 f = __bfloat1622float2(v[r][p]);
        y0 = (f.x - mu) * rs * lw[c] + lb[c];
        y1 = (f.y - mu) * rs * lw[c + 1] + lb[c + 1];
      }
      *reinterpret_cast<uint32_t*>(a + r * sa + c) = pack_bf16(y0, y1);
    }
  }
  __syncwarp();
}

// The rows of a tile: (batch row b, frames t0 .. t0 + 63); a warp's
// accumulator rows are t0 + 16 warp + g (h = 0) and + 8 (h = 1).
struct RowTile {
  int b, t0;
  __device__ int frame(int h) const {
    return t0 + 16 * (threadIdx.x / 32) + (threadIdx.x % 32) / 4 + 8 * h;
  }
};

// Phase A, a row tile: key bias; x1 = x + 0.5 FFN1(LN(x)) -> xs; LN(x1)
// -> q_u, q_v, k, v per head.
template <int NT>
__device__ void mma_phase_a_rows(const MmaArgs& a, bf16* aw, int sa,
                                 char* ring, RowTile rt) {
  const int d = a.d, T = a.t_len, H = a.heads, dk = d / H;
  const int ksd = pad16(d) / 16, nd = pad8(d) / 8, t = threadIdx.x % 4;
  const int fp = pad64(a.dff);
  const size_t row0 = (size_t)rt.b * T;
  auto st = stream(
      ring, slot_bytes<NT>(),
      Then<Ffn, Rows>{Ffn{a.w11, a.w12, ksd, nd, fp / kFC},
                      Rows{a.wqkv, 3 * nd, 0, nd, nd, 3 * nd, ksd, 3}});
  for (int i = threadIdx.x; i < kLT && rt.t0 + i < T; i += blockDim.x)
    a.key_bias[row0 + rt.t0 + i] = a.mask[row0 + rt.t0 + i] ? 0.f : -1e30f;
  const bf16* xb = a.x + row0 * d;
  x_ln_to_tile<NT>(xb, rt.t0 + 16 * (threadIdx.x / 32), T, d, a.s1, a.sb1,
                   aw, sa);
  float o[NT][4];
  ffn_mma<NT>(o, aw, sa, st, a.b11, ksd, fp, nd);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = 8 * j + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int tt = rt.frame(h);
      float2 x1 = make_float2(0.f, 0.f);
      if (col < d && tt < T) {
        const float2 x0 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(xb + (size_t)tt * d +
                                                     col));
        x1.x = x0.x + 0.5f * (o[j][2 * h] + a.b12[col]);
        x1.y = x0.y + 0.5f * (o[j][2 * h + 1] + a.b12[col + 1]);
        *reinterpret_cast<float2*>(a.xs + (row0 + tt) * d + col) = x1;
      }
      o[j][2 * h] = x1.x;
      o[j][2 * h + 1] = x1.y;
    }
  }
  acc_ln_to_tile(o, a.sa, a.sab, d, aw, sa);
  // job 0: q_u and q_v from one product; 1: k; 2: v
  for (int job = 0; job < 3; ++job) {
    zero(o);
    tile_mma<NT>(o, aw, sa, st, ksd);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = 8 * j + 2 * t;
      if (col >= d) continue;
      const int hh = col / dk, dd = col - hh * dk;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int tt = rt.frame(h);
        if (tt >= T) continue;
        const size_t at = (((size_t)rt.b * H + hh) * T + tt) * dk + dd;
        const float v0 = o[j][2 * h], v1 = o[j][2 * h + 1];
        auto put = [&](bf16* dst, const float* bias) {
          *reinterpret_cast<uint32_t*>(dst + at) =
              pack_bf16(v0 + bias[col], v1 + bias[col + 1]);
        };
        if (job == 0) {
          put(a.qu, a.cu);
          put(a.qv, a.cv);
        } else {
          put(job == 1 ? a.k : a.v, job == 1 ? a.bk : a.bv);
        }
      }
    }
  }
  st.finish();
}

// Phase A, a position tile: P rows p0 .. p0 + 63 = bf16(PE rows) Wpos^T,
// per head (H, 2T - 1, dk).
template <int NT>
__device__ void mma_phase_a_pos(const MmaArgs& a, bf16* aw, int sa,
                                char* ring, int p0) {
  const int d = a.d, dp = pad16(d), n_pos = 2 * a.t_len - 1;
  const int dk = d / a.heads, lane = threadIdx.x % 32, t = lane % 4;
  const int r0 = p0 + 16 * (threadIdx.x / 32);
  const int ksd = dp / 16, nd = pad8(d) / 8;
  auto st = stream(ring, slot_bytes<NT>(),
                   Rows{a.wpos, nd, 0, nd, 0, nd, ksd, 1});
  for (int r = 0; r < 16; ++r) {
    const int row = r0 + r;
    for (int c = 2 * lane; c < dp; c += 64) {
      float2 v = make_float2(0.f, 0.f);
      if (row < n_pos && c < d)
        v = *reinterpret_cast<const float2*>(a.pe + (size_t)row * d + c);
      *reinterpret_cast<uint32_t*>(aw + r * sa + c) = pack_bf16(v.x, v.y);
    }
  }
  __syncwarp();
  float acc[NT][4];
  zero(acc);
  tile_mma<NT>(acc, aw, sa, st, ksd);
  st.finish();
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = 8 * j + 2 * t;
    if (col >= d) continue;
    const int hh = col / dk, dd = col - hh * dk;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + lane / 4 + 8 * h;
      if (row < n_pos)
        *reinterpret_cast<uint32_t*>(a.p + ((size_t)hh * n_pos + row) * dk +
                                     dd) =
            pack_bf16(acc[j][2 * h], acc[j][2 * h + 1]);
    }
  }
}

// v += the fp32 rows of xs at this thread's accumulator positions (+ bias
// when not null), stored back to xs; zero outside the tile's valid frames.
template <int NT>
__device__ __forceinline__ void residual(float (&v)[NT][4], float* xs,
                                         const float* __restrict__ bias,
                                         int d, int t_len, size_t row0,
                                         RowTile rt) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = 8 * j + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int tt = rt.frame(h);
      float2 r = make_float2(0.f, 0.f);
      if (col < d && tt < t_len) {
        float2* at = reinterpret_cast<float2*>(xs + (row0 + tt) * d + col);
        r = __ldcg(at);
        r.x += v[j][2 * h] + bias[col];
        r.y += v[j][2 * h + 1] + bias[col + 1];
        *at = r;
      }
      v[j][2 * h] = r.x;
      v[j][2 * h + 1] = r.y;
    }
  }
}

// Phase C, a row tile: x2 = x1 + ctx Wo^T + bo -> xs; LN(x2) -> pointwise
// 1 -> GLU x mask -> glu.
template <int NT>
__device__ void mma_phase_c(const MmaArgs& a, bf16* aw, int sa, char* ring,
                            RowTile rt) {
  const int d = a.d, T = a.t_len, dp = pad16(d);
  const int ksd = dp / 16, nd = pad8(d) / 8, lane = threadIdx.x % 32;
  const int t = lane % 4;
  // W_o, then pointwise 1 in passes of NT tiles
  auto st = stream(
      ring, slot_bytes<NT>(),
      Then<Rows, Rows>{Rows{a.wo, nd, 0, nd, 0, nd, ksd, 1},
                       Rows{a.w1, 2 * nd, 0, NT, NT, 2 * nd, ksd,
                            (2 * nd + NT - 1) / NT}});
  const size_t row0 = (size_t)rt.b * T;
  const int w0 = rt.t0 + 16 * (threadIdx.x / 32);
  // the context rows of this warp, 16-byte pieces (d % 8 == 0)
  for (int i = lane; i < 16 * (dp / 8); i += 32) {
    const int r = i / (dp / 8), c = (i - r * (dp / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (w0 + r < T && c < d)
      v = __ldcg(reinterpret_cast<const uint4*>(a.ctx +
                                                (row0 + w0 + r) * d + c));
    *reinterpret_cast<uint4*>(aw + r * sa + c) = v;
  }
  __syncwarp();
  float acc[NT][4];
  zero(acc);
  tile_mma<NT>(acc, aw, sa, st, ksd);
  residual(acc, a.xs, a.bo, d, T, row0, rt);
  acc_ln_to_tile(acc, a.sc, a.scb, d, aw, sa);
  // pointwise 1: n8 tiles 2q (linear) and 2q + 1 (gate) are channels
  // 8q .. 8q + 7
  for (int p0 = 0; p0 < 2 * nd; p0 += NT) {
    zero(acc);
    tile_mma<NT>(acc, aw, sa, st, ksd);
#pragma unroll
    for (int jj = 0; jj < NT / 2; ++jj) {
      const int col = 8 * (p0 / 2 + jj) + 2 * t;
      if (col >= d) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int tt = rt.frame(h);
        if (tt >= T) continue;
        const float keep = a.mask[row0 + tt] ? 1.f : 0.f;
        float2 gl;
        gl.x = (acc[2 * jj][2 * h] + a.b1[col]) *
               fast_sigmoid(acc[2 * jj + 1][2 * h] + a.b1[d + col]) * keep;
        gl.y = (acc[2 * jj][2 * h + 1] + a.b1[col + 1]) *
               fast_sigmoid(acc[2 * jj + 1][2 * h + 1] + a.b1[d + col + 1]) *
               keep;
        *reinterpret_cast<float2*>(a.glu + (row0 + tt) * d + col) = gl;
      }
    }
  }
  st.finish();
}

// Phase D, a row tile: depthwise + bd -> norm -> SiLU -> pointwise 2 + b2c
// + x2 -> x3; x4 = x3 + 0.5 FFN2(LN(x3)); out = LN(x4) x mask.
template <int NT>
__device__ void mma_phase_d(const MmaArgs& a, bf16* aw, int sa, char* ring,
                            float* dw, RowTile rt) {
  const int d = a.d, T = a.t_len, dp = pad16(d), k = a.ksize;
  const int ksd = dp / 16, nd = pad8(d) / 8, lane = threadIdx.x % 32;
  const int t = lane % 4, fp = pad64(a.dff);
  // pointwise 2's stages, then FFN2's, loading during the depthwise
  auto st = stream(
      ring, slot_bytes<NT>(),
      Then<Rows, Ffn>{Rows{a.w2c, nd, 0, nd, 0, nd, ksd, 1},
                      Ffn{a.w21, a.w22, ksd, nd, fp / kFC}});
  const size_t row0 = (size_t)rt.b * T;
  // depthwise: a thread per (channel, 16 output frames), the taps in
  // registers (zero from k on), each GLU row of the span read once, the
  // sum in tap order
  const float* gb = a.glu + row0 * d;
  for (int it = threadIdx.x; it < d * (kLT / 16); it += blockDim.x) {
    const int c = it % d, r0 = 16 * (it / d);
    float w[kTaps];
#pragma unroll
    for (int j = 0; j < kTaps; ++j) w[j] = j < k ? __ldg(a.wd + j * d + c) : 0.f;
    float acc[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) acc[r] = 0.f;
#pragma unroll
    for (int i = 0; i < 16 + kTaps - 1; ++i) {
      const int tt = rt.t0 + r0 + i - a.pad_l;
      const float gv = i < 15 + k && tt >= 0 && tt < T
                           ? __ldcg(gb + (size_t)tt * d + c)
                           : 0.f;
#pragma unroll
      for (int r = 0; r < 16; ++r)
        if (i - r >= 0 && i - r < kTaps) acc[r] = fmaf(gv, w[i - r], acc[r]);
    }
    const float bias = a.bd[c];
#pragma unroll
    for (int r = 0; r < 16; ++r) dw[(r0 + r) * d + c] = acc[r] + bias;
  }
  __syncthreads();
  // norm, SiLU, rounded to bf16 into this warp's rows of the A tile
  for (int r = 0; r < 16; ++r) {
    const float* y = dw + (16 * (threadIdx.x / 32) + r) * d;
    float mu = 0.f, rs = 1.f;
    if (a.layer_norm) {
      float s = 0.f, q = 0.f;
      for (int c = lane; c < d; c += 32) {
        s += y[c];
        q += y[c] * y[c];
      }
      s = warp_sum(s);
      q = warp_sum(q);
      mu = s / d;
      rs = rsqrtf(q / d - mu * mu + 1e-6f);
    }
    for (int c = 2 * lane; c < dp; c += 64) {
      float v0 = 0.f, v1 = 0.f;
      if (c < d) {
        const float h0 = a.layer_norm ? (y[c] - mu) * rs * a.nw[c] + a.nb[c]
                                      : y[c] * a.nw[c] + a.nb[c];
        const float h1 = a.layer_norm
                             ? (y[c + 1] - mu) * rs * a.nw[c + 1] + a.nb[c + 1]
                             : y[c + 1] * a.nw[c + 1] + a.nb[c + 1];
        v0 = fast_silu(h0);
        v1 = fast_silu(h1);
      }
      *reinterpret_cast<uint32_t*>(aw + r * sa + c) = pack_bf16(v0, v1);
    }
  }
  __syncwarp();
  float acc[NT][4];
  zero(acc);
  tile_mma<NT>(acc, aw, sa, st, ksd);
  residual(acc, a.xs, a.b2c, d, T, row0, rt);
  acc_ln_to_tile(acc, a.s2, a.sb2, d, aw, sa);
  ffn_mma<NT>(acc, aw, sa, st, a.b21, ksd, fp, nd);
  st.finish();
  // x4 = x3 + 0.5 (o + b22)
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = 8 * j + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int tt = rt.frame(h);
      float2 x4 = make_float2(0.f, 0.f);
      if (col < d && tt < T) {
        x4 = __ldcg(reinterpret_cast<const float2*>(a.xs + (row0 + tt) * d +
                                                    col));
        x4.x += 0.5f * (acc[j][2 * h] + a.b22[col]);
        x4.y += 0.5f * (acc[j][2 * h + 1] + a.b22[col + 1]);
      }
      acc[j][2 * h] = x4.x;
      acc[j][2 * h + 1] = x4.y;
    }
  }
  float mu[2], rs[2];
  acc_stats(acc, d, mu, rs);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = 8 * j + 2 * t;
    if (col >= d) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int tt = rt.frame(h);
      if (tt >= T) continue;
      const float keep = a.mask[row0 + tt] ? 1.f : 0.f;
      *reinterpret_cast<uint32_t*>(a.out + (row0 + tt) * d + col) = pack_bf16(
          ((acc[j][2 * h] - mu[h]) * rs[h] * a.sf[col] + a.sfb[col]) * keep,
          ((acc[j][2 * h + 1] - mu[h]) * rs[h] * a.sf[col + 1] +
           a.sfb[col + 1]) * keep);
    }
  }
}

// NT: n8 tiles of a warp's D columns (12 for D <= 96, 22 for D <= 176);
// DKP: dk rounded up to 16, the core's template.
template <int NT, int DKP>
__global__ void __launch_bounds__(kLThreads, 2) layer_mma_kernel(MmaArgs a) {
  extern __shared__ __align__(16) char smem[];
  const int sa = a_stride(a.d), T = a.t_len, H = a.heads;
  bf16* aw = reinterpret_cast<bf16*>(smem) + 16 * (threadIdx.x / 32) * sa;
  char* ring = smem + sizeof(bf16) * kLT * sa;
  float* dw = reinterpret_cast<float*>(ring + kStages * slot_bytes<NT>());
  const int q_tiles = (T + kLT - 1) / kLT, row_tiles = a.batch * q_tiles;
  const int pos_tiles = (2 * T - 1 + kLT - 1) / kLT;
  auto tile = [&](int i) {
    const int b = i / q_tiles;
    return RowTile{b, (i - b * q_tiles) * kLT};
  };

  for (int i = blockIdx.x; i < row_tiles + pos_tiles; i += gridDim.x) {
    if (i < row_tiles)
      mma_phase_a_rows<NT>(a, aw, sa, ring, tile(i));
    else
      mma_phase_a_pos<NT>(a, aw, sa, ring, (i - row_tiles) * kLT);
  }
  grid_barrier(a.bar);

  const int dk = a.d / H;
  const HeadLayout cl = {(long long)T * a.d, dk, a.d};
  for (int i = blockIdx.x; i < H * row_tiles; i += gridDim.x) {
    const int bh = i / q_tiles;
    __syncthreads();  // the previous tile's shared rows are consumed
    core_mma_tile<DKP, false>(smem, a.qu, a.qv, a.k, a.v, a.p, a.key_bias,
                              a.ctx, cl, nullptr, bh,
                              (i - bh * q_tiles) * kMQ, T, H, dk,
                              1.f / sqrtf((float)dk), 0u, 0u, 0u, 1.f, 0,
                              a.left, a.right, nullptr);
  }
  grid_barrier(a.bar);

  for (int i = blockIdx.x; i < row_tiles; i += gridDim.x)
    mma_phase_c<NT>(a, aw, sa, ring, tile(i));
  grid_barrier(a.bar);

  for (int i = blockIdx.x; i < row_tiles; i += gridDim.x) {
    __syncthreads();  // the previous tile's depthwise rows are consumed
    mma_phase_d<NT>(a, aw, sa, ring, dw, tile(i));
  }
}

template <int NT, int DKP>
int run_layer_mma(const MmaArgs& a, int* blocks, cudaStream_t stream) {
  auto* kernel = layer_mma_kernel<NT, DKP>;
  const size_t smem = mma_smem<NT, DKP>(a.d);
  int sms = 0, per_sm = 0;
  cudaError_t err = occupancy(kernel, kLThreads, smem, &sms, &per_sm);
  if (err != cudaSuccess) return (int)err;
  if (blocks) {  // occupancy query only
    *blocks = per_sm;
    return 0;
  }
  MmaArgs args = a;
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(sms * per_sm),
                                    dim3(kLThreads), params, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// What layer_mma_kernel takes (ops/cuda_layer.py::mma_refusal): the
// attention core is built for dk in (32, 48] (DKP 48), the dk of every
// configuration of the repository (44); each further DKP would be two more
// instantiations of the whole kernel to compile.
bool mma_takes(int d, int heads, int ksize) {
  return heads > 0 && d % heads == 0 && d % 8 == 0 && d <= 176 &&
         (d / heads) % 4 == 0 && d / heads > 32 && d / heads <= 48 &&
         ksize >= 1 && ksize <= kTaps;
}

int run_mma(MmaArgs a, int* blocks, cudaStream_t s) {
  if (!mma_takes(a.d, a.heads, a.ksize)) return (int)cudaErrorInvalidValue;
  return pad8(a.d) / 8 <= 12 ? run_layer_mma<12, 48>(a, blocks, s)
                             : run_layer_mma<22, 48>(a, blocks, s);
}

}  // namespace

// route 0: layer_kernel<float>; 1: layer_kernel<bf16>; 2: layer_mma_kernel
// (bf16). The wrapper guarantees: contiguous tensors on one device; x and
// out (batch, t_len, d) in the route's dtype; mask (batch, t_len) of 0/1
// bytes; pe (2 t_len - 1, d) fp32; `w` the route's n_w weight pointers
// (ops/cuda_layer.py::_kernel_weights); ws holds ws_bytes >= the
// route's Workspace total. Routes 0 and 1 take D = H dk, dk <= 64,
// layer_smem <= 227 KB; route 2 what mma_takes says. With `blocks` not
// null nothing is launched and only the shape is read (w, the tensors and
// ws may be null): *blocks is the blocks an SM of the route's launch (its
// occupancy).
extern "C" int tat_conformer_layer(int route, void* const* w, int n_w,
                                   const void* x, const void* mask,
                                   const void* pe, void* out, void* ws,
                                   size_t ws_bytes, int batch, int t_len,
                                   int d, int heads, int dff, int ksize,
                                   int pad_l, int layer_norm, int left,
                                   int right, int* blocks, void* stream) {
  if (route < 0 || route > 2 || heads < 1 || d % heads ||
      n_w != (route == 2 ? kMmaWeights : kSimtWeights))
    return (int)cudaErrorInvalidValue;
  const Workspace sp = workspace(route ? 2 : 4, batch, t_len, d);
  if (!blocks && ws_bytes < sp.total) return (int)cudaErrorInvalidValue;
  char* base = (char*)ws;
  cudaStream_t s = (cudaStream_t)stream;
  unsigned int* bar = (unsigned int*)(base + sp.bar);
  if (!blocks) {
    cudaError_t err = cudaMemsetAsync(bar, 0, 2 * sizeof(unsigned int), s);
    if (err != cudaSuccess) return (int)err;
  }
  if (route == 2) {
    MmaArgs a = {};
    if (w) memcpy(&a, w, sizeof(void*) * kMmaWeights);
    using B = __nv_bfloat16*;
    a.x = (const __nv_bfloat16*)x;
    a.out = (B)out;
    a.mask = (const uint8_t*)mask;
    a.pe = (const float*)pe;
    a.key_bias = (float*)(base + sp.key_bias);
    a.xs = (float*)(base + sp.xs);
    a.glu = (float*)(base + sp.glu);
    a.qu = (B)(base + sp.qu);
    a.qv = (B)(base + sp.qv);
    a.k = (B)(base + sp.k);
    a.v = (B)(base + sp.v);
    a.ctx = (B)(base + sp.ctx);
    a.p = (B)(base + sp.p);
    a.bar = bar;
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
    return run_mma(a, blocks, s);
  }
  LayerArgs a = {};
  if (w) memcpy(&a, w, sizeof(void*) * kSimtWeights);
  a.x = x;
  a.out = out;
  a.mask = (const uint8_t*)mask;
  a.pe = (const float*)pe;
  a.key_bias = (float*)(base + sp.key_bias);
  a.xs = (float*)(base + sp.xs);
  a.glu = (float*)(base + sp.glu);
  a.qu = base + sp.qu;
  a.qv = base + sp.qv;
  a.k = base + sp.k;
  a.v = base + sp.v;
  a.ctx = base + sp.ctx;
  a.p = base + sp.p;
  a.bar = bar;
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
  return route ? run_layer<__nv_bfloat16>(a, blocks, s)
               : run_layer<float>(a, blocks, s);
}
