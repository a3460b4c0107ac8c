// Flow-matching Euler loop of the `mlp` meta encoder, forward and backward.
// Per feature position (row r, frame t), with n = max(steps[r], 1):
//   for j = 0 .. max_steps - 1:    t_j = (n - j) / n
//     h = round(relu(x W1x + t_j a + c))       (C -> H)
//     v = round(h W2 + b2)                     (H -> C)
//     x = round(x - v / n)   while j < n
//   last_v = v at j == n - 1
// where round is a round trip through the compute type (none for fp32).
// The backward walks j = N - 1 .. 0 as _fm_bwd_kernel does: dv = (j < n ?
// -gx / n : 0) + (j == n - 1 ? gv : 0); dh = round(dv) W2^T; dp = dh [p >
// 0]; gx += round(dp) W1x^T (gx in fp32); dW2 += h^T round(dv), dW1x +=
// x_j^T round(dp); db2 += dv, da += t dp, dc += dp (unrounded).
//
// Replaces tpu_asr/ops/pallas_fm.py::_fm_fwd_kernel and ::_fm_bwd_kernel,
// launched by ops/cuda_fm.py::fused_fm_euler and ::fused_fm_euler_bwd.
//
// What bounds it on an H100: at the flagship's rows = 32 x 16 layers,
// T' = 376, C = 88, H = 128, 8 steps, the forward is 4 x steps x rows T C H
// = 69.4 GFLOP against 101.6 MB in and out (bf16), the backward 12 x steps x
// rows T C H = 208 GFLOP against 135.5 MB: both bound by operations (0.070
// and 0.21 ms at the bf16 tensor rate) if x, h and v never leave the chip
// between steps.
//
// bf16: the products on the tensor cores (mma.sync.m16n8k16, bf16 operands,
// fp32 accumulation). Every product operand is a bf16-rounded value (x, h,
// round(dv), round(dp)), which is exactly that instruction's contract, so
// the kernels compute the TPU kernel's function. C % 8 == 0 up to 128 is
// zero-padded to CP (a multiple of 32, a template parameter: the registers
// depend on it), H % 32 == 0 up to 256 is a runtime loop over 32-column
// chunks. A persistent block of 4 warps stages W1x (CP x H) and W2 (H x
// CP) in bf16 once (rows an odd multiple of 16 bytes apart, padding zero-
// filled while staging, so the host makes no copy); one copy serves both
// orientations: ldmatrix.trans for x W1x and h W2, ldmatrix for dv W2^T
// and dp W1x^T. Each warp owns 16 positions at a time (rows x T flattened,
// so a tile may straddle two batch rows; each thread knows its two rows' n)
// and runs the whole recurrence in registers: x as packed bf16 A fragments;
// per 32-column chunk of H the pre-activation p = x W1x[:, chunk] (K = CP)
// gets t a + c, relu and rounding in registers, and its m16n8 accumulator
// pair becomes the m16k16 A fragment of v += h W2[chunk, :] (the register
// trick of FlashAttention's P V: h never touches shared memory); v then
// updates x in the same fragment layout, v / n as a product with 1 / n and
// two fused corrections (the correctly rounded quotient). No barrier inside
// the step loop: the warps share only the read-only weights. A warp stops
// after the largest n among its positions. Grids fill the card once (the
// occupancy query runs once per card and kernel).
//   fm_fwd_mma_kernel - device memory sees one read of x0 and one write
//     each of x_final and last_v (written at j == n - 1, zero where n >
//     max_steps). Its registers are capped per CP (kFwdBlocks).
//   backward - three kernels, no atomics, fixed summation orders, so two
//     calls give bit-equal gradients. Positions are cut into chunks whose
//     workspace (x_j, h_j, round(dp_j), round(dv_j) in bf16 per position
//     and step, 2 (2 CP + 2 H) bytes) stays within kWorkBytes, a whole
//     number of rounds of the grid's warps where it allows; per chunk:
//     fm_bwd_rows_kernel replays the forward, writing each x_j to the
//     workspace, then walks j = steps - 1 .. 0 with gx in fp32 m16n8
//     accumulators: per chunk of H, p again (K = CP), dh = round(dv) W2^T
//     (K = CP), dp, and gx += round(dp) W1x^T (K = 32, the accumulators
//     chained into A fragments). At CP = 128, x_j and round(dv) wait in
//     shared tiles for the chunk loop (kTilesShared). db2, da and dc are
//     summed unrounded in the fragment layout (over the two rows of a
//     thread, then over the 8 row groups by shuffles) into per-warp shared
//     slots, one partial per block.
//     fm_bwd_dw_kernel: dW1x = X^T DP and dW2 = H^T DV over fixed chunks of
//     kDwRows workspace rows, one partial each (gemm.cuh's gemm_tn_tile in
//     128 x 128 tiles, so each workspace row is read once).
//   fm_bwd_sum_kernel: every partial summed in order, 8 partial streams a
//     column added in a fixed order. The workspace's traffic (1.4 GB
//     written and read at the flagship shape) bounds the backward next to
//     its products.
//
// fp32 (the check dtype; C = 88, H = 128 only): plain SIMT with fp32
// accumulation, no TF32, so that it agrees with full-precision references.
// One persistent block per SM stages W1x, W2 (fp32, odd row strides), a, c
// and b2 and walks over tiles. 8 warps; in the position products warp w
// owns rows w R .. w R + R - 1 (R = P / 8) and lane l the columns l + 32 j.
//   fm_fwd_kernel (P = 64) - x in registers and a shared tile for all steps;
//     h in a shared tile.
//   fm_bwd_kernel (P = 16) - replays the forward keeping each step's x_j
//     of the tile in shared memory, then walks back; each thread owns 4 x 11
//     cells of dW1x and of dW2 in registers for all its tiles; one partial
//     per block, summed over blocks in order by fm_bwd_sum_kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <map>
#include <math.h>
#include <mutex>
#include <tuple>
#include <type_traits>

#include "gemm.cuh"

namespace {

// ---------------------------------------------------------------------------
// fp32, plain SIMT (the check dtype)
// ---------------------------------------------------------------------------

constexpr int kC = 88;                // features
constexpr int kH = 128;               // hidden units
constexpr int kMaxSteps = 16;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kJH = kH / 32;          // hidden columns per lane
constexpr int kJC = (kC + 31) / 32;   // feature columns per lane (ragged)
constexpr int kW1S = kH + 1;          // w1s row stride (odd)
constexpr int kW2S = kC + 1;          // w2s row stride (odd)
constexpr int kCG = kC / kWarps;      // features per warp in dW
constexpr int kWF = kC * kW1S + kH * kW2S + 2 * kH + kC;  // staged floats
constexpr int kNP = 2 * kC * kH + 2 * kH + kC;  // partial floats per block
constexpr int kFwdP = 64;

static_assert(kC % kWarps == 0, "dW owner layout");

// w1s[c * kW1S + k] = W1x[c][k], w2s[k * kW2S + c] = W2[k][c], then a, c, b2.
template <typename T>
__device__ void stage_weights(float* s, const T* w1, const T* w2,
                              const float* a, const float* c,
                              const float* b2) {
  float* w1s = s;
  float* w2s = w1s + kC * kW1S;
  float* as = w2s + kH * kW2S;
  float* cs = as + kH;
  float* b2s = cs + kH;
  for (int i = threadIdx.x; i < kC * kH; i += kThreads) {
    const int r = i / kH, k = i - r * kH;
    w1s[r * kW1S + k] = to_f(w1[i]);
  }
  for (int i = threadIdx.x; i < kH * kC; i += kThreads) {
    const int k = i / kC, cc = i - k * kC;
    w2s[k * kW2S + cc] = to_f(w2[i]);
  }
  for (int i = threadIdx.x; i < kH; i += kThreads) {
    as[i] = a[i];
    cs[i] = c[i];
  }
  for (int i = threadIdx.x; i < kC; i += kThreads) b2s[i] = b2[i];
}

// nt[pp] = n of position pos0 + pp (1 past the end); returns the steps the
// tile runs: min(ms, largest n). Ends with a block barrier.
template <int P>
__device__ int load_tile(float* nt, const float* n_rows, long pos0,
                         long n_pos, int t_len, int ms) {
  for (int pp = threadIdx.x; pp < P; pp += kThreads) {
    const long pos = pos0 + pp;
    nt[pp] = pos < n_pos ? n_rows[pos / t_len] : 1.f;
  }
  __syncthreads();
  float m = 1.f;
  for (int pp = 0; pp < P; ++pp) m = fmaxf(m, nt[pp]);
  return min(ms, (int)ceilf(m));
}

// acc[i][j] = sum_{k < K} A(w R + i, k) B(k, col_j) for warp w, col_j =
// min(lane + 32 j, N - 1). A is a row-major tile of stride lda, rounded to
// T on read when RA; B(k, n) = b[k * ldb + n], or b[n * ldb + k] when BT.
template <typename T, int R, int NJ, int N, int K, bool RA, bool BT,
          typename TA>
__device__ __forceinline__ void tile_prod(float (&acc)[R][NJ], const TA* a,
                                          int lda, const float* b, int ldb) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int col[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) col[j] = min(lane + 32 * j, N - 1);
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  const TA* arow = a + (size_t)warp * R * lda;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[R], bv[NJ];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float v = to_f(arow[i * lda + k]);
      av[i] = RA ? rnd<T>(v) : v;
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      bv[j] = BT ? b[col[j] * ldb + k] : b[k * ldb + col[j]];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// h tile = round(relu(x W1x + t a + c)) (pre_only: the pre-activation p,
// unrounded) for the warp's rows; x is the (P, kC) tile xa.
template <typename T, int R, bool PreOnly, typename TA>
__device__ __forceinline__ void hidden(float* ht, const TA* xa,
                                       const float* w1s, const float* as,
                                       const float* cs, const float* nt,
                                       int j) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float acc[R][kJH];
  tile_prod<T, R, kJH, kH, kC, false, false>(acc, xa, kC, w1s, kW1S);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = warp * R + i;
    const float n = nt[row], t = (n - j) / n;
#pragma unroll
    for (int jj = 0; jj < kJH; ++jj) {
      const int col = lane + 32 * jj;
      const float p = acc[i][jj] + t * as[col] + cs[col];
      ht[row * kH + col] = PreOnly ? p : rnd<T>(fmaxf(p, 0.f));
    }
  }
}

// One Euler update of the warp's x registers from the h tile: v = round(h
// W2 + b2); x = round(x - v / n) while j < n; last_v at j == n - 1.
template <typename T, int R>
__device__ __forceinline__ void euler_update(float (&x)[R][kJC],
                                             float (&lv)[R][kJC],
                                             const float* ht,
                                             const float* w2s,
                                             const float* b2s,
                                             const float* nt, int j) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float vv[R][kJC];
  tile_prod<T, R, kJC, kC, kH, false, false>(vv, ht, kH, w2s, kW2S);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const float n = nt[warp * R + i];
#pragma unroll
    for (int jj = 0; jj < kJC; ++jj) {
      const int col = lane + 32 * jj;
      if (col >= kC) continue;
      const float v = rnd<T>(vv[i][jj] + b2s[col]);
      if ((float)j < n) x[i][jj] = rnd<T>(x[i][jj] - v / n);
      if (n - 1.f == (float)j) lv[i][jj] = v;
    }
  }
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreads, 1) fm_fwd_kernel(
    const T* __restrict__ x0, const float* __restrict__ n_rows,
    const T* __restrict__ w1, const float* __restrict__ a,
    const float* __restrict__ c, const T* __restrict__ w2,
    const float* __restrict__ b2, T* __restrict__ xo, T* __restrict__ vo,
    long n_pos, int t_len, int ms) {
  constexpr int R = P / kWarps;
  extern __shared__ float sm[];
  float* w1s = sm;
  float* w2s = w1s + kC * kW1S;
  float* as = w2s + kH * kW2S;
  float* cs = as + kH;
  float* b2s = cs + kH;
  float* nt = sm + kWF;     // P
  float* xt = nt + P;       // P x kC
  float* ht = xt + P * kC;  // P x kH
  stage_weights<T>(sm, w1, w2, a, c, b2);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long n_tiles = (n_pos + P - 1) / P;
  for (long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long pos0 = tile * P;
    __syncthreads();  // staged weights ready; the last tile's smem consumed
    const int steps = load_tile<P>(nt, n_rows, pos0, n_pos, t_len, ms);
    float x[R][kJC], lv[R][kJC];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = warp * R + i;
      const long pos = pos0 + row;
#pragma unroll
      for (int jj = 0; jj < kJC; ++jj) {
        const int col = lane + 32 * jj;
        x[i][jj] = (col < kC && pos < n_pos) ? to_f(x0[pos * kC + col]) : 0.f;
        lv[i][jj] = 0.f;
        if (col < kC) xt[row * kC + col] = x[i][jj];
      }
    }
    __syncthreads();
    for (int j = 0; j < steps; ++j) {
      hidden<T, R, false>(ht, xt, w1s, as, cs, nt, j);
      __syncthreads();
      euler_update<T, R>(x, lv, ht, w2s, b2s, nt, j);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int jj = 0; jj < kJC; ++jj) {
          const int col = lane + 32 * jj;
          if (col < kC) xt[(warp * R + i) * kC + col] = x[i][jj];
        }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const long pos = pos0 + warp * R + i;
      if (pos >= n_pos) continue;
#pragma unroll
      for (int jj = 0; jj < kJC; ++jj) {
        const int col = lane + 32 * jj;
        if (col >= kC) continue;
        xo[pos * kC + col] = from_f<T>(x[i][jj]);
        vo[pos * kC + col] = from_f<T>(lv[i][jj]);
      }
    }
  }
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreads, 1) fm_bwd_kernel(
    const T* __restrict__ x0, const float* __restrict__ n_rows,
    const T* __restrict__ w1, const float* __restrict__ a,
    const float* __restrict__ c, const T* __restrict__ w2,
    const float* __restrict__ b2, const T* __restrict__ gx_in,
    const T* __restrict__ gv_in, T* __restrict__ dx,
    float* __restrict__ part, long n_pos, int t_len, int ms) {
  constexpr int R = P / kWarps;
  extern __shared__ float sm[];
  float* w1s = sm;
  float* w2s = w1s + kC * kW1S;
  float* as = w2s + kH * kW2S;
  float* cs = as + kH;
  float* b2s = cs + kH;
  float* nt = sm + kWF;               // P
  float* pt = nt + P;                 // P x kH: h (replay), p (walk)
  float* dpt = pt + P * kH;           // P x kH: dp, unrounded
  float* dvt = dpt + P * kH;          // P x kC: dv, unrounded
  T* xs = (T*)(dvt + P * kC);         // ms x P x kC: x_j
  stage_weights<T>(sm, w1, w2, a, c, b2);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // dW1x[c][k] and dW2[k][c] for k = lane + 32 i, c = warp * kCG + m
  float dw1[kJH][kCG], dw2[kJH][kCG];
  float pda[kJH], pdc[kJH], pdb2[kJC];
#pragma unroll
  for (int i = 0; i < kJH; ++i) {
    pda[i] = pdc[i] = 0.f;
#pragma unroll
    for (int m = 0; m < kCG; ++m) dw1[i][m] = dw2[i][m] = 0.f;
  }
#pragma unroll
  for (int jj = 0; jj < kJC; ++jj) pdb2[jj] = 0.f;

  const long n_tiles = (n_pos + P - 1) / P;
  for (long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long pos0 = tile * P;
    __syncthreads();
    const int steps = load_tile<P>(nt, n_rows, pos0, n_pos, t_len, ms);
    float x[R][kJC], gx[R][kJC], gv[R][kJC];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = warp * R + i;
      const long pos = pos0 + row;
#pragma unroll
      for (int jj = 0; jj < kJC; ++jj) {
        const int col = lane + 32 * jj;
        const bool in = col < kC && pos < n_pos;
        const long at = pos * kC + col;
        x[i][jj] = in ? to_f(x0[at]) : 0.f;
        gx[i][jj] = in ? to_f(gx_in[at]) : 0.f;
        gv[i][jj] = in ? to_f(gv_in[at]) : 0.f;
        if (col < kC) xs[row * kC + col] = from_f<T>(x[i][jj]);
      }
    }
    __syncthreads();
    // forward replay: x_j of steps 1 .. steps - 1 into xs
    for (int j = 0; j + 1 < steps; ++j) {
      hidden<T, R, false>(pt, xs + (size_t)j * P * kC, w1s, as, cs, nt, j);
      __syncthreads();
      float lv[R][kJC];
      euler_update<T, R>(x, lv, pt, w2s, b2s, nt, j);
      T* xn = xs + (size_t)(j + 1) * P * kC;
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int jj = 0; jj < kJC; ++jj) {
          const int col = lane + 32 * jj;
          if (col < kC) xn[(warp * R + i) * kC + col] = from_f<T>(x[i][jj]);
        }
      __syncthreads();
    }
    // backward walk
    for (int j = steps - 1; j >= 0; --j) {
      const T* xj = xs + (size_t)j * P * kC;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int row = warp * R + i;
        const float n = nt[row];
#pragma unroll
        for (int jj = 0; jj < kJC; ++jj) {
          const int col = lane + 32 * jj;
          if (col >= kC) continue;
          const float dv = ((float)j < n ? -gx[i][jj] / n : 0.f) +
                           (n - 1.f == (float)j ? gv[i][jj] : 0.f);
          dvt[row * kC + col] = dv;
          pdb2[jj] += dv;
        }
      }
      hidden<T, R, true>(pt, xj, w1s, as, cs, nt, j);
      __syncthreads();
      {
        float acc[R][kJH];  // dh = round(dv) W2^T
        tile_prod<T, R, kJH, kH, kC, true, true>(acc, dvt, kC, w2s, kW2S);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int row = warp * R + i;
          const float n = nt[row], t = (n - j) / n;
#pragma unroll
          for (int jj = 0; jj < kJH; ++jj) {
            const int col = lane + 32 * jj;
            const float dp = pt[row * kH + col] > 0.f ? acc[i][jj] : 0.f;
            dpt[row * kH + col] = dp;
            pda[jj] += t * dp;
            pdc[jj] += dp;
          }
        }
      }
      __syncthreads();
      {
        float acc[R][kJC];  // gx += round(dp) W1x^T
        tile_prod<T, R, kJC, kC, kH, true, true>(acc, dpt, kH, w1s, kW1S);
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int jj = 0; jj < kJC; ++jj) gx[i][jj] += acc[i][jj];
      }
      for (int pp = 0; pp < P; ++pp) {
        float hv[kJH], dpv[kJH];
#pragma unroll
        for (int i = 0; i < kJH; ++i) {
          const int k = lane + 32 * i;
          hv[i] = rnd<T>(fmaxf(pt[pp * kH + k], 0.f));
          dpv[i] = rnd<T>(dpt[pp * kH + k]);
        }
#pragma unroll
        for (int m = 0; m < kCG; ++m) {
          const int cc = warp * kCG + m;
          const float dvv = rnd<T>(dvt[pp * kC + cc]);
          const float xv = to_f(xj[pp * kC + cc]);
#pragma unroll
          for (int i = 0; i < kJH; ++i) {
            dw2[i][m] = fmaf(hv[i], dvv, dw2[i][m]);
            dw1[i][m] = fmaf(xv, dpv[i], dw1[i][m]);
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const long pos = pos0 + warp * R + i;
      if (pos >= n_pos) continue;
#pragma unroll
      for (int jj = 0; jj < kJC; ++jj) {
        const int col = lane + 32 * jj;
        if (col < kC) dx[pos * kC + col] = from_f<T>(gx[i][jj]);
      }
    }
  }

  // this block's partial: dW1x (C, H), dW2 (H, C), da (H), dc (H), db2 (C)
  float* pb = part + (size_t)blockIdx.x * kNP;
#pragma unroll
  for (int i = 0; i < kJH; ++i)
#pragma unroll
    for (int m = 0; m < kCG; ++m) {
      const int k = lane + 32 * i, cc = warp * kCG + m;
      pb[cc * kH + k] = dw1[i][m];
      pb[kC * kH + k * kC + cc] = dw2[i][m];
    }
  __syncthreads();
#pragma unroll
  for (int jj = 0; jj < kJH; ++jj) {
    pt[warp * kH + lane + 32 * jj] = pda[jj];
    dpt[warp * kH + lane + 32 * jj] = pdc[jj];
  }
#pragma unroll
  for (int jj = 0; jj < kJC; ++jj) {
    const int col = lane + 32 * jj;
    if (col < kC) dvt[warp * kC + col] = pdb2[jj];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kH; i += kThreads) {
    float s = 0.f, s2 = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      s += pt[w * kH + i];
      s2 += dpt[w * kH + i];
    }
    pb[2 * kC * kH + i] = s;
    pb[2 * kC * kH + kH + i] = s2;
  }
  for (int i = threadIdx.x; i < kC; i += kThreads) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += dvt[w * kC + i];
    pb[2 * kC * kH + 2 * kH + i] = s;
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kMmaThreads = 128;                 // 4 warps
constexpr int kMmaWarps = kMmaThreads / 32;
constexpr int kTile = 16;                        // positions per warp tile
constexpr int kMaxC = 128, kMaxH = 256;
constexpr int kDwRows = 2048;                    // workspace rows a dW partial
constexpr size_t kWorkBytes = (size_t)256 << 20; // workspace of one chunk

// The staged weights in shared memory: w1 = W1x (CP rows, stride s1 = H + 8
// elements), w2 = W2 (H rows, stride kS2 = CP + 8), then a, c (H) and b2
// (CP) in fp32. Row strides are odd multiples of 16 bytes, so the eight
// rows an ldmatrix reads fall in distinct banks.
template <int CP>
struct Staged {
  static constexpr int kS2 = CP + 8;
  const bf16* w1;
  const bf16* w2;
  const float* a;
  const float* c;
  const float* b2;
  int s1;
};

template <int CP>
__host__ __device__ constexpr size_t staged_bytes(int h) {
  return (size_t)CP * (h + 8) * 2 + (size_t)h * (CP + 8) * 2 +
         (size_t)(2 * h + CP) * 4;
}

// CP = 128: the backward's walk keeps x_j and round(dv) in two shared
// tiles of the warp (16 rows, stride CP + 8) for its chunk loop, not in
// registers: with gx's accumulators they would not fit in 255.
template <int CP>
constexpr bool kTilesShared = CP == 128;

// fm_bwd_rows_kernel: the staged weights, then per warp the column sums
// [da (H) | dc (H) | db2 (CP)] in fp32, then (kTilesShared) per warp the
// x_j and round(dv) tiles.
template <int CP>
__host__ __device__ constexpr size_t rows_smem(int h) {
  return staged_bytes<CP>(h) + (size_t)kMmaWarps * (2 * h + CP) * 4 +
         (kTilesShared<CP> ? (size_t)kMmaWarps * 2 * kTile * (CP + 8) * 2
                           : 0);
}

// Stage W1x (cc, h) and W2 (h, cc) with the features zero-padded to CP,
// and a, c, b2 (16-byte copies; rows of cc % 8 == 0 bf16 values).
template <int CP>
__device__ Staged<CP> stage_mma(char* smem, const bf16* w1, const bf16* w2,
                                const float* a, const float* c,
                                const float* b2, int cc, int h) {
  Staged<CP> s;
  s.s1 = h + 8;
  bf16* w1s = reinterpret_cast<bf16*>(smem);
  bf16* w2s = w1s + (size_t)CP * s.s1;
  float* as = reinterpret_cast<float*>(w2s + (size_t)h * Staged<CP>::kS2);
  float* cs = as + h;
  float* bs = cs + h;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const int q1 = h / 8;
  for (int i = threadIdx.x; i < CP * q1; i += blockDim.x) {
    const int r = i / q1, q = i - r * q1;
    *reinterpret_cast<uint4*>(w1s + (size_t)r * s.s1 + 8 * q) =
        r < cc ? reinterpret_cast<const uint4*>(w1 + (size_t)r * h)[q] : zero;
  }
  constexpr int q2 = CP / 8;
  for (int i = threadIdx.x; i < h * q2; i += blockDim.x) {
    const int r = i / q2, q = i - r * q2;
    *reinterpret_cast<uint4*>(w2s + (size_t)r * Staged<CP>::kS2 + 8 * q) =
        8 * q < cc ? *reinterpret_cast<const uint4*>(w2 + (size_t)r * cc +
                                                     8 * q)
                   : zero;
  }
  for (int i = threadIdx.x; i < h; i += blockDim.x) {
    as[i] = a[i];
    cs[i] = c[i];
  }
  for (int i = threadIdx.x; i < CP; i += blockDim.x)
    bs[i] = i < cc ? b2[i] : 0.f;
  s.w1 = w1s;
  s.w2 = w2s;
  s.a = as;
  s.c = cs;
  s.b2 = bs;
  return s;
}

// Fragments of a warp's 16 positions (lane = 4 g + q). A fragment r of k16
// slice kk holds (row g + 8 (r % 2), columns 16 kk + 8 (r / 2) + 2 q, + 1):
// in the m16n8 accumulator layout that is n8 tile 2 kk + r / 2, elements
// 2 (r % 2) and 2 (r % 2) + 1. acc[i][e] holds (row g + 8 (e / 2), column
// 8 i + 2 q + e % 2).
__device__ __forceinline__ float lo_f(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float hi_f(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

// The accumulator pair (lo, hi) = n8 tiles (2 k, 2 k + 1), rounded to bf16,
// as the A fragment of k16 slice k.
__device__ __forceinline__ void acc_to_a(uint32_t (&f)[4], const float (&lo)[4],
                                         const float (&hi)[4]) {
  f[0] = pack_bf16(lo[0], lo[1]);
  f[1] = pack_bf16(lo[2], lo[3]);
  f[2] = pack_bf16(hi[0], hi[1]);
  f[3] = pack_bf16(hi[2], hi[3]);
}

// Rows r0 .. r0 + 15 of a row-major (rows, ld) bf16 matrix as A fragments;
// rows >= n_rows and columns >= cc read zero.
template <int CP>
__device__ __forceinline__ void load_a(uint32_t (&f)[CP / 16][4],
                                       const bf16* m, long r0, long n_rows,
                                       int ld, int cc, int lane) {
  const int g = lane / 4, q = lane % 4;
#pragma unroll
  for (int kk = 0; kk < CP / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const long row = r0 + g + 8 * (r % 2);
      const int col = 16 * kk + 8 * (r / 2) + 2 * q;
      f[kk][r] = (row < n_rows && col < cc)
                     ? *reinterpret_cast<const uint32_t*>(m + row * ld + col)
                     : 0u;
    }
}

// The inverse of load_a: rows < n_rows, columns < cc.
template <int CP>
__device__ __forceinline__ void store_a(bf16* m, const uint32_t (&f)[CP / 16][4],
                                        long r0, long n_rows, int ld, int cc,
                                        int lane) {
  const int g = lane / 4, q = lane % 4;
#pragma unroll
  for (int kk = 0; kk < CP / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const long row = r0 + g + 8 * (r % 2);
      const int col = 16 * kk + 8 * (r / 2) + 2 * q;
      if (row < n_rows && col < cc)
        *reinterpret_cast<uint32_t*>(m + row * ld + col) = f[kk][r];
    }
}

// The A fragments of a warp's 16 x CP tile, slice kk at a time: from
// registers, or from a shared tile (16 rows, CP + 8 apart) by ldmatrix.
// kUnroll: loops over the shared slices stay rolled (unrolled, ptxas hoists
// every slice's loads and spills at CP = 128).
template <int CP>
struct RegFrags {
  static constexpr int kUnroll = CP / 16;
  const uint32_t (&f)[CP / 16][4];
  __device__ __forceinline__ void operator()(int kk, uint32_t (&a)[4]) const {
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = f[kk][r];
  }
};

template <int CP>
struct SharedFrags {
  static constexpr int kUnroll = 1;
  const bf16* tile;
  int lane;
  __device__ __forceinline__ void operator()(int kk, uint32_t (&a)[4]) const {
    ldmatrix_x4(a, tile + (lane % 16) * (CP + 8) + 16 * kk + (lane / 16) * 8);
  }
};

// The walk's fragments: shared at CP = 128 (kTilesShared), else registers.
template <int CP>
__device__ __forceinline__ auto walk_frags(const uint32_t (&f)[CP / 16][4],
                                           const bf16* tile, int lane) {
  if constexpr (kTilesShared<CP>)
    return SharedFrags<CP>{tile, lane};
  else
    return RegFrags<CP>{f};
}

// p = x W1x[:, hc .. hc + 31] + t a + c (t0 for rows g, t1 for rows g + 8)
// as 4 n8 accumulator tiles; K = CP; x's fragments from xf.
template <int CP, class Frags>
__device__ __forceinline__ void pre_act(float (&p)[4][4], const Frags& xf,
                                        const Staged<CP>& s, int hc, float t0,
                                        float t1, int lane) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) p[i][e] = 0.f;
  constexpr int kU = Frags::kUnroll;
#pragma unroll kU
  for (int kk = 0; kk < CP / 16; ++kk) {
    uint32_t xa[4];
    xf(kk, xa);
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      uint32_t b[4];
      ldmatrix_x4_trans(
          b, s.w1 + (size_t)(16 * kk + lane % 8 + ((lane / 8) % 2) * 8) * s.s1 +
                 hc + 16 * jj + (lane / 16) * 8);
      mma_bf16(p[2 * jj], xa, b[0], b[1]);
      mma_bf16(p[2 * jj + 1], xa, b[2], b[3]);
    }
  }
  const int q = lane % 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = hc + 8 * i + 2 * q + e % 2;
      p[i][e] = p[i][e] + (e < 2 ? t0 : t1) * s.a[col] + s.c[col];
    }
}

// The chunk's h = round(relu(p)) as the two A fragments of K = 32.
__device__ __forceinline__ void relu_a(uint32_t (&ha)[2][4],
                                       const float (&p)[4][4]) {
  float r[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) r[i][e] = fmaxf(p[i][e], 0.f);
  acc_to_a(ha[0], r[0], r[1]);
  acc_to_a(ha[1], r[2], r[3]);
}

// v = round(h W2 + b2) with h = round(relu(x W1x + t a + c)), chunk by
// chunk of H: h stays in registers.
template <int CP>
__device__ __forceinline__ void velocity(float (&v)[CP / 8][4],
                                         const uint32_t (&xa)[CP / 16][4],
                                         const Staged<CP>& s, int h, float t0,
                                         float t1, int lane) {
#pragma unroll
  for (int i = 0; i < CP / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) v[i][e] = 0.f;
#pragma unroll 1
  for (int hc = 0; hc < h; hc += 32) {
    float p[4][4];
    pre_act<CP>(p, RegFrags<CP>{xa}, s, hc, t0, t1, lane);
    uint32_t ha[2][4];
    relu_a(ha, p);
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int jj = 0; jj < CP / 16; ++jj) {
        uint32_t b[4];
        ldmatrix_x4_trans(
            b, s.w2 +
                   (size_t)(hc + 16 * ks + lane % 8 + ((lane / 8) % 2) * 8) *
                       Staged<CP>::kS2 +
                   16 * jj + (lane / 16) * 8);
        mma_bf16(v[2 * jj], ha[ks], b[0], b[1]);
        mma_bf16(v[2 * jj + 1], ha[ks], b[2], b[3]);
      }
  }
  const int q = lane % 4;
#pragma unroll
  for (int i = 0; i < CP / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[i][e] = rnd<bf16>(v[i][e] + s.b2[8 * i + 2 * q + e % 2]);
}

// v / n from rn = 1 / n: one product and two fused corrections give the
// correctly rounded quotient, as a division would, for the step counts n
// (small whole numbers; checked against IEEE division for n = 1 .. 300).
__device__ __forceinline__ float div_n(float v, float n, float rn) {
  const float q = v * rn;
  return fmaf(fmaf(-q, n, v), rn, q);
}

// x = round(x - v / n) for the rows with j < n, in x's A fragments (rn0,
// rn1: 1 / n of the two rows).
template <int CP>
__device__ __forceinline__ void x_update(uint32_t (&xa)[CP / 16][4],
                                         const float (&v)[CP / 8][4],
                                         float n0, float n1, float rn0,
                                         float rn1, int j) {
#pragma unroll
  for (int kk = 0; kk < CP / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float n = r % 2 ? n1 : n0, rn = r % 2 ? rn1 : rn0;
      const int i = 2 * kk + r / 2, e = 2 * (r % 2);
      if ((float)j < n)
        xa[kk][r] = pack_bf16(lo_f(xa[kk][r]) - div_n(v[i][e], n, rn),
                              hi_f(xa[kk][r]) - div_n(v[i][e + 1], n, rn));
    }
}

// n of flattened position pos; 1 at and past `end`.
__device__ __forceinline__ float pos_n(const float* n_rows, long pos,
                                       long end, int t_len) {
  return pos < end ? n_rows[pos / t_len] : 1.f;
}

// The steps a warp tile runs: min(ms, the largest n among its positions).
__device__ __forceinline__ int tile_steps(float n0, float n1, int ms) {
  return min(ms, (int)ceilf(warp_max(fmaxf(n0, n1))));
}

// Blocks an SM the forward's registers are capped for (128, 168 and 255
// registers a thread at CP <= 64, 96 and 128): as many as its live
// fragments allow without spills.
template <int CP>
constexpr int kFwdBlocks = CP <= 64 ? 4 : CP <= 96 ? 3 : 2;

template <int CP>
__global__ void __launch_bounds__(kMmaThreads, kFwdBlocks<CP>)
    fm_fwd_mma_kernel(
    const bf16* __restrict__ x0, const float* __restrict__ n_rows,
    const bf16* __restrict__ w1, const float* __restrict__ a,
    const float* __restrict__ c, const bf16* __restrict__ w2,
    const float* __restrict__ b2, bf16* __restrict__ xo,
    bf16* __restrict__ vo, long n_pos, int t_len, int cc, int h, int ms) {
  extern __shared__ __align__(16) char smem[];
  const Staged<CP> s = stage_mma<CP>(smem, w1, w2, a, c, b2, cc, h);
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const long n_tiles = (n_pos + kTile - 1) / kTile;
  for (long tile = (long)blockIdx.x * kMmaWarps + warp; tile < n_tiles;
       tile += (long)gridDim.x * kMmaWarps) {
    const long r0 = tile * kTile;
    const float n0 = pos_n(n_rows, r0 + g, n_pos, t_len);
    const float n1 = pos_n(n_rows, r0 + g + 8, n_pos, t_len);
    const float rn0 = 1.f / n0, rn1 = 1.f / n1;
    const int steps = tile_steps(n0, n1, ms);
    uint32_t xa[CP / 16][4];
    load_a<CP>(xa, x0, r0, n_pos, cc, cc, lane);
#pragma unroll 1
    for (int j = 0; j < steps; ++j) {
      float v[CP / 8][4];
      velocity<CP>(v, xa, s, h, (n0 - j) / n0, (n1 - j) / n1, lane);
#pragma unroll
      for (int i = 0; i < CP / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {   // last_v at j == n - 1
          const long row = r0 + g + 4 * e;
          const int col = 8 * i + 2 * q;
          if ((float)j == (e ? n1 : n0) - 1.f && row < n_pos && col < cc)
            *reinterpret_cast<uint32_t*>(vo + row * cc + col) =
                pack_bf16(v[i][e], v[i][e + 1]);
        }
      x_update<CP>(xa, v, n0, n1, rn0, rn1, j);
    }
    store_a<CP>(xo, xa, r0, n_pos, cc, cc, lane);
#pragma unroll
    for (int i = 0; i < CP / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {     // n > ms: last_v stays zero
        const long row = r0 + g + 4 * e;
        const int col = 8 * i + 2 * q;
        if ((e ? n1 : n0) > (float)ms && row < n_pos && col < cc)
          *reinterpret_cast<uint32_t*>(vo + row * cc + col) = 0u;
      }
  }
}

// The workspace of one chunk, bf16: for step j and chunk-local position l,
// row j cpos + l of x (x_j) and dv (round(dv_j)), CP wide, and of h (h_j)
// and dp (round(dp_j)), H wide. cpos: the chunk's positions rounded up to
// a whole tile.
struct Work {
  bf16* x;
  bf16* h;
  bf16* dp;
  bf16* dv;
  long cpos;
};

// n bf16 values (n % 8 == 0) at p zeroed by the warp.
__device__ __forceinline__ void zero_warp(bf16* p, int n, int lane) {
  for (int i = 8 * lane; i < n; i += 8 * 32)
    *reinterpret_cast<uint4*>(p + i) = make_uint4(0u, 0u, 0u, 0u);
}

// Adds the sum of v over the warp's 8 row groups (lanes 4 g + q hold one
// column for every g; a fixed shuffle order) to *slot, from lanes 0 .. 3.
__device__ __forceinline__ void col_sum(float* slot, float v, int lane) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  if (lane < 4) *slot += v;
}

// One chunk's positions [pos_lo, pos_hi): the replay, the backward walk,
// dx, the workspace rows, and the block's partial [da (h) | dc (h) | db2
// (cc)] at part[blockIdx.x].
template <int CP>
__global__ void __launch_bounds__(kMmaThreads) fm_bwd_rows_kernel(
    const bf16* __restrict__ x0, const float* __restrict__ n_rows,
    const bf16* __restrict__ w1, const float* __restrict__ a,
    const float* __restrict__ c, const bf16* __restrict__ w2,
    const float* __restrict__ b2, const bf16* __restrict__ gx_in,
    const bf16* __restrict__ gv_in, bf16* __restrict__ dx, Work wk,
    float* __restrict__ part, long pos_lo, long pos_hi, int t_len, int cc,
    int h, int ms) {
  extern __shared__ __align__(16) char smem[];
  const Staged<CP> s = stage_mma<CP>(smem, w1, w2, a, c, b2, cc, h);
  const int n_sl = 2 * h + CP;
  float* slots = reinterpret_cast<float*>(smem + staged_bytes<CP>(h));
  for (int i = threadIdx.x; i < kMmaWarps * n_sl; i += blockDim.x)
    slots[i] = 0.f;
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  float* sda = slots + warp * n_sl;
  bf16* xs = reinterpret_cast<bf16*>(slots + kMmaWarps * n_sl) +
             warp * 2 * kTile * (CP + 8);   // kTilesShared: x_j, round(dv)
  bf16* dvs = xs + kTile * (CP + 8);
  float* sdc = sda + h;
  float* sdb2 = sdc + h;
  const long n_tiles = (pos_hi - pos_lo + kTile - 1) / kTile;
  for (long tile = (long)blockIdx.x * kMmaWarps + warp; tile < n_tiles;
       tile += (long)gridDim.x * kMmaWarps) {
    const long l0 = tile * kTile, r0 = pos_lo + l0;
    const float n0 = pos_n(n_rows, r0 + g, pos_hi, t_len);
    const float n1 = pos_n(n_rows, r0 + g + 8, pos_hi, t_len);
    const float rn0 = 1.f / n0, rn1 = 1.f / n1;
    const int steps = tile_steps(n0, n1, ms);
    // replay: x_j of steps 0 .. steps - 1 into the workspace
    uint32_t xa[CP / 16][4];
    load_a<CP>(xa, x0, r0, pos_hi, cc, cc, lane);
#pragma unroll 1
    for (int j = 0; j < steps; ++j) {
      store_a<CP>(wk.x + (j * wk.cpos + l0) * CP, xa, 0, kTile, CP, CP, lane);
      if (j + 1 == steps) break;
      float v[CP / 8][4];
      velocity<CP>(v, xa, s, h, (n0 - j) / n0, (n1 - j) / n1, lane);
      x_update<CP>(xa, v, n0, n1, rn0, rn1, j);
    }
    for (int j = steps; j < ms; ++j) {   // steps no row runs add zeros
      const long at = j * wk.cpos + l0;
      zero_warp(wk.x + at * CP, kTile * CP, lane);
      zero_warp(wk.dv + at * CP, kTile * CP, lane);
      zero_warp(wk.h + at * h, kTile * h, lane);
      zero_warp(wk.dp + at * h, kTile * h, lane);
    }

    float gx[CP / 8][4];
#pragma unroll
    for (int i = 0; i < CP / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const long row = r0 + g + 4 * e;
        const int col = 8 * i + 2 * q;
        const uint32_t u =
            (row < pos_hi && col < cc)
                ? *reinterpret_cast<const uint32_t*>(gx_in + row * cc + col)
                : 0u;
        gx[i][e] = lo_f(u);
        gx[i][e + 1] = hi_f(u);
      }
#pragma unroll 1
    for (int j = steps - 1; j >= 0; --j) {
      const long at = j * wk.cpos + l0;
      const float t0 = (n0 - j) / n0, t1 = (n1 - j) / n1;
      load_a<CP>(xa, wk.x + at * CP, 0, kTile, CP, CP, lane);
      uint32_t dva[CP / 16][4];  // round(dv), a k16 slice at a time
#pragma unroll
      for (int kk = 0; kk < CP / 16; ++kk) {
        float dv[2][4];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int e = 0; e < 4; e += 2) {
            const int i = 2 * kk + hf, col = 8 * i + 2 * q;
            const float n = e ? n1 : n0, rn = e ? rn1 : rn0;
            const long row = r0 + g + 4 * e;
            uint32_t u = 0u;
            if ((float)j == n - 1.f && row < pos_hi && col < cc)
              u = *reinterpret_cast<const uint32_t*>(gv_in + row * cc + col);
            const bool live = (float)j < n;
            dv[hf][e] = (live ? div_n(-gx[i][e], n, rn) : 0.f) + lo_f(u);
            dv[hf][e + 1] =
                (live ? div_n(-gx[i][e + 1], n, rn) : 0.f) + hi_f(u);
          }
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            col_sum(sdb2 + 16 * kk + 8 * hf + 2 * q + e,
                    dv[hf][e] + dv[hf][e + 2], lane);
        acc_to_a(dva[kk], dv[0], dv[1]);
      }
      store_a<CP>(wk.dv + at * CP, dva, 0, kTile, CP, CP, lane);
      if constexpr (kTilesShared<CP>) {
        __syncwarp();   // the last step's ldmatrix reads are done
        store_a<CP>(xs, xa, 0, kTile, CP + 8, CP, lane);
        store_a<CP>(dvs, dva, 0, kTile, CP + 8, CP, lane);
        __syncwarp();
      }
      const auto x_frags = walk_frags<CP>(xa, xs, lane);
      const auto dv_frags = walk_frags<CP>(dva, dvs, lane);
#pragma unroll 1
      for (int hc = 0; hc < h; hc += 32) {
        float p[4][4], dh[4][4];
        pre_act<CP>(p, x_frags, s, hc, t0, t1, lane);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) dh[i][e] = 0.f;
        constexpr int kU = decltype(dv_frags)::kUnroll;
#pragma unroll kU
        for (int kk = 0; kk < CP / 16; ++kk) {  // dh = round(dv) W2^T
          uint32_t a[4];
          dv_frags(kk, a);
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            uint32_t b[4];
            ldmatrix_x4(b, s.w2 +
                               (size_t)(hc + 16 * jj + lane % 8 +
                                        (lane / 16) * 8) *
                                   Staged<CP>::kS2 +
                               16 * kk + ((lane / 8) % 2) * 8);
            mma_bf16(dh[2 * jj], a, b[0], b[1]);
            mma_bf16(dh[2 * jj + 1], a, b[2], b[3]);
          }
        }
        uint32_t fa[2][4];
        relu_a(fa, p);                          // h_j
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            *reinterpret_cast<uint32_t*>(
                wk.h + (at + g + 8 * (r % 2)) * h + hc + 16 * ks +
                8 * (r / 2) + 2 * q) = fa[ks][r];
#pragma unroll
        for (int i = 0; i < 4; ++i) {           // dp = dh [p > 0]
#pragma unroll
          for (int e = 0; e < 4; ++e) dh[i][e] = p[i][e] > 0.f ? dh[i][e] : 0.f;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float* at_col = sda + hc + 8 * i + 2 * q + e;
            col_sum(at_col, t0 * dh[i][e] + t1 * dh[i][e + 2], lane);
            col_sum(at_col + h, dh[i][e] + dh[i][e + 2], lane);
          }
        }
        acc_to_a(fa[0], dh[0], dh[1]);          // round(dp)
        acc_to_a(fa[1], dh[2], dh[3]);
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
          for (int r = 0; r < 4; ++r)
            *reinterpret_cast<uint32_t*>(
                wk.dp + (at + g + 8 * (r % 2)) * h + hc + 16 * ks +
                8 * (r / 2) + 2 * q) = fa[ks][r];
#pragma unroll
          for (int jj = 0; jj < CP / 16; ++jj) {  // gx += round(dp) W1x^T
            uint32_t b[4];
            ldmatrix_x4(b, s.w1 +
                               (size_t)(16 * jj + lane % 8 + (lane / 16) * 8) *
                                   s.s1 +
                               hc + 16 * ks + ((lane / 8) % 2) * 8);
            mma_bf16(gx[2 * jj], fa[ks], b[0], b[1]);
            mma_bf16(gx[2 * jj + 1], fa[ks], b[2], b[3]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < CP / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const long row = r0 + g + 4 * e;
        const int col = 8 * i + 2 * q;
        if (row < pos_hi && col < cc)
          *reinterpret_cast<uint32_t*>(dx + row * cc + col) =
              pack_bf16(gx[i][e], gx[i][e + 1]);
      }
  }
  __syncthreads();
  const int n_part = 2 * h + cc;
  for (int i = threadIdx.x; i < n_part; i += blockDim.x) {
    float sum = 0.f;
    for (int w = 0; w < kMmaWarps; ++w) sum += slots[w * n_sl + i];
    part[(size_t)blockIdx.x * n_part + i] = sum;
  }
}

// Weight-gradient partials of workspace rows [blockIdx.y kDwRows, +
// kDwRows): blocks [0, t) tile dW1x (cc, h) = X^T DP, the rest dW2 (h, cc)
// = H^T DV, t = ceil(h / 128) each (gemm.cuh's gemm_tn_tile, 128 x 128
// tiles: CP <= 128, so each operand is read once), into part[blockIdx.y] =
// [dW1x (cc h) | dW2 (h cc)].
__global__ void __launch_bounds__(128) fm_bwd_dw_kernel(
    Work wk, float* __restrict__ part, int m_rows, int cp, int cc, int h) {
  extern __shared__ __align__(16) char smem[];
  const int m_lo = blockIdx.y * kDwRows;
  const int m_hi = min(m_rows, m_lo + kDwRows);
  float* out = part + (size_t)blockIdx.y * 2 * cc * h;
  const int t = (h + 127) / 128;
  const int tile = blockIdx.x;
  if (tile < t) {
    gemm_tn_tile<128>(smem, wk.x, cp, wk.dp, h, false, m_lo, m_hi, 0,
                      128 * tile, [&](int i, int j, float v) {
                        if (i < cc && j < h) out[(size_t)i * h + j] = v;
                      });
  } else {
    float* o2 = out + (size_t)cc * h;
    gemm_tn_tile<128>(smem, wk.h, h, wk.dv, cp, false, m_lo, m_hi,
                      128 * (tile - t), 0, [&](int i, int j, float v) {
                        if (i < h && j < cc) o2[(size_t)i * cc + j] = v;
                      });
  }
}

// out[i] = sum over p in order of parts_a[p][i] (i < na, n_a parts), then
// of parts_b[p][i - na] (n_b parts). Blocks of 32 x 8 threads: column i =
// 32 blockIdx.x + threadIdx.x, row y of the block sums the parts p = y, y
// + 8, ..., then row 0 adds the 8 sums in order.
constexpr int kSumRows = 8;

__global__ void __launch_bounds__(32 * kSumRows) fm_bwd_sum_kernel(
    const float* __restrict__ parts_a, int n_a, int na,
    const float* __restrict__ parts_b, int n_b, int nb,
    float* __restrict__ out) {
  __shared__ float sums[kSumRows][32];
  const int i = blockIdx.x * 32 + threadIdx.x, y = threadIdx.y;
  float s = 0.f;
  if (i < na + nb) {
    const bool in_a = i < na;
    const float* src = in_a ? parts_a + i : parts_b + (i - na);
    const int n = in_a ? n_a : n_b;
    const size_t stride = in_a ? na : nb;
#pragma unroll 4
    for (int p = y; p < n; p += kSumRows) s += src[(size_t)p * stride];
  }
  sums[y][threadIdx.x] = s;
  __syncthreads();
  if (y == 0 && i < na + nb) {
    float total = 0.f;
#pragma unroll
    for (int r = 0; r < kSumRows; ++r) total += sums[r][threadIdx.x];
    out[i] = total;
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// Blocks of `kernel` (with `smem` bytes, which it is allowed here) that fit
// on the current card at once. The attribute and occupancy queries cost
// more than the launches of a call, so they run once per card, kernel and
// size.
std::mutex grid_mu;
std::map<std::tuple<int, const void*, size_t>, int> grids;

template <typename K>
cudaError_t resident_blocks(int& blocks, K kernel, int threads, size_t smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const auto key = std::make_tuple(dev, (const void*)kernel, smem);
  {
    std::lock_guard<std::mutex> lock(grid_mu);
    const auto hit = grids.find(key);
    if (hit != grids.end()) {
      blocks = hit->second;
      return cudaSuccess;
    }
  }
  err = set_smem(kernel, smem);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  blocks = sms * per_sm;
  std::lock_guard<std::mutex> lock(grid_mu);
  grids[key] = blocks;
  return cudaSuccess;
}

// fp32 (C = 88, H = 128): one persistent wave of 8-warp blocks.
int fwd_simt(const void* x0, const float* n, const void* w1, const float* a,
             const float* c, const void* w2, const float* b2, void* xo,
             void* vo, long n_pos, int t_len, int ms, cudaStream_t stream) {
  constexpr int P = kFwdP;
  const size_t smem = sizeof(float) * (kWF + P + (size_t)P * (kC + kH));
  int grid = 0;
  cudaError_t err =
      resident_blocks(grid, fm_fwd_kernel<float, P>, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  fm_fwd_kernel<float, P><<<grid, kThreads, smem, stream>>>(
      (const float*)x0, n, (const float*)w1, a, c, (const float*)w2, b2,
      (float*)xo, (float*)vo, n_pos, t_len, ms);
  return (int)cudaGetLastError();
}

constexpr int kBwdP = 16;   // fp32 backward positions per tile

size_t simt_bwd_smem(int ms) {
  return sizeof(float) * (kWF + kBwdP + (size_t)kBwdP * (2 * kH + kC) +
                          (size_t)ms * kBwdP * kC);
}

int bwd_simt(const void* x0, const float* n, const void* w1, const float* a,
             const float* c, const void* w2, const float* b2, const void* gx,
             const void* gv, void* dx, float* part, float* out, long n_pos,
             int t_len, int ms, cudaStream_t stream) {
  const size_t smem = simt_bwd_smem(ms);
  int grid = 0;
  cudaError_t err =
      resident_blocks(grid, fm_bwd_kernel<float, kBwdP>, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  fm_bwd_kernel<float, kBwdP><<<grid, kThreads, smem, stream>>>(
      (const float*)x0, n, (const float*)w1, a, c, (const float*)w2, b2,
      (const float*)gx, (const float*)gv, (float*)dx, part, n_pos, t_len, ms);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  fm_bwd_sum_kernel<<<(kNP + 31) / 32, dim3(32, kSumRows), 0, stream>>>(
      part, grid, kNP, nullptr, 0, 0, out);
  return (int)cudaGetLastError();
}

// bf16: one persistent wave of 4-warp blocks.
template <int CP>
int fwd_mma(const void* x0, const float* n, const void* w1, const float* a,
            const float* c, const void* w2, const float* b2, void* xo,
            void* vo, long n_pos, int t_len, int cc, int h, int ms,
            cudaStream_t stream) {
  const size_t smem = staged_bytes<CP>(h);
  int grid = 0;
  cudaError_t err =
      resident_blocks(grid, fm_fwd_mma_kernel<CP>, kMmaThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const long tiles = (n_pos + kTile - 1) / kTile;
  grid = (int)std::min<long>(grid, (tiles + kMmaWarps - 1) / kMmaWarps);
  fm_fwd_mma_kernel<CP><<<grid, kMmaThreads, smem, stream>>>(
      (const bf16*)x0, n, (const bf16*)w1, a, c, (const bf16*)w2, b2,
      (bf16*)xo, (bf16*)vo, n_pos, t_len, cc, h, ms);
  return (int)cudaGetLastError();
}

// How the bf16 backward cuts its positions: `grid` blocks of the rows
// kernel; chunks of `tiles` warp tiles (a whole number of rounds of the
// grid's warps where the workspace cap allows it); the workspace bytes of
// one chunk and the scratch bytes in all: the workspace, then the rows
// kernel's partials (chunks x grid x (2 h + cc) floats), then the dW
// partials (n_dw x 2 cc h floats).
struct BwdPlan {
  int grid = 0, chunks = 0;
  long tiles = 0, n_dw = 0;
  size_t entry = 0, work = 0, bytes = 0;
};

template <int CP>
cudaError_t bwd_plan(BwdPlan& pl, long n_pos, int cc, int h, int ms) {
  cudaError_t err = resident_blocks(pl.grid, fm_bwd_rows_kernel<CP>,
                                    kMmaThreads, rows_smem<CP>(h));
  if (err != cudaSuccess) return err;
  const long all = (n_pos + kTile - 1) / kTile;
  const long warps = (long)pl.grid * kMmaWarps;
  pl.entry = 2 * (2 * (size_t)CP + 2 * (size_t)h);  // bytes a (position, step)
  const long fit = std::max<long>(
      1, (long)(kWorkBytes / (pl.entry * ms * kTile)));
  pl.tiles = std::min(all, fit >= warps ? fit / warps * warps : fit);
  pl.chunks = (int)((all + pl.tiles - 1) / pl.tiles);
  pl.grid = (int)std::min<long>(pl.grid, (pl.tiles + kMmaWarps - 1) /
                                              kMmaWarps);
  pl.n_dw = 0;
  for (long k = 0; k < pl.chunks; ++k) {
    const long rows = ms * kTile * std::min(pl.tiles, all - k * pl.tiles);
    pl.n_dw += (rows + kDwRows - 1) / kDwRows;
  }
  pl.work = pl.entry * ms * kTile * pl.tiles;
  pl.bytes = pl.work + sizeof(float) * ((size_t)pl.chunks * pl.grid *
                                            (2 * h + cc) +
                                        (size_t)pl.n_dw * 2 * cc * h);
  return cudaSuccess;
}

template <int CP>
int bwd_mma(const void* x0, const float* n, const void* w1, const float* a,
            const float* c, const void* w2, const float* b2, const void* gx,
            const void* gv, void* dx, char* scratch, float* out, long n_pos,
            int t_len, int cc, int h, int ms, cudaStream_t stream) {
  BwdPlan pl;
  cudaError_t err = bwd_plan<CP>(pl, n_pos, cc, h, ms);
  if (err != cudaSuccess) return (int)err;
  int dw_grid = 0;   // (sets the dw kernel's shared-memory allowance)
  if ((err = resident_blocks(dw_grid, fm_bwd_dw_kernel, 128,
                             tn_smem<128>())) != cudaSuccess)
    return (int)err;
  const int n_cs = 2 * h + cc, n_w = 2 * cc * h;
  float* part_cs = reinterpret_cast<float*>(scratch + pl.work);
  float* part_w = part_cs + (size_t)pl.chunks * pl.grid * n_cs;
  const int t_dw = 2 * ((h + 127) / 128);
  long dw_at = 0;
  for (int k = 0; k < pl.chunks; ++k) {
    const long lo = k * pl.tiles * kTile;
    const long hi = std::min(n_pos, lo + pl.tiles * kTile);
    Work wk;
    wk.cpos = (hi - lo + kTile - 1) / kTile * kTile;
    const size_t rows = (size_t)ms * wk.cpos;
    wk.x = reinterpret_cast<bf16*>(scratch);
    wk.h = wk.x + rows * CP;
    wk.dp = wk.h + rows * h;
    wk.dv = wk.dp + rows * h;
    fm_bwd_rows_kernel<CP><<<pl.grid, kMmaThreads, rows_smem<CP>(h),
                             stream>>>(
        (const bf16*)x0, n, (const bf16*)w1, a, c, (const bf16*)w2, b2,
        (const bf16*)gx, (const bf16*)gv, (bf16*)dx, wk,
        part_cs + (size_t)k * pl.grid * n_cs, lo, hi, t_len, cc, h, ms);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const int subs = (int)((rows + kDwRows - 1) / kDwRows);
    fm_bwd_dw_kernel<<<dim3(t_dw, subs), 128, tn_smem<128>(), stream>>>(
        wk, part_w + (size_t)dw_at * n_w, (int)rows, CP, cc, h);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    dw_at += subs;
  }
  fm_bwd_sum_kernel<<<(n_w + n_cs + 31) / 32, dim3(32, kSumRows), 0,
                      stream>>>(
      part_w, (int)pl.n_dw, n_w, part_cs, pl.chunks * pl.grid, n_cs, out);
  return (int)cudaGetLastError();
}

// f(std::integral_constant<int, CP>) for cc features padded to CP, a
// multiple of 32.
template <class F>
int with_cp(int cc, F f) {
  switch ((cc + 31) / 32) {
    case 1: return f(std::integral_constant<int, 32>());
    case 2: return f(std::integral_constant<int, 64>());
    case 3: return f(std::integral_constant<int, 96>());
    default: return f(std::integral_constant<int, 128>());
  }
}

// What the kernels take: bf16 C % 8 == 0 in [8, 128], H % 32 == 0 in [32,
// 256]; fp32 C = 88, H = 128; 1 <= max_steps <= 16.
bool takes(int bf16_, int cc, int h, int ms) {
  if (ms < 1 || ms > kMaxSteps) return false;
  if (!bf16_) return cc == kC && h == kH;
  return cc % 8 == 0 && cc >= 8 && cc <= kMaxC && h % 32 == 0 && h >= 32 &&
         h <= kMaxH;
}

}  // namespace

// The wrapper guarantees: contiguous, 16-byte aligned tensors on one
// device; x0, xo, vo (rows, t_len, cc), w1 (cc, h) and w2 (h, cc) in one
// dtype (fp32 or bf16); n (rows,) = max(steps, 1), a, c (h) and b2 (cc)
// fp32.
extern "C" int tat_fm_fwd(int bf16_, const void* x0, const void* n,
                          const void* w1, const void* a, const void* c,
                          const void* w2, const void* b2, void* xo, void* vo,
                          int rows, int t_len, int cc, int h, int max_steps,
                          void* stream) {
  if (!takes(bf16_, cc, h, max_steps)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long n_pos = (long)rows * t_len;
  const float *nn = (const float*)n, *aa = (const float*)a,
              *ca = (const float*)c, *bb = (const float*)b2;
  if (!bf16_)
    return fwd_simt(x0, nn, w1, aa, ca, w2, bb, xo, vo, n_pos, t_len,
                    max_steps, s);
  return with_cp(cc, [&](auto cp) {
    return fwd_mma<decltype(cp)::value>(x0, nn, w1, aa, ca, w2, bb, xo, vo,
                                        n_pos, t_len, cc, h, max_steps, s);
  });
}

// The scratch bytes tat_fm_bwd needs for these shapes, into *(long long*)
// bytes.
extern "C" int tat_fm_bwd_scratch(int bf16_, int rows, int t_len, int cc,
                                  int h, int max_steps, void* bytes,
                                  void* stream) {
  (void)stream;
  if (!takes(bf16_, cc, h, max_steps)) return (int)cudaErrorInvalidValue;
  const long n_pos = (long)rows * t_len;
  if (!bf16_) {
    int grid = 0;
    cudaError_t err = resident_blocks(grid, fm_bwd_kernel<float, kBwdP>,
                                      kThreads, simt_bwd_smem(max_steps));
    if (err != cudaSuccess) return (int)err;
    *(long long*)bytes = (long long)sizeof(float) * grid * kNP;
    return 0;
  }
  return with_cp(cc, [&](auto cp) {
    BwdPlan pl;
    cudaError_t err =
        bwd_plan<decltype(cp)::value>(pl, n_pos, cc, h, max_steps);
    if (err == cudaSuccess) *(long long*)bytes = (long long)pl.bytes;
    return (int)err;
  });
}

// As tat_fm_fwd, plus the cotangents gx, gv and the output dx (like x0),
// the scratch (tat_fm_bwd_scratch bytes, 16-byte aligned) and the fp32
// gradients out = [dW1x (cc, h) | dW2 (h, cc) | da (h) | dc (h) | db2
// (cc)].
extern "C" int tat_fm_bwd(int bf16_, const void* x0, const void* n,
                          const void* w1, const void* a, const void* c,
                          const void* w2, const void* b2, const void* gx,
                          const void* gv, void* dx, void* scratch, void* out,
                          int rows, int t_len, int cc, int h, int max_steps,
                          void* stream) {
  if (!takes(bf16_, cc, h, max_steps)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long n_pos = (long)rows * t_len;
  const float *nn = (const float*)n, *aa = (const float*)a,
              *ca = (const float*)c, *bb = (const float*)b2;
  float* oo = (float*)out;
  if (!bf16_)
    return bwd_simt(x0, nn, w1, aa, ca, w2, bb, gx, gv, dx, (float*)scratch,
                    oo, n_pos, t_len, max_steps, s);
  return with_cp(cc, [&](auto cp) {
    return bwd_mma<decltype(cp)::value>(x0, nn, w1, aa, ca, w2, bb, gx, gv,
                                        dx, (char*)scratch, oo, n_pos, t_len,
                                        cc, h, max_steps, s);
  });
}
