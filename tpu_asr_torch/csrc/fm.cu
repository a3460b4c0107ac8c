// Flow-matching Euler loop of the `mlp` meta encoder, forward and backward.
// Per feature position (row r, frame t), with n = max(steps[r], 1):
//   for j = 0 .. max_steps - 1:    t_j = (n - j) / n
//     h = round(relu(x W1x + t_j a + c))       (C = 88 -> H = 128)
//     v = round(h W2 + b2)                     (H -> C)
//     x = round(x - v / n)   while j < n
//   last_v = v at j == n - 1
// where round is a round trip through the compute type T (none for fp32).
//
// Replaces tpu_asr/ops/pallas_fm.py::_fm_fwd_kernel and ::_fm_bwd_kernel,
// launched by ops/cuda_fm.py::fused_fm_euler and ::fused_fm_euler_bwd.
//
// What bounds it on an H100: at the flagship's rows = 32 x 16 layers,
// T' = 376, 8 steps the forward is 4 ms rows T C H = 69.4 GFLOP against
// 101.6 MB in and out (bf16), the backward 12 ms rows T C H = 208 GFLOP
// against 135.5 MB: both bound by operations, if x, h and v never leave the
// chip between steps.
//
// Design, plain SIMT with fp32 accumulation. Every position is its own
// recurrence and only the weights are shared, so positions are cut into
// tiles of P freely, with no padding of T. One persistent block per SM
// stages W1x, W2 (fp32, odd row strides so that a warp reading a row or a
// column hits 32 banks), a, c and b2 in shared memory once and walks over
// tiles. 8 warps; in the position products warp w owns rows w R .. w R +
// R - 1 (R = P / 8) and lane l the columns l + 32 j.
//   forward (P = 64) - x stays in registers and in a shared tile for all
//     steps; h lives in a shared tile. Device memory sees one read of x0
//     and one write each of x_final and last_v. A tile stops after the
//     largest step count among its rows.
//   backward (P = 32 in bf16, 16 in fp32) - replays the forward and keeps
//     each step's input x_j of the tile in shared memory in T (max_steps x
//     P x 88, 90 KB at 16 steps), then walks j = steps - 1 .. 0 as
//     _fm_bwd_kernel does: dv = (j < n ? -gx / n : 0) + (j == n - 1 ? gv :
//     0); dh = round(dv) W2^T; dp = dh [p > 0]; gx += round(dp) W1x^T;
//     dW2 += h^T round(dv), dW1x += x_j^T round(dp), db2 += dv, da += t dp,
//     dc += dp. Each thread owns 4 x 11 cells of dW1x and of dW2 in
//     registers for all its tiles; one partial per block, summed over
//     blocks in a fixed order by fm_partial_sum_kernel: no atomics, so the
//     gradients are bit-equal from call to call.

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
template <typename T>
__device__ __forceinline__ float rnd(float x) { return to_f(from_f<T>(x)); }

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

// out[i] = sum_p part[p * n + i], p in order.
__global__ void fm_partial_sum_kernel(const float* __restrict__ part,
                                 float* __restrict__ out, int n_parts, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int p = 0; p < n_parts; ++p) s += part[(size_t)p * n + i];
  out[i] = s;
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T>
int fwd(const void* x0, const float* n, const void* w1, const float* a,
        const float* c, const void* w2, const float* b2, void* xo, void* vo,
        long n_pos, int t_len, int ms, int grid, cudaStream_t stream) {
  constexpr int P = kFwdP;
  const size_t smem = sizeof(float) * (kWF + P + (size_t)P * (kC + kH));
  cudaError_t err = set_smem(fm_fwd_kernel<T, P>, smem);
  if (err != cudaSuccess) return (int)err;
  fm_fwd_kernel<T, P><<<grid, kThreads, smem, stream>>>(
      (const T*)x0, n, (const T*)w1, a, c, (const T*)w2, b2, (T*)xo,
      (T*)vo, n_pos, t_len, ms);
  return (int)cudaGetLastError();
}

template <typename T, int P>
int bwd(const void* x0, const float* n, const void* w1, const float* a,
        const float* c, const void* w2, const float* b2, const void* gx,
        const void* gv, void* dx, float* part, float* out, long n_pos,
        int t_len, int ms, int grid, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (kWF + P + (size_t)P * (2 * kH + kC)) +
                      sizeof(T) * (size_t)ms * P * kC;
  cudaError_t err = set_smem(fm_bwd_kernel<T, P>, smem);
  if (err != cudaSuccess) return (int)err;
  fm_bwd_kernel<T, P><<<grid, kThreads, smem, stream>>>(
      (const T*)x0, n, (const T*)w1, a, c, (const T*)w2, b2, (const T*)gx,
      (const T*)gv, (T*)dx, part, n_pos, t_len, ms);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  fm_partial_sum_kernel<<<(kNP + 255) / 256, 256, 0, stream>>>(part, out, grid,
                                                           kNP);
  return (int)cudaGetLastError();
}

}  // namespace

// The wrapper guarantees: contiguous tensors on one device; x0, xo, vo
// (rows, t_len, 88), w1 (88, 128) and w2 (128, 88) in one dtype (fp32 or
// bf16); n (rows,) = max(steps, 1), a, c (128) and b2 (88) fp32;
// 1 <= max_steps <= 16.
extern "C" int tat_fm_fwd(int bf16, const void* x0, const void* n,
                          const void* w1, const void* a, const void* c,
                          const void* w2, const void* b2, void* xo, void* vo,
                          int rows, int t_len, int max_steps, int grid,
                          void* stream) {
  if (max_steps < 1 || max_steps > kMaxSteps || grid < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long n_pos = (long)rows * t_len;
  const float *nn = (const float*)n, *aa = (const float*)a,
              *cc = (const float*)c, *bb = (const float*)b2;
  return bf16 ? fwd<__nv_bfloat16>(x0, nn, w1, aa, cc, w2, bb, xo, vo, n_pos,
                                   t_len, max_steps, grid, s)
              : fwd<float>(x0, nn, w1, aa, cc, w2, bb, xo, vo, n_pos, t_len,
                           max_steps, grid, s);
}

// As tat_fm_fwd, plus the cotangents gx, gv and the output dx (like x0);
// fp32 scratch part (grid, 2 * 88 * 128 + 2 * 128 + 88) and out (the same
// row): dW1x (88, 128), dW2 (128, 88), da (128), dc (128), db2 (88).
extern "C" int tat_fm_bwd(int bf16, const void* x0, const void* n,
                          const void* w1, const void* a, const void* c,
                          const void* w2, const void* b2, const void* gx,
                          const void* gv, void* dx, void* part, void* out,
                          int rows, int t_len, int max_steps, int grid,
                          void* stream) {
  if (max_steps < 1 || max_steps > kMaxSteps || grid < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long n_pos = (long)rows * t_len;
  const float *nn = (const float*)n, *aa = (const float*)a,
              *cc = (const float*)c, *bb = (const float*)b2;
  float *pp = (float*)part, *oo = (float*)out;
  return bf16 ? bwd<__nv_bfloat16, 32>(x0, nn, w1, aa, cc, w2, bb, gx, gv,
                                       dx, pp, oo, n_pos, t_len, max_steps,
                                       grid, s)
              : bwd<float, 16>(x0, nn, w1, aa, cc, w2, bb, gx, gv, dx, pp, oo,
                               n_pos, t_len, max_steps, grid, s);
}
