// Row-tile building blocks of 256-thread blocks that own 32 rows (8 warps x
// 4 rows): a product of an fp32 tile in shared memory with a weight matrix
// staged through shared memory in 32-deep chunks, and flax's LayerNorm of
// the tile's rows. Used by the fused Conformer layer (layer.cu).
#pragma once

#include "common.cuh"

namespace {

constexpr int kRT = 32;       // rows per tile: 8 warps x kRows
constexpr int kNC = 128;      // output columns per pass: 32 lanes x 4
constexpr int kKC = 32;       // reduction chunk staged in shared memory
constexpr int kWS = kNC + 1;  // staged weight row stride (odd)

// Stage W[n0 + c][k0 + kk] of a row-major (N, K) W as ws[kk * kWS + c].
template <typename T>
__device__ void stage_nk(float* ws, const T* w, int n0, int n, int k0,
                         int k) {
  for (int i = threadIdx.x; i < kNC * kKC; i += blockDim.x) {
    const int c = i / kKC, kk = i - c * kKC;
    const int r = n0 + c, col = k0 + kk;
    ws[kk * kWS + c] = (r < n && col < k) ? to_f(w[(size_t)r * k + col]) : 0.f;
  }
}

// Stage W[k0 + kk][n0 + c] of a row-major (K, N) W as ws[kk * kWS + c].
template <typename T>
__device__ void stage_kn(float* ws, const T* w, int n0, int n, int k0,
                         int k) {
  for (int i = threadIdx.x; i < kNC * kKC; i += blockDim.x) {
    const int kk = i / kNC, c = i - kk * kNC;
    const int r = k0 + kk, col = n0 + c;
    ws[kk * kWS + c] = (r < k && col < n) ? to_f(w[(size_t)r * n + col]) : 0.f;
  }
}

// acc[i][j] = sum_{k < K} a[(4 warp + i) * lda + k] * W(k, n0 + lane + 32 j)
// for a row-major (N, K) W (KN = false) or (K, N) W (KN = true). `a` is an
// fp32 tile in shared memory. Starts and ends with a block barrier.
template <typename T, bool KN>
__device__ void tile_product(float (&acc)[kRows][4], const float* a, int lda,
                             const T* w, int n0, int n, int k, float* ws) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < k; k0 += kKC) {
    __syncthreads();  // ws and the a tile are ready / consumed
    if (KN)
      stage_kn<T>(ws, w, n0, n, k0, k);
    else
      stage_nk<T>(ws, w, n0, n, k0, k);
    __syncthreads();
    const int kn = min(kKC, k - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float av[kRows], wv[4];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        av[i] = a[(warp * kRows + i) * lda + k0 + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = ws[kk * kWS + lane + 32 * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
    }
  }
  __syncthreads();
}

// flax LayerNorm of rows m0 .. m0 + 31 of x (row stride d; zero past
// m_rows): y rounded to T into ys; optionally xhat into xh and 1 / std
// into rs. One warp per row, lane c + 32 j holding column c + 32 j, any d.
template <typename T, typename S = T>
__device__ void ln_rows(const S* x, const float* lnw, const float* lnb,
                        int m0, int m_rows, int d, float* ys, float* xh,
                        float* rs) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = 0; i < kRows; ++i) {
    const int row = warp * kRows + i, m = m0 + row;
    const bool in = m < m_rows;
    float s = 0.f, s2 = 0.f;
    for (int c = lane; c < d; c += 32) {
      const float v = in ? to_f(x[(size_t)m * d + c]) : 0.f;
      s += v;
      s2 += v * v;
    }
    s = warp_sum(s);
    s2 = warp_sum(s2);
    const float mu = s / d, r = rsqrtf(s2 / d - mu * mu + 1e-6f);
    for (int c = lane; c < d; c += 32) {
      const float v = in ? to_f(x[(size_t)m * d + c]) : 0.f;
      const float xhat = (v - mu) * r;
      ys[row * d + c] = rnd<T>(xhat * lnw[c] + lnb[c]);
      if (xh) xh[row * d + c] = xhat;
    }
    if (rs && lane == 0) rs[row] = r;
  }
}

}  // namespace
