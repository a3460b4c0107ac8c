// Conformer feed-forward sublayer for int8 serving (eval only), per row:
//   y  = LN(x) in fp32 (E[x^2] - E[x]^2, eps 1e-6), not rounded
//   sx = max(max|y|, 1e-8 * 127) * (1 / 127);  yq = clip(rint(y / sx), +-127)
//   h  = silu(int32(yq . W1q) * sx * s1 + b1)                       fp32
//   sh = max(max|h|, 1e-8 * 127) * (1 / 127);  hq = clip(rint(h / sh), +-127)
//   o  = int32(hq . W2q) * sh * s2 + b2
//   out = x + 0.5 o, rounded to x's type (fp32 or bf16)
// with per-output-channel int8 weights W1q (f, d), W2q (d, f) and their fp32
// scales s1 (f), s2 (d), quantized once per weight version by the wrapper
// (ops/cuda_ffn.py::_int8_weights, the arithmetic of ops/quant.py).
//
// Replaces tpu_asr/ops/pallas_ffn.py::_ffn_int8_kernel, launched by
// ops/cuda_ffn.py::fused_ffn_sublayer_int8.
//
// What bounds it on an H100: at B=32, T'=376, D=176, d_ff=704 the two
// products are 4 M D d_ff = 5.96 G int8 operations (3.0 us at the 1,979 TOP/s
// int8 tensor rate) against 8.5 MB of bf16 x in and out (2.5 us at
// 3.35 TB/s): operations, if the per-token scales and the (M, d_ff)
// activation never reach device memory. In practice each row tile waits on
// its weight stream from L2.
//
// Design: one block of 8 warps per 16 rows, three blocks an SM, no barrier
// inside a product. LN with one warp per 2 rows, their loads in flight
// together, into an int8 row tile yq in shared memory. Each product is the
// row tile times W^T on mma.sync m16n8k32 s8 x s8 -> s32 (exact int32
// sums): a warp owns 32 output columns (four n8 tiles) of a 256-column
// pass, its B fragments read straight from the int8 weights in L2 (8
// contiguous bytes a thread), the next 32-deep step's in flight while this
// one's products run. A and B take the same k permutation inside a 32-deep
// step (physical k 8 t + i feeds logical k 4 t + i, 8 t + 4 + i feeds
// 16 + 4 t + i), which leaves the sum unchanged. h is computed once, into
// an fp32 tile (the per-token scale needs the whole d_ff row); one warp per
// row then takes the row's maximum and quantizes the row in place, front to
// back, into the int8 tile hq that product 2 reads. Tile rows lie 32 (mod
// 64) bytes apart, so the 8-byte fragment loads of a half-warp fall on 32
// distinct banks. Shared memory: 49,280 B at d176 / 704, 140,416 B at
// d512 / 2048. 32-row blocks (two m16 tiles a warp) and a cp.async weight
// ring measured slower at the serve shape (PERF.md). Products and sums
// round as the plain version does: no contraction of a multiply and an add
// into one fma.

#include <cuda_runtime.h>
#include <stdint.h>

#include <math.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kWarps = 8, kThreads = 32 * kWarps;
constexpr int kNW = 32;            // output columns per warp and pass
constexpr int kNP = kWarps * kNW;  // output columns per pass
constexpr int kMaxD = 512, kMaxF = 2048;
constexpr int kMaxDJ = kMaxD / 32;  // LN values per lane
constexpr int kBM = 16;             // rows per block: one m16 tile
constexpr int kRW = kBM / kWarps;   // LN and quantization rows a warp

// Columns rounded up to the mma depth, and the row stride (bytes) of a
// tile whose rows hold `bytes`: 32 (mod 64).
__host__ __device__ inline int pad32(int k) { return (k + 31) / 32 * 32; }
__host__ __device__ inline int q_stride(int bytes) {
  const int b = pad32(bytes);
  return b % 64 == 0 ? b + 32 : b;
}
// The h tile's row stride: fp32 h, then hq (pad32(f) bytes) in place.
__host__ __device__ inline int h_stride(int f) {
  return q_stride(4 * f > pad32(f) ? 4 * f : pad32(f));
}

size_t smem_bytes(int d, int f) {
  return (size_t)kBM * (h_stride(f) + q_stride(pad32(d))) +
         sizeof(float) * 2 * kBM;
}

// max(amax, 1e-8 * 127) * (1 / 127), as the Pallas kernel writes it.
__device__ __forceinline__ float act_scale(float amax) {
  return __fmul_rn(fmaxf(amax, (float)(1e-8 * 127.0)), 1.0f / 127.0f);
}
// clip(rint(v * inv), -127, 127); rintf rounds half to even.
__device__ __forceinline__ int8_t quant(float v, float inv) {
  const float q = fminf(fmaxf(rintf(__fmul_rn(v, inv)), -127.f), 127.f);
  return (int8_t)(int)q;
}
// silu(acc * sx * s1 + b1), every step rounded.
__device__ __forceinline__ float hidden(int acc, float sx, float s1,
                                        float b1) {
  const float h = __fadd_rn(__fmul_rn(__fmul_rn((float)acc, sx), s1), b1);
  return __fmul_rn(h, 1.f / (1.f + expf(-h)));
}

// acc[j] = rows 0..15 of A (int8 in shared memory, stride sa bytes, kp
// columns) times columns nb + 8 j + (0..7) of W^T; W (n_rows, kp) int8 in
// device memory, rows past n_rows read as 0. Fragment (lane = 4 g + t):
// acc[j][0, 1] row g, columns nb + 8 j + 2 t + 0, 1; acc[j][2, 3] row g + 8.
__device__ __forceinline__ void product(int (&acc)[4][4], const int8_t* a,
                                        int sa, const int8_t* __restrict__ w,
                                        int nb, int n_rows, int kp) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0;
  const int8_t* a0 = a + g * sa + 8 * t;
  const int8_t* wr[4];
  bool ok[4];
  uint2 b[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = nb + 8 * j + g;
    ok[j] = n < n_rows;
    wr[j] = w + (size_t)(ok[j] ? n : 0) * kp + 8 * t;
    b[j] = ok[j] ? __ldg(reinterpret_cast<const uint2*>(wr[j]))
                 : make_uint2(0u, 0u);
  }
  for (int k0 = 0; k0 < kp; k0 += 32) {
    const int k1 = k0 + 32 < kp ? k0 + 32 : k0;
    uint2 nx[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      nx[j] = ok[j] ? __ldg(reinterpret_cast<const uint2*>(wr[j] + k1))
                    : make_uint2(0u, 0u);
    const uint2 lo = *reinterpret_cast<const uint2*>(a0 + k0);
    const uint2 hi = *reinterpret_cast<const uint2*>(a0 + 8 * sa + k0);
    const uint32_t af[4] = {lo.x, hi.x, lo.y, hi.y};
#pragma unroll
    for (int j = 0; j < 4; ++j) mma_s8(acc[j], af, b[j].x, b[j].y);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = nx[j];
  }
}

// LN and per-token quantization of R rows (r0 ..) by one warp, their loads
// in flight together: yq rows (zero past d) and their scales sx.
template <int R, typename T>
__device__ __forceinline__ void ln_quant(const T* x, const float* lnw,
                                         const float* lnb, int8_t* yq,
                                         int sa, float* sx, int m0, int r0,
                                         int m_rows, int d) {
  const int lane = threadIdx.x % 32, dp = pad32(d), nj = (d + 31) / 32;
  float v[R][kMaxDJ];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int m = m0 + r0 + q;
#pragma unroll
    for (int j = 0; j < kMaxDJ; ++j) {
      const int c = lane + 32 * j;
      v[q][j] = 0.f;
      if (j < nj && m < m_rows && c < d) v[q][j] = to_f(x[(size_t)m * d + c]);
    }
  }
#pragma unroll
  for (int q = 0; q < R; ++q) {
    float s = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxDJ; ++j) {
      if (j >= nj) break;
      s = __fadd_rn(s, v[q][j]);
      s2 = __fadd_rn(s2, __fmul_rn(v[q][j], v[q][j]));
    }
    s = warp_sum(s);
    s2 = warp_sum(s2);
    const float mu = s / d;
    const float r = 1.f / sqrtf(__fadd_rn(__fsub_rn(s2 / d, __fmul_rn(mu, mu)),
                                          1e-6f));
    float amax = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxDJ; ++j) {
      const int c = lane + 32 * j;
      if (j >= nj) break;
      v[q][j] = c < d ? __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[q][j], mu),
                                                      r),
                                            lnw[c]), lnb[c])
                      : 0.f;
      amax = fmaxf(amax, fabsf(v[q][j]));
    }
    const float scale = act_scale(warp_max(amax)), inv = 1.f / scale;
#pragma unroll
    for (int j = 0; j < kMaxDJ; ++j) {
      const int c = lane + 32 * j;
      if (j >= nj) break;
      if (c < dp)
        yq[(r0 + q) * sa + c] = c < d ? quant(v[q][j], inv) : (int8_t)0;
    }
    if (lane == 0) sx[r0 + q] = scale;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 3) ffn_int8_kernel(
    const T* __restrict__ x, const float* __restrict__ lnw,
    const float* __restrict__ lnb, const int8_t* __restrict__ w1q,
    const float* __restrict__ s1, const float* __restrict__ b1,
    const int8_t* __restrict__ w2q, const float* __restrict__ s2,
    const float* __restrict__ b2, T* __restrict__ out, int m_rows, int d,
    int f) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int dp = pad32(d), fp = pad32(f);
  const int sa = q_stride(dp), sh_b = h_stride(f);
  unsigned char* hs = smem;                              // kBM x sh_b
  int8_t* yq = reinterpret_cast<int8_t*>(hs + kBM * sh_b);  // kBM x sa
  float* sx = reinterpret_cast<float*>(yq + kBM * sa);   // kBM
  float* sh = sx + kBM;                                  // kBM
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * kBM;

  ln_quant<kRW>(x, lnw, lnb, yq, sa, sx, m0, warp * kRW, m_rows, d);
  __syncthreads();

  // h = silu(dequant(yq W1q^T) + b1), fp32 rows in shared memory
  int acc[4][4];
  for (int n0 = 0; n0 < f; n0 += kNP) {
    const int nb = n0 + warp * kNW;
    if (nb >= f) break;
    product(acc, yq, sa, w1q, nb, f, dp);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = nb + 8 * j + 2 * t;
      if (col >= f) continue;
      const bool two = col + 1 < f;
      const float sc0 = s1[col], bc0 = b1[col];
      const float sc1 = two ? s1[col + 1] : 0.f, bc1 = two ? b1[col + 1] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = g + 8 * h;
        float* hr = reinterpret_cast<float*>(hs + row * sh_b) + col;
        const float v0 = hidden(acc[j][2 * h], sx[row], sc0, bc0);
        if (two)
          *reinterpret_cast<float2*>(hr) =
              make_float2(v0, hidden(acc[j][2 * h + 1], sx[row], sc1, bc1));
        else
          *hr = v0;
      }
    }
  }
  __syncthreads();

  // per-token quantization of h, one warp per row, in place: the bytes a
  // step of 128 columns writes overlay floats that step or an earlier one
  // has read
  for (int i = 0; i < kRW; ++i) {
    const int row = warp * kRW + i;
    const float* hr = reinterpret_cast<const float*>(hs + row * sh_b);
    int8_t* qr = reinterpret_cast<int8_t*>(hs + row * sh_b);
    float am[4] = {0.f, 0.f, 0.f, 0.f};
    for (int c0 = 0; c0 < f; c0 += 128)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = c0 + 32 * u + lane;
        if (c < f) am[u] = fmaxf(am[u], fabsf(hr[c]));
      }
    const float scale =
        act_scale(warp_max(fmaxf(fmaxf(am[0], am[1]), fmaxf(am[2], am[3]))));
    const float inv = 1.f / scale;
    for (int c0 = 0; c0 < fp; c0 += 128) {
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = c0 + 32 * u + lane;
        v[u] = c < f ? hr[c] : 0.f;
      }
      __syncwarp();
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = c0 + 32 * u + lane;
        if (c < fp) qr[c] = c < f ? quant(v[u], inv) : (int8_t)0;
      }
    }
    if (lane == 0) sh[row] = scale;
  }
  __syncthreads();

  // out = x + 0.5 (dequant(hq W2q^T) + b2)
  const int8_t* hq = reinterpret_cast<const int8_t*>(hs);
  for (int n0 = 0; n0 < d; n0 += kNP) {
    const int nb = n0 + warp * kNW;
    if (nb >= d) break;
    product(acc, hq, sh_b, w2q, nb, d, fp);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int col = nb + 8 * j + 2 * t + u;
        if (col >= d) continue;
        const float sc = s2[col], bc = b2[col];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = g + 8 * h, m = m0 + row;
          if (m >= m_rows) continue;
          const float o = __fadd_rn(
              __fmul_rn(__fmul_rn((float)acc[j][2 * h + u], sh[row]), sc),
              bc);
          const size_t at = (size_t)m * d + col;
          out[at] = from_f<T>(__fadd_rn(to_f(x[at]), __fmul_rn(0.5f, o)));
        }
      }
  }
}

template <typename T>
int launch(const void* x, const float* lnw, const float* lnb,
           const int8_t* w1q, const float* s1, const float* b1,
           const int8_t* w2q, const float* s2, const float* b2, void* out,
           int m_rows, int d, int f, cudaStream_t stream) {
  const size_t smem = smem_bytes(d, f);
  cudaError_t err = cudaFuncSetAttribute(
      ffn_int8_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  ffn_int8_kernel<T><<<(m_rows + kBM - 1) / kBM, kThreads, smem, stream>>>(
      (const T*)x, lnw, lnb, w1q, s1, b1, w2q, s2, b2, (T*)out, m_rows, d, f);
  return (int)cudaGetLastError();
}

}  // namespace

// The wrapper guarantees: contiguous tensors on one device; x and out
// (m_rows, d) in one dtype (fp32 or bf16); LN scale/bias, s1, b1 (f), s2,
// b2 (d) fp32; w1q (f, pad32(d)) and w2q (d, pad32(f)) int8, zero past d
// and f; 1 <= d <= 512, 1 <= f <= 2048.
extern "C" int tat_ffn_int8(int bf16, const void* x, const void* lnw,
                            const void* lnb, const void* w1q, const void* s1,
                            const void* b1, const void* w2q, const void* s2,
                            const void* b2, void* out, int m_rows, int d,
                            int f, void* stream) {
  if (d < 1 || d > kMaxD || f < 1 || f > kMaxF)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  auto F = [](const void* p) { return (const float*)p; };
  auto Q = [](const void* p) { return (const int8_t*)p; };
  return bf16 ? launch<__nv_bfloat16>(x, F(lnw), F(lnb), Q(w1q), F(s1), F(b1),
                                      Q(w2q), F(s2), F(b2), out, m_rows, d, f,
                                      s)
              : launch<float>(x, F(lnw), F(lnb), Q(w1q), F(s1), F(b1), Q(w2q),
                              F(s2), F(b2), out, m_rows, d, f, s);
}
