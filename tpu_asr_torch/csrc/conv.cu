// Conformer convolution module, eval path, on one (B, T, D) tensor:
//   g   = GLU(x W1^T + b1)                          pointwise D -> 2D, GLU
//   g   = 0 on frames whose mask is false
//   a   = sum_j g[t + j - pad_l] wd[j] + bd         depthwise, k taps, frames
//                                                    outside [0, T) read 0
//   y   = a nw + nb (folded BatchNorm)  or  LayerNorm over D (eps 1e-6,
//         E[a^2] - E[a]^2 clipped at 0) with scale nw and bias nb
//   out = silu(y) W2^T + b2                         pointwise D -> D
// No masking after pointwise 2: the layer masks its output.
//
// Replaces tpu_asr/ops/pallas_conv.py::_conv_kernel, launched by
// ops/cuda_conv.py::fused_conv_module.
//
// What bounds it on an H100: at B=32, T'=376, D=176, k=31 the module is
// 2 M (2 D^2 + D^2 + k D) = 2.37 GFLOP (2.4 us at the bf16 tensor rate,
// 35 us at the fp32 SIMT rate) against 8.5 MB of bf16 x in and out
// (2.5 us): bytes in bf16, if the (M, 2D) and (M, D) intermediates never
// reach device memory.
//
// Design, plain SIMT with fp32 accumulation: one block of 8 warps per
// (batch row, 32 output frames). Pointwise 1 + GLU for the tile and its
// k - 1 halo frames (64 rows, so k <= 33) into shared memory in fp32, x and
// W1 staged through shared memory in 32-deep chunks, a lane computing 2
// GLU channels (their linear and gate halves) of 8 rows. Then the k taps
// per channel, the norm (one warp per row), SiLU, and pointwise 2 from
// shared memory. Operands are in x's type (fp32 or bf16); the SiLU output
// is rounded to it before pointwise 2, where the Pallas kernel rounds its
// dot operands. Intermediates stay fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

constexpr int kTT = 32;          // output frames per block
constexpr int kR1 = 64;          // GLU rows per block: kTT + k - 1 <= kR1
constexpr int kWarps = 8;
constexpr int kRW1 = kR1 / kWarps;  // GLU rows per warp
constexpr int kRW2 = kTT / kWarps;  // output rows per warp
constexpr int kKC = 32;          // reduction chunk staged in shared memory
constexpr int kAS = kKC + 1;     // staged x row stride
constexpr int kNC = 128;         // staged weight columns
constexpr int kWS = kNC + 1;     // staged weight row stride
constexpr int kMaxD = 512, kMaxK = kR1 - kTT + 1;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
}

template <typename T>
__global__ void __launch_bounds__(256) conv_module_kernel(
    const T* __restrict__ x, const uint8_t* __restrict__ mask,
    const T* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ wd, const float* __restrict__ bd,
    const float* __restrict__ nw, const float* __restrict__ nb,
    const T* __restrict__ w2, const float* __restrict__ b2,
    T* __restrict__ out, int t_len, int d, int k, int pad_l,
    int layer_norm) {
  extern __shared__ float sm[];
  float* gs = sm;                 // kR1 x d: GLU output, frames t0 - pad_l ..
  float* as = gs + kR1 * d;       // kTT x d: depthwise, then silu(norm)
  float* xs = as + kTT * d;       // kR1 x kAS: staged x chunk
  float* ws = xs + kR1 * kAS;     // kKC x kWS: staged weight chunk
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.y, t0 = blockIdx.x * kTT, f0 = t0 - pad_l;
  const T* xb = x + (size_t)b * t_len * d;
  const uint8_t* mb = mask + (size_t)b * t_len;

  // pointwise 1 + GLU + mask, 64 GLU channels per pass: lane channels
  // c0 = n0 + lane, c1 = c0 + 32; weight columns 0..63 linear, 64..127 gate
  for (int n0 = 0; n0 < d; n0 += kNC / 2) {
    float acc[kRW1][4];
#pragma unroll
    for (int i = 0; i < kRW1; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < d; k0 += kKC) {
      __syncthreads();
      for (int i = threadIdx.x; i < kR1 * kKC; i += blockDim.x) {
        const int r = i / kKC, kk = i - r * kKC, fr = f0 + r, col = k0 + kk;
        xs[r * kAS + kk] = (fr >= 0 && fr < t_len && col < d)
                               ? to_f(xb[(size_t)fr * d + col]) : 0.f;
      }
      for (int i = threadIdx.x; i < kNC * kKC; i += blockDim.x) {
        const int c = i / kKC, kk = i - c * kKC, col = k0 + kk;
        const int ch = n0 + (c & (kNC / 2 - 1));
        const int n = c < kNC / 2 ? ch : d + ch;
        ws[kk * kWS + c] = (ch < d && col < d)
                               ? to_f(w1[(size_t)n * d + col]) : 0.f;
      }
      __syncthreads();
      const int kn = min(kKC, d - k0);
      for (int kk = 0; kk < kn; ++kk) {
        float wv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) wv[j] = ws[kk * kWS + lane + 32 * j];
#pragma unroll
        for (int i = 0; i < kRW1; ++i) {
          const float av = xs[(warp * kRW1 + i) * kAS + kk];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av, wv[j], acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRW1; ++i) {
      const int r = warp * kRW1 + i, fr = f0 + r;
      const bool live = fr >= 0 && fr < t_len && mb[fr];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = n0 + lane + 32 * j;
        if (c >= d) continue;
        const float lin = acc[i][j] + b1[c], gate = acc[i][j + 2] + b1[d + c];
        gs[r * d + c] = live ? lin * sigmoid(gate) : 0.f;
      }
    }
  }
  __syncthreads();

  // depthwise conv over time + bias
  for (int i = threadIdx.x; i < kTT * d; i += blockDim.x) {
    const int r = i / d, c = i - r * d;
    float a = 0.f;
    for (int j = 0; j < k; ++j)
      a = fmaf(gs[(r + j) * d + c], wd[j * d + c], a);
    as[i] = a + bd[c];
  }
  __syncthreads();

  // norm + SiLU, rounded to the operand type, one warp per row
  for (int r = warp; r < kTT; r += kWarps) {
    float* row = as + r * d;
    float mu = 0.f, rs = 1.f;
    if (layer_norm) {
      float s = 0.f, s2 = 0.f;
      for (int c = lane; c < d; c += 32) {
        s += row[c];
        s2 += row[c] * row[c];
      }
      mu = warp_sum(s) / d;
      rs = 1.f / sqrtf(fmaxf(warp_sum(s2) / d - mu * mu, 0.f) + 1e-6f);
    }
    for (int c = lane; c < d; c += 32) {
      const float y = layer_norm ? (row[c] - mu) * rs * nw[c] + nb[c]
                                 : row[c] * nw[c] + nb[c];
      row[c] = rnd<T>(y * sigmoid(y));
    }
  }

  // pointwise 2, 128 output columns per pass
  for (int n0 = 0; n0 < d; n0 += kNC) {
    float acc[kRW2][4];
#pragma unroll
    for (int i = 0; i < kRW2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < d; k0 += kKC) {
      __syncthreads();
      for (int i = threadIdx.x; i < kNC * kKC; i += blockDim.x) {
        const int c = i / kKC, kk = i - c * kKC, n = n0 + c, col = k0 + kk;
        ws[kk * kWS + c] =
            (n < d && col < d) ? to_f(w2[(size_t)n * d + col]) : 0.f;
      }
      __syncthreads();
      const int kn = min(kKC, d - k0);
      for (int kk = 0; kk < kn; ++kk) {
        float wv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) wv[j] = ws[kk * kWS + lane + 32 * j];
#pragma unroll
        for (int i = 0; i < kRW2; ++i) {
          const float av = as[(warp * kRW2 + i) * d + k0 + kk];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av, wv[j], acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRW2; ++i) {
      const int t = t0 + warp * kRW2 + i;
      if (t >= t_len) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + lane + 32 * j;
        if (c < d)
          out[((size_t)b * t_len + t) * d + c] = from_f<T>(acc[i][j] + b2[c]);
      }
    }
  }
}

template <typename T>
int launch(const void* x, const uint8_t* mask, const void* w1,
           const float* b1, const float* wd, const float* bd,
           const float* nw, const float* nb, const void* w2, const float* b2,
           void* out, int batch, int t_len, int d, int k, int pad_l,
           int layer_norm, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)(kR1 + kTT) * d + kR1 * kAS + kKC * kWS);
  cudaError_t err = cudaFuncSetAttribute(
      conv_module_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((t_len + kTT - 1) / kTT, batch);
  conv_module_kernel<T><<<grid, kWarps * 32, smem, stream>>>(
      (const T*)x, mask, (const T*)w1, b1, wd, bd, nw, nb, (const T*)w2, b2,
      (T*)out, t_len, d, k, pad_l, layer_norm);
  return (int)cudaGetLastError();
}

}  // namespace

// The wrapper guarantees: contiguous tensors on one device; x, out (batch,
// t_len, d), w1 (2d, d) and w2 (d, d) in one dtype (fp32 or bf16); mask
// (batch, t_len) of 0/1 bytes; wd (k, d) time-major, b1 (2d), bd, nw, nb, b2 (d) fp32;
// 1 <= d <= 512, 1 <= k <= 33, 0 <= pad_l < k.
extern "C" int tat_conv_module(int bf16, const void* x, const void* mask,
                               const void* w1, const void* b1, const void* wd,
                               const void* bd, const void* nw, const void* nb,
                               const void* w2, const void* b2, void* out,
                               int batch, int t_len, int d, int k, int pad_l,
                               int layer_norm, void* stream) {
  if (d < 1 || d > kMaxD || k < 1 || k > kMaxK || pad_l < 0 || pad_l >= k)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  auto F = [](const void* p) { return (const float*)p; };
  const uint8_t* m = (const uint8_t*)mask;
  return bf16 ? launch<__nv_bfloat16>(x, m, w1, F(b1), F(wd), F(bd), F(nw),
                                      F(nb), w2, F(b2), out, batch, t_len, d,
                                      k, pad_l, layer_norm, s)
              : launch<float>(x, m, w1, F(b1), F(wd), F(bd), F(nw), F(nb), w2,
                              F(b2), out, batch, t_len, d, k, pad_l,
                              layer_norm, s);
}
