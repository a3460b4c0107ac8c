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
// bf16 (the serving dtype; conv_module_mma_kernel): one block of 8 warps
// per (batch row, 32 output frames), two blocks an SM, no barrier inside a
// product. The x rows of the tile and its k - 1 halo frames (64 rows, so
// k <= 33) are staged by cp.async as the A tile. Both pointwise products
// run on mma.sync m16n8k16 (bf16 operands, fp32 sums), their B fragments
// read straight from the bf16 weights in L2 (8 contiguous bytes a thread,
// the next 16-deep step's in flight while this one's products run); W1's
// rows come interleaved by the wrapper in groups of 8 channels (linear,
// then gate), so that one thread holds both halves of a GLU channel. GLU and
// the mask in the epilogue into an fp32 tile. The k taps run in fp32 with a
// thread per channel over the 32 output rows (each GLU value read from
// shared memory once a half, the taps unrolled), in place; then the norm (a
// warp per row), SiLU, rounded to bf16 into the A tile of pointwise 2 (the
// x tile's space); the output is written once. Frame tile: 32 frames read
// 64 GLU rows (a 2x halo at k = 31); a 48-frame tile would cut the halo to
// 1.7x, but its 80-row fp32 tile does not fit at D=512. Shared memory: the
// x tile 64 x (2 pad16(D) bytes, rows 32 (mod 64) bytes apart) and the GLU
// tile 64 x D fp32: 67,584 B at D=176, 198,656 B at D=512. Registers, not
// shared memory, hold it to two blocks an SM (the 384 blocks of the serve
// shape then take 1.45 waves): under the 80 a thread that three blocks
// allow, ptxas spills. A cp.async weight ring with a block barrier per K
// tile (the pattern of gemm.cuh) measured slower at the serve shape
// (PERF.md has the numbers).
//
// fp32 (the check dtype; conv_module_kernel): plain SIMT with fp32 sums
// (no TF32), so that it agrees with full-precision references. Pointwise 1
// + GLU for the tile and its halo into shared memory, x and W1 staged in
// 32-deep chunks, a lane computing 2 GLU channels (their linear and gate
// halves) of 8 rows; then the k taps per channel, the norm (one warp per
// row), SiLU, and pointwise 2 from shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include <math.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kTT = 32;          // output frames per block
constexpr int kR1 = 64;          // GLU rows per block: kTT + k - 1 <= kR1
constexpr int kWarps = 8, kThreads = 32 * kWarps;
constexpr int kMaxD = 512, kMaxK = kR1 - kTT + 1;

__device__ __forceinline__ float sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
}

// ---------------------------------------------------------------------------
// fp32: plain SIMT
// ---------------------------------------------------------------------------

constexpr int kRW1 = kR1 / kWarps;  // GLU rows per warp
constexpr int kRW2 = kTT / kWarps;  // output rows per warp
constexpr int kKC = 32;          // reduction chunk staged in shared memory
constexpr int kAS = kKC + 1;     // staged x row stride
constexpr int kNC = 128;         // staged weight columns
constexpr int kWS = kNC + 1;     // staged weight row stride

size_t simt_smem(int d) {
  return sizeof(float) * ((size_t)(kR1 + kTT) * d + kR1 * kAS + kKC * kWS);
}

__global__ void __launch_bounds__(kThreads) conv_module_kernel(
    const float* __restrict__ x, const uint8_t* __restrict__ mask,
    const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ wd, const float* __restrict__ bd,
    const float* __restrict__ nw, const float* __restrict__ nb,
    const float* __restrict__ w2, const float* __restrict__ b2,
    float* __restrict__ out, int t_len, int d, int k, int pad_l,
    int layer_norm) {
  extern __shared__ float sm[];
  float* gs = sm;                 // kR1 x d: GLU output, frames t0 - pad_l ..
  float* as = gs + kR1 * d;       // kTT x d: depthwise, then silu(norm)
  float* xs = as + kTT * d;       // kR1 x kAS: staged x chunk
  float* ws = xs + kR1 * kAS;     // kKC x kWS: staged weight chunk
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.y, t0 = blockIdx.x * kTT, f0 = t0 - pad_l;
  const float* xb = x + (size_t)b * t_len * d;
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
                               ? xb[(size_t)fr * d + col] : 0.f;
      }
      for (int i = threadIdx.x; i < kNC * kKC; i += blockDim.x) {
        const int c = i / kKC, kk = i - c * kKC, col = k0 + kk;
        const int ch = n0 + (c & (kNC / 2 - 1));
        const int n = c < kNC / 2 ? ch : d + ch;
        ws[kk * kWS + c] = (ch < d && col < d) ? w1[(size_t)n * d + col] : 0.f;
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

  // norm + SiLU, one warp per row
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
      row[c] = y * sigmoid(y);
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
        ws[kk * kWS + c] = (n < d && col < d) ? w2[(size_t)n * d + col] : 0.f;
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
        if (c < d) out[((size_t)b * t_len + t) * d + c] = acc[i][j] + b2[c];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

// K (= D) padded for the products, and the row stride (bytes) of the bf16
// A tiles: 32 (mod 64), so the 8-byte fragment loads of a half-warp fall
// on 32 distinct banks.
__host__ __device__ inline int pad16(int n) { return (n + 15) / 16 * 16; }
__host__ __device__ inline int a_stride(int d) {
  const int b = 2 * pad16(d);
  return b % 64 == 0 ? b + 32 : b;
}

size_t mma_smem(int d) {
  return (size_t)kR1 * a_stride(d) + sizeof(float) * kR1 * d;
}

// acc[i][j] = rows 16 i + (0..15) of A (bf16 in shared memory, stride sa
// bytes, kp columns) times rows nb + 8 j + (0..7) of W (n_rows, kp) bf16 in
// device memory (rows past n_rows read as 0), on mma.sync m16n8k16 with
// fp32 sums. A thread reads 8 contiguous bytes of a row per 16-deep step:
// A and B take the same k permutation (physical k 4 t + 0, 1 feed logical
// k 2 t + 0, 1; 4 t + 2, 3 feed 2 t + 8, 9). The next step's B fragments
// are in flight while this step's products run; no barrier.
template <int MT, int NT>
__device__ __forceinline__ void product(float (&acc)[MT][NT][4],
                                        const char* a, int sa,
                                        const __nv_bfloat16* __restrict__ w,
                                        int nb, int n_rows, int kp) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  const char* a0 = a + g * sa + 8 * t;
  // row nb + 8 j + g of W at w0 + 8 j kp; rows past n_rows are not read
  const __nv_bfloat16* w0 = w + (size_t)(nb + g) * kp + 4 * t;
  const int live = (n_rows - nb - g + 7) / 8;   // rows j < live exist
  auto ld = [&](int j, int k) {
    return j < live ? __ldg(reinterpret_cast<const uint2*>(
                          w0 + (size_t)(8 * j) * kp + k))
                    : make_uint2(0u, 0u);
  };
  uint2 b[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) b[j] = ld(j, 0);
  for (int k0 = 0; k0 < kp; k0 += 16) {
    const int k1 = k0 + 16 < kp ? k0 + 16 : k0;
    uint2 nx[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) nx[j] = ld(j, k1);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const uint2 lo =
          *reinterpret_cast<const uint2*>(a0 + 16 * i * sa + 2 * k0);
      const uint2 hi =
          *reinterpret_cast<const uint2*>(a0 + (16 * i + 8) * sa + 2 * k0);
      const uint32_t af[4] = {lo.x, hi.x, lo.y, hi.y};
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], af, b[j].x, b[j].y);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) b[j] = nx[j];
  }
}

// w1i: (2 pad8(d), pad16(d)) bf16, rows 16 q .. 16 q + 7 the linear rows of
// channels 8 q .., rows 16 q + 8 .. the gate rows of the same channels;
// w2p: (d, pad16(d)) bf16; both zero past d in K.
__global__ void __launch_bounds__(kThreads, 2) conv_module_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ mask,
    const __nv_bfloat16* __restrict__ w1i, const float* __restrict__ b1,
    const float* __restrict__ wd, const float* __restrict__ bd,
    const float* __restrict__ nw, const float* __restrict__ nb,
    const __nv_bfloat16* __restrict__ w2p, const float* __restrict__ b2,
    __nv_bfloat16* __restrict__ out, int t_len, int d, int k, int pad_l,
    int layer_norm) {
  extern __shared__ __align__(16) char smem[];
  const int kp = pad16(d), sa = a_stride(d);
  // kR1 x sa bytes: the x tile, then the SiLU output (kTT rows)
  char* xs = smem;
  float* gs = reinterpret_cast<float*>(smem + kR1 * sa);   // kR1 x d
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int b = blockIdx.y, t0 = blockIdx.x * kTT, f0 = t0 - pad_l;
  const __nv_bfloat16* xb = x + (size_t)b * t_len * d;
  const uint8_t* mb = mask + (size_t)b * t_len;
  auto xrow = [&](int r) {
    return reinterpret_cast<__nv_bfloat16*>(xs + r * sa);
  };

  // the x tile: frames f0 .. f0 + kR1 - 1, zero outside [0, T) and past d
  if (d % 8 == 0) {
    for (int u = threadIdx.x; u < kR1 * (kp / 8); u += kThreads) {
      const int r = u / (kp / 8), c = (u % (kp / 8)) * 8, fr = f0 + r;
      const bool v = fr >= 0 && fr < t_len && c < d;
      cp_async16(xrow(r) + c, v ? xb + (size_t)fr * d + c : xb, v);
    }
    cp_async_commit();
    cp_async_wait<0>();
  } else {
    for (int u = threadIdx.x; u < kR1 * kp; u += kThreads) {
      const int r = u / kp, c = u % kp, fr = f0 + r;
      xrow(r)[c] = fr >= 0 && fr < t_len && c < d ? xb[(size_t)fr * d + c]
                                                  : __float2bfloat16(0.f);
    }
  }
  __syncthreads();

  // pointwise 1 + GLU + mask: warps in 2 x 4, each 32 of the kR1 rows and
  // two groups of 8 channels (their linear and gate rows: four n8 tiles),
  // 8 groups a pass
  {
    const int n_rows = 2 * ((d + 7) / 8 * 8), wm = 32 * (warp % 2);
    for (int n0 = 0; n0 < n_rows; n0 += 128) {
      const int nb = n0 + 32 * (warp / 2);
      if (nb >= n_rows) break;
      float acc[2][4][4];
      product<2, 4>(acc, xs + wm * sa, sa, w1i, nb, n_rows, kp);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = wm + 16 * i + g + 8 * (e / 2), fr = f0 + r;
            const int c = nb / 2 + 8 * q + 2 * t + (e % 2);
            if (c >= d) continue;
            const bool live = fr >= 0 && fr < t_len && mb[fr];
            const float lin = acc[i][2 * q][e] + b1[c];
            const float gate = acc[i][2 * q + 1][e] + b1[d + c];
            gs[r * d + c] = live ? lin * sigmoid(gate) : 0.f;
          }
    }
  }
  __syncthreads();

  // depthwise + bias: a thread per channel over the kTT output rows in two
  // halves, each GLU row of a half read once (rows and taps unrolled, the
  // taps padded to kMaxK with zero weights, summed in tap order); a half's
  // results overwrite the channel's own GLU rows, which no other thread
  // reads and the second half no longer needs
  for (int c = threadIdx.x; c < d; c += kThreads) {
    float w[kMaxK];
#pragma unroll
    for (int j = 0; j < kMaxK; ++j) w[j] = j < k ? wd[j * d + c] : 0.f;
    const float bias = bd[c];
#pragma unroll
    for (int r0 = 0; r0 < kTT; r0 += kTT / 2) {
      float acc[kTT / 2];
#pragma unroll
      for (int r = 0; r < kTT / 2; ++r) acc[r] = 0.f;
#pragma unroll
      for (int i = 0; i < kTT / 2 + kMaxK - 1; ++i) {
        const float gv = gs[(r0 + i) * d + c];
#pragma unroll
        for (int r = 0; r < kTT / 2; ++r)
          if (i - r >= 0 && i - r < kMaxK)
            acc[r] = fmaf(gv, w[i - r], acc[r]);
      }
#pragma unroll
      for (int r = 0; r < kTT / 2; ++r) gs[(r0 + r) * d + c] = acc[r] + bias;
    }
  }
  __syncthreads();

  // norm + SiLU, a warp per row, rounded to bf16 into the A tile of
  // pointwise 2 (zero past d)
  for (int r = warp; r < kTT; r += kWarps) {
    const float* row = gs + r * d;
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
    for (int c = lane; c < kp; c += 32) {
      float v = 0.f;
      if (c < d) {
        const float y = layer_norm ? (row[c] - mu) * rs * nw[c] + nb[c]
                                   : row[c] * nw[c] + nb[c];
        v = y * sigmoid(y);
      }
      xrow(r)[c] = __float2bfloat16(v);
    }
  }
  __syncthreads();

  // pointwise 2: a warp takes 32 output columns (four n8 tiles) of the
  // kTT rows, 256 columns a pass
  __nv_bfloat16* ob = out + (size_t)b * t_len * d;
  for (int n0 = 0; n0 < d; n0 += 256) {
    const int nb2 = n0 + 32 * warp;
    if (nb2 >= d) break;
    float acc[kTT / 16][4][4];
    product<kTT / 16, 4>(acc, xs, sa, w2p, nb2, d, kp);
#pragma unroll
    for (int i = 0; i < kTT / 16; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int tt = t0 + 16 * i + g + 8 * (e / 2);
          const int c = nb2 + 8 * j + 2 * t + (e % 2);
          if (tt < t_len && c < d)
            ob[(size_t)tt * d + c] = __float2bfloat16(acc[i][j][e] + b2[c]);
        }
  }
}

int launch(int bf16, const void* x, const uint8_t* mask, const void* w1,
           const float* b1, const float* wd, const float* bd, const float* nw,
           const float* nb, const void* w2, const float* b2, void* out,
           int batch, int t_len, int d, int k, int pad_l, int layer_norm,
           cudaStream_t stream) {
  const dim3 grid((t_len + kTT - 1) / kTT, batch);
  cudaError_t err;
  if (bf16) {
    const size_t smem = mma_smem(d);
    err = cudaFuncSetAttribute(conv_module_mma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    using B = const __nv_bfloat16*;
    conv_module_mma_kernel<<<grid, kThreads, smem, stream>>>(
        (B)x, mask, (B)w1, b1, wd, bd, nw, nb, (B)w2, b2,
        (__nv_bfloat16*)out, t_len, d, k, pad_l, layer_norm);
  } else {
    const size_t smem = simt_smem(d);
    err = cudaFuncSetAttribute(conv_module_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    conv_module_kernel<<<grid, kThreads, smem, stream>>>(
        (const float*)x, mask, (const float*)w1, b1, wd, bd, nw, nb,
        (const float*)w2, b2, (float*)out, t_len, d, k, pad_l, layer_norm);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The wrapper guarantees: contiguous tensors on one device; x and out
// (batch, t_len, d) in one dtype; mask (batch, t_len) of 0/1 bytes; wd (k, d)
// time-major, b1 (2d), bd, nw, nb, b2 (d) fp32; 1 <= d <= 512,
// 1 <= k <= 33, 0 <= pad_l < k. fp32: w1 (2d, d) and w2 (d, d) fp32. bf16:
// w1 (2 pad8(d), pad16(d)) interleaved by 8 channels (linear rows, then gate
// rows) and w2 (d, pad16(d)), bf16, zero past d
// (ops/cuda_conv.py::_kernel_weights).
extern "C" int tat_conv_module(int bf16, const void* x, const void* mask,
                               const void* w1, const void* b1, const void* wd,
                               const void* bd, const void* nw, const void* nb,
                               const void* w2, const void* b2, void* out,
                               int batch, int t_len, int d, int k, int pad_l,
                               int layer_norm, void* stream) {
  if (d < 1 || d > kMaxD || k < 1 || k > kMaxK || pad_l < 0 || pad_l >= k)
    return (int)cudaErrorInvalidValue;
  auto F = [](const void* p) { return (const float*)p; };
  return launch(bf16, x, (const uint8_t*)mask, w1, F(b1), F(wd), F(bd),
                F(nw), F(nb), w2, F(b2), out, batch, t_len, d, k, pad_l,
                layer_norm, (cudaStream_t)stream);
}
