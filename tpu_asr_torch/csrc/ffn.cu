// Conformer feed-forward sublayer, training path:
//   out = x + 0.5 * drop2( drop1( silu( LN(x) W1^T + b1 ) ) W2^T + b2 )
// with flax's LayerNorm (E[x^2] - E[x]^2, eps 1e-6, fp32 statistics), and
// its backward: dx, d(LN scale, bias), dW1, db1, dW2, db2.
//
// Replaces tpu_asr/ops/pallas_ffn.py::_ffn_kernel and ::_ffn_bwd_kernel,
// launched by ops/cuda_ffn.py::fused_ffn_sublayer and ::
// fused_ffn_sublayer_bwd.
//
// What bounds it on an H100: at B=32, T'=376, D=88, d_ff=352 the forward is
// 4 B T D d_ff = 1.49 GFLOP against 4.2 MB of bf16 activations in and out,
// so its floor is the arithmetic (about 1.5 us at the bf16 tensor rate, 22 us
// at the fp32 SIMT rate) if the (B*T, d_ff) activation never reaches device
// memory (it would be 17 MB in fp32).
//
// Design, all plain SIMT with fp32 accumulation, operands rounded to the
// working type T where the TPU kernel rounds them (y, the dropped SiLU
// output, do, dh1):
//   forward - one block per 32 rows: LN into shared memory, h = y W1^T in
//     128-column passes with the weight staged through shared memory in
//     32-deep chunks, bias + SiLU + inner mask in the epilogue, then
//     o = h W2^T the same way, outer mask and the 0.5 residual. h stays in
//     shared memory. Any D whose tile fits shared memory (the teacher's
//     D=176 in eval); the tile product and the LayerNorm are rowtile.cuh's,
//     shared with layer.cu.
//   backward - two kernels. ffn_bwd_dx_kernel (one block per 32 rows)
//     recomputes LN and h1, forms do, dh1 = silu'(h1) * mask * (do W2) and
//     dy = dh1 W1, and applies the LN backward; it writes dx and per-block
//     partials of d(LN scale, bias). ffn_bwd_dw_kernel (one block per 32
//     d_ff columns and per chunk of rows) recomputes its 32 columns of h1
//     and dh1 and accumulates dW1, dW2, db1 (and, for the first column
//     block, db2) over its rows in registers (so D <= 128), then writes one
//     partial per row chunk. Partials are summed in a fixed order by
//     sum_rows_kernel: no atomics, so the gradients are deterministic.
// Dropout masks come from the counter hash (dropout.cuh) with JAX's stream
// layout: 2 * (seed + b) + salt, idx t * width + col.

#include <cuda_runtime.h>
#include <stdint.h>

#include <math.h>

#include "dropout.cuh"
#include "rowtile.cuh"

namespace {

constexpr int kFC = 32;       // d_ff columns per dW block
constexpr int kCS = kFC + 1;
constexpr int kMaxDJ = 16;    // D <= 8 * kMaxDJ = 128 in the dW kernel

__device__ __forceinline__ bool keep(uint32_t seed, int m, int t_len,
                                     uint32_t salt, int width, int col,
                                     uint32_t thresh) {
  const uint32_t b = (uint32_t)(m / t_len), t = (uint32_t)(m % t_len);
  return dropout_keep(2u * (seed + b) + salt, t * (uint32_t)width + col,
                      thresh);
}

template <typename T>
__global__ void __launch_bounds__(256) ffn_fwd_kernel(
    const T* __restrict__ x, const float* __restrict__ lnw,
    const float* __restrict__ lnb, const T* __restrict__ w1,
    const float* __restrict__ b1, const T* __restrict__ w2,
    const float* __restrict__ b2, T* __restrict__ out, int m_rows, int t_len,
    int d, int f, uint32_t seed, uint32_t thresh, float scale) {
  extern __shared__ float sm[];
  float* ys = sm;             // kRT x d
  float* hs = ys + kRT * d;   // kRT x f
  float* ws = hs + kRT * f;   // kKC x kWS
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.x * kRT;
  ln_rows<T>(x, lnw, lnb, m0, m_rows, d, ys, nullptr, nullptr);
  float acc[kRows][4];
  for (int n0 = 0; n0 < f; n0 += kNC) {
    tile_product<T, false>(acc, ys, d, w1, n0, f, d, ws);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = warp * kRows + i, m = m0 + row;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + lane + 32 * j;
        if (c >= f) continue;
        float h = acc[i][j] + b1[c];
        h = h / (1.f + expf(-h));
        if (thresh && m < m_rows)
          h = keep(seed, m, t_len, 0u, f, c, thresh) ? h * scale : 0.f;
        hs[row * f + c] = rnd<T>(h);
      }
    }
  }
  for (int n0 = 0; n0 < d; n0 += kNC) {
    tile_product<T, false>(acc, hs, f, w2, n0, d, f, ws);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int m = m0 + warp * kRows + i;
      if (m >= m_rows) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + lane + 32 * j;
        if (c >= d) continue;
        float o = acc[i][j] + b2[c];
        if (thresh) o = keep(seed, m, t_len, 1u, d, c, thresh) ? o * scale : 0.f;
        const size_t at = (size_t)m * d + c;
        out[at] = from_f<T>(to_f(x[at]) + 0.5f * o);
      }
    }
  }
}

// do = 0.5 g * mask2 * scale for rows m0..m0+31, rounded to T into dos.
template <typename T>
__device__ void form_do(const T* g, int m0, int m_rows, int t_len, int d,
                        uint32_t seed, uint32_t thresh, float scale,
                        float* dos, float (&raw)[kRows][4]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = warp * kRows + i, m = m0 + row;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = lane + 32 * j;
      float v = 0.f;
      if (c < d && m < m_rows) {
        v = 0.5f * to_f(g[(size_t)m * d + c]);
        if (thresh) v = keep(seed, m, t_len, 1u, d, c, thresh) ? v * scale : 0.f;
      }
      raw[i][j] = v;
      if (c < d) dos[row * d + c] = rnd<T>(v);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(256) ffn_bwd_dx_kernel(
    const T* __restrict__ x, const T* __restrict__ g,
    const float* __restrict__ lnw, const float* __restrict__ lnb,
    const T* __restrict__ w1, const float* __restrict__ b1,
    const T* __restrict__ w2, T* __restrict__ dx,
    float* __restrict__ part_ds, float* __restrict__ part_dsb, int m_rows,
    int t_len, int d, int f, uint32_t seed, uint32_t thresh, float scale) {
  extern __shared__ float sm[];
  float* ys = sm;              // kRT x d
  float* xh = ys + kRT * d;    // kRT x d
  float* dos = xh + kRT * d;   // kRT x d
  float* hs = dos + kRT * d;   // kRT x f: h1, then dh1
  float* ws = hs + kRT * f;    // kKC x kWS
  float* rs = ws + kKC * kWS;  // kRT
  float* red = rs + kRT;       // 2 x 8 x kNC
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.x * kRT;
  ln_rows<T>(x, lnw, lnb, m0, m_rows, d, ys, xh, rs);
  float raw[kRows][4];
  form_do<T>(g, m0, m_rows, t_len, d, seed, thresh, scale, dos, raw);
  float acc[kRows][4];
  for (int n0 = 0; n0 < f; n0 += kNC) {
    tile_product<T, false>(acc, ys, d, w1, n0, f, d, ws);
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + lane + 32 * j;
        if (c < f) hs[(warp * kRows + i) * f + c] = acc[i][j] + b1[c];
      }
  }
  for (int n0 = 0; n0 < f; n0 += kNC) {
    tile_product<T, true>(acc, dos, d, w2, n0, f, d, ws);  // do W2
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = warp * kRows + i, m = m0 + row;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + lane + 32 * j;
        if (c >= f) continue;
        float dh = acc[i][j];
        if (thresh && m < m_rows)
          dh = keep(seed, m, t_len, 0u, f, c, thresh) ? dh * scale : 0.f;
        const float h1 = hs[row * f + c], sg = 1.f / (1.f + expf(-h1));
        hs[row * f + c] = rnd<T>(dh * sg * (1.f + h1 * (1.f - sg)));
      }
    }
  }
  tile_product<T, true>(acc, hs, f, w1, 0, d, f, ws);  // dy = dh1 W1
  float ds_acc[4] = {0.f, 0.f, 0.f, 0.f}, dsb_acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = warp * kRows + i, m = m0 + row;
    float dxh[4], xv[4], s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = lane + 32 * j;
      const bool in = c < d;
      const float dy = in ? acc[i][j] : 0.f;
      xv[j] = in ? xh[row * d + c] : 0.f;
      dxh[j] = in ? dy * lnw[c] : 0.f;
      s1 += dxh[j];
      s2 += dxh[j] * xv[j];
      ds_acc[j] += dy * xv[j];
      dsb_acc[j] += dy;
    }
    s1 = warp_sum(s1) / d;
    s2 = warp_sum(s2) / d;
    if (m >= m_rows) continue;
    const float r = rs[row];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = lane + 32 * j;
      if (c >= d) continue;
      const size_t at = (size_t)m * d + c;
      dx[at] = from_f<T>(to_f(g[at]) + r * (dxh[j] - s1 - xv[j] * s2));
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    red[warp * kNC + lane + 32 * j] = ds_acc[j];
    red[(8 + warp) * kNC + lane + 32 * j] = dsb_acc[j];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float a = 0.f, bsum = 0.f;
    for (int w = 0; w < 8; ++w) {
      a += red[w * kNC + c];
      bsum += red[(8 + w) * kNC + c];
    }
    part_ds[(size_t)blockIdx.x * d + c] = a;
    part_dsb[(size_t)blockIdx.x * d + c] = bsum;
  }
}

template <typename T>
__global__ void __launch_bounds__(256) ffn_bwd_dw_kernel(
    const T* __restrict__ x, const T* __restrict__ g,
    const float* __restrict__ lnw, const float* __restrict__ lnb,
    const T* __restrict__ w1, const float* __restrict__ b1,
    const T* __restrict__ w2, float* __restrict__ pw1,  // (R, f, d)
    float* __restrict__ pw2,                            // (R, d, f)
    float* __restrict__ pb1,                            // (R, f)
    float* __restrict__ pb2,                            // (R, d)
    int m_rows, int t_len, int d, int f, int rows_per_chunk, uint32_t seed,
    uint32_t thresh, float scale) {
  extern __shared__ float sm[];
  float* ys = sm;               // kRT x d
  float* dos = ys + kRT * d;    // kRT x d
  float* w1c = dos + kRT * d;   // d x kCS: W1[f0 + c][k]
  float* w2c = w1c + d * kCS;   // d x kCS: W2[k][f0 + c]
  float* hdc = w2c + d * kCS;   // kRT x kCS: dropped silu(h1), rounded
  float* dhc = hdc + kRT * kCS; // kRT x kCS: dh1, rounded
  float* red = dhc + kRT * kCS; // 8 x kNC
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int f0 = blockIdx.x * kFC, fc = f0 + lane;
  const bool fin = fc < f;
  const int p = blockIdx.y;
  const int r0 = p * rows_per_chunk;
  const int r1 = min(m_rows, r0 + rows_per_chunk);
  for (int i = threadIdx.x; i < d * kFC; i += blockDim.x) {
    const int k = i / kFC, c = i - k * kFC, col = f0 + c;
    w1c[k * kCS + c] = col < f ? to_f(w1[(size_t)col * d + k]) : 0.f;
    w2c[k * kCS + c] = col < f ? to_f(w2[(size_t)k * f + col]) : 0.f;
  }
  const float bias1 = fin ? b1[fc] : 0.f;
  float acc_w1[kMaxDJ], acc_w2[kMaxDJ], db1 = 0.f;
  float db2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int jj = 0; jj < kMaxDJ; ++jj) acc_w1[jj] = acc_w2[jj] = 0.f;

  for (int m0 = r0; m0 < r1; m0 += kRT) {
    __syncthreads();  // the previous tile's ys / dos / hdc / dhc are consumed
    ln_rows<T>(x, lnw, lnb, m0, r1, d, ys, nullptr, nullptr);
    float raw[kRows][4];
    form_do<T>(g, m0, r1, t_len, d, seed, thresh, scale, dos, raw);
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) db2[j] += raw[i][j];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = warp * kRows + i, m = m0 + row;
      float h1 = bias1, dhd = 0.f;
      for (int k = 0; k < d; ++k) {
        h1 = fmaf(ys[row * d + k], w1c[k * kCS + lane], h1);
        dhd = fmaf(dos[row * d + k], w2c[k * kCS + lane], dhd);
      }
      const float sg = 1.f / (1.f + expf(-h1));
      float hd = h1 * sg, dh = dhd;
      if (thresh && m < r1 && fin && !keep(seed, m, t_len, 0u, f, fc, thresh))
        hd = dh = 0.f;
      else if (thresh) {
        hd *= scale;
        dh *= scale;
      }
      const float dh1 = (fin && m < r1) ? dh * sg * (1.f + h1 * (1.f - sg))
                                        : 0.f;
      hdc[row * kCS + lane] = (fin && m < r1) ? rnd<T>(hd) : 0.f;
      dhc[row * kCS + lane] = rnd<T>(dh1);
      db1 += dh1;
    }
    __syncthreads();
    for (int r = 0; r < kRT; ++r) {
      const float hv = hdc[r * kCS + lane], dv = dhc[r * kCS + lane];
#pragma unroll
      for (int jj = 0; jj < kMaxDJ; ++jj) {
        const int k = warp + 8 * jj;
        if (k < d) {
          acc_w2[jj] = fmaf(hv, dos[r * d + k], acc_w2[jj]);
          acc_w1[jj] = fmaf(dv, ys[r * d + k], acc_w1[jj]);
        }
      }
    }
  }
  if (fin) {
#pragma unroll
    for (int jj = 0; jj < kMaxDJ; ++jj) {
      const int k = warp + 8 * jj;
      if (k >= d) continue;
      pw1[((size_t)p * f + fc) * d + k] = acc_w1[jj];
      pw2[((size_t)p * d + k) * f + fc] = acc_w2[jj];
    }
  }
  __syncthreads();
  red[warp * kNC + lane] = db1;
  __syncthreads();
  if (warp == 0 && fin) {
    float s = 0.f;
    for (int w = 0; w < 8; ++w) s += red[w * kNC + lane];
    pb1[(size_t)p * f + fc] = s;
  }
  if (blockIdx.x != 0) return;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 4; ++j) red[warp * kNC + lane + 32 * j] = db2[j];
  __syncthreads();
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < 8; ++w) s += red[w * kNC + c];
    pb2[(size_t)p * d + c] = s;
  }
}

// out[i] = sum_p part[p * n + i], p in order.
__global__ void sum_rows_kernel(const float* __restrict__ part,
                                float* __restrict__ out, int n_parts, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int p = 0; p < n_parts; ++p) s += part[(size_t)p * n + i];
  out[i] = s;
}

cudaError_t sum_rows(const float* part, float* out, int n_parts, int n,
                     cudaStream_t stream) {
  sum_rows_kernel<<<(n + 255) / 256, 256, 0, stream>>>(part, out, n_parts, n);
  return cudaGetLastError();
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T>
int fwd(const void* x, const float* lnw, const float* lnb, const void* w1,
        const float* b1, const void* w2, const float* b2, void* out,
        int m_rows, int t_len, int d, int f, uint32_t seed, uint32_t thresh,
        float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)kRT * (d + f) + kKC * kWS);
  cudaError_t err = set_smem(ffn_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  ffn_fwd_kernel<T><<<(m_rows + kRT - 1) / kRT, 256, smem, stream>>>(
      (const T*)x, lnw, lnb, (const T*)w1, b1, (const T*)w2, b2, (T*)out,
      m_rows, t_len, d, f, seed, thresh, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd(const void* x, const void* g, const float* lnw, const float* lnb,
        const void* w1, const float* b1, const void* w2, void* dx,
        float* part_ds, float* part_dsb, float* pw1, float* pw2, float* pb1,
        float* pb2, float* ds, float* dsb, float* dw1, float* dw2,
        float* db1, float* db2, int m_rows, int t_len, int d, int f,
        int rows_per_chunk, int n_chunks, uint32_t seed, uint32_t thresh,
        float scale, cudaStream_t stream) {
  const int tiles = (m_rows + kRT - 1) / kRT;
  const size_t smem_dx = sizeof(float) * ((size_t)3 * kRT * d + kRT * f +
                                          kKC * kWS + kRT + 2 * 8 * kNC);
  cudaError_t err = set_smem(ffn_bwd_dx_kernel<T>, smem_dx);
  if (err != cudaSuccess) return (int)err;
  ffn_bwd_dx_kernel<T><<<tiles, 256, smem_dx, stream>>>(
      (const T*)x, (const T*)g, lnw, lnb, (const T*)w1, b1, (const T*)w2,
      (T*)dx, part_ds, part_dsb, m_rows, t_len, d, f, seed, thresh, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const size_t smem_dw = sizeof(float) * ((size_t)2 * kRT * d + 2 * d * kCS +
                                          2 * kRT * kCS + 8 * kNC);
  if ((err = set_smem(ffn_bwd_dw_kernel<T>, smem_dw)) != cudaSuccess)
    return (int)err;
  const dim3 grid((f + kFC - 1) / kFC, n_chunks);
  ffn_bwd_dw_kernel<T><<<grid, 256, smem_dw, stream>>>(
      (const T*)x, (const T*)g, lnw, lnb, (const T*)w1, b1, (const T*)w2,
      pw1, pw2, pb1, pb2, m_rows, t_len, d, f, rows_per_chunk, seed, thresh,
      scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  if ((err = sum_rows(part_ds, ds, tiles, d, stream)) != cudaSuccess ||
      (err = sum_rows(part_dsb, dsb, tiles, d, stream)) != cudaSuccess ||
      (err = sum_rows(pw1, dw1, n_chunks, f * d, stream)) != cudaSuccess ||
      (err = sum_rows(pw2, dw2, n_chunks, d * f, stream)) != cudaSuccess ||
      (err = sum_rows(pb1, db1, n_chunks, f, stream)) != cudaSuccess)
    return (int)err;
  return (int)sum_rows(pb2, db2, n_chunks, d, stream);
}

}  // namespace

// The wrapper guarantees: contiguous tensors on one device; x, out, w1
// (f, d) and w2 (d, f) in one dtype (fp32 or bf16); LN scale/bias and
// biases fp32; 4 (32 (d + f) + 32 * 129) bytes of shared memory <= 227 KB;
// m_rows = B * t_len rows of x.
extern "C" int tat_ffn_fwd(int bf16, const void* x, const void* lnw,
                           const void* lnb, const void* w1, const void* b1,
                           const void* w2, const void* b2, void* out,
                           int m_rows, int t_len, int d, int f,
                           unsigned int seed, unsigned int thresh,
                           float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float *lw = (const float*)lnw, *lb = (const float*)lnb,
              *bb1 = (const float*)b1, *bb2 = (const float*)b2;
  return bf16 ? fwd<__nv_bfloat16>(x, lw, lb, w1, bb1, w2, bb2, out, m_rows,
                                   t_len, d, f, seed, thresh, scale, s)
              : fwd<float>(x, lw, lb, w1, bb1, w2, bb2, out, m_rows, t_len,
                           d, f, seed, thresh, scale, s);
}

// As tat_ffn_fwd, plus the cotangent g (like x) and outputs dx (like x) and
// fp32 ds, dsb (d), dw1 (f, d), dw2 (d, f), db1 (f), db2 (d); fp32 scratch
// part_ds, part_dsb (ceil(m_rows / 32), d), pw1 (n_chunks, f, d), pw2
// (n_chunks, d, f), pb1 (n_chunks, f), pb2 (n_chunks, d) with
// n_chunks * rows_per_chunk >= m_rows and rows_per_chunk a multiple of 32;
// d <= 128 (kMaxDJ).
extern "C" int tat_ffn_bwd(int bf16, const void* x, const void* g,
                           const void* lnw, const void* lnb, const void* w1,
                           const void* b1, const void* w2, void* dx,
                           void* part_ds, void* part_dsb, void* pw1,
                           void* pw2, void* pb1, void* pb2, void* ds,
                           void* dsb, void* dw1, void* dw2, void* db1,
                           void* db2, int m_rows, int t_len, int d, int f,
                           int rows_per_chunk, int n_chunks,
                           unsigned int seed, unsigned int thresh,
                           float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  auto F = [](void* p) { return (float*)p; };
  const float *lw = (const float*)lnw, *lb = (const float*)lnb,
              *bb1 = (const float*)b1;
  return bf16 ? bwd<__nv_bfloat16>(
                    x, g, lw, lb, w1, bb1, w2, dx, F(part_ds), F(part_dsb),
                    F(pw1), F(pw2), F(pb1), F(pb2), F(ds), F(dsb), F(dw1),
                    F(dw2), F(db1), F(db2), m_rows, t_len, d, f,
                    rows_per_chunk, n_chunks, seed, thresh, scale, s)
              : bwd<float>(x, g, lw, lb, w1, bb1, w2, dx, F(part_ds),
                           F(part_dsb), F(pw1), F(pw2), F(pb1), F(pb2), F(ds),
                           F(dsb), F(dw1), F(dw2), F(db1), F(db2), m_rows,
                           t_len, d, f, rows_per_chunk, n_chunks, seed,
                           thresh, scale, s);
}
