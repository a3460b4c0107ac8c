// Striding x4 ConvSubsampling: Conv2d(1->C, 3x3, s2, p1) + ReLU ->
// Conv2d(C->C, 3x3, s2, p1) + ReLU -> (C, F/4) flatten -> Linear(C * F/4 -> D)
// without its bias (the caller adds it).
//
// Replaces tpu_asr/ops/pallas_subsampling.py::_subsample_kernel
// (fused_subsampling).
//
// What bounds it on an H100: conv2 is the whole cost. At B=32 x 15 s,
// C=176 it is a 240,640 x 176 x 1,584 product (134 GFLOP), next to 3 GFLOP
// for conv1 and 15 GFLOP for the out-Linear: bound by operations at the
// bf16 tensor rate (0.15 ms). Its memory traffic is the conv1 activation
// (B, T/2, F/2, C), written once and read back by conv2 (338 MB in bf16,
// 0.1 ms each way at the HBM rate; L2 catches the 9-fold tap reuse).
//
// Design, three launches:
//   1. conv1_kernel: conv1 + ReLU, one thread per 8 channels of one output
//      column f1, holding their 72 taps in registers over 16 output rows,
//      channels-last h1 (B, T1, F1, C) written 16 bytes at a time, so that
//      conv2's reduction axis (tap, c_in) reads contiguous channels.
//      Positions outside the conv1 output are never written, so conv2's
//      zero padding reads zero and not ReLU(b1).
//   2. conv2_kernel: conv2 + b2 + ReLU as an implicit GEMM (gemm.cuh) on
//      the tensor cores: M = B T2 F2 output positions, N = C, K = 9 C in
//      (tap, c_in) order. With C % 8 == 0 every 16-byte piece of a row's
//      K tile is 8 channels of one tap at one h1 position, so the loader
//      (ConvRows) copies it with one cp.async, zero-filled where the tap
//      falls in the padding; each row's base offset is computed once per
//      block and the (tap, c_in) column is stepped, not divided, per K tile.
//      The result, rounded to the working type where the TPU kernel rounds
//      it, is h2 (B T2, F2 C): row m of the GEMM is one (frame, f) position.
//      The grid is 1-D with the N tiles of one M tile adjacent, so they run
//      together and read that tile's h1 rows from L2, not from HBM.
//   3. linear_kernel: h2 (B T2, F2 C) @ W_out'^T on the tensor cores, where
//      W_out' is the out-Linear weight with its K axis in the (f, c) order
//      of h2, permuted once per weight by the wrapper (ops/
//      cuda_subsampling.py). Flattening channel-major in conv2's epilogue
//      instead would turn its coalesced row stores into 40-byte scatters;
//      permuting the 1.2 MB weight once costs nothing per call, and the
//      Pallas kernel takes its Linear weight (F2 C)-ordered too.
// C is a runtime parameter: any C % 8 == 0 (the GEMM tiles walk N and K,
// so shared memory does not bound it; the wrapper takes C <= 1024). bf16
// products run on mma.sync.m16n8k16 with fp32 accumulation; fp32 (the
// check dtype) runs the same launches with SIMT products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "gemm.cuh"

namespace {

__device__ __forceinline__ void store8(float* dst, const float (&v)[8]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* dst,
                                       const float (&v)[8]) {
  uint4 u;
  u.x = pack_bf16(v[0], v[1]);
  u.y = pack_bf16(v[2], v[3]);
  u.z = pack_bf16(v[4], v[5]);
  u.w = pack_bf16(v[6], v[7]);
  *reinterpret_cast<uint4*>(dst) = u;
}

constexpr int kRowsPerBlock = 16;  // conv1 output rows (b, t1) per block

template <typename T>
__global__ void __launch_bounds__(128) conv1_kernel(
    const T* __restrict__ x,      // (B, t0, f0)
    const T* __restrict__ w1,     // (ch, 9): [c][kt * 3 + kf]
    const float* __restrict__ b1, // (ch)
    T* __restrict__ h1,           // (B, t1, f1, ch)
    int rows, int t0, int f0, int t1, int f1, int ch) {
  // thread: 8 channels cg * 8 .. of column fo, kept in registers with
  // their 72 taps, for kRowsPerBlock rows
  const int groups = ch / 8;
  const int idx = blockIdx.y * blockDim.x + threadIdx.x;
  if (idx >= f1 * groups) return;
  const int fo = idx / groups, cg = idx - fo * groups;
  float w[8][9], bias[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    bias[c] = b1[cg * 8 + c];
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
      w[c][tap] = to_f(w1[(cg * 8 + c) * 9 + tap]);
  }
  const int r_end = min(rows, (blockIdx.x + 1) * kRowsPerBlock);
  for (int br = blockIdx.x * kRowsPerBlock; br < r_end; ++br) {
    const int b = br / t1, r = br - b * t1;
    float xin[9];
#pragma unroll
    for (int kt = 0; kt < 3; ++kt) {
      const int ti = 2 * r + kt - 1;
#pragma unroll
      for (int kf = 0; kf < 3; ++kf) {
        const int fi = 2 * fo + kf - 1;
        xin[kt * 3 + kf] = (ti >= 0 && ti < t0 && fi >= 0 && fi < f0)
                               ? to_f(x[((size_t)b * t0 + ti) * f0 + fi])
                               : 0.f;
      }
    }
    float out[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float acc = 0.f;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) acc = fmaf(xin[tap], w[c][tap], acc);
      out[c] = fmaxf(acc + bias[c], 0.f);
    }
    store8(h1 + ((size_t)br * f1 + fo) * ch + cg * 8, out);
  }
}

// conv2's A rows: row m = (b, t, f) of the output reads h1 at
// (b, 2t - 1 + kt, 2f - 1 + kf, c_in) for column k = (kt * 3 + kf) * C + c_in.
template <typename T>
struct ConvRows {
  const T* h1;
  int t1, f1, ch, tap, ci;     // this thread's column: tap, c_in
  long long base[4];           // (b * t1 + ti0) * f1 + fi0 per row
  int ti0[4], fi0[4];
  bool ok[4];
  __device__ ConvRows(const T* h1_, int m, int t1_, int f1_, int t2, int f2,
                      int ch_, int m0, int r0, int pc)
      : h1(h1_), t1(t1_), f1(f1_), ch(ch_) {
    const int k = pc * (16 / (int)sizeof(T));
    tap = k / ch;
    ci = k - tap * ch;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = m0 + r0 + 32 * j;
      ok[j] = r < m;
      const int rr = ok[j] ? r : 0;
      const int f = rr % f2, bt = rr / f2;
      const int t = bt % t2, b = bt / t2;
      ti0[j] = 2 * t - 1;
      fi0[j] = 2 * f - 1;
      base[j] = ((long long)b * t1 + ti0[j]) * f1 + fi0[j];
    }
  }
  __device__ void issue(char* tile, int r0, int pc) {
    const int kt = tap / 3, kf = tap - 3 * kt;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ti = ti0[j] + kt, fi = fi0[j] + kf;
      const bool v = ok[j] && tap < 9 && ti >= 0 && ti < t1 && fi >= 0 &&
                     fi < f1;
      const T* src =
          v ? h1 + (base[j] + (long long)kt * f1 + kf) * ch + ci : h1;
      cp_async16(tile + (r0 + 32 * j) * kGRow + pc * 16, src, v);
    }
    ci += 64 / (int)sizeof(T);
    while (ci >= ch) {
      ci -= ch;
      ++tap;
    }
  }
};

template <typename T, int WN>
__global__ void __launch_bounds__(128) conv2_kernel(
    const T* __restrict__ h1,      // (B, t1, f1, ch)
    const T* __restrict__ w2k,     // (ch, 9 * ch): [c_out][tap * ch + c_in]
    const float* __restrict__ b2,  // (ch)
    T* __restrict__ h2,            // (B t2 f2, ch)
    int m, int t1, int f1, int t2, int f2, int ch) {
  extern __shared__ __align__(16) char smem[];
  constexpr int kN = gemm_cols<WN>();
  const int n_tiles = (ch + kN - 1) / kN;
  const int m0 = (blockIdx.x / n_tiles) * kGM;
  const int n0 = (blockIdx.x % n_tiles) * kN;
  ConvRows<T> a(h1, m, t1, f1, t2, f2, ch, m0, threadIdx.x / 4,
                threadIdx.x % 4);
  gemm_tile<WN>(smem, a, w2k, ch, 9 * ch, m0, n0,
               [&](int r, int c, float v) {
                 if (r < m && c < ch)
                   h2[(size_t)r * ch + c] = from_f<T>(fmaxf(v + b2[c], 0.f));
               });
}

template <typename T, int WN>
__global__ void __launch_bounds__(128) linear_kernel(
    const T* __restrict__ a_in,   // (m, k)
    const T* __restrict__ w,      // (n, k)
    T* __restrict__ out,          // (m, n)
    int m, int n, int k) {
  extern __shared__ __align__(16) char smem[];
  constexpr int kN = gemm_cols<WN>();
  const int n_tiles = (n + kN - 1) / kN;
  const int m0 = (blockIdx.x / n_tiles) * kGM;
  const int n0 = (blockIdx.x % n_tiles) * kN;
  PlainRows<T> a(a_in, m, k, m0, threadIdx.x / 4, threadIdx.x % 4);
  gemm_tile<WN>(smem, a, w, n, k, m0, n0, [&](int r, int c, float v) {
    if (r < m && c < n) out[(size_t)r * n + c] = from_f<T>(v);
  });
}

// One GEMM kernel over an m x n output of 128 x 16 WN tiles, N tiles
// adjacent in the 1-D grid.
template <int WN, typename... P, typename... A>
cudaError_t launch_gemm(void (*kernel)(P...), int m, int n,
                        cudaStream_t stream, A... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, gemm_smem<WN>());
  if (err != cudaSuccess) return err;
  const int grid = ((m + kGM - 1) / kGM) *
                   ((n + gemm_cols<WN>() - 1) / gemm_cols<WN>());
  kernel<<<grid, 128, gemm_smem<WN>(), stream>>>(args...);
  return cudaGetLastError();
}

template <typename T>
int run(const void* x, const void* w1, const void* b1, const void* w2k,
        const void* b2, const void* wlp, void* h1, void* h2, void* out,
        int batch, int t0, int f0, int ch, int d, cudaStream_t stream) {
  const int t1 = (t0 - 1) / 2 + 1, f1 = (f0 - 1) / 2 + 1;
  const int t2 = (t1 - 1) / 2 + 1, f2 = (f1 - 1) / 2 + 1;
  if (ch % 8 != 0) return (int)cudaErrorInvalidValue;
  const int rows = batch * t1;
  conv1_kernel<T><<<dim3((rows + kRowsPerBlock - 1) / kRowsPerBlock,
                         (f1 * (ch / 8) + 127) / 128),
                    128, 0, stream>>>((const T*)x, (const T*)w1,
                                      (const float*)b1, (T*)h1, rows, t0, f0,
                                      t1, f1, ch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int m = batch * t2 * f2, rows2 = batch * t2;
  const int w_conv = gemm_width(ch), w_lin = gemm_width(d);
  if ((err = (w_conv == 6 ? launch_gemm<6>(conv2_kernel<T, 6>, m, ch, stream,
                                           (const T*)h1, (const T*)w2k,
                                           (const float*)b2, (T*)h2, m, t1,
                                           f1, t2, f2, ch)
                          : launch_gemm<4>(conv2_kernel<T, 4>, m, ch, stream,
                                           (const T*)h1, (const T*)w2k,
                                           (const float*)b2, (T*)h2, m, t1,
                                           f1, t2, f2, ch))) != cudaSuccess)
    return (int)err;
  return (int)(w_lin == 6
                   ? launch_gemm<6>(linear_kernel<T, 6>, rows2, d, stream,
                                    (const T*)h2, (const T*)wlp, (T*)out,
                                    rows2, d, f2 * ch)
                   : launch_gemm<4>(linear_kernel<T, 4>, rows2, d, stream,
                                    (const T*)h2, (const T*)wlp, (T*)out,
                                    rows2, d, f2 * ch));
}

}  // namespace

// The wrapper guarantees: contiguous tensors of one dtype (fp32 or bf16,
// biases fp32) on one device, ch % 8 == 0, w2k (ch, 9 ch) in (tap, c_in)
// order, wlp (d, f2 ch) in (f, c) order, h1 sized (B, T1, F1, ch) and h2
// (B T2 F2, ch).
extern "C" int tat_subsampling(int bf16, const void* x, const void* w1,
                               const void* b1, const void* w2k,
                               const void* b2, const void* wlp, void* h1,
                               void* h2, void* out, int batch, int t0, int f0,
                               int ch, int d, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? run<__nv_bfloat16>(x, w1, b1, w2k, b2, wlp, h1, h2, out,
                                   batch, t0, f0, ch, d, s)
              : run<float>(x, w1, b1, w2k, b2, wlp, h1, h2, out, batch, t0,
                           f0, ch, d, s);
}
