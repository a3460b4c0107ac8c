// Striding x4 ConvSubsampling: Conv2d(1->C, 3x3, s2, p1) + ReLU ->
// Conv2d(C->C, 3x3, s2, p1) + ReLU -> channel-major (C, F/4) flatten ->
// Linear(C * F/4 -> D) without its bias (the caller adds it).
//
// Replaces tpu_asr/ops/pallas_subsampling.py::_subsample_kernel
// (fused_subsampling).
//
// What bounds it on an H100: conv2 is the whole cost. At B=32 x 15 s it is a
// 240,640 x 176 x 1,584 product (134 GFLOP), next to 3 GFLOP for conv1 and
// 15 GFLOP for the out-Linear. So it is bound by multiply-add throughput;
// memory traffic is the conv1 activation (B, T/2, F/2, C), written once and
// read back by conv2 (~0.7 GB in fp32).
//
// Design, two launches:
//   1. conv1 + ReLU, one thread per output (b, t1, f1, c), channels-last so
//      that conv2's reduction axis (tap, c_in) reads contiguous channels.
//      Positions outside the conv1 output are never materialised, so
//      conv2's zero padding reads zero and not ReLU(b1).
//   2. conv2 + ReLU + flatten + Linear per (batch row, kTT output frames):
//      an implicit GEMM of (kTT * F2) positions x C channels over
//      K = 9 * C, with the im2col tile gathered from the conv1 activation
//      into shared memory chunk by chunk; the ReLU'd conv2 tile stays in
//      shared memory in the (C, F2) channel-major order of `pre_encode.out`,
//      and the Linear runs over it there.
// Plain SIMT with fp32 accumulation; operands in fp32 or bf16 (template).
// Tensor cores (wgmma) and keeping the conv1 activation on chip are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
__global__ void __launch_bounds__(256) conv1_kernel(
    const T* __restrict__ x,      // (B, t0, f0)
    const T* __restrict__ w1,     // (ch, 9): [c][kt * 3 + kf]
    const float* __restrict__ b1, // (ch)
    T* __restrict__ h1,           // (B, t1, f1, ch)
    int t0, int f0, int t1, int f1, int ch) {
  const int r = blockIdx.x, b = blockIdx.z;
  const int idx = blockIdx.y * blockDim.x + threadIdx.x;
  if (idx >= f1 * ch) return;
  const int fo = idx / ch, c = idx - fo * ch;
  float acc = 0.f;
#pragma unroll
  for (int kt = 0; kt < 3; ++kt) {
    const int ti = 2 * r + kt - 1;
    if (ti < 0 || ti >= t0) continue;
#pragma unroll
    for (int kf = 0; kf < 3; ++kf) {
      const int fi = 2 * fo + kf - 1;
      if (fi < 0 || fi >= f0) continue;
      acc = fmaf(to_f(x[((size_t)b * t0 + ti) * f0 + fi]),
                 to_f(w1[c * 9 + kt * 3 + kf]), acc);
    }
  }
  h1[(((size_t)b * t1 + r) * f1 + fo) * ch + c] =
      from_f<T>(fmaxf(acc + b1[c], 0.f));
}

constexpr int kTT = 4;        // most output frames per block
constexpr int kMR = 5;        // rows per thread: kTT * F2 <= 16 * kMR = 80
constexpr int kBK = 16;       // reduction chunk
constexpr int kAS = 16 * kMR + 1;  // As row stride (odd: conflict-free stores)
// Output channels per thread: 16 * NR covers the channel count. Two
// variants are built: NR = 11 for ModelConfig's C = 176 and NR = 6 for its
// student's C = 88 (make_student_config); each more variant costs build time.

template <typename T, int NR>
__global__ void __launch_bounds__(256) conv2_linear_kernel(
    const T* __restrict__ h1,      // (B, t1, f1, ch)
    const T* __restrict__ w2k,     // (9 * ch, ch): [tap * ch + c_in][c_out]
    const float* __restrict__ b2,  // (ch)
    const T* __restrict__ wlt,     // (ch * f2, d): [c * f2 + f][d]
    T* __restrict__ out,           // (B, t2, d)
    int t1, int f1, int t2, int f2, int ch, int d, int tt) {
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);  // kBK x kAS
  float* Bs = As + kBK * kAS;                   // kBK x 16 * NR
  float* H2 = Bs + kBK * 16 * NR;               // tt x (ch * f2)
  constexpr int kBN = 16 * NR;
  const int m_rows = tt * f2, kflat = ch * f2, K = 9 * ch;
  const int b = blockIdx.y, tb = blockIdx.x * tt;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  float acc[kMR][NR];
#pragma unroll
  for (int i = 0; i < kMR; ++i)
#pragma unroll
    for (int j = 0; j < NR; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // im2col chunk: row m = (frame, f2 position), column k = (tap, c_in)
    for (int i = tid; i < kBK * 16 * kMR; i += 256) {
      const int m = i / kBK, kk = i - m * kBK, k = k0 + kk;
      float v = 0.f;
      if (m < m_rows && k < K) {
        const int tap = k / ch, ci = k - tap * ch;
        const int kt = tap / 3, kf = tap - kt * 3;
        const int tl = m / f2, fo = m - tl * f2;
        const int ti = 2 * (tb + tl) + kt - 1, fi = 2 * fo + kf - 1;
        if (tb + tl < t2 && ti >= 0 && ti < t1 && fi >= 0 && fi < f1)
          v = to_f(h1[(((size_t)b * t1 + ti) * f1 + fi) * ch + ci]);
      }
      As[kk * kAS + m] = v;
    }
    for (int i = tid; i < kBK * kBN; i += 256) {
      const int kk = i / kBN, n = i - kk * kBN, k = k0 + kk;
      Bs[i] = (k < K && n < ch) ? to_f(w2k[(size_t)k * ch + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kMR], w[NR];
#pragma unroll
      for (int i = 0; i < kMR; ++i) a[i] = As[kk * kAS + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NR; ++j) w[j] = Bs[kk * kBN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kMR; ++i)
#pragma unroll
        for (int j = 0; j < NR; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }

  // bias + ReLU, rounded to the working type, flattened channel-major
#pragma unroll
  for (int i = 0; i < kMR; ++i) {
    const int m = ty + 16 * i;
    if (m >= m_rows) continue;
    const int tl = m / f2, fo = m - tl * f2;
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      const int n = tx + 16 * j;
      if (n < ch)
        H2[tl * kflat + n * f2 + fo] =
            to_f(from_f<T>(fmaxf(acc[i][j] + b2[n], 0.f)));
    }
  }
  __syncthreads();

  // out-Linear over the flattened tile, all kTT frames per weight load
  for (int dd = tid; dd < d; dd += 256) {
    float o[kTT];
#pragma unroll
    for (int tl = 0; tl < kTT; ++tl) o[tl] = 0.f;
    for (int k = 0; k < kflat; ++k) {
      const float w = to_f(wlt[(size_t)k * d + dd]);
#pragma unroll
      for (int tl = 0; tl < kTT; ++tl)
        if (tl < tt) o[tl] = fmaf(H2[tl * kflat + k], w, o[tl]);
    }
#pragma unroll
    for (int tl = 0; tl < kTT; ++tl)
      if (tl < tt && tb + tl < t2)
        out[((size_t)b * t2 + tb + tl) * d + dd] = from_f<T>(o[tl]);
  }
}

template <typename T, int NR>
cudaError_t launch_conv2(const void* h1, const void* w2k, const void* b2,
                         const void* wlt, void* out, int batch, int t1,
                         int f1, int t2, int f2, int ch, int d, int tt,
                         cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      ((size_t)kBK * kAS + (size_t)kBK * 16 * NR + (size_t)tt * ch * f2);
  cudaError_t err = cudaFuncSetAttribute(
      conv2_linear_kernel<T, NR>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t2 + tt - 1) / tt, batch);
  conv2_linear_kernel<T, NR><<<grid, 256, smem, stream>>>(
      (const T*)h1, (const T*)w2k, (const float*)b2, (const T*)wlt, (T*)out,
      t1, f1, t2, f2, ch, d, tt);
  return cudaGetLastError();
}

template <typename T>
int run(const void* x, const void* w1, const void* b1, const void* w2k,
        const void* b2, const void* wlt, void* h1, void* out, int batch,
        int t0, int f0, int ch, int d, cudaStream_t stream) {
  const int t1 = (t0 - 1) / 2 + 1, f1 = (f0 - 1) / 2 + 1;
  const int t2 = (t1 - 1) / 2 + 1, f2 = (f1 - 1) / 2 + 1;
  const int nr = (ch + 15) / 16;
  if (nr != 6 && nr != 11) return (int)cudaErrorInvalidValue;
  const dim3 grid1(t1, (f1 * ch + 255) / 256, batch);
  conv1_kernel<T><<<grid1, 256, 0, stream>>>(
      (const T*)x, (const T*)w1, (const float*)b1, (T*)h1, t0, f0, t1, f1, ch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int tt = (16 * kMR) / f2 < kTT ? (16 * kMR) / f2 : kTT;
  return (int)(nr == 6 ? launch_conv2<T, 6>(h1, w2k, b2, wlt, out, batch, t1,
                                            f1, t2, f2, ch, d, tt, stream)
                       : launch_conv2<T, 11>(h1, w2k, b2, wlt, out, batch, t1,
                                             f1, t2, f2, ch, d, tt, stream));
}

}  // namespace

// The wrapper guarantees: contiguous tensors of one dtype (fp32 or bf16,
// biases fp32) on one device, ch in (80, 96] or (160, 176], F2 = F0 / 4 (rounded up)
// <= 80, and h1 sized (B, T1, F1, ch).
extern "C" int tat_subsampling(int bf16, const void* x, const void* w1,
                               const void* b1, const void* w2k,
                               const void* b2, const void* wlt, void* h1,
                               void* out, int batch, int t0, int f0, int ch,
                               int d, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? run<__nv_bfloat16>(x, w1, b1, w2k, b2, wlt, h1, out, batch,
                                   t0, f0, ch, d, s)
              : run<float>(x, w1, b1, w2k, b2, wlt, h1, out, batch, t0, f0,
                           ch, d, s);
}
