// Conformer feed-forward sublayer for int8 serving (eval only), per row:
//   y  = LN(x) in fp32 (E[x^2] - E[x]^2, eps 1e-6), not rounded
//   sx = max(max|y|, 1e-8 * 127) * (1 / 127);  yq = clip(rint(y / sx), +-127)
//   h  = silu(int32(yq . W1q) * sx * s1 + b1)                       fp32
//   sh = max(max|h|, 1e-8 * 127) * (1 / 127);  hq = clip(rint(h / sh), +-127)
//   o  = int32(hq . W2q) * sh * s2 + b2
//   out = x + 0.5 o, rounded to x's type (fp32 or bf16)
// with per-output-channel int8 weights W1q (f, d), W2q (d, f) and their fp32
// scales s1 (f), s2 (d), quantized by the wrapper (ops/quant.py).
//
// Replaces tpu_asr/ops/pallas_ffn.py::_ffn_int8_kernel, launched by
// ops/cuda_ffn.py::fused_ffn_sublayer_int8.
//
// What bounds it on an H100: at B=32, T'=376, D=176, d_ff=704 the two
// products are 4 M D d_ff = 5.96 G int8 operations (3.0 us at the 1,979 TOP/s
// int8 tensor rate) against 8.5 MB of bf16 x in and out (2.5 us at
// 3.35 TB/s): operations, if the per-token scales and the (M, d_ff)
// activation never reach device memory.
//
// Design: one block of 8 warps per 16 rows. LN with one warp per row into
// int8 rows in shared memory; both products on the tensor cores with
// mma.sync m16n8k32 s8 x s8 -> s32, exact int32 sums. A warp owns 32 output
// columns (four n8 tiles) of a 256-column pass; its A fragments come from
// shared memory, its B fragments straight from the int8 weights in device
// memory (L2-resident: 2 x 124 KB at d176). Each thread reads 8 contiguous
// bytes of a row: the k order inside a 32-deep step is permuted the same way
// for A and B (physical k 8 tig + i feeds logical k 4 tig + i, 8 tig + 4 + i
// feeds 16 + 4 tig + i), which leaves the sum unchanged. The fp32 h rows
// (16 x d_ff) stay in shared memory until their scale is known. Rows with
// stride = 32 (mod 64) bytes keep the 8-byte fragment loads of a half-warp
// on 32 distinct banks. Products and sums round as the plain version does:
// no contraction of a multiply and an add into one fma.

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

constexpr int kMT = 16;            // rows per block: one m16 tile
constexpr int kWarps = 8;
constexpr int kNW = 32;            // output columns per warp and pass
constexpr int kNP = kWarps * kNW;  // output columns per pass
constexpr int kMaxD = 512, kMaxF = 2048;
constexpr int kMaxDJ = kMaxD / 32;  // LN values per lane

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Columns rounded up to the mma depth, and the row stride of an int8 tile.
__host__ __device__ inline int pad32(int k) { return (k + 31) / 32 * 32; }
__host__ __device__ inline int q_stride(int kp) {
  return kp % 64 == 0 ? kp + 32 : kp;
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

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[j] = the m16n8 tile of rows 0..15 of A (int8 in shared memory, stride
// sa bytes, kp columns) times columns n = nb + 8 j + 0..7 of W^T, for the
// warp's nb = n0 + 32 warp; W (n_rows, kp) int8 in device memory, rows past
// n_rows read as 0. Fragment (lane = 4 g + t): acc[j][0, 1] row g, columns
// 2 t + 0, 1; acc[j][2, 3] row g + 8.
__device__ __forceinline__ void product(int (&acc)[4][4], const int8_t* a,
                                        int sa,
                                        const int8_t* __restrict__ w,
                                        int n0, int n_rows, int kp) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0;
  const int nb = n0 + warp * kNW;
  if (nb >= n_rows) return;
  const int8_t* a_lo = a + g * sa + 8 * t;
  const int8_t* a_hi = a_lo + 8 * sa;
  const int8_t* wr[4];
  bool ok[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = nb + 8 * j + g;
    ok[j] = n < n_rows;
    wr[j] = w + (size_t)(ok[j] ? n : 0) * kp + 8 * t;
  }
  for (int k0 = 0; k0 < kp; k0 += 32) {
    const uint2 lo = *reinterpret_cast<const uint2*>(a_lo + k0);
    const uint2 hi = *reinterpret_cast<const uint2*>(a_hi + k0);
    const uint32_t af[4] = {lo.x, hi.x, lo.y, hi.y};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint2 bv = ok[j] ? __ldg(reinterpret_cast<const uint2*>(wr[j] + k0))
                             : make_uint2(0u, 0u);
      const uint32_t bf[2] = {bv.x, bv.y};
      mma_s8(acc[j], af, bf);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(256) ffn_int8_kernel(
    const T* __restrict__ x, const float* __restrict__ lnw,
    const float* __restrict__ lnb, const int8_t* __restrict__ w1q,
    const float* __restrict__ s1, const float* __restrict__ b1,
    const int8_t* __restrict__ w2q, const float* __restrict__ s2,
    const float* __restrict__ b2, T* __restrict__ out, int m_rows, int d,
    int f) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int dp = pad32(d), fp = pad32(f);
  const int sa = q_stride(dp), sb = q_stride(fp);
  float* hs = reinterpret_cast<float*>(smem);           // kMT x f
  int8_t* yq = reinterpret_cast<int8_t*>(hs + kMT * f);  // kMT x sa
  int8_t* hq = yq + kMT * sa;                            // kMT x sb
  float* sx = reinterpret_cast<float*>(hq + kMT * sb);   // kMT
  float* sh = sx + kMT;                                  // kMT
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * kMT;

  // LN and per-token quantization, one warp per row
  for (int i = 0; i < kMT / kWarps; ++i) {
    const int row = warp * (kMT / kWarps) + i, m = m0 + row;
    float v[kMaxDJ], s = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxDJ; ++j) {
      const int c = lane + 32 * j;
      v[j] = (m < m_rows && c < d) ? to_f(x[(size_t)m * d + c]) : 0.f;
      s = __fadd_rn(s, v[j]);
      s2 = __fadd_rn(s2, __fmul_rn(v[j], v[j]));
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
      v[j] = c < d ? __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[j], mu), r),
                                         lnw[c]), lnb[c])
                   : 0.f;
      amax = fmaxf(amax, fabsf(v[j]));
    }
    const float scale = act_scale(warp_max(amax)), inv = 1.f / scale;
#pragma unroll
    for (int j = 0; j < kMaxDJ; ++j) {
      const int c = lane + 32 * j;
      if (c < dp) yq[row * sa + c] = c < d ? quant(v[j], inv) : (int8_t)0;
    }
    if (lane == 0) sx[row] = scale;
  }
  __syncthreads();

  // h = silu(dequant(yq W1q^T) + b1), fp32 rows in shared memory
  int acc[4][4];
  for (int n0 = 0; n0 < f; n0 += kNP) {
    product(acc, yq, sa, w1q, n0, f, dp);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = g + (e >> 1) * 8;
        const int col = n0 + warp * kNW + 8 * j + 2 * t + (e & 1);
        if (col >= f) continue;
        float h = __fadd_rn(__fmul_rn(__fmul_rn((float)acc[j][e], sx[row]),
                                      s1[col]), b1[col]);
        h = __fmul_rn(h, 1.f / (1.f + expf(-h)));
        hs[row * f + col] = h;
      }
  }
  __syncthreads();

  // per-token quantization of h
  for (int i = 0; i < kMT / kWarps; ++i) {
    const int row = warp * (kMT / kWarps) + i;
    float amax = 0.f;
    for (int c = lane; c < f; c += 32) amax = fmaxf(amax, fabsf(hs[row * f + c]));
    const float scale = act_scale(warp_max(amax)), inv = 1.f / scale;
    for (int c = lane; c < fp; c += 32)
      hq[row * sb + c] = c < f ? quant(hs[row * f + c], inv) : (int8_t)0;
    if (lane == 0) sh[row] = scale;
  }
  __syncthreads();

  // out = x + 0.5 (dequant(hq W2q^T) + b2)
  for (int n0 = 0; n0 < d; n0 += kNP) {
    product(acc, hq, sb, w2q, n0, d, fp);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = g + (e >> 1) * 8, m = m0 + row;
        const int col = n0 + warp * kNW + 8 * j + 2 * t + (e & 1);
        if (col >= d || m >= m_rows) continue;
        const float o = __fadd_rn(
            __fmul_rn(__fmul_rn((float)acc[j][e], sh[row]), s2[col]), b2[col]);
        const size_t at = (size_t)m * d + col;
        out[at] = from_f<T>(__fadd_rn(to_f(x[at]), __fmul_rn(0.5f, o)));
      }
  }
}

template <typename T>
int launch(const void* x, const float* lnw, const float* lnb,
           const int8_t* w1q, const float* s1, const float* b1,
           const int8_t* w2q, const float* s2, const float* b2, void* out,
           int m_rows, int d, int f, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)kMT * f + 2 * kMT) +
                      (size_t)kMT * (q_stride(pad32(d)) + q_stride(pad32(f)));
  cudaError_t err = cudaFuncSetAttribute(
      ffn_int8_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  ffn_int8_kernel<T><<<(m_rows + kMT - 1) / kMT, kWarps * 32, smem,
                       stream>>>((const T*)x, lnw, lnb, w1q, s1, b1, w2q, s2,
                                 b2, (T*)out, m_rows, d, f);
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
