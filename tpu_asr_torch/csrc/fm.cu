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
// Routes (`mma_route`): every C % 8 == 0 and H % 32 == 0 up to 512 and
// any max_steps >= 1 run, in both types. bf16 at C <= 128, H <= 256 takes
// the narrow tensor-core kernels below; every other bf16 shape the wide
// tensor-core kernels (fm_fwd_wide_mma_kernel, fm_bwd_wide_rows_kernel:
// the tiles in shared memory, the weights through a ring of 64 x 64
// windows; see their section); fp32 (the check dtype) at every shape the
// SIMT kernels (fm_fwd_wide_kernel<float>, fm_bwd_wide_kernel<float>: fp32
// accumulation, no TF32, so that fp32 agrees with full-precision
// references). No shape falls back: a failed launch is an error. At
// conformer-LARGE's flowkd_large shape (rows = 4 x 18 layers, T' = 376,
// C = 256, H = 128, 8 steps) the forward is 28.4 GFLOP and the backward
// 3x that: 0.029 and 0.086 ms at the bf16 tensor rate.

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

constexpr int kThreads = 256;        // the SIMT kernels' blocks

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
// kDwRows): blocks [0, tc th) tile dW1x (cc, h) = X^T DP, the rest dW2 (h,
// cc) = H^T DV, tc = ceil(cc / 128), th = ceil(h / 128) (gemm.cuh's
// gemm_tn_tile, 128 x 128 tiles, each reading every workspace row of its
// two column bands once), into part[blockIdx.y] = [dW1x (cc h) | dW2 (h
// cc)]. cp: the workspace's x and dv row stride (CP or cc).
__host__ __device__ constexpr int dw_tiles(int cc, int h) {
  return 2 * ((cc + 127) / 128) * ((h + 127) / 128);
}

__global__ void __launch_bounds__(128) fm_bwd_dw_kernel(
    Work wk, float* __restrict__ part, int m_rows, int cp, int cc, int h) {
  extern __shared__ __align__(16) char smem[];
  const int m_lo = blockIdx.y * kDwRows;
  const int m_hi = min(m_rows, m_lo + kDwRows);
  float* out = part + (size_t)blockIdx.y * 2 * cc * h;
  const int tc = (cc + 127) / 128, th = (h + 127) / 128;
  const int tile = blockIdx.x;
  if (tile < tc * th) {
    gemm_tn_tile<128>(smem, wk.x, cp, wk.dp, h, false, m_lo, m_hi,
                      128 * (tile / th), 128 * (tile % th),
                      [&](int i, int j, float v) {
                        if (i < cc && j < h) out[(size_t)i * h + j] = v;
                      });
  } else {
    const int u = tile - tc * th;
    float* o2 = out + (size_t)cc * h;
    gemm_tn_tile<128>(smem, wk.h, h, wk.dv, cp, false, m_lo, m_hi,
                      128 * (u / tc), 128 * (u % tc),
                      [&](int i, int j, float v) {
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

// ---------------------------------------------------------------------------
// bf16 beyond C = 128 or H = 256 on the tensor cores (fm_fwd_wide_mma_kernel;
// fm_bwd_wide_rows_kernel, then fm_bwd_dw_kernel and fm_bwd_sum_kernel):
// conformer-LARGE's student is C = 256, XLarge's C = 512. They replace
// pallas_fm.py::_fm_fwd_kernel and ::_fm_bwd_kernel at those widths.
//
// What bounds them: the products (4 steps rows T C H flops forward, 14 in
// the backward with its replay and the p it recomputes) on the tensor cores
// if x, h, v and gx never leave the chip between steps. Neither the whole
// weights (256 KB at C = 512, H = 128) nor a 16-position tile's x and v in
// registers (64 + 128 a thread at C = 256) fit, as the narrow kernels keep
// them. So here a block's warps each own a 16-position tile (rows x T
// flattened) whose x and h (backward: x_j, round(dv), round(dp)) lie in
// shared memory in bf16, and the weights stream through a ring of kRing
// 64 x 64 windows (cp.async, zero-filled past C or H): every warp of the
// block multiplies its tile by the same window, so one window read from L2
// serves 16 x (warps) positions, and one block barrier a window (64 weight
// rows) orders the ring, while the next kRing - 1 windows are in flight.
// Each product runs in 64-column chunks of its output (32 fp32 accumulators
// a thread; A fragments by ldmatrix from the warp's tile, B by ldmatrix or
// ldmatrix.trans from the window, mma.sync.m16n8k16), its epilogue in
// registers: t a + c, relu and rounding into the h tile; v + b2, rounding,
// last_v, and x = round(x - v / n) (div_n) into the x tile. The block runs
// the largest step count among its tiles' positions (capped at max_steps);
// the extra steps of a position are masked as the header says.
//   The backward follows the narrow one (three kernels, no atomics, fixed
// summation orders: bit-equal calls). fm_bwd_wide_rows_kernel replays the
// forward, writing x_j to the workspace (row stride cc), then walks j =
// steps - 1 .. 0: per 64-column chunk of H, p = x_j W1x and dh = round(dv)
// W2^T (W2's windows read transposed), whose epilogue writes h_j and
// round(dp) to the workspace and round(dp) to its tile and sums da, dc;
// then per 64-column chunk of C, gx += round(dp) W1x^T, gx in fp32 in a
// per-warp slot of device memory (C / 2 values a thread would not fit in
// registers, and an L2-resident slot costs less shared memory than the
// tile count it would take), whose epilogue forms the next step's dv (its
// tile, the workspace, db2) or, at j = 0, dx. x_{j - 1} comes back from the
// workspace. fm_bwd_dw_kernel then takes dW1x and dW2 over the workspace in
// 128 x 128 tiles of both output dimensions. Warps a block (wide_shape):
// the count that runs a call's (a chunk's) tiles in the fewest rounds of
// resident blocks (shared memory grows with C and H). Measured on an H100
// (fm_ablation.py, PERF.md), the ring's depth (2 to 8 windows) and the barriers
// hardly move the time: a block tile's serial per-warp work does, the
// products and, as much, the epilogues (the forward's at C = 512 take ~40%
// of it) and the backward's workspace stores.
// ---------------------------------------------------------------------------

constexpr int kWin = 64;                         // rows and columns a window
constexpr int kWinLd = kWin + 8;                 // staged stride (144 bytes)
constexpr size_t kWinBytes = (size_t)kWin * kWinLd * 2;
constexpr int kRing = 4;                         // windows in flight
constexpr int kMaxWarps = 16;                   // a block (forward)
constexpr int kMaxBwdWarps = 8;                 // a block (backward)

// The stride of a 16-row bf16 tile n wide (its columns padded to 64 with
// zeros, then 8 more: rows an odd multiple of 16 bytes apart).
__host__ __device__ constexpr int tile_ld(int n) {
  return (n + 63) / 64 * 64 + 8;
}

// Shared bytes a warp: x and h tiles (forward); x_j, round(dv), h_j /
// round(dp) tiles and the column sums [da | dc | db2] (backward).
__host__ __device__ constexpr size_t wide_fwd_warp(int cc, int h) {
  return (size_t)kTile * (tile_ld(cc) + tile_ld(h)) * 2;
}
__host__ __device__ constexpr int sums_len(int cc, int h) {
  return 2 * (tile_ld(h) - 8) + tile_ld(cc) - 8;
}
__host__ __device__ constexpr size_t wide_bwd_warp(int cc, int h) {
  return (size_t)kTile * (2 * tile_ld(cc) + tile_ld(h)) * 2 +
         (size_t)sums_len(cc, h) * 4;
}
// The block's: the ring, the warps', then kMaxWarps ints.
__host__ __device__ constexpr size_t wide_smem(int warps, size_t per_warp) {
  return kRing * kWinBytes + (size_t)warps * per_warp + 4 * kMaxWarps;
}

// A 64 x 64 window at (r0, c0) of a row-major (rows, cols) bf16 matrix.
struct Win {
  const bf16* m;
  int rows, cols, r0, c0;
};

__device__ __forceinline__ void issue_win(char* slot, const Win& w) {
  for (int p = threadIdx.x; p < kWin * 8; p += blockDim.x) {
    const int r = p / 8, c = 8 * (p % 8);
    const int gr = w.r0 + r, gc = w.c0 + c;
    const bool v = gr < w.rows && gc < w.cols;
    cp_async16(slot + (r * kWinLd + c) * 2,
               v ? w.m + (size_t)gr * w.cols + gc : w.m, v);
  }
}

// Runs `total` windows through the ring: win(i) names window i, eat(i,
// slot) consumes it once it has landed. Every thread of the block calls it
// with the same total; a block barrier before each window, so what a warp
// wrote to shared memory in one eat is seen by every warp in the next.
template <class WinOf, class Eat>
__device__ __forceinline__ void through_ring(char* ring, int total,
                                             WinOf win, Eat eat) {
#pragma unroll 1
  for (int s = 0; s < kRing - 1; ++s) {
    if (s < total) issue_win(ring + s * kWinBytes, win(s));
    cp_async_commit();
  }
#pragma unroll 1
  for (int i = 0; i < total; ++i) {
    cp_async_wait<kRing - 2>();
    __syncthreads();   // window i landed; window i - 1 consumed
    const int nx = i + kRing - 1;
    if (nx < total) issue_win(ring + (nx % kRing) * kWinBytes, win(nx));
    cp_async_commit();
    eat(i, ring + (i % kRing) * kWinBytes);
  }
  cp_async_wait<0>();
  __syncthreads();
}

__device__ __forceinline__ void zero_acc(float (&acc)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
}

// The fragments of k16 slice kk: A from the warp's tile, B (4 x 16 columns)
// from the window.
template <bool T>
__device__ __forceinline__ void win_frags(uint32_t (&af)[4],
                                          uint32_t (&b)[4][4], const bf16* a,
                                          int lda, int k0, const bf16* w,
                                          int kk, int lane) {
  ldmatrix_x4(af, a + (lane % 16) * lda + k0 + 16 * kk + (lane / 16) * 8);
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    if constexpr (T)
      ldmatrix_x4(b[jj], w + (16 * jj + lane % 8 + (lane / 16) * 8) * kWinLd +
                             16 * kk + ((lane / 8) % 2) * 8);
    else
      ldmatrix_x4_trans(b[jj], w + (16 * kk + lane % 8 +
                                    ((lane / 8) % 2) * 8) * kWinLd +
                                   16 * jj + (lane / 16) * 8);
  }
}

// acc += A[:, k0 .. k0 + 63] B for the warp's 16-row tile A (stride lda)
// and the 64 x 64 window B, held as [k][n] (ldmatrix.trans) or, T, as
// [n][k] (a weight used transposed: ldmatrix). The fragments of slice kk
// + 1 load before slice kk's products (the asm statements keep their
// order), so the products do not wait on each load.
template <bool T>
__device__ __forceinline__ void mma_win(float (&acc)[8][4], const bf16* a,
                                        int lda, int k0, const char* slot,
                                        int lane) {
  const bf16* w = reinterpret_cast<const bf16*>(slot);
  uint32_t af[2][4], b[2][4][4];
  win_frags<T>(af[0], b[0], a, lda, k0, w, 0, lane);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (kk + 1 < 4)
      win_frags<T>(af[(kk + 1) % 2], b[(kk + 1) % 2], a, lda, k0, w, kk + 1,
                   lane);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      mma_bf16(acc[2 * jj], af[kk % 2], b[kk % 2][jj][0], b[kk % 2][jj][1]);
      mma_bf16(acc[2 * jj + 1], af[kk % 2], b[kk % 2][jj][2],
               b[kk % 2][jj][3]);
    }
  }
}

// The warp's 16 x ld tile from rows r0 .. r0 + 15 of a row-major (., cols)
// matrix; rows >= end and columns >= cols read zero.
__device__ __forceinline__ void tile_in(bf16* t, int ld, const bf16* m,
                                        long r0, long end, int cols,
                                        int lane) {
  const int q = ld / 8;
  for (int i = lane; i < kTile * q; i += 32) {
    const int r = i / q, col = 8 * (i % q);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < end && col < cols)
      v = *reinterpret_cast<const uint4*>(m + (r0 + r) * cols + col);
    *reinterpret_cast<uint4*>(t + r * ld + col) = v;
  }
}

// The tile's columns < cols to rows r0 .. r0 + 15 (those < end) of m.
__device__ __forceinline__ void tile_out(bf16* m, const bf16* t, int ld,
                                         long r0, long end, int cols,
                                         int lane) {
  const int q = cols / 8;
  for (int i = lane; i < kTile * q; i += 32) {
    const int r = i / q, col = 8 * (i % q);
    if (r0 + r < end)
      *reinterpret_cast<uint4*>(m + (r0 + r) * cols + col) =
          *reinterpret_cast<const uint4*>(t + r * ld + col);
  }
}

// The steps the block runs: the largest of its warps' (every warp calls it).
__device__ __forceinline__ int block_steps(int* red, int steps) {
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) red[warp] = steps;
  __syncthreads();
  int m = 0;
  for (int w = 0; w < (int)blockDim.x / 32; ++w) m = max(m, red[w]);
  __syncthreads();
  return m;
}

// The forward step's windows: s < nh nc: W1x (k = 64 (s % nc), n = 64 (s
// / nc)), then W2 (k = 64 (u % nh), n = 64 (u / nh)), u = s - nh nc.
__device__ __forceinline__ Win fwd_win(int s, const bf16* w1,
                                       const bf16* w2, int cc, int h,
                                       int nc, int nh) {
  if (s < nh * nc) return Win{w1, cc, h, 64 * (s % nc), 64 * (s / nc)};
  const int u = s - nh * nc;
  return Win{w2, h, cc, 64 * (u % nh), 64 * (u / nh)};
}

// h[:, n0 .. n0 + 63] = round(relu(p + t a + c)) into the h tile (zero at
// and past h).
__device__ __forceinline__ void hidden_epi(bf16* hs, int lh,
                                           const float (&p)[8][4], int n0,
                                           const float* a, const float* c,
                                           int h, float t0, float t1,
                                           int lane) {
  const int g = lane / 4, q = lane % 4;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const int col = n0 + 8 * i + 2 * q;
      const float t = e ? t1 : t0;
      float v0 = 0.f, v1 = 0.f;
      if (col < h) {
        v0 = fmaxf(p[i][e] + t * __ldg(a + col) + __ldg(c + col), 0.f);
        v1 = fmaxf(p[i][e + 1] + t * __ldg(a + col + 1) + __ldg(c + col + 1),
                   0.f);
      }
      *reinterpret_cast<uint32_t*>(hs + (g + 4 * e) * lh + col) =
          pack_bf16(v0, v1);
    }
}

// v[:, n0 .. n0 + 63] = round(acc + b2); x = round(x - v / n) in the x
// tile where j < n; each pair of v and of the new x to put(row, col, v, x).
template <class Put>
__device__ __forceinline__ void update_epi(bf16* xs, int lx,
                                           const float (&acc)[8][4], int n0,
                                           const float* b2, int cc, int j,
                                           float n0r, float n1r, float rn0,
                                           float rn1, int lane, Put put) {
  const int g = lane / 4, q = lane % 4;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const int col = n0 + 8 * i + 2 * q, row = g + 4 * e;
      if (col >= cc) continue;
      const float n = e ? n1r : n0r, rn = e ? rn1 : rn0;
      const float v0 = rnd<bf16>(acc[i][e] + __ldg(b2 + col));
      const float v1 = rnd<bf16>(acc[i][e + 1] + __ldg(b2 + col + 1));
      uint32_t* xp = reinterpret_cast<uint32_t*>(xs + row * lx + col);
      if ((float)j < n)
        *xp = pack_bf16(lo_f(*xp) - div_n(v0, n, rn),
                        hi_f(*xp) - div_n(v1, n, rn));
      put(row, col, n, pack_bf16(v0, v1), *xp);
    }
}

__global__ void __launch_bounds__(kMaxWarps * 32, 1) fm_fwd_wide_mma_kernel(
    const bf16* __restrict__ x0, const float* __restrict__ n_rows,
    const bf16* __restrict__ w1, const float* __restrict__ a,
    const float* __restrict__ c, const bf16* __restrict__ w2,
    const float* __restrict__ b2, bf16* __restrict__ xo,
    bf16* __restrict__ vo, long n_pos, int t_len, int cc, int h, int ms) {
  extern __shared__ __align__(16) char smem[];
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32, g = lane / 4;
  const int lx = tile_ld(cc), lh = tile_ld(h);
  char* ring = smem;
  bf16* xs = reinterpret_cast<bf16*>(smem + kRing * kWinBytes) +
             (size_t)warp * (wide_fwd_warp(cc, h) / 2);
  bf16* hs = xs + kTile * lx;
  int* red = reinterpret_cast<int*>(smem + wide_smem(warps,
                                                     wide_fwd_warp(cc, h)) -
                                    4 * kMaxWarps);
  const int nc = (cc + 63) / 64, nh = (h + 63) / 64, per = 2 * nh * nc;
  const long n_tiles = (n_pos + kTile - 1) / kTile;
  for (long bt = blockIdx.x; bt * warps < n_tiles; bt += gridDim.x) {
    const long tile = bt * warps + warp, r0 = tile * kTile;
    const bool live = tile < n_tiles;
    const float n0 = pos_n(n_rows, r0 + g, n_pos, t_len);
    const float n1 = pos_n(n_rows, r0 + g + 8, n_pos, t_len);
    const float rn0 = 1.f / n0, rn1 = 1.f / n1;
    const int steps = block_steps(red, tile_steps(n0, n1, ms));
    tile_in(xs, lx, x0, r0, n_pos, cc, lane);
    float acc[8][4];
    through_ring(
        ring, steps * per,
        [&](int i) { return fwd_win(i % per, w1, w2, cc, h, nc, nh); },
        [&](int i, const char* slot) {
          if (!live) return;
          const int j = i / per, s = i % per;
          const bool ph = s < nh * nc;           // p = x W1x, else v = h W2
          const int u = ph ? s : s - nh * nc, kn = ph ? nc : nh;
          const int kp = u % kn, n0c = 64 * (u / kn);
          if (kp == 0) zero_acc(acc);
          mma_win<false>(acc, ph ? xs : hs, ph ? lx : lh, 64 * kp, slot,
                         lane);
          if (kp + 1 < kn) return;
          if (ph) {
            hidden_epi(hs, lh, acc, n0c, a, c, h, (n0 - j) / n0,
                       (n1 - j) / n1, lane);
            return;
          }
          update_epi(xs, lx, acc, n0c, b2, cc, j, n0, n1, rn0, rn1, lane,
                     [&](int row, int col, float n, uint32_t v, uint32_t) {
                       const long pos = r0 + row;   // last_v at j == n - 1
                       if ((float)j == n - 1.f && pos < n_pos)
                         *reinterpret_cast<uint32_t*>(vo + pos * cc + col) =
                             v;
                     });
        });
    if (!live) continue;
    tile_out(xo, xs, lx, r0, n_pos, cc, lane);
    for (int i = lane; i < kTile * (cc / 8); i += 32) {  // n > ms: zero
      const long pos = r0 + i / (cc / 8);
      if (pos < n_pos && n_rows[pos / t_len] > (float)ms)
        *reinterpret_cast<uint4*>(vo + pos * cc + 8 * (i % (cc / 8))) =
            make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// dv = (j < n ? -gx / n : 0) + (j == n - 1 ? gv : 0) for the C chunk n0 ..
// n0 + 63 from gx in the accumulator layout: round(dv) into the dv tile
// and workspace row block `at`, dv (unrounded) into db2's column sums.
__device__ __forceinline__ void dv_epi(bf16* dvs, int lx, bf16* wdv,
                                       float* sdb2, const float (&gx)[8][4],
                                       const bf16* gv_in, int n0, long r0,
                                       long pos_hi, int cc, int j, float n0r,
                                       float n1r, float rn0, float rn1,
                                       int lane) {
  const int g = lane / 4, q = lane % 4;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int col = n0 + 8 * i + 2 * q;
    float dv[4];
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const float n = e ? n1r : n0r, rn = e ? rn1 : rn0;
      const long pos = r0 + g + 4 * e;
      uint32_t u = 0u;
      if ((float)j == n - 1.f && pos < pos_hi && col < cc)
        u = *reinterpret_cast<const uint32_t*>(gv_in + pos * cc + col);
      const bool live = (float)j < n;
      dv[e] = (live ? div_n(-gx[i][e], n, rn) : 0.f) + lo_f(u);
      dv[e + 1] = (live ? div_n(-gx[i][e + 1], n, rn) : 0.f) + hi_f(u);
      const uint32_t r = pack_bf16(dv[e], dv[e + 1]);
      *reinterpret_cast<uint32_t*>(dvs + (g + 4 * e) * lx + col) = r;
      if (col < cc)
        *reinterpret_cast<uint32_t*>(wdv + (size_t)(g + 4 * e) * cc + col) =
            r;
    }
#pragma unroll
    for (int e = 0; e < 2; ++e)
      col_sum(sdb2 + col + e, dv[e] + dv[e + 2], lane);
  }
}

// One chunk's positions [pos_lo, pos_hi) as the section note says: dx, the
// workspace rows, and the block's partial [da (h) | dc (h) | db2 (cc)] at
// part[blockIdx.x]; gxs: a slot of 16 x tile_ld(cc) - 8 floats a warp.
__global__ void __launch_bounds__(kMaxBwdWarps * 32, 1) fm_bwd_wide_rows_kernel(
    const bf16* __restrict__ x0, const float* __restrict__ n_rows,
    const bf16* __restrict__ w1, const float* __restrict__ a,
    const float* __restrict__ c, const bf16* __restrict__ w2,
    const float* __restrict__ b2, const bf16* __restrict__ gx_in,
    const bf16* __restrict__ gv_in, bf16* __restrict__ dx, Work wk,
    float* __restrict__ part, float* __restrict__ gxs, long pos_lo,
    long pos_hi, int t_len, int cc, int h, int ms) {
  extern __shared__ __align__(16) char smem[];
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32, g = lane / 4;
  const int lx = tile_ld(cc), lh = tile_ld(h), n_sl = sums_len(cc, h);
  const size_t per_warp = wide_bwd_warp(cc, h);
  char* ring = smem;
  bf16* xs = reinterpret_cast<bf16*>(smem + kRing * kWinBytes +
                                     warp * per_warp);
  bf16* dvs = xs + kTile * lx;
  bf16* hs = dvs + kTile * lx;            // h_j in the replay, then round(dp)
  float* sda = reinterpret_cast<float*>(hs + kTile * lh);
  float* sdc = sda + (lh - 8);
  float* sdb2 = sdc + (lh - 8);
  int* red = reinterpret_cast<int*>(smem + wide_smem(warps, per_warp) -
                                    4 * kMaxWarps);
  for (int i = lane; i < n_sl; i += 32) sda[i] = 0.f;
  const int nc = (cc + 63) / 64, nh = (h + 63) / 64;
  const int per_f = 2 * nh * nc, per_b = 3 * nh * nc;
  float* slot = gxs + ((size_t)(blockIdx.x * warps + warp) * nc * 32 + lane) *
                          32;   // [chunk][lane][32]
  const long n_tiles = (pos_hi - pos_lo + kTile - 1) / kTile;
  for (long bt = blockIdx.x; bt * warps < n_tiles; bt += gridDim.x) {
    const long tile = bt * warps + warp, l0 = tile * kTile;
    const long r0 = pos_lo + l0;
    const bool live = tile < n_tiles;
    const float n0 = pos_n(n_rows, r0 + g, pos_hi, t_len);
    const float n1 = pos_n(n_rows, r0 + g + 8, pos_hi, t_len);
    const float rn0 = 1.f / n0, rn1 = 1.f / n1;
    const int steps = block_steps(red, tile_steps(n0, n1, ms));
    const auto row_at = [&](int j) { return (size_t)j * wk.cpos + l0; };
    if (live) {
      tile_in(xs, lx, x0, r0, pos_hi, cc, lane);
      tile_out(wk.x + row_at(0) * cc, xs, lx, 0, kTile, cc, lane);
      for (int j = steps; j < ms; ++j) {   // steps no row runs add zeros
        zero_warp(wk.x + row_at(j) * cc, kTile * cc, lane);
        zero_warp(wk.dv + row_at(j) * cc, kTile * cc, lane);
        zero_warp(wk.h + row_at(j) * h, kTile * h, lane);
        zero_warp(wk.dp + row_at(j) * h, kTile * h, lane);
      }
    }
    float acc[8][4], accd[8][4];
    // replay: steps 0 .. steps - 2, each step's new x into the workspace
    through_ring(
        ring, (steps - 1) * per_f,
        [&](int i) { return fwd_win(i % per_f, w1, w2, cc, h, nc, nh); },
        [&](int i, const char* slot_) {
          if (!live) return;
          const int j = i / per_f, s = i % per_f;
          const bool ph = s < nh * nc;
          const int u = ph ? s : s - nh * nc, kn = ph ? nc : nh;
          const int kp = u % kn, n0c = 64 * (u / kn);
          if (kp == 0) zero_acc(acc);
          mma_win<false>(acc, ph ? xs : hs, ph ? lx : lh, 64 * kp, slot_,
                         lane);
          if (kp + 1 < kn) return;
          if (ph) {
            hidden_epi(hs, lh, acc, n0c, a, c, h, (n0 - j) / n0,
                       (n1 - j) / n1, lane);
            return;
          }
          bf16* wx = wk.x + row_at(j + 1) * cc;
          update_epi(xs, lx, acc, n0c, b2, cc, j, n0, n1, rn0, rn1, lane,
                     [&](int row, int col, float, uint32_t, uint32_t x) {
                       *reinterpret_cast<uint32_t*>(wx + (size_t)row * cc +
                                                    col) = x;
                     });
        });
    // the walk's first dv, from gx_in; gx into the slot
    const int jl = steps - 1;
    if (live) {
#pragma unroll 1
      for (int m = 0; m < nc; ++m) {
        float gx[8][4];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; e += 2) {
            const int col = 64 * m + 8 * i + 2 * (lane % 4);
            const long pos = r0 + g + 4 * e;
            const uint32_t u =
                (pos < pos_hi && col < cc)
                    ? *reinterpret_cast<const uint32_t*>(gx_in + pos * cc +
                                                         col)
                    : 0u;
            gx[i][e] = lo_f(u);
            gx[i][e + 1] = hi_f(u);
          }
        float4* sp = reinterpret_cast<float4*>(slot + (size_t)m * 1024);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          sp[i] = make_float4(gx[i][0], gx[i][1], gx[i][2], gx[i][3]);
        dv_epi(dvs, lx, wk.dv + row_at(jl) * cc, sdb2, gx, gv_in, 64 * m, r0,
               pos_hi, cc, jl, n0, n1, rn0, rn1, lane);
      }
    }
    through_ring(
        ring, steps * per_b,
        [&](int i) {
          const int s = i % per_b;
          if (s < 2 * nh * nc) {
            const int r = s % (2 * nc), hc = 64 * (s / (2 * nc));
            return r < nc ? Win{w1, cc, h, 64 * r, hc}          // p
                          : Win{w2, h, cc, hc, 64 * (r - nc)};  // dh
          }
          const int u = s - 2 * nh * nc;                        // gx
          return Win{w1, cc, h, 64 * (u / nh), 64 * (u % nh)};
        },
        [&](int i, const char* slot_) {
          if (!live) return;
          const int j = steps - 1 - i / per_b, s = i % per_b;
          const float t0 = (n0 - j) / n0, t1 = (n1 - j) / n1;
          if (s < 2 * nh * nc) {
            const int r = s % (2 * nc), hc = 64 * (s / (2 * nc));
            if (r < nc) {                  // p = x_j W1x
              if (r == 0) zero_acc(acc);
              mma_win<false>(acc, xs, lx, 64 * r, slot_, lane);
              return;
            }
            if (r == nc) zero_acc(accd);   // dh = round(dv) W2^T
            mma_win<true>(accd, dvs, lx, 64 * (r - nc), slot_, lane);
            if (r + 1 < 2 * nc) return;
            const int q = lane % 4;
            bf16* wh = wk.h + row_at(j) * h;
            bf16* wdp = wk.dp + row_at(j) * h;
#pragma unroll
            for (int i2 = 0; i2 < 8; ++i2) {
              const int col = hc + 8 * i2 + 2 * q;
              const bool in = col < h;
              float dp[4];
#pragma unroll
              for (int e = 0; e < 4; e += 2) {
                const float t = e ? t1 : t0;
                float p0 = 0.f, p1 = 0.f;
                if (in) {
                  p0 = acc[i2][e] + t * __ldg(a + col) + __ldg(c + col);
                  p1 = acc[i2][e + 1] + t * __ldg(a + col + 1) +
                       __ldg(c + col + 1);
                }
                dp[e] = p0 > 0.f ? accd[i2][e] : 0.f;
                dp[e + 1] = p1 > 0.f ? accd[i2][e + 1] : 0.f;
                const int row = g + 4 * e;
                const uint32_t rd = pack_bf16(dp[e], dp[e + 1]);
                *reinterpret_cast<uint32_t*>(hs + row * lh + col) = rd;
                if (in) {
                  *reinterpret_cast<uint32_t*>(wh + (size_t)row * h + col) =
                      pack_bf16(fmaxf(p0, 0.f), fmaxf(p1, 0.f));
                  *reinterpret_cast<uint32_t*>(wdp + (size_t)row * h + col) =
                      rd;
                }
              }
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                col_sum(sda + col + e, t0 * dp[e] + t1 * dp[e + 2], lane);
                col_sum(sdc + col + e, dp[e] + dp[e + 2], lane);
              }
            }
            return;
          }
          const int u = s - 2 * nh * nc, m = u / nh, kp = u % nh;
          if (kp == 0) {
            zero_acc(acc);
            if (m == 0 && j > 0)          // x_{j - 1} for the next p
              tile_in(xs, lx, wk.x + row_at(j - 1) * cc, 0, kTile, cc, lane);
          }
          mma_win<true>(acc, hs, lh, 64 * kp, slot_, lane);  // round(dp) W1x^T
          if (kp + 1 < nh) return;
          float4* sp = reinterpret_cast<float4*>(slot + (size_t)m * 1024);
#pragma unroll
          for (int i2 = 0; i2 < 8; ++i2) {
            const float4 o = sp[i2];
            acc[i2][0] = o.x + acc[i2][0];
            acc[i2][1] = o.y + acc[i2][1];
            acc[i2][2] = o.z + acc[i2][2];
            acc[i2][3] = o.w + acc[i2][3];
          }
          if (j > 0) {
#pragma unroll
            for (int i2 = 0; i2 < 8; ++i2)
              sp[i2] = make_float4(acc[i2][0], acc[i2][1], acc[i2][2],
                                   acc[i2][3]);
            dv_epi(dvs, lx, wk.dv + row_at(j - 1) * cc, sdb2, acc, gv_in,
                   64 * m, r0, pos_hi, cc, j - 1, n0, n1, rn0, rn1, lane);
            return;
          }
          const int q = lane % 4;
#pragma unroll
          for (int i2 = 0; i2 < 8; ++i2)
#pragma unroll
            for (int e = 0; e < 4; e += 2) {
              const int col = 64 * m + 8 * i2 + 2 * q;
              const long pos = r0 + g + 4 * e;
              if (pos < pos_hi && col < cc)
                *reinterpret_cast<uint32_t*>(dx + pos * cc + col) =
                    pack_bf16(acc[i2][e], acc[i2][e + 1]);
            }
        });
  }
  __syncthreads();
  const int n_part = 2 * h + cc;
  const float* sums = reinterpret_cast<const float*>(
      smem + kRing * kWinBytes + kTile * (2 * lx + lh) * 2);
  for (int i = threadIdx.x; i < n_part; i += blockDim.x) {
    const int k = i < h ? i : i < 2 * h ? (lh - 8) + (i - h)
                                        : 2 * (lh - 8) + (i - 2 * h);
    float sum = 0.f;
    for (int w = 0; w < warps; ++w) sum += sums[w * (per_warp / 4) + k];
    part[(size_t)blockIdx.x * n_part + i] = sum;
  }
}

// ---------------------------------------------------------------------------
// fp32 at any width (fm_fwd_wide_kernel, fm_bwd_wide_kernel, instantiated
// for float only: fp32 is the check dtype): plain SIMT with fp32
// accumulation and no TF32, so that fp32 agrees with full-precision
// references. A block of 256 threads walks tiles of kWP
// positions; x, h (and in the backward round(dv), round(dp)) of the tile
// stay in shared memory as fp32 holding T values, and the weights stream
// through a kWK-row chunk of shared memory per product (wide_prod), so
// shared memory is linear in C + H and the step count is a runtime loop.
// Each product's output tile (kWP x N, N <= 512) is cut as thread (rg, cg)
// = (tid / 64, tid % 64) owning rows 4 rg .. 4 rg + 3 and columns cg + 64 s.
// The backward replays the forward, keeping each step's x_j of the tile in
// a per-block stack in device memory, then walks back as the header says;
// dW1x and dW2 accumulate into the block's own partial in device memory
// once per (tile, step), a fixed order, and fm_bwd_sum_kernel adds the
// blocks' partials in block order: two calls give bit-equal gradients.
// That read-modify-write of 2 C H floats per (tile, step) and the chunk
// staging (two barriers per kWK weight rows, fp32 FMAs) make these kernels
// slow on an H100 (PERF.md); they are design debt of the check dtype
// (ROADMAP.md).
// ---------------------------------------------------------------------------

constexpr int kWP = 16;                          // positions a tile
constexpr int kWK = 16;                          // weight rows a chunk
constexpr int kWCols = 64;                       // threads along columns
constexpr int kWSlots = 8;                       // columns a thread
constexpr int kWRows = kWP / (kThreads / kWCols);   // rows a thread (4)
constexpr int kWideMax = kWCols * kWSlots;       // widest C or H (512)

// acc[i][s] = sum_{k < K} A[(4 rg + i) lda + k] Bv(k, cg + 64 s) for s <
// S with Bv(k, n) = B[k ldb + n], or B[n ldb + k] when BT (the transposed
// use of a weight); B staged kWK rows at a time into wb (kWK x N fp32).
// Every thread of the block calls it; it begins with a barrier, so what the
// block wrote to A before the call is read. Slots s >= S stay 0.
template <typename T, bool BT, int S>
__device__ __forceinline__ void wide_prod_s(float (&acc)[kWRows][kWSlots],
                                            const float* A, int lda, int K,
                                            const T* __restrict__ B, int ldb,
                                            int N, float* wb) {
  const int cg = threadIdx.x % kWCols, rg = threadIdx.x / kWCols;
#pragma unroll
  for (int i = 0; i < kWRows; ++i)
#pragma unroll
    for (int s = 0; s < kWSlots; ++s) acc[i][s] = 0.f;
  const float* arow = A + (size_t)rg * kWRows * lda;
  for (int k0 = 0; k0 < K; k0 += kWK) {
    const int kn = min(kWK, K - k0);
    __syncthreads();   // wb free, A written
    for (int i = threadIdx.x; i < kn * N; i += kThreads) {
      if (BT) {
        const int n = i / kn, kk = i - n * kn;
        wb[kk * N + n] = to_f(B[(size_t)n * ldb + k0 + kk]);
      } else {
        const int kk = i / N, n = i - kk * N;
        wb[kk * N + n] = to_f(B[(size_t)(k0 + kk) * ldb + n]);
      }
    }
    __syncthreads();
    for (int kk = 0; kk < kn; ++kk) {
      float av[kWRows], bv[S];
#pragma unroll
      for (int i = 0; i < kWRows; ++i) av[i] = arow[i * lda + k0 + kk];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int n = cg + kWCols * s;
        bv[s] = n < N ? wb[kk * N + n] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kWRows; ++i)
#pragma unroll
        for (int s = 0; s < S; ++s)
          acc[i][s] = fmaf(av[i], bv[s], acc[i][s]);
    }
  }
}

// wide_prod_s with as many column slots as N needs (2, 4 or 8: the FMAs of
// slots past N are not issued).
template <typename T, bool BT>
__device__ __forceinline__ void wide_prod(float (&acc)[kWRows][kWSlots],
                                          const float* A, int lda, int K,
                                          const T* __restrict__ B, int ldb,
                                          int N, float* wb) {
  if (N <= 2 * kWCols)
    wide_prod_s<T, BT, 2>(acc, A, lda, K, B, ldb, N, wb);
  else if (N <= 4 * kWCols)
    wide_prod_s<T, BT, 4>(acc, A, lda, K, B, ldb, N, wb);
  else
    wide_prod_s<T, BT, kWSlots>(acc, A, lda, K, B, ldb, N, wb);
}

__host__ __device__ constexpr size_t wide_fwd_smem(int cc, int h) {
  return sizeof(float) * (kWP + (size_t)kWP * (cc + h) +
                          (size_t)kWK * (cc > h ? cc : h));
}
__host__ __device__ constexpr size_t wide_bwd_smem(int cc, int h) {
  return sizeof(float) * (kWP + 2 * (size_t)kWP * (cc + h) +
                          (size_t)kWK * (cc > h ? cc : h));
}

// h = round(relu(x W1x + t a + c)) of the tile into hs (kWP x h).
template <typename T>
__device__ __forceinline__ void wide_hidden(float* hs, const float* xs,
                                            const T* w1, const float* a,
                                            const float* c, const float* nt,
                                            int cc, int h, int j, float* wb) {
  const int cg = threadIdx.x % kWCols, rg = threadIdx.x / kWCols;
  float acc[kWRows][kWSlots];
  wide_prod<T, false>(acc, xs, cc, cc, w1, h, h, wb);
#pragma unroll
  for (int i = 0; i < kWRows; ++i) {
    const int row = rg * kWRows + i;
    const float n = nt[row], t = (n - j) / n;
#pragma unroll
    for (int s = 0; s < kWSlots; ++s) {
      const int col = cg + kWCols * s;
      if (col < h)
        hs[row * h + col] = rnd<T>(fmaxf(acc[i][s] + t * a[col] + c[col],
                                         0.f));
    }
  }
}

// v = round(h W2 + b2); x = round(x - v / n) while j < n (the thread's own
// cells of xs); last_v into vo at j == n - 1 when vo is given.
template <typename T>
__device__ __forceinline__ void wide_update(float* xs, const float* hs,
                                            const T* w2, const float* b2,
                                            const float* nt, T* vo,
                                            long pos0, long n_pos, int cc,
                                            int h, int j, float* wb) {
  const int cg = threadIdx.x % kWCols, rg = threadIdx.x / kWCols;
  float acc[kWRows][kWSlots];
  wide_prod<T, false>(acc, hs, h, h, w2, cc, cc, wb);
#pragma unroll
  for (int i = 0; i < kWRows; ++i) {
    const int row = rg * kWRows + i;
    const float n = nt[row];
    const long pos = pos0 + row;
#pragma unroll
    for (int s = 0; s < kWSlots; ++s) {
      const int col = cg + kWCols * s;
      if (col >= cc) continue;
      const float v = rnd<T>(acc[i][s] + b2[col]);
      if ((float)j < n) xs[row * cc + col] = rnd<T>(xs[row * cc + col] - v / n);
      if (vo != nullptr && n - 1.f == (float)j && pos < n_pos)
        vo[pos * cc + col] = from_f<T>(v);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) fm_fwd_wide_kernel(
    const T* __restrict__ x0, const float* __restrict__ n_rows,
    const T* __restrict__ w1, const float* __restrict__ a,
    const float* __restrict__ c, const T* __restrict__ w2,
    const float* __restrict__ b2, T* __restrict__ xo, T* __restrict__ vo,
    long n_pos, int t_len, int cc, int h, int ms) {
  extern __shared__ float sm[];
  float* nt = sm;                        // kWP
  float* xs = nt + kWP;                  // kWP x cc
  float* hs = xs + kWP * cc;             // kWP x h
  float* wb = hs + kWP * h;              // kWK x max(cc, h)
  const int cg = threadIdx.x % kWCols, rg = threadIdx.x / kWCols;
  const long n_tiles = (n_pos + kWP - 1) / kWP;
  for (long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long pos0 = tile * kWP;
    __syncthreads();   // the last tile's shared memory consumed
    const int steps = load_tile<kWP>(nt, n_rows, pos0, n_pos, t_len, ms);
    for (int i = threadIdx.x; i < kWP * cc; i += kThreads) {
      const int r = i / cc;
      xs[i] = pos0 + r < n_pos ? to_f(x0[pos0 * cc + i]) : 0.f;
    }
    for (int j = 0; j < steps; ++j) {
      wide_hidden<T>(hs, xs, w1, a, c, nt, cc, h, j, wb);
      wide_update<T>(xs, hs, w2, b2, nt, vo, pos0, n_pos, cc, h, j, wb);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kWRows; ++i) {
      const int row = rg * kWRows + i;
      const long pos = pos0 + row;
      if (pos >= n_pos) continue;
#pragma unroll
      for (int s = 0; s < kWSlots; ++s) {
        const int col = cg + kWCols * s;
        if (col >= cc) continue;
        xo[pos * cc + col] = from_f<T>(xs[row * cc + col]);
        if (nt[row] > (float)ms) vo[pos * cc + col] = from_f<T>(0.f);
      }
    }
  }
}

// The backward of a block's tiles: dx, and the block's partial [dW1x (cc,
// h) | dW2 (h, cc) | da (h) | dc (h) | db2 (cc)] at part + blockIdx.x
// n_part; xst: the block's stack of ms x kWP x cc floats.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) fm_bwd_wide_kernel(
    const T* __restrict__ x0, const float* __restrict__ n_rows,
    const T* __restrict__ w1, const float* __restrict__ a,
    const float* __restrict__ c, const T* __restrict__ w2,
    const float* __restrict__ b2, const T* __restrict__ gx_in,
    const T* __restrict__ gv_in, T* __restrict__ dx,
    float* __restrict__ part, float* __restrict__ xstack, long n_pos,
    int t_len, int cc, int h, int ms) {
  extern __shared__ float sm[];
  float* nt = sm;                        // kWP
  float* xs = nt + kWP;                  // kWP x cc: x_j
  float* dvt = xs + kWP * cc;            // kWP x cc: round(dv)
  float* ht = dvt + kWP * cc;            // kWP x h: h_j
  float* dpt = ht + kWP * h;             // kWP x h: round(dp)
  float* wb = dpt + kWP * h;             // kWK x max(cc, h)
  const int cg = threadIdx.x % kWCols, rg = threadIdx.x / kWCols;
  const int n_part = 2 * cc * h + 2 * h + cc;
  float* pb = part + (size_t)blockIdx.x * n_part;
  float* xst = xstack + (size_t)blockIdx.x * ms * kWP * cc;
  for (int i = threadIdx.x; i < 2 * cc * h; i += kThreads) pb[i] = 0.f;
  float pda[kWSlots], pdc[kWSlots], pdb2[kWSlots];
#pragma unroll
  for (int s = 0; s < kWSlots; ++s) pda[s] = pdc[s] = pdb2[s] = 0.f;
  const int h4 = h / 4, c4 = cc / 4;

  const long n_tiles = (n_pos + kWP - 1) / kWP;
  for (long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long pos0 = tile * kWP;
    __syncthreads();
    const int steps = load_tile<kWP>(nt, n_rows, pos0, n_pos, t_len, ms);
    float gx[kWRows][kWSlots];
#pragma unroll
    for (int i = 0; i < kWRows; ++i) {
      const int row = rg * kWRows + i;
      const long pos = pos0 + row;
#pragma unroll
      for (int s = 0; s < kWSlots; ++s) {
        const int col = cg + kWCols * s;
        const bool in = col < cc && pos < n_pos;
        gx[i][s] = in ? to_f(gx_in[pos * cc + col]) : 0.f;
        if (col < cc) xs[row * cc + col] = in ? to_f(x0[pos * cc + col]) : 0.f;
      }
    }
    // replay: x_j of steps 0 .. steps - 1 onto the stack (own cells)
    for (int j = 0; j < steps; ++j) {
#pragma unroll
      for (int i = 0; i < kWRows; ++i)
#pragma unroll
        for (int s = 0; s < kWSlots; ++s) {
          const int row = rg * kWRows + i, col = cg + kWCols * s;
          if (col < cc)
            xst[((size_t)j * kWP + row) * cc + col] = xs[row * cc + col];
        }
      if (j + 1 == steps) break;
      wide_hidden<T>(ht, xs, w1, a, c, nt, cc, h, j, wb);
      wide_update<T>(xs, ht, w2, b2, nt, (T*)nullptr, pos0, n_pos, cc, h,
                     j, wb);
    }
    // backward walk
    for (int j = steps - 1; j >= 0; --j) {
      __syncthreads();   // the last step's partial update read xs, dvt
#pragma unroll
      for (int i = 0; i < kWRows; ++i) {
        const int row = rg * kWRows + i;
        const float n = nt[row];
        const long pos = pos0 + row;
#pragma unroll
        for (int s = 0; s < kWSlots; ++s) {
          const int col = cg + kWCols * s;
          if (col >= cc) continue;
          xs[row * cc + col] = xst[((size_t)j * kWP + row) * cc + col];
          float dv = (float)j < n ? -gx[i][s] / n : 0.f;
          if (n - 1.f == (float)j && pos < n_pos)
            dv += to_f(gv_in[pos * cc + col]);
          pdb2[s] += dv;
          dvt[row * cc + col] = rnd<T>(dv);
        }
      }
      float p[kWRows][kWSlots], acc[kWRows][kWSlots];
      wide_prod<T, false>(p, xs, cc, cc, w1, h, h, wb);     // p - t a - c
      wide_prod<T, true>(acc, dvt, cc, cc, w2, cc, h, wb);  // dh
#pragma unroll
      for (int i = 0; i < kWRows; ++i) {
        const int row = rg * kWRows + i;
        const float n = nt[row], t = (n - j) / n;
#pragma unroll
        for (int s = 0; s < kWSlots; ++s) {
          const int col = cg + kWCols * s;
          if (col >= h) continue;
          const float pv = p[i][s] + t * a[col] + c[col];
          const float dp = pv > 0.f ? acc[i][s] : 0.f;
          pda[s] += t * dp;
          pdc[s] += dp;
          dpt[row * h + col] = rnd<T>(dp);
          ht[row * h + col] = rnd<T>(fmaxf(pv, 0.f));
        }
      }
      wide_prod<T, true>(acc, dpt, h, h, w1, h, cc, wb);    // round(dp) W1x^T
#pragma unroll
      for (int i = 0; i < kWRows; ++i)
#pragma unroll
        for (int s = 0; s < kWSlots; ++s) gx[i][s] += acc[i][s];
      __syncthreads();   // ht, dpt of every thread written
      // dW1x += x_j^T round(dp), dW2 += h_j^T round(dv): 4 columns a cell
      for (int i = threadIdx.x; i < cc * h4; i += kThreads) {
        const int r = i / h4, k = 4 * (i - r * h4);
        float4 acc4 = *reinterpret_cast<float4*>(pb + (size_t)r * h + k);
        for (int pp = 0; pp < kWP; ++pp) {
          const float xv = xs[pp * cc + r];
          const float4 d4 = *reinterpret_cast<const float4*>(dpt + pp * h + k);
          acc4.x = fmaf(xv, d4.x, acc4.x);
          acc4.y = fmaf(xv, d4.y, acc4.y);
          acc4.z = fmaf(xv, d4.z, acc4.z);
          acc4.w = fmaf(xv, d4.w, acc4.w);
        }
        *reinterpret_cast<float4*>(pb + (size_t)r * h + k) = acc4;
      }
      float* pw2 = pb + (size_t)cc * h;
      for (int i = threadIdx.x; i < h * c4; i += kThreads) {
        const int r = i / c4, k = 4 * (i - r * c4);
        float4 acc4 = *reinterpret_cast<float4*>(pw2 + (size_t)r * cc + k);
        for (int pp = 0; pp < kWP; ++pp) {
          const float hv = ht[pp * h + r];
          const float4 d4 =
              *reinterpret_cast<const float4*>(dvt + pp * cc + k);
          acc4.x = fmaf(hv, d4.x, acc4.x);
          acc4.y = fmaf(hv, d4.y, acc4.y);
          acc4.z = fmaf(hv, d4.z, acc4.z);
          acc4.w = fmaf(hv, d4.w, acc4.w);
        }
        *reinterpret_cast<float4*>(pw2 + (size_t)r * cc + k) = acc4;
      }
    }
#pragma unroll
    for (int i = 0; i < kWRows; ++i) {
      const long pos = pos0 + rg * kWRows + i;
      if (pos >= n_pos) continue;
#pragma unroll
      for (int s = 0; s < kWSlots; ++s) {
        const int col = cg + kWCols * s;
        if (col < cc) dx[pos * cc + col] = from_f<T>(gx[i][s]);
      }
    }
  }
  // da, dc, db2: the 4 row groups' sums added in order
  __syncthreads();
  const int n_cs = 2 * h + cc;
  float* red = xs;   // 4 x n_cs floats (xs, dvt, ht, dpt hold 32 (cc + h))
#pragma unroll
  for (int s = 0; s < kWSlots; ++s) {
    const int col = cg + kWCols * s;
    if (col < h) {
      red[rg * n_cs + col] = pda[s];
      red[rg * n_cs + h + col] = pdc[s];
    }
    if (col < cc) red[rg * n_cs + 2 * h + col] = pdb2[s];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_cs; i += kThreads) {
    float sum = 0.f;
    for (int r = 0; r < kThreads / kWCols; ++r) sum += red[r * n_cs + i];
    pb[2 * cc * h + i] = sum;
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
// more than the launches of a call, so they run once per card, kernel,
// size and block size. The allowance is the kernel's, not the launch's: it is raised to
// the largest size asked so far (a smaller one set later would refuse a
// larger launch whose count was cached before).
std::mutex grid_mu;
std::map<std::tuple<int, const void*, size_t, int>, int> grids;
std::map<std::pair<int, const void*>, size_t> allowed;

template <typename K>
cudaError_t allow_smem(int dev, K kernel, size_t smem) {
  size_t& have = allowed[std::make_pair(dev, (const void*)kernel)];
  if (smem <= have) return cudaSuccess;
  cudaError_t err = set_smem(kernel, smem);
  if (err == cudaSuccess) have = smem;
  return err;
}

template <typename K>
cudaError_t resident_blocks(int& blocks, K kernel, int threads, size_t smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const auto key = std::make_tuple(dev, (const void*)kernel, smem, threads);
  std::lock_guard<std::mutex> lock(grid_mu);
  if ((err = allow_smem(dev, kernel, smem)) != cudaSuccess) return err;
  const auto hit = grids.find(key);
  if (hit != grids.end()) {
    blocks = hit->second;
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  blocks = sms * per_sm;
  grids[key] = blocks;
  return cudaSuccess;
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
// kernel, `wpb` warps each; chunks of `tiles` warp tiles (a whole number of
// rounds of the grid's warps where the workspace cap allows it); the
// workspace bytes of one chunk and the scratch bytes in all: the workspace,
// then the rows kernel's partials (chunks x grid x (2 h + cc) floats), then
// the dW partials (n_dw x 2 cc h floats), then `extra` floats.
struct BwdPlan {
  int grid = 0, chunks = 0;
  long tiles = 0, n_dw = 0;
  size_t entry = 0, work = 0, bytes = 0;
};

// cp: the workspace's x_j and round(dv_j) row stride.
void cut_chunks(BwdPlan& pl, int wpb, long n_pos, int cp, int cc, int h,
                int ms, size_t extra) {
  const long all = (n_pos + kTile - 1) / kTile;
  const long warps = (long)pl.grid * wpb;
  pl.entry = 2 * (2 * (size_t)cp + 2 * (size_t)h);  // bytes a (position, step)
  const long fit = std::max<long>(
      1, (long)(kWorkBytes / (pl.entry * ms * kTile)));
  pl.tiles = std::min(all, fit >= warps ? fit / warps * warps : fit);
  pl.chunks = (int)((all + pl.tiles - 1) / pl.tiles);
  pl.grid = (int)std::min<long>(pl.grid, (pl.tiles + wpb - 1) / wpb);
  pl.n_dw = 0;
  for (long k = 0; k < pl.chunks; ++k) {
    const long rows = ms * kTile * std::min(pl.tiles, all - k * pl.tiles);
    pl.n_dw += (rows + kDwRows - 1) / kDwRows;
  }
  pl.work = pl.entry * ms * kTile * pl.tiles;
  pl.bytes = pl.work + sizeof(float) * ((size_t)pl.chunks * pl.grid *
                                            (2 * h + cc) +
                                        (size_t)pl.n_dw * 2 * cc * h + extra);
}

template <int CP>
cudaError_t bwd_plan(BwdPlan& pl, long n_pos, int cc, int h, int ms) {
  cudaError_t err = resident_blocks(pl.grid, fm_bwd_rows_kernel<CP>,
                                    kMmaThreads, rows_smem<CP>(h));
  if (err != cudaSuccess) return err;
  cut_chunks(pl, kMmaWarps, n_pos, CP, cc, h, ms, 0);
  return cudaSuccess;
}

// Runs the rows kernel of each chunk (rows(k, lo, hi, wk, part_cs)), then
// fm_bwd_dw_kernel on its workspace, then the ordered sum of every partial
// into out.
template <class Rows>
int bwd_chunks(const BwdPlan& pl, char* scratch, float* out, long n_pos,
               int cp, int cc, int h, int ms, cudaStream_t stream,
               Rows rows_kernel) {
  int dw_grid = 0;   // (sets the dw kernel's shared-memory allowance)
  cudaError_t err = resident_blocks(dw_grid, fm_bwd_dw_kernel, 128,
                                    tn_smem<128>());
  if (err != cudaSuccess) return (int)err;
  const int n_cs = 2 * h + cc, n_w = 2 * cc * h;
  float* part_cs = reinterpret_cast<float*>(scratch + pl.work);
  float* part_w = part_cs + (size_t)pl.chunks * pl.grid * n_cs;
  long dw_at = 0;
  for (int k = 0; k < pl.chunks; ++k) {
    const long lo = k * pl.tiles * kTile;
    const long hi = std::min(n_pos, lo + pl.tiles * kTile);
    Work wk;
    wk.cpos = (hi - lo + kTile - 1) / kTile * kTile;
    const size_t rows = (size_t)ms * wk.cpos;
    wk.x = reinterpret_cast<bf16*>(scratch);
    wk.h = wk.x + rows * cp;
    wk.dp = wk.h + rows * h;
    wk.dv = wk.dp + rows * h;
    rows_kernel(lo, hi, wk, part_cs + (size_t)k * pl.grid * n_cs);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const int subs = (int)((rows + kDwRows - 1) / kDwRows);
    fm_bwd_dw_kernel<<<dim3(dw_tiles(cc, h), subs), 128, tn_smem<128>(),
                       stream>>>(wk, part_w + (size_t)dw_at * n_w, (int)rows,
                                 cp, cc, h);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    dw_at += subs;
  }
  fm_bwd_sum_kernel<<<(n_w + n_cs + 31) / 32, dim3(32, kSumRows), 0,
                      stream>>>(
      part_w, (int)pl.n_dw, n_w, part_cs, pl.chunks * pl.grid, n_cs, out);
  return (int)cudaGetLastError();
}

template <int CP>
int bwd_mma(const void* x0, const float* n, const void* w1, const float* a,
            const float* c, const void* w2, const float* b2, const void* gx,
            const void* gv, void* dx, char* scratch, float* out, long n_pos,
            int t_len, int cc, int h, int ms, cudaStream_t stream) {
  BwdPlan pl;
  cudaError_t err = bwd_plan<CP>(pl, n_pos, cc, h, ms);
  if (err != cudaSuccess) return (int)err;
  return bwd_chunks(
      pl, scratch, out, n_pos, CP, cc, h, ms, stream,
      [&](long lo, long hi, const Work& wk, float* part) {
        fm_bwd_rows_kernel<CP><<<pl.grid, kMmaThreads, rows_smem<CP>(h),
                                 stream>>>(
            (const bf16*)x0, n, (const bf16*)w1, a, c, (const bf16*)w2, b2,
            (const bf16*)gx, (const bf16*)gv, (bf16*)dx, wk, part, lo, hi,
            t_len, cc, h, ms);
      });
}

// The wide tensor-core kernels' block for `tiles` warp tiles (those of one
// chunk): the warps (1 .. max_warps), given per_warp shared bytes a warp
// beside the ring, that take the fewest rounds of the resident blocks (a
// block tile's time hardly depends on its warps: one barrier a window),
// then put the most warps on the card, then the smaller block; the
// resident blocks and the shared bytes.
struct WideShape {
  int warps = 0, grid = 0;
  size_t smem = 0;
};

template <typename K>
cudaError_t wide_shape(WideShape& ws, K kernel, size_t per_warp, long tiles,
                       int max_warps) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  long best_rounds = 0, best_warps = 0;
  for (int w = 1; w <= max_warps; ++w) {
    const size_t smem = wide_smem(w, per_warp);
    if (smem > (size_t)optin) break;
    int blocks = 0;
    if (resident_blocks(blocks, kernel, 32 * w, smem) != cudaSuccess) break;
    const long rounds = ((tiles + w - 1) / w + blocks - 1) / blocks;
    if (best_rounds == 0 || rounds < best_rounds ||
        (rounds == best_rounds && (long)blocks * w > best_warps)) {
      best_rounds = rounds;
      best_warps = (long)blocks * w;
      ws.warps = w;
      ws.grid = blocks;
      ws.smem = smem;
    }
  }
  return best_rounds > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

int fwd_wide_mma(const void* x0, const float* n, const void* w1,
                 const float* a, const float* c, const void* w2,
                 const float* b2, void* xo, void* vo, long n_pos, int t_len,
                 int cc, int h, int ms, cudaStream_t stream) {
  WideShape ws;
  const long tiles = (n_pos + kTile - 1) / kTile;
  cudaError_t err = wide_shape(ws, fm_fwd_wide_mma_kernel,
                               wide_fwd_warp(cc, h), tiles, kMaxWarps);
  if (err != cudaSuccess) return (int)err;
  const int grid = (int)std::min<long>(ws.grid,
                                       (tiles + ws.warps - 1) / ws.warps);
  fm_fwd_wide_mma_kernel<<<grid, 32 * ws.warps, ws.smem, stream>>>(
      (const bf16*)x0, n, (const bf16*)w1, a, c, (const bf16*)w2, b2,
      (bf16*)xo, (bf16*)vo, n_pos, t_len, cc, h, ms);
  return (int)cudaGetLastError();
}

// The wide backward's plan: its block, then the chunks, with a gx slot of
// 16 x (tile_ld(cc) - 8) floats a warp of the grid after the partials.
cudaError_t wide_mma_plan(BwdPlan& pl, WideShape& ws, long n_pos, int cc,
                          int h, int ms) {
  const long all = (n_pos + kTile - 1) / kTile;
  const long fit = std::max<long>(
      1, (long)(kWorkBytes / ((size_t)4 * (cc + h) * ms * kTile)));
  cudaError_t err = wide_shape(ws, fm_bwd_wide_rows_kernel,
                               wide_bwd_warp(cc, h), std::min(all, fit),
                               kMaxBwdWarps);
  if (err != cudaSuccess) return err;
  pl.grid = ws.grid;
  const size_t slot = (size_t)kTile * (tile_ld(cc) - 8);
  cut_chunks(pl, ws.warps, n_pos, cc, cc, h, ms,
             (size_t)ws.grid * ws.warps * slot);
  return cudaSuccess;
}

int bwd_wide_mma(const void* x0, const float* n, const void* w1,
                 const float* a, const float* c, const void* w2,
                 const float* b2, const void* gx, const void* gv, void* dx,
                 char* scratch, float* out, long n_pos, int t_len, int cc,
                 int h, int ms, cudaStream_t stream) {
  BwdPlan pl;
  WideShape ws;
  cudaError_t err = wide_mma_plan(pl, ws, n_pos, cc, h, ms);
  if (err != cudaSuccess) return (int)err;
  float* gxs = reinterpret_cast<float*>(
      scratch + pl.bytes -
      sizeof(float) * ws.grid * ws.warps * kTile * (tile_ld(cc) - 8));
  return bwd_chunks(
      pl, scratch, out, n_pos, cc, cc, h, ms, stream,
      [&](long lo, long hi, const Work& wk, float* part) {
        fm_bwd_wide_rows_kernel<<<pl.grid, 32 * ws.warps, ws.smem,
                                  stream>>>(
            (const bf16*)x0, n, (const bf16*)w1, a, c, (const bf16*)w2, b2,
            (const bf16*)gx, (const bf16*)gv, (bf16*)dx, wk, part, gxs, lo,
            hi, t_len, cc, h, ms);
      });
}

// fp32 at any width: one persistent wave of 8-warp blocks.
template <typename T>
int fwd_wide(const void* x0, const float* n, const void* w1, const float* a,
             const float* c, const void* w2, const float* b2, void* xo,
             void* vo, long n_pos, int t_len, int cc, int h, int ms,
             cudaStream_t stream) {
  const size_t smem = wide_fwd_smem(cc, h);
  int grid = 0;
  cudaError_t err =
      resident_blocks(grid, fm_fwd_wide_kernel<T>, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  grid = (int)std::min<long>(grid, (n_pos + kWP - 1) / kWP);
  fm_fwd_wide_kernel<T><<<grid, kThreads, smem, stream>>>(
      (const T*)x0, n, (const T*)w1, a, c, (const T*)w2, b2, (T*)xo,
      (T*)vo, n_pos, t_len, cc, h, ms);
  return (int)cudaGetLastError();
}

// The wide backward's blocks: a resident wave, fewer when its scratch (a
// partial of 2 cc h + 2 h + cc floats and a stack of ms kWP cc floats a
// block) would pass kWorkBytes; the scratch bytes into *bytes.
template <typename T>
cudaError_t wide_bwd_plan(int& grid, size_t& bytes, long n_pos, int cc,
                          int h, int ms) {
  cudaError_t err = resident_blocks(grid, fm_bwd_wide_kernel<T>, kThreads,
                                    wide_bwd_smem(cc, h));
  if (err != cudaSuccess) return err;
  const size_t per = sizeof(float) * ((size_t)2 * cc * h + 2 * h + cc +
                                      (size_t)ms * kWP * cc);
  grid = (int)std::min<long>(
      {(long)grid, (n_pos + kWP - 1) / kWP,
       std::max<long>(1, (long)(kWorkBytes / per))});
  bytes = per * grid;
  return cudaSuccess;
}

template <typename T>
int bwd_wide(const void* x0, const float* n, const void* w1, const float* a,
             const float* c, const void* w2, const float* b2, const void* gx,
             const void* gv, void* dx, char* scratch, float* out, long n_pos,
             int t_len, int cc, int h, int ms, cudaStream_t stream) {
  int grid = 0;
  size_t bytes = 0;
  cudaError_t err = wide_bwd_plan<T>(grid, bytes, n_pos, cc, h, ms);
  if (err != cudaSuccess) return (int)err;
  const int n_part = 2 * cc * h + 2 * h + cc;
  float* part = reinterpret_cast<float*>(scratch);
  fm_bwd_wide_kernel<T><<<grid, kThreads, wide_bwd_smem(cc, h), stream>>>(
      (const T*)x0, n, (const T*)w1, a, c, (const T*)w2, b2, (const T*)gx,
      (const T*)gv, (T*)dx, part, part + (size_t)grid * n_part, n_pos,
      t_len, cc, h, ms);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  fm_bwd_sum_kernel<<<(n_part + 31) / 32, dim3(32, kSumRows), 0, stream>>>(
      part, grid, n_part, nullptr, 0, 0, out);
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

// What the kernels take, in fp32 and bf16: C % 8 == 0 in [8, kWideMax],
// H % 32 == 0 in [32, kWideMax], max_steps >= 1.
bool takes(int cc, int h, int ms) {
  return ms >= 1 && cc % 8 == 0 && cc >= 8 && cc <= kWideMax &&
         h % 32 == 0 && h >= 32 && h <= kWideMax;
}

// Which kernels run a shape `takes`: fp32 (the check dtype) the SIMT
// kernels; bf16 at C <= 128, H <= 256 the narrow tensor-core kernels, every
// other bf16 shape the wide tensor-core kernels.
enum Route { kSimt, kNarrow, kWide };

Route mma_route(int bf16_, int cc, int h) {
  if (!bf16_) return kSimt;
  return cc <= kMaxC && h <= kMaxH ? kNarrow : kWide;
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
  if (!takes(cc, h, max_steps)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long n_pos = (long)rows * t_len;
  const float *nn = (const float*)n, *aa = (const float*)a,
              *ca = (const float*)c, *bb = (const float*)b2;
  switch (mma_route(bf16_, cc, h)) {
    case kSimt:
      return fwd_wide<float>(x0, nn, w1, aa, ca, w2, bb, xo, vo, n_pos,
                             t_len, cc, h, max_steps, s);
    case kWide:
      return fwd_wide_mma(x0, nn, w1, aa, ca, w2, bb, xo, vo, n_pos, t_len,
                          cc, h, max_steps, s);
    default:
      return with_cp(cc, [&](auto cp) {
        return fwd_mma<decltype(cp)::value>(x0, nn, w1, aa, ca, w2, bb, xo,
                                            vo, n_pos, t_len, cc, h,
                                            max_steps, s);
      });
  }
}

// The scratch bytes tat_fm_bwd needs for these shapes, into *(long long*)
// bytes.
extern "C" int tat_fm_bwd_scratch(int bf16_, int rows, int t_len, int cc,
                                  int h, int max_steps, void* bytes,
                                  void* stream) {
  (void)stream;
  if (!takes(cc, h, max_steps)) return (int)cudaErrorInvalidValue;
  const long n_pos = (long)rows * t_len;
  BwdPlan pl;
  cudaError_t err = cudaSuccess;
  switch (mma_route(bf16_, cc, h)) {
    case kSimt: {
      int grid = 0;
      err = wide_bwd_plan<float>(grid, pl.bytes, n_pos, cc, h, max_steps);
      break;
    }
    case kWide: {
      WideShape ws;
      err = wide_mma_plan(pl, ws, n_pos, cc, h, max_steps);
      break;
    }
    default:
      err = (cudaError_t)with_cp(cc, [&](auto cp) {
        return (int)bwd_plan<decltype(cp)::value>(pl, n_pos, cc, h,
                                                  max_steps);
      });
  }
  if (err == cudaSuccess) *(long long*)bytes = (long long)pl.bytes;
  return (int)err;
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
  if (!takes(cc, h, max_steps)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long n_pos = (long)rows * t_len;
  const float *nn = (const float*)n, *aa = (const float*)a,
              *ca = (const float*)c, *bb = (const float*)b2;
  float* oo = (float*)out;
  char* sc = (char*)scratch;
  switch (mma_route(bf16_, cc, h)) {
    case kSimt:
      return bwd_wide<float>(x0, nn, w1, aa, ca, w2, bb, gx, gv, dx, sc, oo,
                             n_pos, t_len, cc, h, max_steps, s);
    case kWide:
      return bwd_wide_mma(x0, nn, w1, aa, ca, w2, bb, gx, gv, dx, sc, oo,
                          n_pos, t_len, cc, h, max_steps, s);
    default:
      return with_cp(cc, [&](auto cp) {
        return bwd_mma<decltype(cp)::value>(x0, nn, w1, aa, ca, w2, bb, gx,
                                            gv, dx, sc, oo, n_pos, t_len, cc,
                                            h, max_steps, s);
      });
  }
}
