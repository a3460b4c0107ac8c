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
// 4 B T D d_ff = 1.49 GFLOP against 4.2 MB of bf16 activations in and out
// (1.5 us at the bf16 tensor rate, 1.3 us of bytes), the backward 3.7
// GFLOP; both only if the (B*T, d_ff) activation stays on chip. In
// practice each row tile streams both weight matrices from L2 (0.14 MB at
// d88, 0.5 MB at d176 per tile) and waits on that stream and on its block
// barriers: the kernels are latency-bound, far above both bounds.
//
// Design. Every product is A (a row tile in shared memory) times B^T with B
// row-major (N, K) in device memory: the wrapper hands over the weights
// once per weight version (ops/cuda_ffn.py::_kernel_weights) as W1 (F, D),
// W2 (D, F), W1^T (D, F) and W2^T (F, D) in the working type T, zero-padded
// to Dp, Fp (multiples of 16), so the forward's h W2^T and the backward's
// do W2 and dh1 W1 are the same product (`product`). B is walked in chunks
// of NC output columns and K tiles of KB bytes through an S-stage cp.async
// ring: Big (NC 128, KB 64, S 3) where the tiles leave room for it, else
// Small (64, 64, 2), the least shared memory, which sets the widths the
// kernels take (ops/cuda_ffn.py::ffn_refusal). bf16: 64-row tiles, 8 warps
// in 4 x 2, each a 16 x NC/2 piece of the chunk on mma.sync.m16n8k16
// (ldmatrix from the row tile and the ring), fp32 accumulation. fp32 (the
// check dtype): 32-row tiles, the same ring, SIMT FMAs (no TF32), so that
// it agrees with full-precision references. Operands round to T where the
// TPU kernel rounds them (y, the dropped SiLU output, do, dh1).
//   forward (ffn_fwd_kernel) - per row tile: LN into a T tile; h = y W1^T
//     chunk by chunk with b1, SiLU and mask 1 in the epilogue into a T tile
//     (the (rows, d_ff) activation never reaches device memory); o = h W2^T
//     with b2, mask 2 and the 0.5 residual in the epilogue.
//   backward - three launches, no atomics, fixed summation orders, so two
//     calls give bit-equal gradients:
//     ffn_bwd_rows_kernel, per row tile: LN again; do = 0.5 g mask2 scale;
//       per chunk of d_ff h1 = y W1^T and dhd = do W2 (the same fragment
//       layout), then dh1 = dhd mask1 scale silu'(h1) into a T tile;
//       dy = dh1 W1 into an fp32 tile; the LN backward to dx. It stores y,
//       do, hd (the dropped SiLU output) and dh1 in T to a workspace, and
//       per-tile column sums of dy xhat, dy, do and dh1 (the unrounded fp32
//       values) for d(LN scale, bias), db2 and db1.
//     ffn_bwd_dw_kernel: dW1 = dh1^T y and dW2 = do^T hd over fixed chunks
//       of rows (gemm.cuh's gemm_tn_tile: bf16 on mma.sync, fp32 SIMT), one
//       partial per chunk.
//     ffn_bwd_sum_kernel: every partial summed in chunk order.
// The LayerNorm passes load four rows at a time (their loads in flight
// together); the masks' stream and index base are computed once per row.
// Dropout masks come from the counter hash (dropout.cuh) with JAX's stream
// layout: 2 * (seed + b) + salt, idx t * width + col.

#include <cuda_runtime.h>
#include <stdint.h>

#include <math.h>

#include "dropout.cuh"
#include "gemm.cuh"

namespace {

constexpr int kThreads = 256;   // row-tile kernels: 8 warps
constexpr int kSmemMax = 232448;  // dynamic shared memory of one block

// The weight ring: NC weight rows (output columns) per chunk, K walked in
// tiles of KB bytes per staged row through S stages. Big for the shapes
// whose tiles leave room for it; Small, the least shared memory, for the
// rest.
template <int NC, int KB, int S>
struct Cfg {
  static constexpr int kNC = NC, kKB = KB, kStages = S;
  static constexpr int kRingRow = KB + 16;     // an odd multiple of 16 bytes
  static constexpr int kRing = S * NC * kRingRow;
  static constexpr int kRed = 8 * NC;          // floats of column-sum slots
};
using Big = Cfg<128, 64, 3>;
using Small = Cfg<64, 64, 2>;

// Per working type: rows per tile, row padding of the shared tiles (16
// bytes, so that ldmatrix rows fall in distinct banks), column-sum slots.
// bf16: 8 warps in 4 x 2, each 16 rows x NC/2 columns of m16n8 fragments;
// fp32: thread (ty, tx) = (tid / 16, tid % 16) holds rows ty, ty + 16 and
// columns tx + 16 j.
template <typename T>
struct Tile;
template <>
struct Tile<__nv_bfloat16> {
  static constexpr int kBM = 64, kPad = 8, kSlots = 4;
};
template <>
struct Tile<float> {
  static constexpr int kBM = 32, kPad = 4, kSlots = 8;
};
// Accumulators per thread for a chunk of NC columns.
template <typename T, int NC>
constexpr int kAcc = Tile<T>::kBM * NC / kThreads;

// Which of its two tile rows accumulator `i` of this thread is on, that
// row, and the chunk column.
template <typename T, int NC>
__device__ __forceinline__ int acc_half(int i) {
  return sizeof(T) == 2 ? (i % 4) / 2 : i / (NC / 16);
}
template <typename T>
__device__ __forceinline__ int half_row(int h) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if constexpr (sizeof(T) == 2)
    return 16 * (warp % 4) + lane / 4 + 8 * h;
  else
    return tid / 16 + 16 * h;
}
template <typename T, int NC>
__device__ __forceinline__ int acc_row(int i) {
  return half_row<T>(acc_half<T, NC>(i));
}
template <typename T, int NC>
__device__ __forceinline__ int acc_col(int i) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if constexpr (sizeof(T) == 2)
    return (NC / 2) * (warp / 4) + 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
  else
    return tid % 16 + 16 * (i % (NC / 16));
}

// The dropout stream and index base of row m (b = m / t_len, t = m % t_len)
// for a mask of `width` columns: keep column c when
// dropout_bits(stream, base + c) >= thresh.
struct RowMask {
  uint32_t stream, base;
};
__device__ __forceinline__ RowMask row_mask(uint32_t seed, int m, int t_len,
                                            uint32_t salt, int width) {
  const uint32_t b = (uint32_t)(m / t_len), t = (uint32_t)(m % t_len);
  return {2u * (seed + b) + salt, t * (uint32_t)width};
}
__device__ __forceinline__ bool kept(RowMask r, int c, uint32_t thresh) {
  return dropout_keep(r.stream, r.base + (uint32_t)c, thresh);
}

__device__ __forceinline__ float sigmoid(float h) {
  return __fdividef(1.f, 1.f + __expf(-h));
}

// acc = A[0 .. kBM) x B[n0 .. n0 + NC)^T over K = k_len: A a row tile in
// shared memory (row stride lda elements), B row-major (n_len, k_len) in
// device memory, both multiples of 16, rows 16-byte aligned; B rows past
// n_len read as zeros. Starts with a block barrier (the ring and the A tile
// are free / written), so consecutive calls need none between them.
template <typename T, class C>
__device__ void product(float (&acc)[kAcc<T, C::kNC>], const T* a, int lda,
                        const T* b, int n_len, int k_len, int n0,
                        char* ring) {
  constexpr int NC = C::kNC, S = C::kStages, kRow = C::kRingRow;
  constexpr int kKT = C::kKB / (int)sizeof(T);   // K per tile
  constexpr int kEl = 16 / (int)sizeof(T);       // elements per copy
  constexpr int kPieces = C::kKB / 16;           // copies per staged row
  constexpr int kStage = NC * kRow;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nk = (k_len + kKT - 1) / kKT;
  auto load_tile = [&](int kt) {
    if (kt < nk) {
      char* st = ring + (kt % S) * kStage;
#pragma unroll
      for (int u = tid; u < NC * kPieces; u += kThreads) {
        const int r = u / kPieces, pc = u % kPieces, n = n0 + r;
        const int k = kt * kKT + pc * kEl;
        const bool v = n < n_len && k < k_len;
        cp_async16(st + r * kRow + pc * 16,
                   v ? b + (size_t)n * k_len + k : b, v);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kAcc<T, NC>; ++i) acc[i] = 0.f;
  __syncthreads();
#pragma unroll
  for (int s = 0; s < S - 1; ++s) load_tile(s);
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<S - 2>();
    __syncthreads();  // tile kt landed; tile kt - 1 is consumed
    load_tile(kt + S - 1);
    const char* sb = ring + (kt % S) * kStage;
    const int k0 = kt * kKT;
    if constexpr (sizeof(T) == 2) {
      const int wr = 16 * (warp % 4), wc = (NC / 2) * (warp / 4);
#pragma unroll
      for (int ks = 0; ks < kKT / 16; ++ks) {
        if (k0 + 16 * ks >= k_len) break;
        uint32_t af[4], bf[NC / 32][4];
        ldmatrix_x4(af, a + (size_t)(wr + lane % 16) * lda + k0 + 16 * ks +
                            (lane / 16) * 8);
#pragma unroll
        for (int jj = 0; jj < NC / 32; ++jj)
          ldmatrix_x4(bf[jj],
                      sb + (wc + 16 * jj + lane % 8 + (lane / 16) * 8) * kRow +
                          (ks * 16 + ((lane / 8) % 2) * 8) * 2);
#pragma unroll
        for (int j = 0; j < NC / 16; ++j) {
          float c[4] = {acc[4 * j], acc[4 * j + 1], acc[4 * j + 2],
                        acc[4 * j + 3]};
          mma_bf16(c, af, bf[j / 2][(j % 2) * 2], bf[j / 2][(j % 2) * 2 + 1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[4 * j + e] = c[e];
        }
      }
    } else {
      constexpr int kJ = NC / 16;
      const float* fb = reinterpret_cast<const float*>(sb);
      const int tx = tid % 16, ty = tid / 16;
      const int kn = min(kKT, k_len - k0);
#pragma unroll 4
      for (int kk = 0; kk < kn; ++kk) {
        float av[2], bv[kJ];
#pragma unroll
        for (int h = 0; h < 2; ++h)
          av[h] = to_f(a[(size_t)(ty + 16 * h) * lda + k0 + kk]);
#pragma unroll
        for (int j = 0; j < kJ; ++j) bv[j] = fb[(tx + 16 * j) * (kRow / 4) + kk];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < kJ; ++j)
            acc[kJ * h + j] = fmaf(av[h], bv[j], acc[kJ * h + j]);
      }
    }
  }
  cp_async_wait<0>();
}

// Column sums over the tile's rows of v (one value per accumulator, in the
// fragment layout of `product`), in a fixed order: the rows a thread
// holds, then across lanes by shuffles, then the slots (row groups) in
// order by the first NC threads, which write out[c] for chunk column
// c < n_valid. `red` holds 8 NC floats. Ends with a block barrier.
template <typename T, int NC>
__device__ void column_sums(const float (&v)[kAcc<T, NC>], float* red,
                            float* out, int n_valid) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int j = 0; j < NC / 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float s = v[4 * j + e] + v[4 * j + e + 2];   // rows g and g + 8
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        if (lane < 4) red[(warp % 4) * NC + acc_col<T, NC>(4 * j + e)] = s;
      }
  } else {
    constexpr int kJ = NC / 16;
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      float s = v[j] + v[kJ + j];                    // rows ty and ty + 16
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      if (lane < 16) red[warp * NC + acc_col<T, NC>(j)] = s;
    }
  }
  __syncthreads();
  if (tid < n_valid && tid < NC) {
    float s = 0.f;
    for (int k = 0; k < Tile<T>::kSlots; ++k) s += red[k * NC + tid];
    out[tid] = s;
  }
  __syncthreads();
}

// Mean and 1 / std (flax: E[x^2] - E[x]^2, eps 1e-6) of the rows
// m0 + r0 .. m0 + r0 + 3 of x, by one warp, the four rows' loads in flight
// together; (0, 0) for rows past m_rows.
template <typename T>
__device__ __forceinline__ void row_stats4(const T* x, int m0, int r0,
                                           int m_rows, int d,
                                           float2 (&st)[4]) {
  const int lane = threadIdx.x % 32;
  float s[4] = {0.f, 0.f, 0.f, 0.f}, s2[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c = lane; c < d; c += 32)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int m = m0 + r0 + q;
      const float v = m < m_rows ? to_f(x[(size_t)m * d + c]) : 0.f;
      s[q] += v;
      s2[q] += v * v;
    }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float mu = warp_sum(s[q]) / d, ex2 = warp_sum(s2[q]) / d;
    st[q] = m0 + r0 + q < m_rows
                ? make_float2(mu, rsqrtf(ex2 - mu * mu + 1e-6f))
                : make_float2(0.f, 0.f);
  }
}

// Shared memory of the row-tile kernels (bytes); ops/cuda_ffn.py::fwd_smem
// and bwd_smem compute it for Small, the least.
template <typename T>
__host__ __device__ constexpr size_t tile_bytes(int cols) {
  return (size_t)Tile<T>::kBM * (cols + Tile<T>::kPad) * sizeof(T);
}
template <typename T, class C>
size_t fwd_smem(int dp, int fp) {
  return tile_bytes<T>(dp) + tile_bytes<T>(fp) + C::kRing;
}
template <typename T, class C>
size_t bwd_smem(int dp, int fp) {
  return 2 * tile_bytes<T>(dp) + tile_bytes<T>(fp) + C::kRing +
         sizeof(float) * (C::kRed + 4 * Tile<T>::kBM);
}

// kStep accumulators from an even i on lie on one row at consecutive
// columns (bf16: the pair of an m16n8 fragment); store them as one run.
template <typename T>
constexpr int kStep = sizeof(T) == 2 ? 2 : 1;
__device__ __forceinline__ void store_run(__nv_bfloat16* p, const float* v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
}
__device__ __forceinline__ void store_run(float* p, const float* v) {
  *p = v[0];
}

template <typename T, class C>
__global__ void __launch_bounds__(kThreads) ffn_fwd_kernel(
    const T* __restrict__ x, const float* __restrict__ lnw,
    const float* __restrict__ lnb, const T* __restrict__ w1,  // (fp, dp)
    const float* __restrict__ b1, const T* __restrict__ w2,   // (dp, fp)
    const float* __restrict__ b2, T* __restrict__ out, int m_rows, int t_len,
    int d, int f, int dp, int fp, uint32_t seed, uint32_t thresh,
    float scale) {
  constexpr int BM = Tile<T>::kBM, RPW = BM / 8, NC = C::kNC;
  constexpr int kA = kAcc<T, NC>, kS = kStep<T>;
  extern __shared__ __align__(16) char smem[];
  const int ldd = dp + Tile<T>::kPad, ldf = fp + Tile<T>::kPad;
  T* ys = reinterpret_cast<T*>(smem);                 // BM x ldd
  T* hs = ys + BM * ldd;                              // BM x ldf
  char* ring = reinterpret_cast<char*>(hs + BM * ldf);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.x * BM;
  for (int r0 = warp * RPW; r0 < (warp + 1) * RPW; r0 += 4) {
    float2 st[4];
    row_stats4(x, m0, r0, m_rows, d, st);
    for (int c = lane; c < dp; c += 32)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int m = m0 + r0 + q;
        float y = 0.f;
        if (m < m_rows && c < d)
          y = (to_f(x[(size_t)m * d + c]) - st[q].x) * st[q].y * lnw[c] +
              lnb[c];
        ys[(r0 + q) * ldd + c] = from_f<T>(y);
      }
  }
  RowMask mk1[2], mk2[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mk1[h] = row_mask(seed, m0 + half_row<T>(h), t_len, 0u, f);
    mk2[h] = row_mask(seed, m0 + half_row<T>(h), t_len, 1u, d);
  }
  float acc[kA];
  for (int n0 = 0; n0 < fp; n0 += NC) {
    product<T, C>(acc, ys, ldd, w1, fp, dp, n0, ring);
#pragma unroll
    for (int i = 0; i < kA; i += kS) {
      const int row = acc_row<T, NC>(i), c = n0 + acc_col<T, NC>(i);
      if (c >= fp) continue;
      float v[kS];
#pragma unroll
      for (int q = 0; q < kS; ++q) {
        float h = 0.f;
        if (c + q < f) {
          h = acc[i + q] + b1[c + q];
          h *= sigmoid(h);
          if (thresh)
            h = kept(mk1[acc_half<T, NC>(i)], c + q, thresh) ? h * scale
                                                             : 0.f;
        }
        v[q] = h;
      }
      store_run(hs + row * ldf + c, v);
    }
  }
  for (int n0 = 0; n0 < dp; n0 += NC) {
    product<T, C>(acc, hs, ldf, w2, dp, fp, n0, ring);
#pragma unroll
    for (int i = 0; i < kA; ++i) {
      const int c = n0 + acc_col<T, NC>(i), m = m0 + acc_row<T, NC>(i);
      if (c >= d || m >= m_rows) continue;
      float o = acc[i] + b2[c];
      if (thresh)
        o = kept(mk2[acc_half<T, NC>(i)], c, thresh) ? o * scale : 0.f;
      const size_t at = (size_t)m * d + c;
      out[at] = from_f<T>(to_f(x[at]) + 0.5f * o);
    }
  }
}

// Per row tile: dx, the T workspace (y, do: (m_rows, dp); hd, dh1:
// (m_rows, fp); padding columns zero) and the tile's column sums
// part[tile] = [sum dy xhat (d) | sum dy (d) | sum do (d) | sum dh1 (f)].
template <typename T, class C>
__global__ void __launch_bounds__(kThreads) ffn_bwd_rows_kernel(
    const T* __restrict__ x, const T* __restrict__ g,
    const float* __restrict__ lnw, const float* __restrict__ lnb,
    const T* __restrict__ w1, const float* __restrict__ b1,  // (fp, dp)
    const T* __restrict__ w2t, const T* __restrict__ w1t,    // (fp, dp), (dp, fp)
    T* __restrict__ dx, T* __restrict__ wy, T* __restrict__ wdo,
    T* __restrict__ whd, T* __restrict__ wdh1, float* __restrict__ part,
    int m_rows, int t_len, int d, int f, int dp, int fp, uint32_t seed,
    uint32_t thresh, float scale) {
  constexpr int BM = Tile<T>::kBM, RPW = BM / 8, NC = C::kNC;
  constexpr int kA = kAcc<T, NC>, kS = kStep<T>;
  extern __shared__ __align__(16) char smem[];
  const int ldd = dp + Tile<T>::kPad, ldf = fp + Tile<T>::kPad;
  const int ldy = dp + 4;                              // dy row stride
  T* ys = reinterpret_cast<T*>(smem);                  // BM x ldd
  T* dos = ys + BM * ldd;                              // BM x ldd
  T* dhs = dos + BM * ldd;                             // BM x ldf
  char* ring = reinterpret_cast<char*>(dhs + BM * ldf);
  float* red = reinterpret_cast<float*>(ring + C::kRing);
  float* mus = red + C::kRed;                          // BM
  float* rss = mus + BM;                               // BM
  RowMask* mks = reinterpret_cast<RowMask*>(rss + BM); // BM: mask 2
  float* dys = reinterpret_cast<float*>(smem);         // BM x ldy, over ys, dos
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.x * BM;
  const int rows = min(BM, m_rows - m0);
  float* my_part = part + (size_t)blockIdx.x * (3 * d + f);

  // LN again, and do; y and do to the tiles and the workspace
  for (int r0 = warp * RPW; r0 < (warp + 1) * RPW; r0 += 4) {
    float2 st[4];
    RowMask mk[4];
    row_stats4(x, m0, r0, m_rows, d, st);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      mk[q] = row_mask(seed, m0 + r0 + q, t_len, 1u, d);
      if (lane == 0) {
        mus[r0 + q] = st[q].x;
        rss[r0 + q] = st[q].y;
        mks[r0 + q] = mk[q];
      }
    }
    for (int c = lane; c < dp; c += 32)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = r0 + q, m = m0 + row;
        float y = 0.f, dov = 0.f;
        if (m < m_rows && c < d) {
          const size_t at = (size_t)m * d + c;
          y = (to_f(x[at]) - st[q].x) * st[q].y * lnw[c] + lnb[c];
          dov = 0.5f * to_f(g[at]);
          if (thresh) dov = kept(mk[q], c, thresh) ? dov * scale : 0.f;
        }
        const T yt = from_f<T>(y), dt = from_f<T>(dov);
        ys[row * ldd + c] = yt;
        dos[row * ldd + c] = dt;
        if (m < m_rows) {
          wy[(size_t)m * dp + c] = yt;
          wdo[(size_t)m * dp + c] = dt;
        }
      }
  }

  // per chunk of d_ff: h1 = y W1^T, dhd = do W2, then hd and dh1
  RowMask mk1[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    mk1[h] = row_mask(seed, m0 + half_row<T>(h), t_len, 0u, f);
  for (int n0 = 0; n0 < fp; n0 += NC) {
    float a1[kA], a2[kA];
    product<T, C>(a1, ys, ldd, w1, fp, dp, n0, ring);
    product<T, C>(a2, dos, ldd, w2t, fp, dp, n0, ring);
#pragma unroll
    for (int i = 0; i < kA; i += kS) {
      const int row = acc_row<T, NC>(i), c = n0 + acc_col<T, NC>(i);
      const int m = m0 + row;
      float hd[kS], dh1[kS];
#pragma unroll
      for (int q = 0; q < kS; ++q) {
        hd[q] = dh1[q] = 0.f;
        if (c + q < f && m < m_rows) {
          const float h1 = a1[i + q] + b1[c + q], sg = sigmoid(h1);
          float dhd = a2[i + q];
          hd[q] = h1 * sg;
          if (thresh) {
            const bool k = kept(mk1[acc_half<T, NC>(i)], c + q, thresh);
            hd[q] = k ? hd[q] * scale : 0.f;
            dhd = k ? dhd * scale : 0.f;
          }
          dh1[q] = dhd * sg * (1.f + h1 * (1.f - sg));
        }
        a2[i + q] = dh1[q];
      }
      if (c >= fp) continue;
      store_run(dhs + row * ldf + c, dh1);
      if (m < m_rows) {
        store_run(whd + (size_t)m * fp + c, hd);
        store_run(wdh1 + (size_t)m * fp + c, dh1);
      }
    }
    column_sums<T, NC>(a2, red, my_part + 3 * d + n0, f - n0);
  }

  // dy = dh1 W1 into the fp32 tile over ys and dos (consumed: the first
  // product starts with a barrier)
  for (int n0 = 0; n0 < dp; n0 += NC) {
    float a1[kA];
    product<T, C>(a1, dhs, ldf, w1t, dp, fp, n0, ring);
#pragma unroll
    for (int i = 0; i < kA; ++i) {
      const int c = n0 + acc_col<T, NC>(i);
      if (c < dp) dys[acc_row<T, NC>(i) * ldy + c] = a1[i];
    }
  }
  __syncthreads();

  // LN backward, one warp per row: dx = g + r (dxhat - mean dxhat
  // - xhat mean(dxhat xhat)), dxhat = dy * scale
  for (int r0 = warp * RPW; r0 < (warp + 1) * RPW; r0 += 4) {
    float s1[4] = {0.f, 0.f, 0.f, 0.f}, s2[4] = {0.f, 0.f, 0.f, 0.f};
    for (int c = lane; c < d; c += 32)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = r0 + q, m = m0 + row;
        if (m >= m_rows) continue;
        const float dxh = dys[row * ldy + c] * lnw[c];
        s1[q] += dxh;
        s2[q] += dxh * (to_f(x[(size_t)m * d + c]) - mus[row]) * rss[row];
      }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      s1[q] = warp_sum(s1[q]) / d;
      s2[q] = warp_sum(s2[q]) / d;
    }
    for (int c = lane; c < d; c += 32)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = r0 + q, m = m0 + row;
        if (m >= m_rows) continue;
        const size_t at = (size_t)m * d + c;
        const float r = rss[row], xh = (to_f(x[at]) - mus[row]) * r;
        const float dxh = dys[row * ldy + c] * lnw[c];
        dx[at] = from_f<T>(to_f(g[at]) + r * (dxh - s1[q] - xh * s2[q]));
      }
  }

  // column sums over the tile's rows in row order: d(LN scale), d(LN bias),
  // db2 (the unrounded do)
  for (int c = tid; c < d; c += kThreads) {
    float ds = 0.f, dsb = 0.f, db2 = 0.f;
#pragma unroll 8
    for (int row = 0; row < rows; ++row) {
      const size_t at = (size_t)(m0 + row) * d + c;
      const float dy = dys[row * ldy + c];
      ds += dy * (to_f(x[at]) - mus[row]) * rss[row];
      dsb += dy;
      float dov = 0.5f * to_f(g[at]);
      if (thresh) dov = kept(mks[row], c, thresh) ? dov * scale : 0.f;
      db2 += dov;
    }
    my_part[c] = ds;
    my_part[d + c] = dsb;
    my_part[2 * d + c] = db2;
  }
}

// One C tile of A^T B into out (ni, nj), row-major.
template <typename T>
__device__ __forceinline__ void tn_tile(char* smem, const T* a, int na,
                                        const T* b, int nb, int m_lo,
                                        int m_hi, int i0, int j0, float* out,
                                        int ni, int nj) {
  auto store = [&](int i, int j, float v) {
    if (i < ni && j < nj) out[(size_t)i * nj + j] = v;
  };
  if constexpr (sizeof(T) == 2)
    gemm_tn_tile(smem, a, na, b, nb, false, m_lo, m_hi, i0, j0, store);
  else
    gemm_tn_tile(smem, a, na, b, nb, m_lo, m_hi, i0, j0, store);
}

// Weight-gradient partials of row chunk blockIdx.y: blocks [0, t1) tile
// dW1 (f, d) = dh1^T y, the rest dW2 (d, f) = do^T hd, into
// part[chunk] = [dW1 (f * d) | dW2 (d * f)].
template <typename T>
__global__ void __launch_bounds__(128) ffn_bwd_dw_kernel(
    const T* __restrict__ wy, const T* __restrict__ wdo,
    const T* __restrict__ whd, const T* __restrict__ wdh1,
    float* __restrict__ part, int m_rows, int d, int f, int dp, int fp,
    int rows_per_chunk) {
  extern __shared__ __align__(16) char smem[];
  const int m_lo = blockIdx.y * rows_per_chunk;
  const int m_hi = min(m_rows, m_lo + rows_per_chunk);
  float* out = part + (size_t)blockIdx.y * 2 * f * d;
  const int t1 = ((fp + 127) / 128) * ((dp + 63) / 64);
  int tile = blockIdx.x;
  if (tile < t1) {
    const int nj = (dp + 63) / 64;
    tn_tile(smem, wdh1, fp, wy, dp, m_lo, m_hi, 128 * (tile / nj),
            64 * (tile % nj), out, f, d);
  } else {
    tile -= t1;
    const int nj = (fp + 63) / 64;
    tn_tile(smem, wdo, dp, whd, fp, m_lo, m_hi, 128 * (tile / nj),
            64 * (tile % nj), out + (size_t)f * d, d, f);
  }
}

// out[i] = sum over p in order of parts_a[p][i] (i < na, n_a parts), then
// of parts_b[p][i - na] (n_b parts).
__global__ void ffn_bwd_sum_kernel(const float* __restrict__ parts_a,
                                 int n_a, int na,
                                 const float* __restrict__ parts_b, int n_b,
                                 int nb, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= na + nb) return;
  const bool in_a = i < na;
  const float* src = in_a ? parts_a + i : parts_b + (i - na);
  const int n = in_a ? n_a : n_b;
  const size_t stride = in_a ? na : nb;
  float s = 0.f;
#pragma unroll 8
  for (int p = 0; p < n; ++p) s += src[(size_t)p * stride];
  out[i] = s;
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

int pad16(int n) { return (n + 15) / 16 * 16; }

template <typename T, class C>
int fwd_launch(const void* x, const float* lnw, const float* lnb,
               const void* w1, const float* b1, const void* w2,
               const float* b2, void* out, int m_rows, int t_len, int d,
               int f, int dp, int fp, uint32_t seed, uint32_t thresh,
               float scale, cudaStream_t stream) {
  const int bm = Tile<T>::kBM;
  const size_t smem = fwd_smem<T, C>(dp, fp);
  cudaError_t err = set_smem(ffn_fwd_kernel<T, C>, smem);
  if (err != cudaSuccess) return (int)err;
  ffn_fwd_kernel<T, C><<<(m_rows + bm - 1) / bm, kThreads, smem, stream>>>(
      (const T*)x, lnw, lnb, (const T*)w1, b1, (const T*)w2, b2, (T*)out,
      m_rows, t_len, d, f, dp, fp, seed, thresh, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int fwd(const void* x, const float* lnw, const float* lnb, const void* w1,
        const float* b1, const void* w2, const float* b2, void* out,
        int m_rows, int t_len, int d, int f, uint32_t seed, uint32_t thresh,
        float scale, cudaStream_t stream) {
  const int dp = pad16(d), fp = pad16(f);
  auto run = fwd_smem<T, Big>(dp, fp) <= kSmemMax ? fwd_launch<T, Big>
                                                  : fwd_launch<T, Small>;
  return run(x, lnw, lnb, w1, b1, w2, b2, out, m_rows, t_len, d, f, dp, fp,
             seed, thresh, scale, stream);
}

template <typename T, class C>
cudaError_t bwd_rows(const void* x, const void* g, const float* lnw,
                     const float* lnb, const void* w1, const float* b1,
                     const void* w2t, const void* w1t, void* dx, T* wy,
                     T* wdo, T* whd, T* wdh1, float* part, int m_rows,
                     int t_len, int d, int f, int dp, int fp, uint32_t seed,
                     uint32_t thresh, float scale, cudaStream_t stream) {
  const int bm = Tile<T>::kBM;
  const size_t smem = bwd_smem<T, C>(dp, fp);
  cudaError_t err = set_smem(ffn_bwd_rows_kernel<T, C>, smem);
  if (err != cudaSuccess) return err;
  ffn_bwd_rows_kernel<T, C><<<(m_rows + bm - 1) / bm, kThreads, smem,
                              stream>>>(
      (const T*)x, (const T*)g, lnw, lnb, (const T*)w1, b1, (const T*)w2t,
      (const T*)w1t, (T*)dx, wy, wdo, whd, wdh1, part, m_rows, t_len, d, f,
      dp, fp, seed, thresh, scale);
  return cudaGetLastError();
}

template <typename T>
int bwd(const void* x, const void* g, const float* lnw, const float* lnb,
        const void* w1, const float* b1, const void* w2t, const void* w1t,
        void* dx, char* work, float* grads, int m_rows, int t_len, int d,
        int f, int rows_per_chunk, uint32_t seed, uint32_t thresh,
        float scale, cudaStream_t stream) {
  const int dp = pad16(d), fp = pad16(f), bm = Tile<T>::kBM;
  const int tiles = (m_rows + bm - 1) / bm;
  const int chunks = (m_rows + rows_per_chunk - 1) / rows_per_chunk;
  T* wy = (T*)work;
  T* wdo = wy + (size_t)m_rows * dp;
  T* whd = wdo + (size_t)m_rows * dp;
  T* wdh1 = whd + (size_t)m_rows * fp;
  float* part_rows = (float*)(wdh1 + (size_t)m_rows * fp);
  float* part_w = part_rows + (size_t)tiles * (3 * d + f);
  auto rows = bwd_smem<T, Big>(dp, fp) <= kSmemMax ? bwd_rows<T, Big>
                                                   : bwd_rows<T, Small>;
  cudaError_t err = rows(x, g, lnw, lnb, w1, b1, w2t, w1t, dx, wy, wdo, whd,
                         wdh1, part_rows, m_rows, t_len, d, f, dp, fp, seed,
                         thresh, scale, stream);
  if (err != cudaSuccess) return (int)err;

  const size_t smem_dw = sizeof(T) == 2 ? kTNSmem : kTNSmemF32;
  if ((err = set_smem(ffn_bwd_dw_kernel<T>, smem_dw)) != cudaSuccess)
    return (int)err;
  const int t1 = ((fp + 127) / 128) * ((dp + 63) / 64);
  const int t2 = ((dp + 127) / 128) * ((fp + 63) / 64);
  ffn_bwd_dw_kernel<T><<<dim3(t1 + t2, chunks), 128, smem_dw, stream>>>(
      wy, wdo, whd, wdh1, part_w, m_rows, d, f, dp, fp, rows_per_chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int na = 3 * d + f, nb = 2 * f * d;
  ffn_bwd_sum_kernel<<<(na + nb + 255) / 256, 256, 0, stream>>>(
      part_rows, tiles, na, part_w, chunks, nb, grads);
  return (int)cudaGetLastError();
}

}  // namespace

// The wrapper guarantees: contiguous tensors on one device; x, out and the
// padded weights w1 (fp, dp), w2 (dp, fp) in one dtype (fp32 or bf16), with
// dp, fp = d, f rounded up to 16 and zero padding; LN scale/bias and biases
// fp32; fwd_smem <= 227 KB; m_rows = B * t_len rows of x.
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

// As tat_ffn_fwd, plus the cotangent g (like x), the padded w2t = W2^T
// (fp, dp) and w1t = W1^T (dp, fp), the output dx (like x), the workspace
// (ops/cuda_ffn.py::bwd_workspace bytes: y, do (m_rows, dp) and hd, dh1
// (m_rows, fp) in the working type, then the fp32 partials of bwd(); 16-byte
// aligned) and the fp32 gradients
// grads = [d ln_scale (d) | d ln_bias (d) | db2 (d) | db1 (f) | dW1 (f, d)
// | dW2 (d, f)]; bwd_smem <= 227 KB.
extern "C" int tat_ffn_bwd(int bf16, const void* x, const void* g,
                           const void* lnw, const void* lnb, const void* w1,
                           const void* b1, const void* w2t, const void* w1t,
                           void* dx, void* work, void* grads, int m_rows,
                           int t_len, int d, int f, int rows_per_chunk,
                           unsigned int seed, unsigned int thresh,
                           float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float *lw = (const float*)lnw, *lb = (const float*)lnb,
              *bb1 = (const float*)b1;
  return bf16 ? bwd<__nv_bfloat16>(x, g, lw, lb, w1, bb1, w2t, w1t, dx,
                                   (char*)work, (float*)grads, m_rows, t_len,
                                   d, f, rows_per_chunk, seed, thresh, scale,
                                   s)
              : bwd<float>(x, g, lw, lb, w1, bb1, w2t, w1t, dx, (char*)work,
                           (float*)grads, m_rows, t_len, d, f,
                           rows_per_chunk, seed, thresh, scale, s);
}
