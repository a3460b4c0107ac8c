// Tiles of C = A B^T (gemm_tile) and, further down, C = A^T B
// (gemm_tn_tile) for 128 threads. gemm_tile: A (M, K) row-major, B (N, K)
// row-major (PyTorch's Linear layout, K contiguous in both), C tile
// 128 x 16 WN (WN = 4 or 6: 64 or 96 columns) in fp32 registers, handed
// element by element to an epilogue. Shared by subsampling.cu (conv2 as an
// implicit GEMM, the out-Linear), attention.cu (the bf16 projections;
// gemm_tn_tile: its bf16 weight gradients) and ffn.cu (gemm_tn_tile in
// both dtypes: the weight gradients).
//
// K is walked in 64-byte tiles (32 bf16 or 16 fp32 values) through a
// 3-stage ring of cp.async 16-byte copies, so K must be a multiple of
// 16 / sizeof(T) (8 bf16, 4 fp32) and every row 16-byte aligned; pieces past
// K or past the last row are zero-filled by the copy itself. Staged rows are
// 80 bytes apart (five 16-byte units, odd), so the eight rows an ldmatrix
// reads, and the rows the copies write, fall in distinct banks.
//
// bf16: 4 warps in 2 x 2, each a 64 x 8 WN tile of mma.sync.m16n8k16 (4 WN
// products per 16-deep step) fed by ldmatrix. The wider tile reads the A
// rows half as often again per column (the caller picks the width that pads
// N least). fp32: plain SIMT FMAs, 16 x WN outputs per thread (fp32 is the
// check dtype; no tensor-core TF32, so that it agrees with full-precision
// fp32 references).
//
// The A operand comes from a loader object with
//   void issue(char* tile, int r0, int pc)
// which copies its 4 rows (r0 + 32 j) x 16-byte piece pc of the current K
// tile into the staged A tile and steps to the next K tile.
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kGM = 128;             // C tile rows
constexpr int kGRow = 80;            // bytes per staged row (64 + 16)
constexpr int kGStages = 3;
template <int WN>
__host__ __device__ constexpr int gemm_cols() {
  return 16 * WN;
}
template <int WN>
__host__ __device__ constexpr int gemm_stage() {
  return (kGM + gemm_cols<WN>()) * kGRow;
}
template <int WN>  // 46,080 bytes at WN = 4, 53,760 at 6
__host__ __device__ constexpr int gemm_smem() {
  return kGStages * gemm_stage<WN>();
}

// A rows of a row-major (M, K) matrix.
template <typename T>
struct PlainRows {
  const T* a;
  int k_len, k;          // K, and this thread's element column in the tile
  const T* row[4];
  bool ok[4];
  __device__ PlainRows(const T* a_, int m, int k_len_, int m0, int r0,
                       int pc)
      : a(a_), k_len(k_len_), k(pc * (16 / (int)sizeof(T))) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = m0 + r0 + 32 * j;
      ok[j] = r < m;
      row[j] = a + (size_t)(ok[j] ? r : 0) * k_len;
    }
  }
  __device__ void issue(char* tile, int r0, int pc) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool v = ok[j] && k < k_len;
      cp_async16(tile + (r0 + 32 * j) * kGRow + pc * 16, v ? row[j] + k : a,
                 v);
    }
    k += 64 / (int)sizeof(T);
  }
};

// B tile: rows n0 .. n0 + 16 WN - 1 of (N, K), K tile kt.
template <int WN, typename T>
__device__ __forceinline__ void issue_b(char* tile, const T* b, int n_len,
                                        int k_len, int n0, int kt, int r0,
                                        int pc) {
  const int k = kt * (64 / (int)sizeof(T)) + pc * (16 / (int)sizeof(T));
#pragma unroll
  for (int j = 0; j < WN / 2; ++j) {
    const int n = n0 + r0 + 32 * j;
    const bool v = n < n_len && k < k_len;
    cp_async16(tile + (r0 + 32 * j) * kGRow + pc * 16,
               v ? b + (size_t)n * k_len + k : b, v);
  }
}

// The whole K loop of one C tile; epi(row, col, value) for each of the
// thread's 16 WN outputs (rows m0.., cols n0.., unguarded: the epilogue
// checks its bounds). `smem` holds gemm_smem<WN>() bytes, 16-byte aligned.
template <int WN, typename T, class ALoad, class Epi>
__device__ void gemm_tile(char* smem, ALoad& a, const T* b, int n_len,
                          int k_len, int m0, int n0, Epi epi) {
  constexpr int kStage = gemm_stage<WN>();
  const int tid = threadIdx.x, r0 = tid / 4, pc = tid % 4;
  const int nk = (k_len + 64 / (int)sizeof(T) - 1) / (64 / (int)sizeof(T));
#pragma unroll
  for (int s = 0; s < kGStages - 1; ++s) {
    if (s < nk) {
      a.issue(smem + s * kStage, r0, pc);
      issue_b<WN>(smem + s * kStage + kGM * kGRow, b, n_len, k_len, n0, s,
                  r0, pc);
    }
    cp_async_commit();
  }

  constexpr bool kTC = sizeof(T) == 2;
  // bf16: [m16 tile * WN + n8 tile][fragment]; fp32: flat (row i, col j)
  // at i * WN + j
  float acc[4 * WN][4];
#pragma unroll
  for (int i = 0; i < 4 * WN; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  const int warp = tid / 32, lane = tid % 32;

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kGStages - 2>();
    __syncthreads();  // tile kt landed; tile kt - 1 is consumed
    const int nxt = kt + kGStages - 1;
    if (nxt < nk) {
      char* st = smem + (nxt % kGStages) * kStage;
      a.issue(st, r0, pc);
      issue_b<WN>(st + kGM * kGRow, b, n_len, k_len, n0, nxt, r0, pc);
    }
    cp_async_commit();
    const char* sa = smem + (kt % kGStages) * kStage;
    const char* sb = sa + kGM * kGRow;
    if constexpr (kTC) {
      const int wm = (warp % 2) * 64, wn = (warp / 2) * 8 * WN;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t af[4][4], bf[WN / 2][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          ldmatrix_x4(af[i], sa + (wm + 16 * i + lane % 16) * kGRow +
                                 (ks * 16 + (lane / 16) * 8) * 2);
#pragma unroll
        for (int jj = 0; jj < WN / 2; ++jj)
          ldmatrix_x4(bf[jj],
                      sb + (wn + 16 * jj + lane % 8 + (lane / 16) * 8) * kGRow +
                          (ks * 16 + ((lane / 8) % 2) * 8) * 2);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < WN; ++j)
            mma_bf16(acc[i * WN + j], af[i], bf[j / 2][(j % 2) * 2],
                     bf[j / 2][(j % 2) * 2 + 1]);
      }
    } else {
      const float* fa = reinterpret_cast<const float*>(sa);
      const float* fb = reinterpret_cast<const float*>(sb);
      const int tx = tid % 16, ty = tid / 16;
      constexpr int kRowF = kGRow / 4;
#pragma unroll 4
      for (int kk = 0; kk < 16; ++kk) {
        float av[16], bv[WN];
#pragma unroll
        for (int i = 0; i < 16; ++i) av[i] = fa[(ty + 8 * i) * kRowF + kk];
#pragma unroll
        for (int j = 0; j < WN; ++j) bv[j] = fb[(tx + 16 * j) * kRowF + kk];
#pragma unroll
        for (int i = 0; i < 16; ++i)
#pragma unroll
          for (int j = 0; j < WN; ++j) {
            float& c = acc[(i * WN + j) / 4][(i * WN + j) % 4];
            c = fmaf(av[i], bv[j], c);
          }
      }
    }
  }
  cp_async_wait<0>();

  if constexpr (kTC) {
    const int wm = (warp % 2) * 64, wn = (warp / 2) * 8 * WN;
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < WN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          epi(m0 + wm + 16 * i + g + (e / 2) * 8,
              n0 + wn + 8 * j + 2 * t + (e % 2), acc[i * WN + j][e]);
  } else {
    const int tx = tid % 16, ty = tid / 16;
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int j = 0; j < WN; ++j)
        epi(m0 + ty + 8 * i, n0 + tx + 16 * j,
            acc[(i * WN + j) / 4][(i * WN + j) % 4]);
  }
}

// ---------------------------------------------------------------------------
// A tile of C = A^T B for 128 threads, bf16 on the tensor cores: A (M, NA)
// and B (M, NB) row-major, reduced over the rows m in [m_lo, m_hi) (the
// weight gradients: activations^T x inputs, both stored row by row). C tile
// rows i0 .. i0 + 127 (columns of A), columns j0 .. j0 + WJ - 1 (columns of
// B, WJ = 64 or 128; with `ones`, column NB of B reads 1, so that C's column
// NB holds the column sums of A: the bias gradients). The rows are walked 32
// at a time through a 3-stage ring of 16-byte cp.async copies (NA % 8 == 0,
// NB % 8 == 0, rows 16-byte aligned); pieces past the last row or column
// are zero-filled by the copy. Both operands are read transposed through
// ldmatrix.trans: staged rows are 272 (A) and 2 WJ + 16 (B) bytes apart, odd
// multiples of 16, so the eight rows an ldmatrix reads fall in distinct
// banks. 4 warps in 2 x 2, each a 64 x WJ / 2 tile (4 x WJ / 16 m16n8k16
// products per 16-row step).
// ---------------------------------------------------------------------------

constexpr int kTNM = 32;               // rows of m per stage
constexpr int kTNA = 128 * 2 + 16;     // bytes per staged A row
template <int WJ>
__host__ __device__ constexpr int tn_b_row() {   // bytes per staged B row
  return WJ * 2 + 16;
}
template <int WJ>
__host__ __device__ constexpr int tn_stage() {
  return kTNM * (kTNA + tn_b_row<WJ>());
}
template <int WJ>  // 39,936 bytes at WJ = 64, 52,224 at 128
__host__ __device__ constexpr int tn_smem() {
  return kGStages * tn_stage<WJ>();
}
constexpr int kTNSmem = tn_smem<64>();

template <int WJ = 64, class Epi>
__device__ void gemm_tn_tile(char* smem, const __nv_bfloat16* a, int na,
                             const __nv_bfloat16* b, int nb, bool ones,
                             int m_lo, int m_hi, int i0, int j0, Epi epi) {
  static_assert(WJ == 64 || WJ == 128, "tile width");
  constexpr int kB = tn_b_row<WJ>(), kStage = tn_stage<WJ>();
  constexpr int kJT = WJ / 16;         // n8 tiles per warp
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nk = (m_hi - m_lo + kTNM - 1) / kTNM;
  auto issue = [&](int kt, char* st) {
    const int m0 = m_lo + kt * kTNM;
#pragma unroll
    for (int u = 0; u < 4; ++u) {      // A: 32 rows x 16 pieces
      const int p = tid + 128 * u, r = p / 16, c = p % 16;
      const int m = m0 + r, i = i0 + 8 * c;
      const bool v = m < m_hi && i < na;
      cp_async16(st + r * kTNA + c * 16, v ? a + (size_t)m * na + i : a, v);
    }
    char* sb = st + kTNM * kTNA;
#pragma unroll
    for (int u = 0; u < WJ / 32; ++u) {  // B: 32 rows x WJ / 8 pieces
      const int p = tid + 128 * u, r = p / (WJ / 8), c = p % (WJ / 8);
      const int m = m0 + r, j = j0 + 8 * c;
      if (ones && j == nb) {
        const uint32_t one = m < m_hi ? 0x3F80u : 0u;   // bf16 1.0
        *reinterpret_cast<uint4*>(sb + r * kB + c * 16) =
            make_uint4(one, 0u, 0u, 0u);
      } else {
        const bool v = m < m_hi && j < nb;
        cp_async16(sb + r * kB + c * 16, v ? b + (size_t)m * nb + j : b, v);
      }
    }
  };
#pragma unroll
  for (int s = 0; s < kGStages - 1; ++s) {
    if (s < nk) issue(s, smem + s * kStage);
    cp_async_commit();
  }

  float acc[4][kJT][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kJT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  const int wi = (warp % 2) * 64, wj = (warp / 2) * (WJ / 2);

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kGStages - 2>();
    __syncthreads();  // tile kt landed; tile kt - 1 is consumed
    const int nxt = kt + kGStages - 1;
    if (nxt < nk) issue(nxt, smem + (nxt % kGStages) * kStage);
    cp_async_commit();
    const char* sa = smem + (kt % kGStages) * kStage;
    const char* sb = sa + kTNM * kTNA;
#pragma unroll
    for (int kc = 0; kc < kTNM / 16; ++kc) {
      uint32_t af[4][4], bf[kJT / 2][4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
        ldmatrix_x4_trans(af[ii],
                          sa + (16 * kc + lane % 8 + (lane / 16) * 8) * kTNA +
                              (wi + 16 * ii + ((lane / 8) % 2) * 8) * 2);
#pragma unroll
      for (int jj = 0; jj < kJT / 2; ++jj)
        ldmatrix_x4_trans(bf[jj],
                          sb + (16 * kc + lane % 8 + ((lane / 8) % 2) * 8) *
                                   kB +
                              (wj + 16 * jj + (lane / 16) * 8) * 2);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jn = 0; jn < kJT; ++jn)
          mma_bf16(acc[ii][jn], af[ii], bf[jn / 2][(jn % 2) * 2],
                   bf[jn / 2][(jn % 2) * 2 + 1]);
    }
  }
  cp_async_wait<0>();

  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int jn = 0; jn < kJT; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        epi(i0 + wi + 16 * ii + g + (e / 2) * 8,
            j0 + wj + 8 * jn + 2 * t + (e % 2), acc[ii][jn][e]);
}

// The fp32 twin of gemm_tn_tile (the check dtype: SIMT FMAs, no TF32): the
// same C tile over the same rows, without the ones column; the rows walked
// 32 at a time through one shared stage of kTNSmemF32 bytes; 128 threads,
// 16 x 4 outputs each.
constexpr int kTNSmemF32 = kTNM * (128 + 64) * 4;   // 24,576 bytes

template <class Epi>
__device__ void gemm_tn_tile(char* smem, const float* a, int na,
                             const float* b, int nb, int m_lo, int m_hi,
                             int i0, int j0, Epi epi) {
  float* as = reinterpret_cast<float*>(smem);   // 32 x 128
  float* bs = as + kTNM * 128;                  // 32 x 64
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[16][4];
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int m0 = m_lo; m0 < m_hi; m0 += kTNM) {
    __syncthreads();
    for (int p = tid; p < kTNM * 128; p += 128) {
      const int r = p / 128, c = p % 128, m = m0 + r, i = i0 + c;
      as[p] = (m < m_hi && i < na) ? a[(size_t)m * na + i] : 0.f;
    }
    for (int p = tid; p < kTNM * 64; p += 128) {
      const int r = p / 64, c = p % 64, m = m0 + r, j = j0 + c;
      bs[p] = (m < m_hi && j < nb) ? b[(size_t)m * nb + j] : 0.f;
    }
    __syncthreads();
    for (int r = 0; r < kTNM; ++r) {
      float av[16], bv[4];
#pragma unroll
      for (int i = 0; i < 16; ++i) av[i] = as[r * 128 + ty + 8 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[r * 64 + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 16; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      epi(i0 + ty + 8 * i, j0 + tx + 16 * j, acc[i][j]);
}

// The tile width (n8 tiles per warp, 4 or 6) that pads N least; a tie
// takes the wider tile, which reads the A rows fewer times.
inline int gemm_width(int n) {
  const int pad4 = (n + 63) / 64 * 64, pad6 = (n + 95) / 96 * 96;
  return pad6 <= pad4 ? 6 : 4;
}

}  // namespace
