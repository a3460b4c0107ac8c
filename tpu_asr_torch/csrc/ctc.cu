// CTC forward-backward over the extended label lattice (2S+1 positions,
// blank-interleaved), log-space, fp32.
//
// Replaces tpu_asr/ops/pallas_ctc.py::_ctc_fwd_kernel (alpha recursion +
// per-sample NLL, saving alpha) and ::_ctc_bwd_kernel (beta recursion fused
// with the posterior) together with the one-hot einsum that scatters the
// posterior onto the vocabulary (::_ctc_vjp_bwd), launched by
// ops/cuda_ctc.py::ctc_nll and ::ctc_nll_bwd.
//
// What bounds it on an H100: the recursion is sequential in time. At
// B=32, T'=376, V=129, 2S+1=97 the bytes are 11 MB forward and 17 MB
// backward (a few microseconds at 3.35 TB/s), but each sample runs T'
// dependent steps, each a log-sum-exp over its left (right) neighbours.
// The floor is that chain of steps, not bytes or arithmetic: one step's
// dependent path through two max, a subtraction, ex2, two adds, lg2, an
// fma and the add of the frame's log-prob, with the sub-partition's 4
// special-function lanes taking 8 cycles a warp instruction (10 a step at
// P = 4).
//
// Design: one block per sample; warp specialisation at the scale of one
// sample.
// - The recursion warp holds the lattice row in registers: lane i owns
//   positions iP .. iP + P - 1 (P = 4 for 2S+1 <= 128, 8 for <= 256, 32 for
//   <= 1024). A step needs one neighbour from lane i - 1 (forward) or two
//   from lane i + 1 (backward), each one __shfl issued as soon as the
//   values exist; no barrier is on the critical path. Blank positions
//   (even) never skip, which the unrolled code knows at compile time: a
//   blank costs one ex2 and one lg2, a label two ex2 and one lg2 (the
//   largest term's exp is 1). The log-sum-exp is branch-free, ex2 and lg2
//   volatile (a select keeps the NEG_INF rule): written as a conditional,
//   nvcc branched around each position's ex2 and lg2, and a lane's P
//   chains ran one after another, each waiting out the unit's latency.
//   The kernels ask for one block an SM (__launch_bounds__(n, 1)), which
//   lets ptxas spend registers on overlapping them (the backward 0.0628
//   against 0.0668 ms on an H100; tpu_asr_torch/ctc_ablation.py, which
//   also times the kernels with each piece of their work taken out).
// - Loader warps stage the gathered label log-probs lp[b, t, ext[s]] (and,
//   backward, the saved alpha rows) for 128 / P frames at a time into a
//   2-stage shared-memory ring with 4- and 16-byte cp.async copies, a chunk
//   ahead of the recursion. A loader thread owns fixed slots of a row, so
//   its columns stay in registers and a frame is P / 2 copies with no
//   dependent load. A row's P values of a lane sit as P / 4 float4s
//   interleaved across lanes, so a lane reads them conflict-free; slots of
//   positions past 2 tl hold NEG_INF, which masks them without a select.
//   Named barriers (bar.arrive / bar.sync) hand a stage from producer to
//   consumer and back.
// - Forward: the recursion warp writes each frame's alpha row, padded to a
//   multiple of 4 positions, with 16-byte stores (fire and forget), and the
//   NLL at the end.
// - Backward: the recursion warp writes each frame's log-posterior
//   w = alpha + beta - lp + nll into a second ring; writer warps turn it
//   into d log-probs (B, T, V), written in full by the kernel: a frame's V
//   entries are zeroed, then blank's sum (its positions lane-strided, then
//   a fixed xor butterfly), each label that occurs once straight from its
//   lane, and each repeated label's sum (its positions walked in order
//   from its first, a table built in the prologue) are stored, times -g.
//   A writer takes its frames of a chunk together, so that their exps,
//   butterflies and walks overlap. The sums are in a fixed order, so two
//   calls are bit-equal; frames past the input length are zeros.
// Each sample runs only its own input length. No atomics.

#include <cuda_runtime.h>
#include <stdint.h>

#include <math.h>

#include "mma.cuh"

namespace {

constexpr float kNegInf = -1.0e30f;
constexpr int kStages = 2;
constexpr int kLoaders = 2;     // loader warps
constexpr int kWriters = 5;     // backward writer warps
constexpr int kFwdThreads = 32 * (1 + kLoaders);
constexpr int kBwdThreads = 32 * (1 + kLoaders + kWriters);
constexpr int kIn = 32 * (1 + kLoaders);   // recursion + loaders
constexpr int kOut = 32 * (1 + kWriters);  // recursion + writers
// named barriers (0 is __syncthreads): a stage's "full" and "empty"
constexpr int kFullIn = 1, kEmptyIn = 3, kFullW = 5, kEmptyW = 7;

template <int P>
struct Lattice {
  static constexpr int kRow = 32 * P;        // positions a staged row holds
  static constexpr int kFrames = 128 / P;    // frames a stage holds
  static constexpr int kStage = kFrames * kRow;   // floats: 16 KB
};

// The position held by slot k of a staged row: lane s / P keeps its P
// positions as P / 4 float4s, the q-th float4 of every lane side by side.
template <int P>
__device__ __forceinline__ int pos_of(int k) {
  return ((k >> 2) & 31) * P + (k >> 7) * 4 + (k & 3);
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// 2^x and log2(x) on the special-function unit, flushing subnormals to
// zero. Volatile, so that nvcc does not sink them into a branch.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm volatile("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float lg2(float x) {
  float y;
  asm volatile("lg2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;

// n[j] = log(e^h0 + e^h1) at even j (blank positions, which never skip)
// and log(e^h0 + e^h1 + e^h2) at odd j, max-shifted: the largest term
// contributes exactly 1, and a max at or below NEG_INF / 2 gives NEG_INF.
// Branch-free, and written with every ex2 of the row before the first lg2,
// so that a lane's P chains can overlap.
template <int P>
__device__ __forceinline__ void lse_row(float (&n)[P], const float (&h0)[P],
                                        const float (&h1)[P],
                                        const float (&h2)[P]) {
  float m[P], e1[P], e2[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    if (j & 1) {
      const float p = fmaxf(h1[j], h2[j]), q = fminf(h1[j], h2[j]);
      m[j] = fmaxf(h0[j], p);
      e1[j] = (fminf(h0[j], p) - m[j]) * kLog2e;
      e2[j] = (q - m[j]) * kLog2e;
    } else {
      m[j] = fmaxf(h0[j], h1[j]);
      e1[j] = (fminf(h0[j], h1[j]) - m[j]) * kLog2e;
    }
  }
#pragma unroll
  for (int j = 0; j < P; ++j) {
    e1[j] = ex2(e1[j]);
    if (j & 1) e2[j] = ex2(e2[j]);
  }
#pragma unroll
  for (int j = 0; j < P; ++j)
    e1[j] = (j & 1) ? 1.f + e1[j] + e2[j] : 1.f + e1[j];
#pragma unroll
  for (int j = 0; j < P; ++j) e1[j] = lg2(e1[j]);
#pragma unroll
  for (int j = 0; j < P; ++j)
    n[j] = m[j] <= kNegInf * 0.5f ? kNegInf : fmaf(e1[j], kLn2, m[j]);
}

__device__ __forceinline__ int load_index(const void* p, size_t i, bool wide) {
  return wide ? (int)((const long long*)p)[i] : ((const int*)p)[i];
}

// What every thread of a sample's block knows after the prologue.
struct Sample {
  int frames;   // input length clamped to [0, T]
  int tl;       // target length clamped to [0, S]
  int lv;       // valid positions 2 tl + 1
};

// The extended labels of sample b into ext[0, 2S+1) (blank, y1, blank, ...).
__device__ __forceinline__ Sample prologue(int* ext, const void* targets,
                                           const void* ilen,
                                           const void* tlen, int b,
                                           int t_max, int s_max, int blank,
                                           int wide) {
  Sample sp;
  sp.frames = max(0, min(load_index(ilen, b, wide & 2), t_max));
  sp.tl = max(0, min(load_index(tlen, b, wide & 4), s_max));
  sp.lv = 2 * sp.tl + 1;
  for (int s = threadIdx.x; s < 2 * s_max + 1; s += blockDim.x)
    ext[s] = (s & 1) ? load_index(targets, (size_t)b * s_max + (s >> 1),
                                  wide & 1)
                     : blank;
  return sp;
}

// Loader thread lt (of 32 kLoaders) owns slots lt + 32 kLoaders i of every
// staged row. The column each slot gathers is the same for every frame of
// the sample, so it stays in a register: -1 where the position is not
// valid (the slot keeps the NEG_INF the prologue wrote, which masks it in
// the recursion), -2 where the label lies outside [0, V) (zero-filled).
template <int P>
struct LpSlots {
  static constexpr int kN = Lattice<P>::kRow / (32 * kLoaders);
  int col[kN];
};
template <int P>
__device__ __forceinline__ LpSlots<P> lp_slots(const int* ext, int lv, int v,
                                               int lt) {
  LpSlots<P> sl;
#pragma unroll
  for (int i = 0; i < LpSlots<P>::kN; ++i) {
    const int s = pos_of<P>(lt + 32 * kLoaders * i);
    const int e = s < lv ? ext[s] : -1;
    sl.col[i] = s >= lv ? -1 : (unsigned)e < (unsigned)v ? e : -2;
  }
  return sl;
}
// Stage the label log-probs of `nf` frames, frame f of the chunk being time
// t0 + dir * f.
template <int P>
__device__ __forceinline__ void stage_lp(float* dst, const float* lpb,
                                         const LpSlots<P>& sl, int t0,
                                         int dir, int nf, int v, int lt) {
  for (int f = 0; f < nf; ++f) {
    const float* row = lpb + (size_t)(t0 + dir * f) * v;
#pragma unroll
    for (int i = 0; i < LpSlots<P>::kN; ++i)
      if (sl.col[i] != -1)
        cp_async4(dst + f * Lattice<P>::kRow + lt + 32 * kLoaders * i,
                  row + max(sl.col[i], 0), sl.col[i] >= 0);
  }
}

// A lane's P values of a staged row (see pos_of).
template <int P>
__device__ __forceinline__ void read_row(float (&x)[P], const float* row,
                                         int lane) {
#pragma unroll
  for (int q = 0; q < P / 4; ++q) {
    const float4 u = reinterpret_cast<const float4*>(row)[q * 32 + lane];
    x[4 * q] = u.x;
    x[4 * q + 1] = u.y;
    x[4 * q + 2] = u.z;
    x[4 * q + 3] = u.w;
  }
}

// A lane's P values to p[0 .. 4 nq), 16 bytes at a time.
template <int P>
__device__ __forceinline__ void write_row(float* p, const float (&a)[P],
                                          int nq) {
#pragma unroll
  for (int q = 0; q < P / 4; ++q)
    if (q < nq)
      reinterpret_cast<float4*>(p)[q] =
          make_float4(a[4 * q], a[4 * q + 1], a[4 * q + 2], a[4 * q + 3]);
}

template <int P>
__global__ void __launch_bounds__(kFwdThreads, 1)
    ctc_fwd_kernel(const float* __restrict__ lp,    // (B, T, V)
                   const void* __restrict__ targets,  // (B, S) int32/int64
                   const void* __restrict__ ilen,     // (B)
                   const void* __restrict__ tlen,     // (B)
                   float* __restrict__ alpha,         // (B, T, lpad)
                   float* __restrict__ nll,           // (B)
                   int t_max, int v, int s_max, int lpad, int blank,
                   int wide) {
  using Lt = Lattice<P>;
  extern __shared__ float4 sm4[];
  float* ring = reinterpret_cast<float*>(sm4);       // kStages x kStage
  float* last = ring + kStages * Lt::kStage;          // kRow
  int* ext = reinterpret_cast<int*>(last + Lt::kRow);  // 2S+1
  const int b = blockIdx.x, lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const Sample sp = prologue(ext, targets, ilen, tlen, b, t_max, s_max, blank,
                             wide);
  for (int k = threadIdx.x; k < kStages * Lt::kStage; k += blockDim.x)
    ring[k] = kNegInf;
  __syncthreads();
  // frame 0 starts the lattice whatever the input length (as the TPU kernel)
  const int frames = max(sp.frames, 1);
  const int chunks = (frames + Lt::kFrames - 1) / Lt::kFrames;
  const float* lpb = lp + (size_t)b * t_max * v;

  if (warp > 0) {                                     // loaders
    const int lt = threadIdx.x - 32;
    const LpSlots<P> sl = lp_slots<P>(ext, sp.lv, v, lt);
    for (int c = 0; c < chunks; ++c) {
      const int st = c % kStages;
      if (c >= kStages) bar_sync(kEmptyIn + st, kIn);
      const int t0 = c * Lt::kFrames;
      stage_lp<P>(ring + st * Lt::kStage, lpb, sl, t0, 1,
                  min(Lt::kFrames, frames - t0), v, lt);
      cp_async_commit();
      cp_async_wait<0>();
      bar_arrive(kFullIn + st, kIn);
    }
    return;
  }

  // the recursion warp
  const int s0 = lane * P, l = 2 * s_max + 1;
  uint32_t skip = 0;        // bit j: position s0 + j may come from s0 + j - 2
#pragma unroll
  for (int j = 1; j < P; j += 2) {
    const int s = s0 + j;
    if (s >= 2 && s < l && ext[s] != blank && ext[s] != ext[s - 2])
      skip |= 1u << j;
  }
  float a[P], x[P], xn[P];
  // this lane's part of the alpha rows: 4 nq positions (0 past the padding)
  float* arow = alpha + (size_t)b * t_max * lpad + s0;
  const int nq = max(0, min(P / 4, (lpad - s0) / 4));
  float u;               // the left neighbour's last position, one step old
  for (int c = 0; c < chunks; ++c) {
    const int st = c % kStages;
    bar_sync(kFullIn + st, kIn);
    const float* stage = ring + st * Lt::kStage;
    const int t0 = c * Lt::kFrames, nf = min(Lt::kFrames, frames - t0);
    int f = 0;
    if (c == 0) {
      read_row<P>(x, stage, lane);
#pragma unroll
      for (int j = 0; j < P; ++j) a[j] = s0 + j <= 1 ? x[j] : kNegInf;
      u = __shfl_up_sync(0xffffffffu, a[P - 1], 1);
      write_row<P>(arow, a, nq);
      f = 1;
    }
    read_row<P>(xn, stage + min(f, nf - 1) * Lt::kRow, lane);
    for (; f < nf; ++f) {
#pragma unroll
      for (int j = 0; j < P; ++j) x[j] = xn[j];
      read_row<P>(xn, stage + min(f + 1, nf - 1) * Lt::kRow, lane);
      if (lane == 0) u = kNegInf;
      float h1[P], h2[P], n[P];
#pragma unroll
      for (int j = 0; j < P; ++j) {
        h1[j] = j >= 1 ? a[j - 1] : u;
        h2[j] = ((j & 1) && (skip >> j & 1)) ? (j >= 2 ? a[j - 2] : u)
                                             : kNegInf;
      }
      lse_row<P>(n, a, h1, h2);
      // an invalid position's staged NEG_INF keeps it at NEG_INF (not
      // 2 NEG_INF, as the saved lattice should read)
#pragma unroll
      for (int j = 0; j < P; ++j) a[j] = fmaxf(n[j] + x[j], kNegInf);
      // the next step's neighbour first: the store can wait
      u = __shfl_up_sync(0xffffffffu, a[P - 1], 1);
      arow += lpad;
      write_row<P>(arow, a, nq);
    }
    if (c + kStages < chunks) bar_arrive(kEmptyIn + st, kIn);
  }
#pragma unroll
  for (int j = 0; j < P; ++j) last[s0 + j] = a[j];
  __syncwarp();
  if (lane == 0) {
    const float al = last[2 * sp.tl];
    const float ap = sp.tl > 0 ? last[2 * sp.tl - 1] : kNegInf;
    const float m = fmaxf(al, ap);
    nll[b] = -(m + logf(expf(al - m) + expf(ap - m)));
  }
}

template <int P>
__global__ void __launch_bounds__(kBwdThreads, 1)
    ctc_bwd_kernel(const float* __restrict__ lp,       // (B, T, V)
                   const void* __restrict__ targets,
                   const void* __restrict__ ilen,
                   const void* __restrict__ tlen,
                   const float* __restrict__ alpha,    // (B, T, lpad)
                   const float* __restrict__ nll,      // (B)
                   const float* __restrict__ g,        // (B)
                   float* __restrict__ dlp,            // (B, T, V)
                   int t_max, int v, int s_max, int lpad, int blank,
                   int wide) {
  using Lt = Lattice<P>;
  extern __shared__ float4 sm4[];
  float* lp_ring = reinterpret_cast<float*>(sm4);
  float* al_ring = lp_ring + kStages * Lt::kStage;
  float* w_ring = al_ring + kStages * Lt::kStage;     // natural order rows
  const int l = 2 * s_max + 1;
  int* ext = reinterpret_cast<int*>(w_ring + kStages * Lt::kStage);
  int* next = ext + l;      // a label position's next with the same id, or -1
  int* head = next + l;     // 1 at a label id's first position
  const int b = blockIdx.x, lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const Sample sp = prologue(ext, targets, ilen, tlen, b, t_max, s_max, blank,
                             wide);
  for (int k = threadIdx.x; k < 2 * kStages * Lt::kStage; k += blockDim.x)
    lp_ring[k] = kNegInf;                   // both input rings
  __syncthreads();
  for (int k = threadIdx.x; k < sp.tl; k += blockDim.x) {
    const int s = 2 * k + 1, e = ext[s];
    int nx = -1, first = e != blank;
    for (int s2 = s + 2; e != blank && s2 < sp.lv; s2 += 2)
      if (ext[s2] == e) {
        nx = s2;
        break;
      }
    for (int s2 = 1; first && s2 < s; s2 += 2) first = ext[s2] != e;
    next[s] = nx;
    head[s] = first;
  }
  __syncthreads();
  const int frames = sp.frames;
  const int chunks = (frames + Lt::kFrames - 1) / Lt::kFrames;
  const float gb = g[b], nb = nll[b];
  // a zero cotangent (zero_infinity's masked samples) or an impossible
  // alignment gives a zero gradient instead of 0 * inf
  const bool live = gb != 0.f && isfinite(nb) && nb < 1e29f;
  const float* lpb = lp + (size_t)b * t_max * v;

  if (warp > kLoaders) {                              // writers
    const int wid = warp - 1 - kLoaders;
    float* db = dlp + (size_t)b * t_max * v;
    for (int t = frames + wid; t < t_max; t += kWriters)
      for (int u = lane; u < v; u += 32) db[(size_t)t * v + u] = 0.f;
    // this lane's positions lane + 32 i: their ids and what they are
    int lab[P];
    uint32_t blank_bits = 0;   // blank's positions
    uint32_t uniq_bits = 0;    // a label that occurs once
    uint32_t head_bits = 0;    // the first of a label that repeats
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int s = lane + 32 * i;
      lab[i] = s < sp.lv ? ext[s] : blank;
      if (s >= sp.lv) continue;
      if (lab[i] == blank)
        blank_bits |= 1u << i;
      else if (head[s])
        (next[s] < 0 ? uniq_bits : head_bits) |= 1u << i;
    }
    const bool repeats = __any_sync(0xffffffffu, head_bits != 0);
    // a writer takes frames wid + kWriters m of a chunk, all at once, so
    // that their exps, butterflies and chain walks overlap
    constexpr int kM = (Lt::kFrames + kWriters - 1) / kWriters;
    for (int c = 0; c < chunks; ++c) {
      const int st = c % kStages;
      bar_sync(kFullW + st, kOut);
      const int nf = min(Lt::kFrames, frames - c * Lt::kFrames);
      float* w0 = w_ring + st * Lt::kStage + wid * Lt::kRow;
      float* out0 = db + (size_t)(frames - 1 - c * Lt::kFrames - wid) * v;
      const int nm = nf > wid ? (nf - 1 - wid) / kWriters + 1 : 0;
      auto w = [&](int m) { return w0 + m * kWriters * Lt::kRow; };
      auto out = [&](int m) { return out0 - (size_t)m * kWriters * v; };
      for (int m = 0; m < nm; ++m)
        for (int u = lane; u < v; u += 32) out(m)[u] = 0.f;
      __syncwarp();                   // every zero before any value
      if (live && nm > 0) {
        float gam[kM][P], sb[kM];
#pragma unroll
        for (int m = 0; m < kM; ++m) {
          sb[m] = 0.f;
#pragma unroll
          for (int i = 0; i < P; ++i) {
            gam[m][i] = __expf(w(min(m, nm - 1))[lane + 32 * i]);
            if (blank_bits >> i & 1) sb[m] += gam[m][i];
          }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
#pragma unroll
          for (int m = 0; m < kM; ++m)
            sb[m] += __shfl_xor_sync(0xffffffffu, sb[m], o);
#pragma unroll
        for (int m = 0; m < kM; ++m) {
          if (m >= nm) break;
          if (lane == 0) out(m)[blank] = -gb * sb[m];
#pragma unroll
          for (int i = 0; i < P; ++i)
            if ((uniq_bits >> i & 1) && (unsigned)lab[i] < (unsigned)v)
              out(m)[lab[i]] = -gb * gam[m][i];
        }
        if (repeats) {
          // a repeated label sums its positions in order: the posteriors go
          // into the frames' rows, which only this warp reads
#pragma unroll
          for (int m = 0; m < kM; ++m)
#pragma unroll
            for (int i = 0; i < P; ++i)
              if (m < nm) w(m)[lane + 32 * i] = gam[m][i];
          __syncwarp();
#pragma unroll
          for (int i = 0; i < P; ++i) {
            if (!(head_bits >> i & 1)) continue;
            float acc[kM];
#pragma unroll
            for (int m = 0; m < kM; ++m) acc[m] = 0.f;
            for (int p = lane + 32 * i; p >= 0; p = next[p])
#pragma unroll
              for (int m = 0; m < kM; ++m)
                if (m < nm) acc[m] += w(m)[p];
            if ((unsigned)lab[i] < (unsigned)v)
#pragma unroll
              for (int m = 0; m < kM; ++m)
                if (m < nm) out(m)[lab[i]] = -gb * acc[m];
          }
        }
      }
      __syncwarp();
      if (c + kStages < chunks) bar_arrive(kEmptyW + st, kOut);
    }
    return;
  }
  if (warp > 0) {                                     // loaders
    const int lt = threadIdx.x - 32;
    const LpSlots<P> sl = lp_slots<P>(ext, sp.lv, v, lt);
    // the float4 slots q * 32 + lane' of an alpha row this thread copies:
    // positions lane' P + 4 q (-1: none, or not valid)
    constexpr int kA = (Lt::kRow / 4 + 32 * kLoaders - 1) / (32 * kLoaders);
    int apos[kA];
#pragma unroll
    for (int i = 0; i < kA; ++i) {
      const int slot = lt + 32 * kLoaders * i;
      const int s = (slot & 31) * P + (slot >> 5) * 4;
      apos[i] = slot < Lt::kRow / 4 && s < sp.lv ? s : -1;
    }
    const float* abase = alpha + (size_t)b * t_max * lpad;
    for (int c = 0; c < chunks; ++c) {
      const int st = c % kStages;
      if (c >= kStages) bar_sync(kEmptyIn + st, kIn);
      const int t0 = frames - 1 - c * Lt::kFrames;
      const int nf = min(Lt::kFrames, frames - c * Lt::kFrames);
      stage_lp<P>(lp_ring + st * Lt::kStage, lpb, sl, t0, -1, nf, v, lt);
      float* adst = al_ring + st * Lt::kStage;
      for (int f = 0; f < nf; ++f) {
        const float* arow = abase + (size_t)(t0 - f) * lpad;
#pragma unroll
        for (int i = 0; i < kA; ++i)
          if (apos[i] >= 0)
            cp_async16(adst + f * Lt::kRow + 4 * (lt + 32 * kLoaders * i),
                       arow + apos[i], true);
      }
      cp_async_commit();
      cp_async_wait<0>();
      bar_arrive(kFullIn + st, kIn);
    }
    return;
  }

  // the recursion warp
  const int s0 = lane * P;
  uint32_t skip = 0;   // bit j: beta may jump s0 + j -> s0 + j + 2
  uint32_t end = 0;    // bit j: s0 + j is a final position
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int s = s0 + j;
    if ((j & 1) && s + 2 < l && ext[s + 2] != blank && ext[s + 2] != ext[s])
      skip |= 1u << j;
    if (s == 2 * sp.tl || (s == 2 * sp.tl - 1 && sp.tl > 0)) end |= 1u << j;
  }
  float be[P], x[P], al[P], xn[P], aln[P];
  float d1, d2;    // the right neighbour's first two positions, one step old
  for (int c = 0; c < chunks; ++c) {
    const int st = c % kStages;
    bar_sync(kFullIn + st, kIn);
    if (c >= kStages) bar_sync(kEmptyW + st, kOut);
    const float* lst = lp_ring + st * Lt::kStage;
    const float* ast = al_ring + st * Lt::kStage;
    float* wst = w_ring + st * Lt::kStage + s0;
    const int nf = min(Lt::kFrames, frames - c * Lt::kFrames);
    int f = 0;
    if (c == 0) {                           // the last frame
      read_row<P>(x, lst, lane);
      read_row<P>(al, ast, lane);
#pragma unroll
      for (int j = 0; j < P; ++j) be[j] = (end >> j & 1) ? x[j] : kNegInf;
      d1 = __shfl_down_sync(0xffffffffu, be[0], 1);
      d2 = __shfl_down_sync(0xffffffffu, be[1], 1);
#pragma unroll
      for (int j = 0; j < P; ++j) al[j] = al[j] + be[j] - x[j] + nb;
      write_row<P>(wst, al, P / 4);
      f = 1;
    }
    read_row<P>(xn, lst + min(f, nf - 1) * Lt::kRow, lane);
    read_row<P>(aln, ast + min(f, nf - 1) * Lt::kRow, lane);
    for (; f < nf; ++f) {
#pragma unroll
      for (int j = 0; j < P; ++j) {
        x[j] = xn[j];
        al[j] = aln[j];
      }
      read_row<P>(xn, lst + min(f + 1, nf - 1) * Lt::kRow, lane);
      read_row<P>(aln, ast + min(f + 1, nf - 1) * Lt::kRow, lane);
      if (lane == 31) d1 = d2 = kNegInf;
      float h1[P], h2[P], n[P];
#pragma unroll
      for (int j = 0; j < P; ++j) {
        h1[j] = j + 1 < P ? be[j + 1] : d1;
        h2[j] = ((j & 1) && (skip >> j & 1)) ? (j + 2 < P ? be[j + 2] : d2)
                                             : kNegInf;
      }
      lse_row<P>(n, be, h1, h2);
      // invalid positions may reach 2 NEG_INF, which the max-shift treats
      // as NEG_INF; the writers read valid positions only
#pragma unroll
      for (int j = 0; j < P; ++j) be[j] = n[j] + x[j];
      d1 = __shfl_down_sync(0xffffffffu, be[0], 1);
      d2 = __shfl_down_sync(0xffffffffu, be[1], 1);
#pragma unroll
      for (int j = 0; j < P; ++j)
        al[j] = al[j] + be[j] - x[j] + nb;   // the log-posterior w
      write_row<P>(wst + f * Lt::kRow, al, P / 4);
    }
    bar_arrive(kFullW + st, kOut);
    if (c + kStages < chunks) bar_arrive(kEmptyIn + st, kIn);
  }
}

template <int P>
size_t fwd_smem(int l) {
  return sizeof(float) * (kStages * Lattice<P>::kStage + Lattice<P>::kRow) +
         sizeof(int) * l;
}
template <int P>
size_t bwd_smem(int l) {
  return sizeof(float) * 3 * kStages * Lattice<P>::kStage +
         sizeof(int) * 3 * l;
}

template <int P>
int launch_fwd(const void* lp, const void* targets, const void* ilen,
               const void* tlen, void* alpha, void* nll, int batch, int t_max,
               int v, int s_max, int lpad, int blank, int wide,
               cudaStream_t stream) {
  const size_t smem = fwd_smem<P>(2 * s_max + 1);
  cudaError_t err = cudaFuncSetAttribute(
      ctc_fwd_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  ctc_fwd_kernel<P><<<batch, kFwdThreads, smem, stream>>>(
      (const float*)lp, targets, ilen, tlen, (float*)alpha, (float*)nll,
      t_max, v, s_max, lpad, blank, wide);
  return (int)cudaGetLastError();
}

template <int P>
int launch_bwd(const void* lp, const void* targets, const void* ilen,
               const void* tlen, const void* alpha, const void* nll,
               const void* g, void* dlp, int batch, int t_max, int v,
               int s_max, int lpad, int blank, int wide, cudaStream_t stream) {
  const size_t smem = bwd_smem<P>(2 * s_max + 1);
  cudaError_t err = cudaFuncSetAttribute(
      ctc_bwd_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  ctc_bwd_kernel<P><<<batch, kBwdThreads, smem, stream>>>(
      (const float*)lp, targets, ilen, tlen, (const float*)alpha,
      (const float*)nll, (const float*)g, (float*)dlp, t_max, v, s_max, lpad,
      blank, wide);
  return (int)cudaGetLastError();
}

}  // namespace

// The wrapper guarantees: contiguous fp32 log-probs (B, T, V); targets
// (B, S) with 2S+1 <= 1024, input and target lengths (B), each int32 or
// int64 (bit 0 / 1 / 2 of `wide` set for int64); 0 <= blank < V; fp32
// alpha (B, T, lpad = 2S+1 rounded up to 4) and nll (B). The kernel clamps
// the lengths to [0, T] and [0, S] and writes alpha for the frames it runs.
extern "C" int tat_ctc_fwd(const void* lp, const void* targets,
                           const void* ilen, const void* tlen, void* alpha,
                           void* nll, int batch, int t_max, int v, int s_max,
                           int lpad, int blank, int wide, void* stream) {
  const int l = 2 * s_max + 1;
  auto* launch = l <= 128   ? launch_fwd<4>
                 : l <= 256 ? launch_fwd<8>
                            : launch_fwd<32>;
  return launch(lp, targets, ilen, tlen, alpha, nll, batch, t_max, v, s_max,
                lpad, blank, wide, (cudaStream_t)stream);
}

// As tat_ctc_fwd, plus the saved alpha and nll, the per-sample cotangent g
// (B) fp32, and the output d log-probs (B, T, V) fp32, which the kernel
// writes in full (zero past each input length and off the target's ids).
extern "C" int tat_ctc_bwd(const void* lp, const void* targets,
                           const void* ilen, const void* tlen,
                           const void* alpha, const void* nll, const void* g,
                           void* dlp, int batch, int t_max, int v, int s_max,
                           int lpad, int blank, int wide, void* stream) {
  const int l = 2 * s_max + 1;
  auto* launch = l <= 128   ? launch_bwd<4>
                 : l <= 256 ? launch_bwd<8>
                            : launch_bwd<32>;
  return launch(lp, targets, ilen, tlen, alpha, nll, g, dlp, batch, t_max, v,
                s_max, lpad, blank, wide, (cudaStream_t)stream);
}
