// CTC forward-backward over the extended label lattice (2S+1 positions,
// blank-interleaved), log-space, fp32.
//
// Replaces tpu_asr/ops/pallas_ctc.py::_ctc_fwd_kernel (alpha recursion +
// per-sample NLL, saving alpha) and ::_ctc_bwd_kernel (beta recursion fused
// with the posterior, emitting d(label log-probs)), launched by
// ops/cuda_ctc.py::ctc_nll and ::ctc_nll_bwd.
//
// What bounds it on an H100: the recursion is sequential in time. At
// B=32, T'=376, 2S+1=97 the work is ~97 x 376 three-way log-sum-exps per
// sample and the bytes are the alpha lattice (4.7 MB) and the label
// gradient (4.7 MB), so neither the memory rate nor the arithmetic rate is
// reached: each of the T steps costs one block barrier plus the latency of
// a gathered log-prob load.
//
// Design: one block per sample, one thread per lattice position (the block
// is 2S+1 rounded up to a warp multiple, at most 1024). The lattice row
// lives in shared memory, double-buffered with two guard cells, so a step is
// one barrier. The next frame's gathered log-prob is loaded before the
// barrier. Each sample runs only its own input length (frames past it
// neither advance alpha nor get a gradient), so the loop bound is the data.
// No atomics.

#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr float kNegInf = -1.0e30f;

__device__ __forceinline__ float lse3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  if (m <= kNegInf * 0.5f) return kNegInf;
  return m + logf(expf(a - m) + expf(b - m) + expf(c - m));
}

__global__ void ctc_fwd_kernel(const float* __restrict__ lp,   // (B, T, V)
                               const int* __restrict__ ext,    // (B, L)
                               const int* __restrict__ ilen,   // (B)
                               const int* __restrict__ tlen,   // (B)
                               float* __restrict__ alpha,      // (B, T, L)
                               float* __restrict__ nll,        // (B)
                               int t_max, int v, int l, int blank) {
  extern __shared__ float sm[];
  const int b = blockIdx.x, s = threadIdx.x, n = blockDim.x;
  float* cur = sm;            // [2 guards | n positions]
  float* nxt = sm + n + 2;
  const int il = ilen[b], tl = tlen[b];
  const bool in = s < l;
  const int e = in ? ext[b * l + s] : blank;
  const int e2 = (in && s >= 2) ? ext[b * l + s - 2] : blank;
  const bool valid = in && s <= 2 * tl;
  const bool skip = s >= 2 && e != blank && e != e2;
  const float* lpb = lp + (size_t)b * t_max * v;
  float* ab = alpha + (size_t)b * t_max * l;

  if (s < 2) cur[s] = nxt[s] = kNegInf;
  float a = (valid && s <= 1) ? lpb[e] : kNegInf;
  if (in) ab[s] = a;
  cur[s + 2] = a;
  float lpt = (valid && 1 < il) ? lpb[(size_t)v + e] : 0.f;
  __syncthreads();
  for (int t = 1; t < il; ++t) {
    const float a1 = cur[s + 1], a2 = skip ? cur[s] : kNegInf;
    const float here = lpt;
    if (valid && t + 1 < il) lpt = lpb[(size_t)(t + 1) * v + e];
    a = valid ? lse3(a, a1, a2) + here : kNegInf;
    if (in) ab[(size_t)t * l + s] = a;
    nxt[s + 2] = a;
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  if (s == 0) {
    const float al = cur[2 * tl + 2];
    const float ap = tl > 0 ? cur[2 * tl + 1] : kNegInf;
    const float m = fmaxf(al, ap);
    nll[b] = -(m + logf(expf(al - m) + expf(ap - m)));
  }
}

__global__ void ctc_bwd_kernel(const float* __restrict__ lp,     // (B, T, V)
                               const int* __restrict__ ext,      // (B, L)
                               const int* __restrict__ ilen,
                               const int* __restrict__ tlen,
                               const float* __restrict__ alpha,  // (B, T, L)
                               const float* __restrict__ nll,    // (B)
                               const float* __restrict__ g,      // (B)
                               float* __restrict__ dlab,         // (B, T, L)
                               int t_max, int v, int l, int blank) {
  extern __shared__ float sm[];
  const int b = blockIdx.x, s = threadIdx.x, n = blockDim.x;
  float* cur = sm;            // [n positions | 2 guards]
  float* nxt = sm + n + 2;
  const int il = ilen[b], tl = tlen[b];
  const bool in = s < l;
  const int e = in ? ext[b * l + s] : blank;
  const int e2 = (s + 2 < l) ? ext[b * l + s + 2] : blank;
  const bool valid = in && s <= 2 * tl;
  // beta may jump s -> s + 2 iff position s + 2 skips over s + 1
  const bool skip_from = s + 2 < l && e2 != blank && e2 != e;
  const bool is_end = s == 2 * tl || (s == 2 * tl - 1 && tl > 0);
  const float gb = g[b], nb = nll[b];
  // a zero cotangent (zero_infinity's masked samples) or an impossible
  // alignment gives a zero gradient instead of 0 * inf
  const bool live = gb != 0.f && isfinite(nb) && nb < 1e29f;
  const float* lpb = lp + (size_t)b * t_max * v;
  const float* ab = alpha + (size_t)b * t_max * l;
  float* db = dlab + (size_t)b * t_max * l;

  if (in)
    for (int t = il > 0 ? il : 0; t < t_max; ++t) db[(size_t)t * l + s] = 0.f;
  if (s < 2) cur[n + s] = nxt[n + s] = kNegInf;
  float beta = kNegInf;
  float lpt = (valid && il > 0) ? lpb[(size_t)(il - 1) * v + e] : 0.f;
  for (int t = il - 1; t >= 0; --t) {
    const float here = lpt;
    if (valid && t > 0) lpt = lpb[(size_t)(t - 1) * v + e];
    float nb_ = t == il - 1
                    ? (is_end ? here : kNegInf)
                    : lse3(beta, cur[s + 1], skip_from ? cur[s + 2] : kNegInf) +
                          here;
    beta = valid ? nb_ : kNegInf;
    if (in)
      db[(size_t)t * l + s] =
          (valid && live)
              ? -expf(ab[(size_t)t * l + s] + beta - here + nb) * gb
              : 0.f;
    nxt[s] = beta;
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
}

int threads_for(int l) { return (l + 31) / 32 * 32; }

}  // namespace

// The wrapper guarantees: contiguous fp32 log-probs (B, T, V); int32
// extended labels (B, L = 2S+1 <= 1024), input lengths clamped to T and
// target lengths; fp32 alpha (B, T, L) and nll (B).
extern "C" int tat_ctc_fwd(const void* lp, const void* ext, const void* ilen,
                           const void* tlen, void* alpha, void* nll,
                           int batch, int t_max, int v, int l, int blank,
                           void* stream) {
  const int n = threads_for(l);
  ctc_fwd_kernel<<<batch, n, sizeof(float) * 2 * (n + 2),
                   (cudaStream_t)stream>>>(
      (const float*)lp, (const int*)ext, (const int*)ilen, (const int*)tlen,
      (float*)alpha, (float*)nll, t_max, v, l, blank);
  return (int)cudaGetLastError();
}

// As tat_ctc_fwd, plus the saved alpha and nll, the per-sample cotangent g
// (B) fp32, and the output d(label log-probs) (B, T, L) fp32, which the
// kernel writes in full (zero past each input length).
extern "C" int tat_ctc_bwd(const void* lp, const void* ext, const void* ilen,
                           const void* tlen, const void* alpha,
                           const void* nll, const void* g, void* dlab,
                           int batch, int t_max, int v, int l, int blank,
                           void* stream) {
  const int n = threads_for(l);
  ctc_bwd_kernel<<<batch, n, sizeof(float) * 2 * (n + 2),
                   (cudaStream_t)stream>>>(
      (const float*)lp, (const int*)ext, (const int*)ilen, (const int*)tlen,
      (const float*)alpha, (const float*)nll, (const float*)g, (float*)dlab,
      t_max, v, l, blank);
  return (int)cudaGetLastError();
}
