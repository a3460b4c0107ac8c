// Log-mel spectrogram: windowed |FFT|^mag_power -> mel -> log(x + guard)
// (or the mel power itself), fp32.
//
// Replaces tpu_asr/ops/pallas_features.py::_logmel_kernel (fused_logmel).
// Input is the pre-emphasised, reflect-padded audio (B, Lp); output is the
// unnormalised log-mel (B, T, n_mels). Normalisation and masking stay in
// PyTorch, as they stay in XLA on the TPU.
//
// What bounds it on an H100: computed by an FFT, a frame of n_fft = 512
// costs about 11.5 k operations (a 256-point complex FFT, the real split
// and the power) and ~514 multiply-adds of mel bands, against 3 KB of audio
// in (shared by overlapping frames: 640 new bytes a frame at hop 160) and
// 320 bytes out. So the function is bound by bytes (audio in, log-mel out);
// the TPU kernel's DFT-as-matmul (~0.26 M multiply-adds a frame) is work an
// FFT does not need.
//
// Two kernels:
//   logmel_fft_kernel (n_fft a power of two, 64 .. 2048): one block of 8
//     warps per (batch row, 32 frames). The tile's audio span,
//     31 hop + n_fft samples, is staged once in shared memory with cp.async
//     (16-byte copies where the row is 16-byte aligned, 4-byte copies
//     elsewhere: bucket padding varies Lp), with the window and the
//     twiddle table exp(-2 pi i m / n_fft) (built by the wrapper in float64,
//     handed over in fp32). The real FFT of n_fft = 2N samples is one
//     N-point complex FFT of the even/odd packed windowed frame, in the
//     warp's own shared buffers: at n_fft = 512 (every config of the
//     repo) two frames per warp, each by a half-warp in two radix-16
//     Stockham passes whose 16-point DFTs run in registers; at other sizes
//     one frame per warp in radix-4 Stockham stages (one radix-2 stage
//     where log2 N is odd), __syncwarp between passes. Then the split
//     X[k] = E[k] + W^k O[k] gives the power of bins k and N - k together,
//     raised to mag_power / 2 in registers and contracted with the mel
//     filterbank over each filter's band of nonzero bins (Slaney
//     triangles: each bin in at most two filters), one lane per filter,
//     the filters dealt to the lanes so that their multiply-add counts
//     even out.
//   logmel_kernel (any other n_fft % 4 == 0, hop % 4 == 0, n_freq <= 288):
//     the windowed [cos | sin] DFT as SIMT fp32 multiply-adds, 16 frames a
//     block, thread f owning frequency f; the power tile stays in shared
//     memory for the dense mel product.

#include <cuda_runtime.h>

#include <stdint.h>

#include "mma.cuh"

namespace {

// ---------------------------------------------------------------------------
// The DFT kernel (any n_fft % 4 == 0).
// ---------------------------------------------------------------------------

constexpr int kTile = 16;  // frames per block

__device__ __forceinline__ float mag(float power, float mag_power) {
  return mag_power == 2.f ? power
                          : powf(sqrtf(fmaxf(power, 0.f)), mag_power);
}

__global__ void __launch_bounds__(288) logmel_kernel(
    const float* __restrict__ audio,  // (B, lp)
    const float* __restrict__ basis,  // (n_fft, 2 * n_freq): [cos | sin]
    const float* __restrict__ fb,     // (n_freq, n_mels)
    float* __restrict__ out,          // (B, n_frames, n_mels)
    int lp, int n_frames, int n_fft, int hop, int n_freq, int n_mels,
    float log_guard, float mag_power, int take_log) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int span = (kTile - 1) * hop + n_fft;
  float* wav = smem;                   // span samples (multiple of 4)
  float* power = smem + span;          // kTile * n_freq
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kTile;

  const float* src = audio + (size_t)b * lp + (size_t)t0 * hop;
  const int avail = lp - t0 * hop;
  for (int i = threadIdx.x; i < span; i += blockDim.x)
    wav[i] = i < avail ? src[i] : 0.f;
  __syncthreads();

  const int row = 2 * n_freq;
  for (int f = threadIdx.x; f < n_freq; f += blockDim.x) {
    float re[kTile], im[kTile];
#pragma unroll
    for (int t = 0; t < kTile; ++t) re[t] = im[t] = 0.f;
    for (int n = 0; n < n_fft; n += 4) {
      float c[4], s[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        c[u] = __ldg(basis + (size_t)(n + u) * row + f);
        s[u] = __ldg(basis + (size_t)(n + u) * row + n_freq + f);
      }
#pragma unroll
      for (int t = 0; t < kTile; ++t) {
        const float4 x = *reinterpret_cast<const float4*>(wav + t * hop + n);
        re[t] = fmaf(x.x, c[0], re[t]);
        im[t] = fmaf(x.x, s[0], im[t]);
        re[t] = fmaf(x.y, c[1], re[t]);
        im[t] = fmaf(x.y, s[1], im[t]);
        re[t] = fmaf(x.z, c[2], re[t]);
        im[t] = fmaf(x.z, s[2], im[t]);
        re[t] = fmaf(x.w, c[3], re[t]);
        im[t] = fmaf(x.w, s[3], im[t]);
      }
    }
#pragma unroll
    for (int t = 0; t < kTile; ++t)
      power[t * n_freq + f] = mag(re[t] * re[t] + im[t] * im[t], mag_power);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < kTile * n_mels; i += blockDim.x) {
    const int t = i / n_mels, m = i - (i / n_mels) * n_mels;
    if (t0 + t >= n_frames) continue;
    const float* p = power + t * n_freq;
    float acc = 0.f;
    for (int f = 0; f < n_freq; ++f)
      acc = fmaf(p[f], __ldg(fb + (size_t)f * n_mels + m), acc);
    out[((size_t)b * n_frames + t0 + t) * n_mels + m] =
        take_log ? logf(acc + log_guard) : acc;
  }
}

// ---------------------------------------------------------------------------
// The FFT kernel (n_fft = 2N a power of two, 64 <= n_fft <= 2048).
// ---------------------------------------------------------------------------

constexpr int kFT = 32;   // frames per block
constexpr int kFW = 8;    // warps per block, one frame at a time each

// A warp's complex buffer keeps element i at i + i / 16: one pad every 16
// float2s, so that the first radix-16 pass's stores (16 apart across the
// lanes) and the first radix-4 stages' (4 and 16 apart) fall in distinct
// banks.
__host__ __device__ constexpr int fft_pad(int i) { return i + (i >> 4); }

// Per-warp shared floats: the padded N-point complex buffer (two at
// N = 256: one frame per half-warp) and N + 1 powers.
__host__ __device__ constexpr int fft_warp_floats(int n) {
  return (n == 256 ? 2 : 1) * 2 * fft_pad(n) + n + 4;
}

// Floats of the 16 x 16 stage twiddles W_256^(r j) (N = 256 only).
__host__ __device__ constexpr int fft_tw16_floats(int n) {
  return n == 256 ? 2 * 256 : 0;
}

__host__ __device__ constexpr int log2i(int n) {
  return n > 1 ? 1 + log2i(n / 2) : 0;
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// One Stockham stage of radix R over the warp's N-point buffer: butterfly
// j reads elements j + r N / R, multiplies element r by
// exp(-2 pi i r (j mod ns) / (ns R)) (table entry r (j mod ns) 2N / (ns R)),
// takes the R-point DFT and writes element r to
// (j - j mod ns) R + j mod ns + r ns; ns is the product of the earlier
// stages' radices, and the output is in natural order after the last
// stage. The first stage (ns = 1, no twiddles) reads the packed windowed
// frame z[n] = x[2n] w[2n] + i x[2n + 1] w[2n + 1] from the staged audio
// (as float2 pairs where the frame starts at an even sample). Every lane
// reads all its inputs before any lane writes.
template <int N, int R, bool kFirst>
__device__ __forceinline__ void fft_stage(float2* buf, const float* x,
                                          const float* win, const float2* tw,
                                          int ns, int lane, bool pairs) {
  constexpr int kB = N / R;
  constexpr int kPer = (kB + 31) / 32;
  float2 v[kPer][R];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int j = lane + 32 * i;
    if (kB % 32 == 0 || j < kB) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int n = j + r * kB;
        if (!kFirst) {
          v[i][r] = buf[fft_pad(n)];
        } else if (pairs) {
          const float2 a = *reinterpret_cast<const float2*>(x + 2 * n);
          const float2 w = *reinterpret_cast<const float2*>(win + 2 * n);
          v[i][r] = make_float2(a.x * w.x, a.y * w.y);
        } else {
          v[i][r] = make_float2(x[2 * n] * win[2 * n],
                                x[2 * n + 1] * win[2 * n + 1]);
        }
      }
    }
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int j = lane + 32 * i;
    if (kB % 32 == 0 || j < kB) {
      const int k = j & (ns - 1);
      if (!kFirst) {
        const int step = k * (2 * N / (ns * R));
#pragma unroll
        for (int r = 1; r < R; ++r) v[i][r] = cmul(v[i][r], tw[r * step]);
      }
      float2 y[R];
      if constexpr (R == 4) {
        const float2 a0 = make_float2(v[i][0].x + v[i][2].x,
                                      v[i][0].y + v[i][2].y);
        const float2 a1 = make_float2(v[i][0].x - v[i][2].x,
                                      v[i][0].y - v[i][2].y);
        const float2 a2 = make_float2(v[i][1].x + v[i][3].x,
                                      v[i][1].y + v[i][3].y);
        // (v1 - v3) * (-i)
        const float2 a3 = make_float2(v[i][1].y - v[i][3].y,
                                      v[i][3].x - v[i][1].x);
        y[0] = make_float2(a0.x + a2.x, a0.y + a2.y);
        y[1] = make_float2(a1.x + a3.x, a1.y + a3.y);
        y[2] = make_float2(a0.x - a2.x, a0.y - a2.y);
        y[3] = make_float2(a1.x - a3.x, a1.y - a3.y);
      } else {
        y[0] = make_float2(v[i][0].x + v[i][1].x, v[i][0].y + v[i][1].y);
        y[1] = make_float2(v[i][0].x - v[i][1].x, v[i][0].y - v[i][1].y);
      }
      const int d = (j - k) * R + k;
#pragma unroll
      for (int r = 0; r < R; ++r) buf[fft_pad(d + r * ns)] = y[r];
    }
  }
  __syncwarp();
}

// x * (-i)
__device__ __forceinline__ float2 mul_mi(float2 x) {
  return make_float2(x.y, -x.x);
}
__device__ __forceinline__ float2 add2(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 sub2(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

// The 4-point DFT of (a, b, c, d) in place.
__device__ __forceinline__ void dft4(float2& a, float2& b, float2& c,
                                     float2& d) {
  const float2 s0 = add2(a, c), s1 = sub2(a, c), s2 = add2(b, d);
  const float2 s3 = mul_mi(sub2(b, d));
  a = add2(s0, s2);
  b = add2(s1, s3);
  c = sub2(s0, s2);
  d = sub2(s1, s3);
}

// The 16-point DFT of v in registers, as 4 x 4: n = 4 n1 + n2,
// k = k1 + 4 k2; X[k1 + 4 k2] ends in v[4 k1 + k2].
__device__ __forceinline__ void dft16(float2 (&v)[16]) {
  constexpr float c1 = 0.92387953251128674f;  // cos(pi / 8)
  constexpr float s1 = 0.38268343236508978f;  // sin(pi / 8)
  constexpr float r2 = 0.70710678118654752f;  // cos(pi / 4)
#pragma unroll
  for (int n2 = 0; n2 < 4; ++n2) dft4(v[n2], v[4 + n2], v[8 + n2], v[12 + n2]);
  // W_16^(n2 k1) on v[4 k1 + n2]
  v[5] = cmul(v[5], make_float2(c1, -s1));     // W^1
  v[6] = cmul(v[6], make_float2(r2, -r2));     // W^2
  v[7] = cmul(v[7], make_float2(s1, -c1));     // W^3
  v[9] = cmul(v[9], make_float2(r2, -r2));     // W^2
  v[10] = mul_mi(v[10]);                       // W^4
  v[11] = cmul(v[11], make_float2(-r2, -r2));  // W^6
  v[13] = cmul(v[13], make_float2(s1, -c1));   // W^3
  v[14] = cmul(v[14], make_float2(-r2, -r2));  // W^6
  v[15] = cmul(v[15], make_float2(-c1, s1));   // W^9
#pragma unroll
  for (int k1 = 0; k1 < 4; ++k1)
    dft4(v[4 * k1], v[4 * k1 + 1], v[4 * k1 + 2], v[4 * k1 + 3]);
}

// The 256-point complex FFT of one frame by a half-warp (lane h of 16),
// two radix-16 Stockham passes in registers: pass 1 takes
// z[h + 16 r] (the packed windowed frame) and writes its DFT to
// buf[16 h + q]; pass 2 takes buf[h + 16 r] times W_256^(r h) (tw16, from
// the wrapper's table) and writes X[h + 16 q]. Both halves of the warp
// call it; it ends with the buffer complete.
__device__ __forceinline__ void fft256_half(float2* buf, const float* x,
                                            const float* win,
                                            const float2* tw16, int h,
                                            bool pairs) {
  float2 v[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int n = h + 16 * r;
    if (pairs) {
      const float2 a = *reinterpret_cast<const float2*>(x + 2 * n);
      const float2 w = *reinterpret_cast<const float2*>(win + 2 * n);
      v[r] = make_float2(a.x * w.x, a.y * w.y);
    } else {
      v[r] = make_float2(x[2 * n] * win[2 * n], x[2 * n + 1] * win[2 * n + 1]);
    }
  }
  dft16(v);
#pragma unroll
  for (int q = 0; q < 16; ++q)
    buf[fft_pad(16 * h + q)] = v[4 * (q & 3) + (q >> 2)];
  __syncwarp();
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    v[r] = buf[fft_pad(h + 16 * r)];
    if (r) v[r] = cmul(v[r], tw16[16 * r + h]);
  }
  dft16(v);
#pragma unroll
  for (int q = 0; q < 16; ++q)   // the elements this lane read
    buf[fft_pad(h + 16 * q)] = v[4 * (q & 3) + (q >> 2)];
  __syncwarp();
}

// The power of bins 0 .. N of one frame from its complex FFT Z (the real
// split: E = (Z[k] + conj Z[N-k]) / 2, O = (Z[k] - conj Z[N-k]) / 2i;
// X[k] = E + W^k O and X[N - k] = conj(E - W^k O)), raised to
// mag_power / 2, then the mel bands and the log into dst; the whole warp.
template <int N>
__device__ __forceinline__ void frame_out(
    const float2* buf, float* pw, const float2* tw,
    const int4* __restrict__ band, const float* __restrict__ wts,
    float* dst, int n_mels, float log_guard, float mag_power, int take_log,
    int lane) {
  for (int k = lane; k <= N / 2; k += 32) {
    const float2 zk = buf[fft_pad(k)], zn = buf[fft_pad((N - k) & (N - 1))];
    const float2 e = make_float2(0.5f * (zk.x + zn.x), 0.5f * (zk.y - zn.y));
    const float2 o = make_float2(0.5f * (zk.y + zn.y), 0.5f * (zn.x - zk.x));
    const float2 wo = cmul(tw[k], o);
    const float pr = e.x + wo.x, pi = e.y + wo.y;
    const float qr = e.x - wo.x, qi = e.y - wo.y;
    pw[k] = mag(pr * pr + pi * pi, mag_power);
    pw[N - k] = mag(qr * qr + qi * qi, mag_power);
  }
  __syncwarp();
  for (int q = lane; q < n_mels; q += 32) {
    const int4 bd = __ldg(band + q);
    float acc = 0.f;
    for (int i = 0; i < bd.y; ++i)
      acc = fmaf(pw[bd.x + i], __ldg(wts + bd.z + i), acc);
    dst[bd.w] = take_log ? logf(acc + log_guard) : acc;
  }
  __syncwarp();  // the buffers are free for the next frame
}

template <int N>
__global__ void __launch_bounds__(32 * kFW) logmel_fft_kernel(
    const float* __restrict__ audio,    // (B, lp)
    const float* __restrict__ window,   // (2N)
    const float* __restrict__ twiddle,  // (2N, 2): exp(-2 pi i m / 2N)
    const float* __restrict__ tw16g,    // N = 256: (16 r + j, 2) W_256^(rj)
    const int4* __restrict__ band,      // (n_mels): first bin, count,
                                        // offset, mel, in lane order
    const float* __restrict__ wts,      // packed band weights
    float* __restrict__ out,            // (B, n_frames, n_mels)
    int lp, int n_frames, int hop, int n_mels, float log_guard,
    float mag_power, int take_log) {
  constexpr int n_fft = 2 * N;
  extern __shared__ __align__(16) float smem[];
  const int spanp = ((kFT - 1) * hop + n_fft + 3) / 4 * 4;
  float* wav = smem;
  float* win = wav + spanp;
  float2* tw = reinterpret_cast<float2*>(win + n_fft);
  float2* tw16 = tw + n_fft;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float2* buf = reinterpret_cast<float2*>(
      win + 3 * n_fft + fft_tw16_floats(N) + warp * fft_warp_floats(N));
  float* pw = reinterpret_cast<float*>(buf) + fft_warp_floats(N) - N - 4;

  const int b = blockIdx.y, t0 = blockIdx.x * kFT;
  const float* src = audio + (size_t)b * lp + (size_t)t0 * hop;
  const int avail = lp - t0 * hop;
  const bool aligned = (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  for (int c = threadIdx.x; c < spanp / 4; c += blockDim.x) {
    const int i = 4 * c;
    if (aligned && i + 4 <= avail) {
      cp_async16(wav + i, src + i, true);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool v = i + e < avail;
        cp_async4(wav + i + e, v ? src + i + e : audio, v);
      }
    }
  }
  for (int c = threadIdx.x; c < n_fft / 4; c += blockDim.x)
    cp_async16(win + 4 * c, window + 4 * c, true);
  for (int c = threadIdx.x; c < n_fft / 2; c += blockDim.x)
    cp_async16(reinterpret_cast<float*>(tw) + 4 * c, twiddle + 4 * c, true);
  for (int c = threadIdx.x; c < fft_tw16_floats(N) / 4; c += blockDim.x)
    cp_async16(reinterpret_cast<float*>(tw16) + 4 * c, tw16g + 4 * c, true);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  if constexpr (N == 256) {
    // two frames per warp, one per half-warp, then each frame's output
    // with the whole warp
    for (int f0 = 2 * warp; f0 < kFT; f0 += 2 * kFW) {
      if (t0 + f0 >= n_frames) break;
      const int half = lane / 16, f = f0 + half;
      fft256_half(buf + half * fft_pad(N), wav + f * hop, win, tw16, lane % 16,
                  (f * hop) % 2 == 0);
      for (int e = 0; e < 2 && t0 + f0 + e < n_frames; ++e)
        frame_out<N>(buf + e * fft_pad(N), pw, tw, band, wts,
                     out + ((size_t)b * n_frames + t0 + f0 + e) * n_mels,
                     n_mels, log_guard, mag_power, take_log, lane);
    }
  } else {
    for (int f = warp; f < kFT; f += kFW) {
      const int t = t0 + f;
      if (t >= n_frames) break;
      const float* x = wav + f * hop;
      const bool pairs = (f * hop) % 2 == 0;
      int ns;
      if constexpr (log2i(N) % 2) {
        fft_stage<N, 2, true>(buf, x, win, tw, 1, lane, pairs);
        ns = 2;
      } else {
        fft_stage<N, 4, true>(buf, x, win, tw, 1, lane, pairs);
        ns = 4;
      }
      for (; ns < N; ns *= 4)
        fft_stage<N, 4, false>(buf, x, win, tw, ns, lane, pairs);
      frame_out<N>(buf, pw, tw, band, wts,
                   out + ((size_t)b * n_frames + t) * n_mels, n_mels,
                   log_guard, mag_power, take_log, lane);
    }
  }
}

size_t fft_smem(int n_fft, int hop) {
  const int spanp = ((kFT - 1) * hop + n_fft + 3) / 4 * 4;
  return sizeof(float) *
         ((size_t)spanp + 3 * n_fft + fft_tw16_floats(n_fft / 2) +
          kFW * fft_warp_floats(n_fft / 2));
}

template <int N>
int launch_fft(const void* audio, const void* window, const void* twiddle,
               const void* tw16, const void* band, const void* wts,
               void* out, int batch,
               int lp, int n_frames, int hop, int n_mels, float log_guard,
               float mag_power, int take_log, cudaStream_t stream) {
  const size_t smem = fft_smem(2 * N, hop);
  cudaError_t err = cudaFuncSetAttribute(
      logmel_fft_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_frames + kFT - 1) / kFT, batch);
  logmel_fft_kernel<N><<<grid, 32 * kFW, smem, stream>>>(
      (const float*)audio, (const float*)window, (const float*)twiddle,
      (const float*)tw16, (const int4*)band, (const float*)wts, (float*)out,
      lp, n_frames, hop, n_mels, log_guard, mag_power, take_log);
  return (int)cudaGetLastError();
}

}  // namespace

// The wrapper guarantees: fp32 contiguous tensors on one device,
// n_fft % 4 == 0, hop % 4 == 0, n_freq <= 288.
extern "C" int tat_logmel(const void* audio, const void* basis, const void* fb,
                          void* out, int batch, int lp, int n_frames,
                          int n_fft, int hop, int n_freq, int n_mels,
                          float log_guard, float mag_power, int take_log,
                          void* stream) {
  const int span = (kTile - 1) * hop + n_fft;
  const size_t smem = sizeof(float) * (size_t)(span + kTile * n_freq);
  cudaError_t err = cudaFuncSetAttribute(
      logmel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_frames + kTile - 1) / kTile, batch);
  logmel_kernel<<<grid, 288, smem, (cudaStream_t)stream>>>(
      (const float*)audio, (const float*)basis, (const float*)fb, (float*)out,
      lp, n_frames, n_fft, hop, n_freq, n_mels, log_guard, mag_power,
      take_log);
  return (int)cudaGetLastError();
}

// The wrapper guarantees: fp32 contiguous audio (B, lp), window (n_fft),
// twiddle (n_fft, 2) = exp(-2 pi i m / n_fft), tw16 (256, 2) =
// exp(-2 pi i r j / 256) at 16 r + j (read at n_fft = 512), wts and out on
// one device; band (n_mels, 4) int32 = (first bin, count, offset into wts,
// mel index), row q taken by lane q % 32, with first + count <=
// n_fft / 2 + 1; n_fft a power of two in [64, 2048];
// lp >= (n_frames - 1) hop + n_fft; fft_smem(n_fft, hop) within the
// block's shared memory.
extern "C" int tat_logmel_fft(const void* audio, const void* window,
                              const void* twiddle, const void* tw16,
                              const void* band, const void* wts, void* out,
                              int batch, int lp,
                              int n_frames, int n_fft, int hop, int n_mels,
                              float log_guard, float mag_power, int take_log,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define TAT_FFT(N)                                                          \
  case 2 * N:                                                               \
    return launch_fft<N>(audio, window, twiddle, tw16, band, wts, out,     \
                         batch, lp, n_frames, hop, n_mels, log_guard,       \
                         mag_power, take_log, s)
  switch (n_fft) {
    TAT_FFT(32);
    TAT_FFT(64);
    TAT_FFT(128);
    TAT_FFT(256);
    TAT_FFT(512);
    TAT_FFT(1024);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef TAT_FFT
}

extern "C" const char* tat_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
