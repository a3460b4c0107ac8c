// Log-mel spectrogram: windowed DFT -> |.|^2 -> mel -> log(x + guard), fp32.
//
// Replaces tpu_asr/ops/pallas_features.py::_logmel_kernel (fused_logmel).
// Input is the pre-emphasised, reflect-padded audio (B, Lp); output is the
// unnormalised log-mel (B, T, n_mels). Normalisation and masking stay in
// PyTorch, as they stay in XLA on the TPU.
//
// What bounds it on an H100: the DFT is 2 * n_fft * n_freq multiply-adds per
// frame (~0.26 MFMA at 512 / 257), about 97% of the work; audio in and
// log-mel out are only ~3 + 0.3 KB per frame. So it is bound by fp32
// arithmetic and by how often operands are fetched per multiply-add.
//
// Design: one block per (batch row, tile of kTile frames). The tile's
// overlapping audio span, (kTile - 1) * hop + n_fft samples, is staged once
// in shared memory, so no (B, T, n_fft) frame tensor ever exists. Thread f
// owns frequency f for every frame of the tile: per basis row it loads
// cos/sin[n, f] once (coalesced over f, L1/L2 resident) and reuses them for
// kTile frames, whose audio comes as float4 broadcasts from shared memory.
// The power tile stays in shared memory for the mel product and the log.
// Plain SIMT fp32; tensor cores (TF32 would cost the fp32 parity) are later
// work.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;  // frames per block

__global__ void __launch_bounds__(288) logmel_kernel(
    const float* __restrict__ audio,  // (B, lp)
    const float* __restrict__ basis,  // (n_fft, 2 * n_freq): [cos | sin]
    const float* __restrict__ fb,     // (n_freq, n_mels)
    float* __restrict__ out,          // (B, n_frames, n_mels)
    int lp, int n_frames, int n_fft, int hop, int n_freq, int n_mels,
    float log_guard) {
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
      power[t * n_freq + f] = re[t] * re[t] + im[t] * im[t];
  }
  __syncthreads();

  for (int i = threadIdx.x; i < kTile * n_mels; i += blockDim.x) {
    const int t = i / n_mels, m = i - (i / n_mels) * n_mels;
    if (t0 + t >= n_frames) continue;
    const float* p = power + t * n_freq;
    float acc = 0.f;
    for (int f = 0; f < n_freq; ++f)
      acc = fmaf(p[f], __ldg(fb + (size_t)f * n_mels + m), acc);
    out[((size_t)b * n_frames + t0 + t) * n_mels + m] = logf(acc + log_guard);
  }
}

}  // namespace

// The wrapper guarantees: fp32 contiguous tensors on one device,
// n_fft % 4 == 0, hop % 4 == 0, n_freq <= 288.
extern "C" int tat_logmel(const void* audio, const void* basis, const void* fb,
                          void* out, int batch, int lp, int n_frames,
                          int n_fft, int hop, int n_freq, int n_mels,
                          float log_guard, void* stream) {
  const int span = (kTile - 1) * hop + n_fft;
  const size_t smem = sizeof(float) * (size_t)(span + kTile * n_freq);
  cudaFuncSetAttribute(logmel_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const dim3 grid((n_frames + kTile - 1) / kTile, batch);
  logmel_kernel<<<grid, 288, smem, (cudaStream_t)stream>>>(
      (const float*)audio, (const float*)basis, (const float*)fb, (float*)out,
      lp, n_frames, n_fft, hop, n_freq, n_mels, log_guard);
  return (int)cudaGetLastError();
}

extern "C" const char* tat_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
