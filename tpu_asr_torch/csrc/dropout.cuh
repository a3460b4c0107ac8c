// Counter-based dropout bits, the device twin of ops/dropout.py::hash_bits
// and of the interpret-mode hash in tpu_asr/ops/pallas_attention.py::
// _dropout_keep: a murmur3 finalizer over idx * 2654435761 +
// stream * 0x9E3779B9 in uint32 arithmetic. An element is kept when its
// bits are >= the threshold min(int(rate * 2^32), 2^32 - 1), which the
// wrapper computes on the host. Pure in (stream, idx): a backward kernel
// redraws the forward's mask without storing it.
#pragma once

#include <stdint.h>

__device__ __forceinline__ uint32_t dropout_bits(uint32_t stream,
                                                 uint32_t idx) {
  uint32_t x = idx * 2654435761u + stream * 0x9E3779B9u;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  return x ^ (x >> 16);
}

__device__ __forceinline__ bool dropout_keep(uint32_t stream, uint32_t idx,
                                             uint32_t thresh) {
  return dropout_bits(stream, idx) >= thresh;
}
