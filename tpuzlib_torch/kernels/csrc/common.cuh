// Helpers shared by the kernels: the match screens' device helpers, and
// the card's SM count.
#pragma once

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace tz {

// The current device's streaming multiprocessors, read once a device (a
// race only reads the same value twice).
inline cudaError_t sm_count(int* sms) {
  constexpr int kDevices = 64;
  static std::atomic<int> cached[kDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kDevices) return cudaErrorInvalidDevice;
  int n = cached[dev].load(std::memory_order_relaxed);
  if (n == 0) {
    if ((err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return err;
    cached[dev].store(n, std::memory_order_relaxed);
  }
  *sms = n;
  return cudaSuccess;
}

constexpr int kMinMatch = 3;

// Common prefix length in bytes (0..16) of two little-endian 16-byte
// windows, without a branch: the first word that differs, and its
// trailing zero bits.
__device__ __forceinline__ int prefix16(uint4 a, uint4 b) {
  const uint32_t x0 = a.x ^ b.x, x1 = a.y ^ b.y, x2 = a.z ^ b.z, x3 = a.w ^ b.w;
  const uint32_t x = x0 ? x0 : x1 ? x1 : x2 ? x2 : x3;
  const int at = x0 ? 0 : x1 ? 32 : x2 ? 64 : 96;
  return (at + __clz(__brev(x))) >> 3;  // 16 when all four words are equal
}

// Best-match key: a longer screen wins, then a closer distance.
__device__ __forceinline__ int pack_key(int screen, int dist) {
  return (screen << 16) | (0xFFFF - dist);
}

}  // namespace tz
