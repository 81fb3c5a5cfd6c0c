// Adler-32 partial sums of 2 KiB blocks.
//
// Replaces tpuzlib/kernels/adler32_pallas.py:_kernel_fn.  For block b of
// the (virtually front-padded) input, S_b = sum x_i and
// W_b = sum (2048 - i) x_i, exact in 32 bits (W_b <= 255 * 2048 * 2049 / 2
// < 2^31), so no modulo is taken here; the mod-65521 combine across blocks
// runs after the kernel.  The TPU splits bytes into nibbles and multiplies
// by a weight matrix on its matrix unit; on the card the sums are plain
// integer multiply-adds.
//
// Bound: device-memory bandwidth, one byte read per input byte (256 MiB is a
// floor of about 80 us at 3.35 TB/s) against two multiply-adds per byte.
// One warp owns one block: lane l reads bytes l, l + 32, ... so each load of
// the warp is 32 consecutive bytes (coalesced at any starting byte, which a
// sliced tensor or the front padding gives), then a shuffle reduction sums
// the lanes.  Indices i - pad < 0 read as 0 and nothing past n is read.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 2048;  // bytes per block
constexpr int kWarps = 8;     // blocks per CUDA block

__global__ void __launch_bounds__(kWarps * 32)
adler32_blocks_kernel(const uint8_t* __restrict__ data, long long n, long long pad,
                      int32_t* __restrict__ out, long long nb) {
  const int lane = threadIdx.x & 31;
  const long long blk = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (blk >= nb) return;  // whole warps leave together
  const long long base = blk * kBlock - pad;
  uint32_t s = 0, w = 0;
#pragma unroll 8
  for (int i = lane; i < kBlock; i += 32) {
    const long long d = base + i;
    const uint32_t x = (d >= 0 && d < n) ? data[d] : 0u;
    s += x;
    w += static_cast<uint32_t>(kBlock - i) * x;
  }
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    s += __shfl_down_sync(0xffffffffu, s, off);
    w += __shfl_down_sync(0xffffffffu, w, off);
  }
  if (lane == 0) {
    out[2 * blk] = static_cast<int32_t>(s);
    out[2 * blk + 1] = static_cast<int32_t>(w);
  }
}

}  // namespace

extern "C" int tz_adler32_blocks(const void* data, long long n, long long pad, void* out,
                                 long long nb, void* stream) {
  const long long grid = (nb + kWarps - 1) / kWarps;
  adler32_blocks_kernel<<<static_cast<unsigned>(grid), kWarps * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), n, pad, static_cast<int32_t*>(out), nb);
  return static_cast<int>(cudaGetLastError());
}
