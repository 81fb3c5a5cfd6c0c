// Adler-32 partial sums of 2 KiB blocks, and the whole Adler-32 in one
// launch.
//
// tz_adler32_blocks replaces tpuzlib/kernels/adler32_pallas.py:_kernel_fn.
// For block b of the (virtually front-padded) input, S_b = sum x_i and
// W_b = sum (2048 - i) x_i, exact in 32 bits (W_b <= 255 * 2048 * 2049 / 2
// < 2^31), so no modulo is taken there; the mod-65521 combine across blocks
// runs after the kernel.  The TPU splits bytes into nibbles and multiplies
// by a weight matrix on its matrix unit; on the card the sums are integer
// dot products of 4 bytes (dp4a).
//
// tz_adler32_scalar replaces tpuzlib/kernels/adler32_pallas.py:119
// adler32_device_jit (row 7's kernel, the combine and the finish in one
// program).  Its warps take the same block sums, a block at a time over a
// grid-stride loop, and weight them as the combine does:
//   S += S_b,  W += W_b + 2048 (nb - 1 - b) S_b   (mod 65521)
// Each CUDA block adds its warps' sums and publishes them; the CUDA block
// that takes the last ticket adds every CUDA block's, applies the seed and
// writes the checksum, and resets the ticket to 0 for the next call on its
// stream.  The fence before the ticket makes every CUDA block's sums
// visible to the last one.
//
// Bound: device-memory bandwidth, one byte read per input byte (256 MiB is a
// floor of about 80 us at 3.35 TB/s) against two multiply-adds per byte.
// A warp owns a block and loads it as 16-byte words, every word of the
// block at once (4 or 5 a lane), so a warp waits for one round trip a
// block: a byte a lane a load (the first design) kept 8 bytes a lane in
// flight and left a warp waiting for 8 round trips a block.  The blocks
// start at any byte (a sliced tensor, the front padding), so a block spans
// 129 aligned words, its first and last cut by a byte mask; a word that
// reaches before data[0] or past data[n - 1] is loaded a byte at a time,
// with the front padding and nothing past n read as 0.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 2048;  // bytes per block
constexpr int kWords = kBlock / 16;
constexpr int kWarps = 8;     // warps per CUDA block
constexpr unsigned kMod = 65521;

// the bytes j in [lo, hi) of a 16-byte word, the others 0
__device__ __forceinline__ uint4 keep_bytes(uint4 v, int lo, int hi) {
  uint32_t* c = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int t = 0; t < 4; ++t)
      if (4 * q + t < lo || 4 * q + t >= hi) c[q] &= ~(0xFFu << (8 * t));
  return v;
}

// word d of the input (16 bytes from data index d); bytes outside [0, n) as 0
__device__ __forceinline__ uint4 load_word(const uint8_t* __restrict__ data, long long n,
                                           long long d) {
  if (d >= 0 && d + 16 <= n) return __ldg(reinterpret_cast<const uint4*>(data + d));
  uint4 v;
  uint32_t* c = reinterpret_cast<uint32_t*>(&v);
  for (int q = 0; q < 4; ++q) {
    c[q] = 0;
    for (int t = 0; t < 4; ++t) {
      const long long i = d + 4 * q + t;
      if (i >= 0 && i < n) c[q] |= static_cast<uint32_t>(data[i]) << (8 * t);
    }
  }
  return v;
}

// (S_b, W_b) of block `blk`, in every lane of the warp; o: the blocks'
// start modulo 16, (data - pad) mod 16
__device__ __forceinline__ void block_sums(const uint8_t* __restrict__ data, long long n,
                                           long long pad, int o, long long blk, int lane,
                                           uint32_t& s, uint32_t& w) {
  constexpr int kPerLane = (kWords + 32) / 32;  // 5: words 0..128 over 32 lanes
  const long long first = blk * kBlock - pad - o;  // data index of the block's first word
  const int words = kWords + (o != 0);
  uint4 v[kPerLane];
#pragma unroll
  for (int t = 0; t < kPerLane; ++t) {  // every load first, then the sums
    const int k = lane + 32 * t;
    v[t] = k < words ? load_word(data, n, first + 16 * k) : make_uint4(0, 0, 0, 0);
  }
  s = 0;
  w = 0;
#pragma unroll
  for (int t = 0; t < kPerLane; ++t) {
    const int k = lane + 32 * t;
    if (k == 0) v[t] = keep_bytes(v[t], o, 16);
    if (k == kWords) v[t] = keep_bytes(v[t], 0, o);
    // byte j of word k is at i = 16 k - o + j in the block: weight 2048 - i
    const uint32_t ones = 0x01010101u, ramp = 0x03020100u;
    const uint32_t s0 = __dp4a(v[t].x, ones, 0u), s1 = __dp4a(v[t].y, ones, 0u);
    const uint32_t s2 = __dp4a(v[t].z, ones, 0u), s3 = __dp4a(v[t].w, ones, 0u);
    const uint32_t sum = s0 + s1 + s2 + s3;
    const uint32_t ramped = __dp4a(v[t].x, ramp, 0u) + __dp4a(v[t].y, ramp, 0u) +
                            __dp4a(v[t].z, ramp, 0u) + __dp4a(v[t].w, ramp, 0u) + 4u * s1 +
                            8u * s2 + 12u * s3;
    s += sum;
    w += static_cast<uint32_t>(kBlock - 16 * k + o) * sum - ramped;
  }
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
    w += __shfl_xor_sync(0xffffffffu, w, off);
  }
}

__device__ __forceinline__ int start_mod16(const uint8_t* data, long long pad) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(data) - static_cast<uintptr_t>(pad)) & 15);
}

__global__ void __launch_bounds__(kWarps * 32)
adler32_blocks_kernel(const uint8_t* __restrict__ data, long long n, long long pad,
                      int32_t* __restrict__ out, long long nb) {
  const int lane = threadIdx.x & 31;
  const long long blk = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (blk >= nb) return;  // whole warps leave together
  uint32_t s, w;
  block_sums(data, n, pad, start_mod16(data, pad), blk, lane, s, w);
  if (lane == 0) {
    out[2 * blk] = static_cast<int32_t>(s);
    out[2 * blk + 1] = static_cast<int32_t>(w);
  }
}

// partials: 2 words a CUDA block; ticket: one word, 0 before and after
__global__ void __launch_bounds__(kWarps * 32)
adler32_scalar_kernel(const uint8_t* __restrict__ data, long long n, long long pad, long long nb,
                      unsigned long long* __restrict__ partials, unsigned* ticket,
                      unsigned seed, long long* __restrict__ adler) {
  __shared__ unsigned long long warp_s[kWarps], warp_w[kWarps];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int o = start_mod16(data, pad);
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  const long long blk0 = static_cast<long long>(blockIdx.x) * kWarps + warp;
  // r = (nb - 1 - blk) mod 65521, stepped down by the stride each turn, so
  // that a turn takes no 64-bit division; a warp's sums stay far below
  // 2^64 (each turn adds below 2^19 to ws and below 2^36 to ww)
  const uint32_t dr = static_cast<uint32_t>(stride % kMod);
  uint32_t r = blk0 < nb ? static_cast<uint32_t>((nb - 1 - blk0) % kMod) : 0;
  unsigned long long ws = 0, ww = 0;
  for (long long blk = blk0; blk < nb; blk += stride) {
    uint32_t s, w;
    block_sums(data, n, pad, o, blk, lane, s, w);
    ws += s;
    ww += w + static_cast<unsigned long long>(r * kBlock % kMod) * s;
    r = r >= dr ? r - dr : r + kMod - dr;
  }
  if (lane == 0) {
    warp_s[warp] = ws % kMod;
    warp_w[warp] = ww % kMod;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long cs = 0, cw = 0;
    for (int i = 0; i < kWarps; ++i) {
      cs += warp_s[i];
      cw += warp_w[i];
    }
    partials[2 * blockIdx.x] = cs % kMod;
    partials[2 * blockIdx.x + 1] = cw % kMod;
    __threadfence();  // the sums before the ticket
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  unsigned long long ts = 0, tw = 0;
  for (unsigned i = threadIdx.x; i < gridDim.x; i += blockDim.x) {
    ts += __ldcg(partials + 2 * i);
    tw += __ldcg(partials + 2 * i + 1);
  }
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    ts += __shfl_xor_sync(0xffffffffu, ts, off);
    tw += __shfl_xor_sync(0xffffffffu, tw, off);
  }
  __syncthreads();  // warp_s / warp_w are free again
  if (lane == 0) {
    warp_s[warp] = ts % kMod;
    warp_w[warp] = tw % kMod;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long s_total = 0, w_total = 0;
    for (int i = 0; i < kWarps; ++i) {
      s_total += warp_s[i];
      w_total += warp_w[i];
    }
    const unsigned long long s1_0 = seed & 0xFFFFu, s2_0 = seed >> 16;
    const unsigned long long s1 = (s1_0 + s_total) % kMod;
    const unsigned long long s2 =
        (s2_0 + static_cast<unsigned long long>(n % kMod) * s1_0 + w_total) % kMod;
    *adler = static_cast<long long>((s2 << 16) | s1);
    *ticket = 0;  // ready for the next call on this stream
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

// grid: any count of CUDA blocks (the wrapper takes one for each 8 blocks,
// at most 4 an SM); partials: 2 words a CUDA block
extern "C" int tz_adler32_scalar(const void* data, long long n, long long pad, long long nb,
                                 long long grid, void* partials, void* ticket, unsigned seed,
                                 void* adler, void* stream) {
  adler32_scalar_kernel<<<static_cast<unsigned>(grid), kWarps * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), n, pad, nb,
      static_cast<unsigned long long*>(partials), static_cast<unsigned*>(ticket), seed,
      static_cast<long long*>(adler));
  return static_cast<int>(cudaGetLastError());
}
