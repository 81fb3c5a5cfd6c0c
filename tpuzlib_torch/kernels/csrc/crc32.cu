// CRC-32 linear forms of 1 KiB blocks (tile 1) or 256 KiB spans (tile 256).
//
// Replaces tpuzlib/kernels/crc32_pallas.py:_kernel_fn (per-block forms) and
// :_fused_kernel_fn (the same plus an in-kernel combine of 256 blocks to one
// form per span).  The form of a run of bytes is the raw CRC register after
// folding them from register 0, no pre- or post-XOR:
// r = T[(r ^ b) & 0xFF] ^ (r >> 8).  The TPU computes it as a bit-plane GF(2)
// matrix product on its matrix unit because it has no fast byte gather; the
// card has fast shared-memory lookups, so each thread folds its own 1 KiB
// block through the 256-entry table, one 32-bit word (4 bytes) at a time.
//
// Bound: the input is read once, one byte per byte (256 MiB is a floor of
// about 80 us at 3.35 TB/s), but this simple design is bound by each
// thread's chain of 1024 dependent shared-memory lookups and their bank
// conflicts.  What the design does about the memory side: a CUDA block of
// 256 threads owns 256 consecutive 1 KiB blocks (256 KiB) and stages them
// 64 bytes a row at a time into shared memory with coalesced byte loads, so
// the input may start at any byte and the (virtual) front padding costs no
// copy; each thread then reads its own row as words, conflict-free (row
// stride 68 bytes).  Span mode combines the 256 forms in shared memory over
// 8 levels, form(a|b) = A^len(b) form(a) ^ form(b), with A^(1024 * 2^l) given
// as 32 packed columns per level.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 1024;       // bytes per form
constexpr int kThreads = 256;      // 1 KiB blocks per CUDA block (one span)
constexpr int kLevels = 8;         // log2(kThreads)
constexpr int kRow = 64;           // bytes of each block staged per step
constexpr int kStride = kRow + 4;  // padded row: word reads hit 32 banks

__global__ void __launch_bounds__(kThreads)
crc32_forms_kernel(const uint8_t* __restrict__ data, long long n, long long pad,
                   const uint32_t* __restrict__ table, const uint32_t* __restrict__ cols,
                   uint32_t* __restrict__ out, long long nb, int tile) {
  __shared__ uint32_t t8[256];
  __shared__ uint32_t cm[kLevels * 32];
  __shared__ uint32_t forms[kThreads];
  __shared__ __align__(16) uint8_t rows[kThreads * kStride];
  const int tid = threadIdx.x;
  t8[tid] = table[tid];
  if (tile > 1) {
    for (int i = tid; i < kLevels * 32; i += kThreads) cm[i] = cols[i];
  }
  // data index of this CUDA block's first (virtual, padded) byte
  const long long base = static_cast<long long>(blockIdx.x) * kThreads * kBlock - pad;
  uint32_t crc = 0;
  for (int step = 0; step < kBlock / kRow; ++step) {
    __syncthreads();  // the rows of the last step are consumed
    for (int q = tid; q < kThreads * kRow; q += kThreads) {
      const int r = q / kRow, c = q % kRow;
      const long long i = base + static_cast<long long>(r) * kBlock + step * kRow + c;
      rows[r * kStride + c] = (i >= 0 && i < n) ? data[i] : 0;
    }
    __syncthreads();
    const uint32_t* w = reinterpret_cast<const uint32_t*>(rows + tid * kStride);
#pragma unroll
    for (int k = 0; k < kRow / 4; ++k) {
      crc ^= w[k];  // little-endian: the word's low byte is folded first
      crc = t8[crc & 0xFF] ^ (crc >> 8);
      crc = t8[crc & 0xFF] ^ (crc >> 8);
      crc = t8[crc & 0xFF] ^ (crc >> 8);
      crc = t8[crc & 0xFF] ^ (crc >> 8);
    }
  }
  if (tile == 1) {
    const long long blk = static_cast<long long>(blockIdx.x) * kThreads + tid;
    if (blk < nb) out[blk] = crc;
    return;
  }
  // after level l, forms[i] for i = 0 mod 2^(l+1) is the form of blocks
  // [i, i + 2^(l+1)); the partner forms[i + 2^l] is not written at level l
  forms[tid] = crc;
  for (int l = 0; l < kLevels; ++l) {
    __syncthreads();
    const int half = 1 << l;
    if ((tid & (2 * half - 1)) == 0) {
      const uint32_t v = forms[tid];
      uint32_t r = 0;
#pragma unroll
      for (int b = 0; b < 32; ++b) r ^= cm[l * 32 + b] & (0u - ((v >> b) & 1u));
      forms[tid] = r ^ forms[tid + half];
    }
  }
  if (tid == 0) out[blockIdx.x] = forms[0];
}

}  // namespace

extern "C" int tz_crc32_forms(const void* data, long long n, long long pad, const void* table,
                              const void* cols, void* out, long long nb, int tile,
                              void* stream) {
  if (tile != 1 && tile != kThreads) return static_cast<int>(cudaErrorInvalidValue);
  const long long grid = (nb + kThreads - 1) / kThreads;
  crc32_forms_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), n, pad, static_cast<const uint32_t*>(table),
      static_cast<const uint32_t*>(cols), static_cast<uint32_t*>(out), nb, tile);
  return static_cast<int>(cudaGetLastError());
}
