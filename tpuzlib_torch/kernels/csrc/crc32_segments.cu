// CRC-32 of every segment of one buffer in one launch: the check of all
// the gzip members a call decodes (a BGZF slice's hundreds of members).
//
// A CUDA block a segment.  The segment is cut at absolute 128-byte
// boundaries of memory: the whole pieces between its first boundary at or
// before its start and its last boundary at or before its end, then a tail
// of under 128 bytes.  The bytes of the first piece before the segment's
// start read as zeros, which is free for the raw form (L(zeros | x) =
// L(x); crc32.cu's notation: the form L of a run of bytes is the raw CRC
// register after folding them from register 0; A the register's
// propagation through one zero byte).
//
// Bound: each byte read once (32 MiB of output is about 10 us at
// 3.35 TB/s) and 4 bytes a segment written.  What the design does about it:
//  - loads: a round of the CUDA block is 256 pieces, 32 a warp; each warp
//    stages its 4 KiB with 16-byte loads, 512 contiguous bytes an
//    instruction, into its own shared buffer (the word places XOR-swizzled
//    as crc32.cu's, so the lanes' reads of their pieces' k-th words fall in
//    different banks), then each lane folds its own piece.  Every piece
//    starts on a 16-byte boundary, so no word is shifted; only the two
//    words at the segment's start may be loaded byte by byte.
//  - lookups: slice-by-4, crc32.cu's tables (4 KiB).
//  - joins: a lane keeps the forms of its pieces of every round in one
//    register (Horner: acc = A^(32 KiB) acc ^ L(piece)); after the last
//    round crc32.cu's tree joins the 256 lanes (A^(128 * 2^l) at level l),
//    with the rounds' empty pieces in front, where zeros are free.
//  - finish: thread 0 folds the tail's words and bytes, joins it
//    (L(seg) = A^len(tail) L(pieces) ^ L(tail)) and finishes the CRC
//    (crc = L ^ A^n ~0 ^ ~0), A^k by the bits of k from A^(2^k).
// Segments are independent, so the grid needs no ticket; a segment far
// larger than the rest keeps one SM busy alone.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLevels = 8;               // log2(kThreads)
constexpr int kPiece = 128;              // bytes a lane folds as one chain
constexpr int kLogPiece = 7;
constexpr int kWords = kPiece / 16;      // 16-byte words a piece
constexpr int kChunk = 32 * kPiece;      // bytes a warp stages a round
constexpr int kLogRound = 15;            // log2(bytes a CUDA block folds a round)
constexpr int kPowers = 64;              // A^(2^k) for k < kPowers
constexpr int kSmemWords = 4 * 256 + kPowers * 32 + kWarps;
constexpr int kSmemBytes = kSmemWords * 4 + kWarps * kChunk;
static_assert(kThreads * kPiece == 1 << kLogRound, "a round is 32 KiB");
static_assert((kSmemWords * 4) % 16 == 0, "the staging buffers are 16-byte aligned");

struct Args {
  const uint8_t* data;
  long long n;                // bytes of data
  const long long* offsets;   // segment s is data[offsets[s], offsets[s + 1])
  const uint32_t* table;      // the CRC table (256)
  const uint32_t* powers;     // A^(2^k), k < kPowers, 32 packed columns each
  uint32_t* out;              // a CRC-32 a segment
};

// mat (32 packed columns) applied to v, in four independent sums
__device__ __forceinline__ uint32_t apply(const uint32_t* cols, uint32_t v) {
  uint32_t r[4] = {0, 0, 0, 0};
#pragma unroll
  for (int b = 0; b < 32; ++b) r[b & 3] ^= cols[b] & (0u - ((v >> b) & 1u));
  return (r[0] ^ r[1]) ^ (r[2] ^ r[3]);
}

// A^k v, by the bits of k
__device__ __forceinline__ uint32_t shift_by(const uint32_t* pw, long long k, uint32_t v) {
  for (int b = 0; b < kPowers && (k >> b) != 0; ++b)
    if ((k >> b) & 1) v = apply(pw + b * 32, v);
  return v;
}

// crc32.cu's slice-by-4 step: the register after the four bytes of x
__device__ __forceinline__ uint32_t fold_word(const uint32_t* t, uint32_t x) {
  return t[768 + (x & 0xFFu)] ^ t[512 + ((x >> 8) & 0xFFu)] ^ t[256 + ((x >> 16) & 0xFFu)] ^
         t[x >> 24];
}

// crc32.cu's swizzle of a staged chunk's 16-byte words
__device__ __forceinline__ int slot(int u) { return u ^ ((u >> 3) & 7); }

// the 16 bytes at data[i, i + 16), bytes outside [lo, hi) read as 0 and
// not loaded
__device__ __forceinline__ uint4 load_masked(const uint8_t* data, long long lo, long long hi,
                                             long long i) {
  if (i >= lo && i + 16 <= hi) return __ldg(reinterpret_cast<const uint4*>(data + i));
  uint32_t w[4] = {0, 0, 0, 0};
  if (i + 16 > lo && i < hi) {
#pragma unroll
    for (int b = 0; b < 16; ++b)
      if (i + b >= lo && i + b < hi)
        w[b >> 2] |= static_cast<uint32_t>(data[i + b]) << (8 * (b & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// crc32.cu's tree: the form of kThreads consecutive pieces of 2^lg bytes,
// thread t's form v being piece t's; thread 0 returns it
__device__ uint32_t block_tree(uint32_t v, const uint32_t* pw, int lg, uint32_t* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int l = 0; l < 5; ++l) {
    const uint32_t right = __shfl_down_sync(0xFFFFFFFFu, v, 1 << l);
    v = apply(pw + (lg + l) * 32, v) ^ right;
  }
  __syncthreads();
  if (lane == 0) part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? part[lane] : 0;
#pragma unroll
    for (int l = 5; l < kLevels; ++l) {
      const uint32_t right = __shfl_down_sync(0xFFFFFFFFu, v, 1 << (l - 5));
      v = apply(pw + (lg + l) * 32, v) ^ right;
    }
  }
  return v;
}

// four CUDA blocks an SM (64 registers a thread): a block's chains wait on
// shared-memory lookups, so the SM needs other blocks' warps in flight
__global__ void __launch_bounds__(kThreads, 4) crc32_segments_kernel(Args a) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* t = smem;                  // the slice-by-4 tables
  uint32_t* pw = t + 4 * 256;          // A^(2^k)
  uint32_t* part = pw + kPowers * 32;  // the tree's warp forms
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  uint4* buf = reinterpret_cast<uint4*>(smem + kSmemWords) + warp * (kChunk / 16);
  for (int i = tid; i < 256; i += kThreads) t[i] = a.table[i];
  for (int i = tid; i < kPowers * 32; i += kThreads) pw[i] = a.powers[i];
  __syncthreads();
  for (int i = tid; i < 256; i += kThreads) {
    for (int k = 1; k < 4; ++k) {
      const uint32_t v = t[(k - 1) * 256 + i];
      t[k * 256 + i] = t[v & 0xFFu] ^ (v >> 8);
    }
  }
  __syncthreads();

  const long long lo = a.offsets[blockIdx.x], hi = a.offsets[blockIdx.x + 1];
  const uintptr_t base = reinterpret_cast<uintptr_t>(a.data);
  // data indices of the first piece's start and of the whole pieces' end
  const long long g0 = lo - static_cast<long long>((base + lo) & (kPiece - 1));
  const long long g1 = hi - static_cast<long long>((base + hi) & (kPiece - 1));
  const long long pieces = (g1 - g0) >> kLogPiece;
  const long long rounds = (pieces + kThreads - 1) / kThreads;
  const long long front = rounds * kThreads - pieces;  // empty pieces in front

  uint32_t acc = 0;
#pragma unroll 1
  for (long long r = 0; r < rounds; ++r) {
    // the warp's 32 pieces of this round, from data index c0
    const long long c0 = g0 + (r * kThreads + warp * 32 - front) * kPiece;
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      const int u = lane + 32 * i;
      buf[slot(u)] = load_masked(a.data, lo, g1, c0 + 16ll * u);
    }
    __syncwarp();
    uint32_t crc = 0;
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      const uint4 w = buf[slot(lane * kWords + k)];
      crc = fold_word(t, crc ^ w.x);
      crc = fold_word(t, crc ^ w.y);
      crc = fold_word(t, crc ^ w.z);
      crc = fold_word(t, crc ^ w.w);
    }
    __syncwarp();  // the buffer is read before it is refilled
    acc = apply(pw + kLogRound * 32, acc) ^ crc;
  }
  const uint32_t v = block_tree(acc, pw, kLogPiece, part);
  if (tid != 0) return;
  // the tail [g1, hi), bytes before lo read as 0 (a segment inside one piece)
  uint32_t tail = 0;
  for (long long i = g1; i < hi;) {
    if (i >= lo && i + 4 <= hi && ((i - g1) & 3) == 0) {  // an aligned word
      tail = fold_word(t, tail ^ __ldg(reinterpret_cast<const uint32_t*>(a.data + i)));
      i += 4;
    } else {
      const uint32_t b = i >= lo ? a.data[i] : 0u;
      tail = t[(tail ^ b) & 0xFFu] ^ (tail >> 8);
      ++i;
    }
  }
  const uint32_t form = shift_by(pw, hi - g1, v) ^ tail;
  a.out[blockIdx.x] = form ^ shift_by(pw, hi - lo, 0xFFFFFFFFu) ^ 0xFFFFFFFFu;
}

}  // namespace

// out[s] = CRC-32 of data[offsets[s], offsets[s + 1]) for s < segments;
// offsets (segments + 1 int64 on the card) non-decreasing within [0, n)
extern "C" int tz_crc32_segments(const void* data, long long n, const void* offsets,
                                 int segments, const void* table, const void* powers, void* out,
                                 void* stream) {
  if (segments <= 0) return static_cast<int>(cudaSuccess);
  Args a{};
  a.data = static_cast<const uint8_t*>(data);
  a.n = n;
  a.offsets = static_cast<const long long*>(offsets);
  a.table = static_cast<const uint32_t*>(table);
  a.powers = static_cast<const uint32_t*>(powers);
  a.out = static_cast<uint32_t*>(out);
  crc32_segments_kernel<<<segments, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
