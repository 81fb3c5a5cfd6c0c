// The device inflate's full-stream dynamic-block header scan (the block
// planner's pass 1) on the card: every bit position of a raw DEFLATE
// stream tested as the start of a dynamic block's header.
//
// It replaces no TPU kernel: tpuzlib scans on the host
// (native/tpuzlib_native.cc: tz_find_headers), and so did the port, on at
// most four host threads while the card idled (~15 ms a MiB of output on
// the inflate cell's gzip level-9 text).  Its output is the host scan's
// candidates, not its answer: a position passes here when it passes
// tz_scan_headers_range's field checks and code-length-code Kraft test
// under the same limits (from_bit, allow_final, bit + 81 <= nbits) and its
// header then parses by read_dynamic_tables' rules.  The host confirms
// the survivors (tz_confirm_headers) with the bounded decode the host
// scan confirms with, and that decode parses the header first, so this
// scan never refuses a position the host scan would return.  On zlib's
// level-9 text ~0.09% of positions pass the filter and about one a block
// passes the parse.
//
// Two kernels, one launch of each:
//
//   - header_filter_kernel: a thread owns the 32 start bits of one stream
//     word.  Its block stages 256 words and a 4-word halo in shared memory
//     by 16-byte loads; the thread takes words j .. j + 3 as two 64-bit
//     halves.  The field checks of all 32 positions are bit-sliced over
//     the low half (BTYPE 10, BFINAL 0 unless allow_final, HLIT and HDIST
//     fields <= 29: a dozen shifts and ands for the 32), and only their
//     survivors (22% on the cell's text) take the 19-term Kraft sum, five
//     byte permutes and dp4a sums.  A warp appends its
//     survivors with one atomic: each lane's count, a shuffle scan, and
//     the lanes' stores at their offsets.
//   - header_parse_kernel: a thread a survivor (a grid-stride loop sized
//     from the SMs, since the count stays on the card): HLIT, HDIST,
//     HCLEN, the code-length code decoded canonically without a branch
//     (seven compares of the next 7 bits against the lengths' code
//     limits) from a bit buffer in registers (no table, no load a symbol
//     waits for), its
//     run-length coded lengths with the rules of codes 16, 17
//     and 18 and the bounds on their counts, each bit read checked against
//     nbits, lengths[256] != 0, and build_lut's Kraft rules for the
//     literal/length and distance codes: over-subscribed is refused,
//     incomplete is allowed for a single code (a distance code may have
//     none).  The sums only grow, so a parse stops as soon as one passes
//     2^15.  Passes are appended as the filter appends.
//
// Bound.  The filter reads the stream once: 12 MB for the cell's 12.05 MB
// stream, 0.004 ms at 3.35 TB/s; its ~1.45 G integer operations (32 a
// word, 64 a field-check survivor: 22% of the start bits there) at 67 T/s
// take 0.022 ms.  The parse is a serial chain a survivor (up to 316
// symbols), 85 k chains on that stream, all resident at once.
//
// Words: the stream as little-endian 32-bit words, zero after it, at least
// four words past its last byte (the decode's padded words, inflate_cuda.
// prepare, have more), 16-byte aligned.  res: res[0] the filter's
// survivors (may pass cap: the caller runs again with a larger cap),
// res[1] the parse's passes, res[2 ..] their positions, in no order.

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kFilterThreads = 256;  // stream words (of 32 start bits) a block
constexpr int kParseThreads = 128;
constexpr int kParseBlocksPerSm = 8;
constexpr int kKraftOne = 1 << 15;  // build_lut's complete sum (MAX_BITS 15)

// The code-length code (hclen lengths of 3 bits, k: the 57 bits from the
// header's bit 17) is complete, of two codes or more (clc_complete).  A
// length l adds 128 >> l (0 for l = 0): four lengths at a time pick their
// terms out of a byte table with one byte permute, and dp4a sums them.
// One code adds 64 at most, so a sum of 128 has two codes or more.
__device__ __forceinline__ bool clc_complete(int hclen, uint64_t k) {
  constexpr uint32_t kTermsLo = 0x10204000u;  // bytes 0, 64, 32, 16: l = 0 .. 3
  constexpr uint32_t kTermsHi = 0x01020408u;  // bytes 8, 4, 2, 1: l = 4 .. 7
  k &= (1ull << (3 * hclen)) - 1;  // lengths past hclen read as 0
  uint32_t kraft = 0;
#pragma unroll
  for (int g = 0; g < 5; g++) {
    const uint32_t x = static_cast<uint32_t>(k >> (12 * g)) & 0xfff;
    const uint32_t sel = (x & 7) | (x << 1 & 0x70) | (x << 2 & 0x700) | (x << 3 & 0x7000);
    kraft = __dp4a(__byte_perm(kTermsLo, kTermsHi, sel), 0x01010101u, kraft);
  }
  return kraft == 128;
}

// Appends each lane's set bits of `found` (positions pos0 + bit) to out
// through one atomic a warp on *count; stores only below cap.  Every lane
// of the warp calls it.
__device__ __forceinline__ void warp_append(uint32_t found, int64_t pos0, int32_t* count,
                                            int32_t* out, int cap) {
  const int lane = threadIdx.x & 31;
  const int n = __popc(found);
  int incl = n;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += up;
  }
  const int total = __shfl_sync(0xffffffffu, incl, 31);
  if (total == 0) return;
  int base = 0;
  if (lane == 31) base = atomicAdd(count, total);
  base = __shfl_sync(0xffffffffu, base, 31) + incl - n;
  while (found) {
    const int s = __ffs(found) - 1;
    found &= found - 1;
    if (base < cap) out[base] = static_cast<int32_t>(pos0 + s);
    base++;
  }
}

// Thread t of block b owns word base0 + 256 b + t: start bits 32 j .. 32 j + 31,
// of which it tests those in [from_bit, last_bit].
__global__ void __launch_bounds__(kFilterThreads)
    header_filter_kernel(const uint32_t* __restrict__ words, int64_t nwords, int64_t base0,
                         int64_t from_bit, int64_t last_bit, int allow_final,
                         int32_t* __restrict__ cand, int cap, int32_t* __restrict__ res) {
  __shared__ __align__(16) uint32_t tile[kFilterThreads + 4];
  const int t = threadIdx.x;
  const int64_t base = base0 + static_cast<int64_t>(blockIdx.x) * kFilterThreads;
  if (t < (kFilterThreads + 4) / 4) {
    const int64_t w = base + 4 * t;
    uint4 v;
    if (w + 4 <= nwords) {
      v = __ldg(reinterpret_cast<const uint4*>(words + w));
    } else {
      v.x = w < nwords ? words[w] : 0u;
      v.y = w + 1 < nwords ? words[w + 1] : 0u;
      v.z = w + 2 < nwords ? words[w + 2] : 0u;
      v.w = w + 3 < nwords ? words[w + 3] : 0u;
    }
    reinterpret_cast<uint4*>(tile)[t] = v;
  }
  __syncthreads();
  const int64_t j = base + t;
  const int64_t first = j * 32;
  uint32_t found = 0;
  // the positions of this word inside [from_bit, last_bit]
  const int64_t lo = from_bit > first ? from_bit - first : 0;
  const int64_t hi = last_bit - first < 31 ? last_bit - first : 31;
  if (lo <= hi) {
    const uint64_t lo64 = tile[t] | static_cast<uint64_t>(tile[t + 1]) << 32;
    const uint64_t hi64 = tile[t + 2] | static_cast<uint64_t>(tile[t + 3]) << 32;
    // bit s of each mask: the check at start bit first + s
    const uint32_t btype2 = static_cast<uint32_t>(~lo64 >> 1 & lo64 >> 2);
    const uint32_t not_final = allow_final ? 0xffffffffu : static_cast<uint32_t>(~lo64);
    const uint32_t hlit_over = static_cast<uint32_t>(lo64 >> 4 & lo64 >> 5 & lo64 >> 6 & lo64 >> 7);
    const uint32_t hdist_over = static_cast<uint32_t>(lo64 >> 9 & lo64 >> 10 & lo64 >> 11 & lo64 >> 12);
    const uint32_t range = (0xffffffffu >> (31 - hi)) & (0xffffffffu << lo);
    uint32_t fields = btype2 & not_final & ~hlit_over & ~hdist_over & range;
    while (fields) {
      const int s = __ffs(fields) - 1;
      fields &= fields - 1;
      const int hclen = static_cast<int>((lo64 >> (s + 13)) & 15) + 4;
      const uint64_t k = lo64 >> (s + 17) | hi64 << (47 - s);
      if (clc_complete(hclen, k)) found |= 1u << s;
    }
  }
  warp_append(found, first, res, cand, cap);
}

// The 64 bits from bit `pos` (words zero past the stream).
__device__ __forceinline__ uint64_t peek64(const uint32_t* __restrict__ words, int64_t pos) {
  const int64_t j = pos >> 5;
  const int s = static_cast<int>(pos & 31);
  const uint64_t lo = __ldg(words + j) | static_cast<uint64_t>(__ldg(words + j + 1)) << 32;
  return s ? lo >> s | static_cast<uint64_t>(__ldg(words + j + 2)) << (64 - s) : lo;
}

// read_dynamic_tables' verdict on the header at `bit` (its fields already
// checked), without its tables.  Everything lives in registers: the
// code-length code's lengths by symbol, their counts and code limits by
// length, the symbols in canonical order packed 5 bits each, and a bit
// buffer of the stream that takes the next word, loaded a refill ahead,
// whenever it holds under 32 bits, so a symbol waits for no load.
__device__ bool header_parses(const uint32_t* __restrict__ words, int64_t nbits, int64_t bit) {
  // each symbol's place among the header's code-length fields
  constexpr int kSlot[19] = {3, 17, 15, 13, 11, 9, 7, 5, 4, 6, 8, 10, 12, 14, 16, 18, 0, 1, 2};
  const uint64_t w = peek64(words, bit);
  const int hlit = static_cast<int>((w >> 3) & 31) + 257;
  const int hdist = static_cast<int>((w >> 8) & 31) + 1;
  const int hclen = static_cast<int>((w >> 13) & 15) + 4;
  const int total = hlit + hdist;
  const uint64_t k = peek64(words, bit + 17) & ((1ull << (3 * hclen)) - 1);
  int clen[19];
#pragma unroll
  for (int t = 0; t < 19; t++) clen[t] = static_cast<int>((k >> (3 * kSlot[t])) & 7);
  // by length l: its codes' count, and their end as a 7-bit code read
  // MSB first (canonical codes of length l fill [limit[l - 1], limit[l]))
  int count[8], limit[8];
  uint64_t order_lo = 0, order_hi = 0;  // ranks 0 .. 11, then 12 .. 18
  int ranked = 0, code_end = 0;
#pragma unroll
  for (int l = 1; l <= 7; l++) {
    count[l] = 0;
#pragma unroll
    for (int t = 0; t < 19; t++) {
      if (clen[t] == l) {
        if (ranked < 12)
          order_lo |= static_cast<uint64_t>(t) << (5 * ranked);
        else
          order_hi |= static_cast<uint64_t>(t) << (5 * (ranked - 12));
        ranked++;
        count[l]++;
      }
    }
    code_end += count[l];
    limit[l] = code_end << (7 - l);
    code_end <<= 1;
  }

  int64_t pos = bit + 17 + 3 * hclen;
  int64_t next = (pos >> 5) + 2;  // the word after those in the buffer
  const int s0 = static_cast<int>(pos & 31);
  uint64_t bb = (__ldg(words + (pos >> 5)) |
                 static_cast<uint64_t>(__ldg(words + (pos >> 5) + 1)) << 32) >> s0;
  int have = 64 - s0;
  uint32_t ahead = __ldg(words + next);
  int i = 0, prev = 0, len256 = 0;
  int kraft_lit = 0, kraft_dist = 0, codes_lit = 0, codes_dist = 0;
  while (i < total) {
    if (have < 32) {
      bb |= static_cast<uint64_t>(ahead) << have;
      have += 32;
      ahead = __ldg(words + ++next);
    }
    // canonical decode without a branch: the next 7 bits as a code read
    // MSB first lie past the limits of the lengths shorter than theirs
    // (the code is complete, so below limit[7] = 128)
    const int x = static_cast<int>(__brev(static_cast<uint32_t>(bb)) >> 25);
    int nb = 1, base = 0, rank = 0;
#pragma unroll
    for (int l = 1; l < 7; l++) {
      const bool past = x >= limit[l];
      nb += past;
      base = past ? limit[l] : base;
      rank += past ? count[l] : 0;
    }
    rank += (x - base) >> (7 - nb);
    const int sym = static_cast<int>(
        (rank < 12 ? order_lo >> (5 * rank) : order_hi >> (5 * (rank - 12))) & 31);
    int need = 0, rep = 1, v = sym;
    if (sym == 16) {
      if (i == 0) return false;
      need = 2;
      rep = 3 + static_cast<int>((bb >> nb) & 3);
      v = prev;
    } else if (sym == 17) {
      need = 3;
      rep = 3 + static_cast<int>((bb >> nb) & 7);
      v = 0;
    } else if (sym == 18) {
      need = 7;
      rep = 11 + static_cast<int>((bb >> nb) & 127);
      v = 0;
    }
    if (pos + nb + need > nbits || i + rep > total) return false;
    pos += nb + need;
    bb >>= nb + need;
    have -= nb + need;
    const int nlit = hlit - i > rep ? rep : (hlit - i > 0 ? hlit - i : 0);
    if (v) {
      kraft_lit += nlit << (15 - v);
      kraft_dist += (rep - nlit) << (15 - v);
      codes_lit += nlit;
      codes_dist += rep - nlit;
      if (kraft_lit > kKraftOne || kraft_dist > kKraftOne) return false;
    }
    if (i <= 256 && 256 < i + rep) len256 = v;
    prev = v;
    i += rep;
  }
  return len256 != 0 && (kraft_lit == kKraftOne || codes_lit == 1) &&
         (kraft_dist == kKraftOne || codes_dist <= 1);
}

__global__ void __launch_bounds__(kParseThreads)
    header_parse_kernel(const uint32_t* __restrict__ words, int64_t nbits,
                        const int32_t* __restrict__ cand, int cap, int32_t* __restrict__ res) {
  const int n = min(res[0], cap);
  const int stride = gridDim.x * kParseThreads;
  // whole warps go round the loop together: warp_append shuffles
  for (int b = blockIdx.x * kParseThreads; b < n; b += stride) {
    const int i = b + threadIdx.x;
    const bool ok = i < n && header_parses(words, nbits, cand[i]);
    warp_append(ok ? 1u : 0u, ok ? cand[i] : 0, res + 1, res + 2, cap);
  }
}

}  // namespace

// Scans start bits [from_bit, nbits - 81] of the stream in `words` (nwords
// of them) into res (2 + cap int32), cand (cap int32) its scratch.
extern "C" int tz_header_scan(const void* words, long long nwords, long long nbits,
                              long long from_bit, int allow_final, void* cand, int cap, void* res,
                              void* stream) {
  if (cap < 1 || from_bit < 0 || nbits >= (1ll << 31) || nwords * 32 < nbits + 128 ||
      reinterpret_cast<uintptr_t>(words) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(res, 0, 2 * sizeof(int32_t), st);
  const long long last_bit = nbits - 81;
  if (err != cudaSuccess || last_bit < from_bit) return static_cast<int>(err);
  int sms = 0;
  if ((err = tz::sm_count(&sms)) != cudaSuccess) return static_cast<int>(err);
  const long long base0 = (from_bit >> 5) & ~3ll;
  const long long nw = (last_bit >> 5) - base0 + 1;
  const int grid = static_cast<int>((nw + kFilterThreads - 1) / kFilterThreads);
  const uint32_t* w = static_cast<const uint32_t*>(words);
  int32_t* r = static_cast<int32_t*>(res);
  int32_t* c = static_cast<int32_t*>(cand);
  header_filter_kernel<<<grid, kFilterThreads, 0, st>>>(w, nwords, base0, from_bit, last_bit,
                                                         allow_final, c, cap, r);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  header_parse_kernel<<<sms * kParseBlocksPerSm, kParseThreads, 0, st>>>(w, nbits, c, cap, r);
  return static_cast<int>(cudaGetLastError());
}
