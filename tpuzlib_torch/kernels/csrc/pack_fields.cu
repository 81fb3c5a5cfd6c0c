// Token fields and the bit pack of the batched device deflate encoder.
//
// Replaces tpuzlib/kernels/deflate_device3.py:_pack_fields_kernel and the
// bit pack that tpuzlib runs in XLA after it (deflate_device3.py:670-700):
// the rows' packed words come out of these two kernels.  A row's field
// stream is head3 (3 bits: 4 | last), its 338 dynamic-header fields, then
// its tokens up to and including the EOB at eob_at; the slots after the
// EOB hold pads, whose fields are empty, and are not read.  A token is
// litlen | is_match << 9 | (dist - 1) << 10; its field is the LSB-first
// concatenation of its lit/len code, length extra bits, distance code and
// distance extra bits, from the chunk's tables.
//
// The field at bit offset o lands in words o/32, o/32 + 1 and o/32 + 2 as
// three u32 pieces, the word index clamped to the row's last word.  The
// words are the sums of their pieces mod 2^32, as the torch version's
// int64 index_add_ followed by & 0xFFFFFFFF gives them, so pieces are
// added with u32 atomicAdd into the low half of each int64 word: the
// order does not change the sum, and pieces that the clamp piles into the
// last word add up as they do there.
//
// A row's fields are numbered from kLead empty ones, so that a thread's
// eight consecutive tokens start 16-byte aligned.  Two launches, each over
// blocks of kTile fields of one row:
//   pack_sums   sums the widths of its tile and zeroes its share of the
//               row's words;
//   pack_words  takes the sums of the tiles before its own as its first
//               bit, scans its fields' widths in the block, adds their
//               pieces into a window of shared memory over the words its
//               bits cover, and then adds the window into the row's words
//               (pieces outside the window, which only fields wider than a
//               token's 48 bits give, go to the words directly).
// Both read the chunk's code tables into shared memory once a block.
// Bound by device memory: four bytes a token up to the EOB, the header,
// the tables, and eight bytes a word written.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;                   // fields a thread
constexpr int kTile = kThreads * kItems;    // fields a block
constexpr int kHdr = 338;                   // header fields
constexpr int kLead = 5;                    // empty fields before head3, so that
constexpr int kHead = kLead + 1 + kHdr;     // the tokens start at a multiple of kItems
static_assert(kHead % kItems == 0, "a thread's tokens must start 16-byte aligned");
constexpr int kWin = kTile * 48 / 32 + 4;   // window words: a tile of 48-bit token fields
constexpr int kWarps = kThreads / 32;
constexpr int kNumLit = 286;
constexpr int kNumDist = 30;
constexpr int kWindow = 1 << 15;

struct Args {
  const int* tok;
  const int* lcode;
  const int* lbits;
  const int* dcode;
  const int* dbits;
  const long long* eob_at;
  const long long* hdr_vals;
  const long long* hdr_bits;
  const int* lasts;
  long long* words;
  long long* total_bits;
  int* sums;  // [B, ntile] widths of each tile
  int T;
  int out_words;
  int ntile;
  bool vec;  // rows of tokens 16-byte aligned: a thread reads its eight as two int4
};

struct Tables {
  int lc[kNumLit], lb[kNumLit], dc[kNumDist], db[kNumDist];
};

__device__ __forceinline__ int floor_log2(int v) { return 31 - __clz(v); }

// fields in row b: the lead, head3, the header, tokens 0..eob_at
__device__ __forceinline__ int row_fields(const Args& a, int b) {
  return kHead + static_cast<int>(min(max(a.eob_at[b], -1LL), static_cast<long long>(a.T - 1))) + 1;
}

// a field's input: a token (w < 0), or bits and their width
struct Raw {
  uint32_t v;
  int w;
};

// the input of field f of row b (nf fields)
__device__ __forceinline__ Raw raw_field(const Args& a, int b, int nf, int f) {
  if (f >= nf || f < kLead) return {0u, 0};
  if (f >= kHead) return {static_cast<uint32_t>(a.tok[static_cast<long long>(b) * a.T + f - kHead]), -1};
  if (f == kLead) return {4u | static_cast<uint32_t>(a.lasts[b]), 3};
  const long long i = static_cast<long long>(b) * kHdr + f - kLead - 1;
  return {static_cast<uint32_t>(a.hdr_vals[i]), static_cast<int>(a.hdr_bits[i])};
}

__device__ void load_tables(Tables& s, const Args& a, int b) {
  for (int i = threadIdx.x; i < kNumLit; i += blockDim.x) {
    s.lc[i] = a.lcode[b * kNumLit + i];
    s.lb[i] = a.lbits[b * kNumLit + i];
  }
  for (int i = threadIdx.x; i < kNumDist; i += blockDim.x) {
    s.dc[i] = a.dcode[b * kNumDist + i];
    s.db[i] = a.dbits[b * kNumDist + i];
  }
}

// a field's bits (lo, hi) and its width nb, from its input
__device__ __forceinline__ void field(const Tables& s, Raw r, uint32_t& lo, uint32_t& hi, int& nb) {
  lo = r.v;
  hi = 0;
  nb = r.w;
  if (r.w >= 0) return;
  const uint32_t tk = r.v;
  const int litlen = tk & 0x1FF;
  const bool is_match = (tk >> 9) & 1;
  const int dist = is_match ? static_cast<int>(tk >> 10) + 1 : 0;

  const int l = min(max(litlen - 3, 0), 255);
  const int e = floor_log2(max(l, 1));
  const int lsym = !is_match ? litlen
                   : l < 8   ? 257 + l
                   : l == 255 ? 285
                              : 253 + 4 * e + ((l >> max(e - 2, 0)) & 3);
  const int lext = (is_match && l >= 8 && l != 255) ? max(e - 2, 0) : 0;
  const uint32_t lext_val = is_match ? (l & ((1 << lext) - 1)) : 0;

  const int v = min(max(dist - 1, 0), kWindow - 1);
  const int ed = floor_log2(max(v, 1));
  const int dsym = v < 4 ? v : 2 * ed + ((v >> max(ed - 1, 0)) & 1);
  const int dext = (v < 4 || !is_match) ? 0 : max(ed - 1, 0);
  const uint32_t dext_val = is_match ? (v & ((1 << dext) - 1)) : 0;

  // symbols outside the tables (the pad 511) take code 0, length 0
  uint64_t bits = 0;
  int w = 0;
  if (lsym < kNumLit) {
    bits = static_cast<uint32_t>(s.lc[lsym]);
    w = s.lb[lsym];
  }
  bits |= static_cast<uint64_t>(lext_val) << w;
  w += lext;
  if (is_match && dsym < kNumDist) {
    bits |= static_cast<uint64_t>(static_cast<uint32_t>(s.dc[dsym])) << w;
    w += s.db[dsym];
  }
  bits |= static_cast<uint64_t>(dext_val) << w;
  lo = static_cast<uint32_t>(bits);
  hi = static_cast<uint32_t>(bits >> 32);
  nb = w + dext;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int d = 16; d; d >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, d);
  return v;
}

// the block's sum of v, in every thread
__device__ int block_sum(int v, int* part) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  int t = 0;
  for (int i = 0; i < kWarps; ++i) t += part[i];
  return t;
}

// the block's exclusive prefix sum of v, in thread order
__device__ int block_exclusive_scan(int v, int* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) part[warp] = x;
  __syncthreads();
  int before = 0;
  for (int i = 0; i < warp; ++i) before += part[i];
  return before + x - v;
}

// grid (ntile, B): the widths of tile x of row b, in thread-strided order
__global__ void __launch_bounds__(kThreads) pack_sums_kernel(Args a) {
  __shared__ Tables s;
  __shared__ int part[kWarps];
  const int t = blockIdx.x, b = blockIdx.y;
  long long* row = a.words + static_cast<long long>(b) * a.out_words;
  const int share = (a.out_words + a.ntile - 1) / a.ntile;
  const int end = min(a.out_words, (t + 1) * share);
  for (int i = t * share + threadIdx.x; i < end; i += kThreads) row[i] = 0;

  const int nf = row_fields(a, b);
  const int f0 = t * kTile;
  int width = 0;
  if (f0 < nf) {
    Raw r[kItems];
#pragma unroll
    for (int i = 0; i < kItems; ++i) r[i] = raw_field(a, b, nf, f0 + i * kThreads + threadIdx.x);
    load_tables(s, a, b);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      uint32_t lo, hi;
      int nb;
      field(s, r[i], lo, hi, nb);
      width += nb;
    }
  }
  width = block_sum(width, part);
  if (threadIdx.x == 0) a.sums[static_cast<long long>(b) * a.ntile + t] = width;
}

// grid (ntile, B): the pieces of tile x of row b
__global__ void __launch_bounds__(kThreads) pack_words_kernel(Args a) {
  __shared__ Tables s;
  __shared__ uint32_t win[kWin];
  __shared__ int part[kWarps];
  __shared__ int first_bit;
  const int t = blockIdx.x, b = blockIdx.y;
  const int* sums = a.sums + static_cast<long long>(b) * a.ntile;
  const int nf = row_fields(a, b);
  const int f0 = t * kTile;
  if (threadIdx.x < 32) {
    // the row's bits before this tile (tile 0 also writes the row's total)
    int before = 0, all = 0;
    for (int i = threadIdx.x; i < a.ntile; i += 32) {
      before += i < t ? sums[i] : 0;
      all += sums[i];
    }
    before = warp_sum(before);
    all = warp_sum(all);
    if (threadIdx.x == 0) {
      first_bit = before;
      if (t == 0) a.total_bits[b] = all;
    }
  }
  if (f0 >= nf) return;  // the whole block: no field in this tile
  // this thread's kItems fields, in order; tokens two int4 at a time
  const int fb = f0 + threadIdx.x * kItems, t0 = fb - kHead;
  Raw r[kItems];
  if (a.vec && t0 >= 0 && t0 + kItems <= a.T) {
    const int4* p = reinterpret_cast<const int4*>(a.tok + static_cast<long long>(b) * a.T + t0);
    const int4 x = p[0], y = p[1];
    const int t[kItems] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      r[i] = fb + i < nf ? Raw{static_cast<uint32_t>(t[i]), -1} : Raw{0u, 0};
    }
  } else {
#pragma unroll
    for (int i = 0; i < kItems; ++i) r[i] = raw_field(a, b, nf, fb + i);
  }
  load_tables(s, a, b);
  for (int i = threadIdx.x; i < kWin; i += kThreads) win[i] = 0;
  __syncthreads();

  uint32_t lo[kItems], hi[kItems];
  int nb[kItems];
  int width = 0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    field(s, r[i], lo[i], hi[i], nb[i]);
    width += nb[i];
  }
  const int first = first_bit;
  int off = first + block_exclusive_scan(width, part);
  const int last = a.out_words - 1;
  const int wbase = min(first >> 5, last);
  // the low u32 half of word w of the row is at out[2 * w]
  unsigned* out = reinterpret_cast<unsigned*>(a.words + static_cast<long long>(b) * a.out_words);
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int idx = off >> 5, sh = off & 31;
    const uint32_t piece[3] = {lo[i] << sh, __funnelshift_l(lo[i], hi[i], sh),
                               __funnelshift_l(hi[i], 0u, sh)};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      if (piece[k] == 0) continue;
      const int w = min(max(idx + k, 0), last);
      const unsigned j = static_cast<unsigned>(w - wbase);
      if (j < kWin) {
        atomicAdd(&win[j], piece[k]);
      } else {
        atomicAdd(&out[2LL * w], piece[k]);
      }
    }
    off += nb[i];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < kWin && wbase + j <= last; j += kThreads) {
    if (win[j]) atomicAdd(&out[2LL * (wbase + j)], win[j]);
  }
}

}  // namespace

// sums: room for B * (T / kTile + 2) ints, the tiles' widths
extern "C" int tz_pack_words(const void* tok, const void* lcode, const void* lbits,
                             const void* dcode, const void* dbits, const void* eob_at,
                             const void* hdr_vals, const void* hdr_bits, const void* lasts,
                             void* words, void* total_bits, void* sums, int T, int B,
                             int out_words, void* stream) {
  const int ntile = (kHead + T + kTile - 1) / kTile;
  const bool vec = T % 4 == 0 && reinterpret_cast<uintptr_t>(tok) % 16 == 0;
  const Args a{static_cast<const int*>(tok),          static_cast<const int*>(lcode),
               static_cast<const int*>(lbits),        static_cast<const int*>(dcode),
               static_cast<const int*>(dbits),        static_cast<const long long*>(eob_at),
               static_cast<const long long*>(hdr_vals), static_cast<const long long*>(hdr_bits),
               static_cast<const int*>(lasts),        static_cast<long long*>(words),
               static_cast<long long*>(total_bits),   static_cast<int*>(sums),
               T, out_words, ntile, vec};
  const dim3 grid(ntile, B);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  pack_sums_kernel<<<grid, kThreads, 0, st>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  pack_words_kernel<<<grid, kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
