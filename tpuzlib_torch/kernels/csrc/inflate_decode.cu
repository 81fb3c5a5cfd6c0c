// K-cursor speculative Huffman decode of a raw DEFLATE stream.
//
// Replaces tpuzlib/kernels/inflate_pallas.py:_decode_kernel (through
// _prep_and_decode / pallas_cursor_tokenize).  Cursor k decodes symbols from
// its own start bit until it stops, writing one tape row per symbol:
// tok = val | dist << 9 | is_len << 25 (1 << 26 for an EOB it does not stop
// at), bp = the symbol's absolute bit position.  A symbol is decoded by
// canonical counting over the bit-reversed 16-bit window: the first code
// length L with first[L] <= code < first[L] + count[L] gives the rank
// off[L] + code - first[L] into the block's entry table.  It stops at an
// expected EOB (ST_EOB, whose bits it consumes), a bad code (ST_ERR), a
// symbol that ends past its available bits (ST_OOB), its stop bit
// (ST_STRIDE_END), or a full tape (ST_ERR).  Rows past the cursor's count
// hold tok 0 and bp 1 << 30.
//
// The outputs equal the Pallas kernel's bit for bit, so the word index is
// clamped into the cursor's slice as fetch3 clamps it, every shift by 32 is
// guarded as its `where`s guard it, and an unmatched code reads length 15
// with its rank clamped into the table before the lookup.
//
// Bound: latency.  The decode is a serial chain of dependent loads per
// cursor (three stream words, two tables of 16, an entry, twice per
// symbol), about 3,250 steps at the main path's shapes, and only ~8k cursors
// run.  The TPU kernel keeps 128 cursors on the lanes of one vector unit and
// selects every dynamic index with where-chains; on the card one thread owns
// one cursor and indexes its block's tables through the block number, which
// the caches serve, so no per-cursor copy of a table is built.  A warp's
// threads diverge in length; the warp runs as long as its longest cursor.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kLitRows = 288, kDistRows = 32, kTab = 96;
constexpr int kLC = 0, kLF = 16, kLO = 32, kDC = 48, kDF = 64, kDO = 80;
constexpr int kRun = 0, kStrideEnd = 1, kEob = 2, kErr = 3, kOob = 4;
constexpr int32_t kSent = 1 << 30;
constexpr uint32_t kLen = 1u << 23, kEobFlag = 1u << 24, kInvalid = 1u << 31;

// (lo >> s) | (hi << (32 - s)), and lo where s == 0 (no shift by 32).
__device__ __forceinline__ uint32_t shr_or(uint32_t lo, uint32_t hi, uint32_t s) {
  return s == 0 ? lo : (lo >> s) | (hi << (32 - s));
}

// Counting decode of one symbol from window w; tables of 16 code lengths.
// Returns whether a length matched; an unmatched code reads length 15.
__device__ __forceinline__ bool tree_decode(uint32_t w, const int32_t* __restrict__ cnt,
                                            const int32_t* __restrict__ first,
                                            const int32_t* __restrict__ off, int& rank, int& len) {
  const int rv = static_cast<int>(__brev(w) >> 16);  // the low 16 bits reversed
  int l = 1;
  for (; l < 16; ++l) {
    const int code = rv >> (16 - l);
    const int f = __ldg(first + l);
    if (code >= f && code - f < __ldg(cnt + l)) break;
  }
  const bool ok = l < 16;
  len = ok ? l : 15;
  rank = __ldg(off + len) + (rv >> (16 - len)) - __ldg(first + len);
  return ok;
}

__device__ __forceinline__ uint32_t lookup(const uint32_t* __restrict__ ents, int rows, int rank) {
  return __ldg(ents + min(max(rank, 0), rows - 1));
}

// cur: 7 rows of K int32 (slice start word, start, stop, available bits
// relative to the slice, active, stops-at-EOB, block).  fin: 4 rows of K
// (count, absolute end bit, status, first flagged EOB row).
__global__ void __launch_bounds__(kThreads)
inflate_decode_kernel(const uint32_t* __restrict__ words, const int32_t* __restrict__ cur,
                      int K, int nwp, int cap, const int32_t* __restrict__ tabs,
                      const uint32_t* __restrict__ lents, const uint32_t* __restrict__ dents,
                      int32_t* __restrict__ tok, int32_t* __restrict__ bp,
                      int32_t* __restrict__ fin) {
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= K) return;
  const int swstart = cur[k];
  const int stop = cur[2 * K + k], avail = cur[3 * K + k];
  const bool active = cur[4 * K + k] != 0, expect = cur[5 * K + k] != 0;
  const int blk = cur[6 * K + k];
  const int32_t* tb = tabs + static_cast<long long>(blk) * kTab;
  const uint32_t* le = lents + static_cast<long long>(blk) * kLitRows;
  const uint32_t* de = dents + static_cast<long long>(blk) * kDistRows;
  const uint32_t* w = words + swstart;
  const int off = swstart << 5;
  int32_t* trow = tok + static_cast<long long>(k) * cap;
  int32_t* brow = bp + static_cast<long long>(k) * cap;

  int pos = cur[K + k], cnt = 0, eob_first = -1;
  int status = active && pos < stop ? kRun : kStrideEnd;
  for (int it = 0; it < cap && status == kRun; ++it) {
    const int j = min(max(pos >> 5, 0), nwp - 3);
    const uint32_t wa = __ldg(w + j), wb = __ldg(w + j + 1), wc = __ldg(w + j + 2);
    const uint32_t sh = pos & 31;
    const uint32_t lo = shr_or(wa, wb, sh), hi = shr_or(wb, wc, sh);

    // literal/length symbol, then its extra bits
    int rank, len;
    const bool okl = tree_decode(lo, tb + kLC, tb + kLF, tb + kLO, rank, len);
    const uint32_t ent = lookup(le, kLitRows, rank);
    const int eb = (ent >> 19) & 0xF;
    const int val = static_cast<int>(ent & 0x7FFF) +
                    static_cast<int>((lo >> len) & ((1u << eb) - 1));
    const bool is_len = ent & kLen, is_eob = ent & kEobFlag;
    const int jump1 = len + eb;
    bool bad = !okl || (ent & kInvalid);

    // distance symbol and its extra bits (meaningful for lengths only)
    const uint32_t o = min(max(jump1, 0), 31);
    const uint32_t w2 = shr_or(lo, hi, o), w2hi = o == 0 ? hi : hi >> o;
    int drank, dlen;
    const bool okd = tree_decode(w2, tb + kDC, tb + kDF, tb + kDO, drank, dlen);
    const uint32_t dent = lookup(de, kDistRows, drank);
    const int deb = (dent >> 19) & 0xF;
    const int dval = static_cast<int>(dent & 0x7FFF) +
                     static_cast<int>(shr_or(w2, w2hi, dlen) & ((1u << deb) - 1));
    if (is_len && (!okd || (dent & kInvalid))) bad = true;

    const int jump = is_len ? jump1 + dlen + deb : jump1;
    const int nxt = pos + jump;
    const bool oob = nxt > avail;
    const bool real_eob = is_eob && expect;
    if (bad) {
      status = kErr;
    } else if (oob) {
      status = kOob;
    } else if (real_eob) {
      status = kEob;
      pos = nxt;  // an EOB consumes its bits
    } else {
      uint32_t pack = static_cast<uint32_t>(val) |
                      (static_cast<uint32_t>(is_len ? dval : 0) << 9) |
                      (static_cast<uint32_t>(is_len) << 25);
      if (is_eob) pack = 1u << 26;
      trow[cnt] = static_cast<int32_t>(pack);
      brow[cnt] = pos + off;
      if (is_eob && eob_first < 0) eob_first = cnt;
      ++cnt;
      pos = nxt;
      if (pos >= stop) status = kStrideEnd;
    }
  }
  if (status == kRun) status = kErr;  // still running after `cap` rows: the tape overflowed
  for (int r = cnt; r < cap; ++r) {
    trow[r] = 0;
    brow[r] = kSent;
  }
  fin[k] = cnt;
  fin[K + k] = active ? pos + off : 0;
  fin[2 * K + k] = status;
  fin[3 * K + k] = eob_first;
}

}  // namespace

extern "C" int tz_inflate_decode(const void* words, const void* cur, int K, int nwp, int cap,
                                 const void* tabs, const void* lents, const void* dents,
                                 void* tok, void* bp, void* fin, void* stream) {
  const int grid = (K + kThreads - 1) / kThreads;
  inflate_decode_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const int32_t*>(cur), K, nwp, cap,
      static_cast<const int32_t*>(tabs), static_cast<const uint32_t*>(lents),
      static_cast<const uint32_t*>(dents), static_cast<int32_t*>(tok),
      static_cast<int32_t*>(bp), static_cast<int32_t*>(fin));
  return static_cast<int>(cudaGetLastError());
}
