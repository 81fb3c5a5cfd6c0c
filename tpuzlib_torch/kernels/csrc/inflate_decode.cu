// K-cursor speculative Huffman decode of a raw DEFLATE stream, and the
// per-block lookup tables it decodes most symbols with.
//
// Replaces tpuzlib/kernels/inflate_pallas.py:_decode_kernel (through
// _prep_and_decode / pallas_cursor_tokenize).  Cursor k decodes symbols from
// its own start bit until it stops, writing one tape row per symbol:
// tok = val | dist << 9 | is_len << 25 (1 << 26 for an EOB it does not stop
// at), bp = the symbol's absolute bit position.  A symbol's code is the first
// length L with first[L] <= code < first[L] + count[L] of the canonical count
// tables (code: the window's first L bits, MSB-first), and its entry is row
// off[L] + code - first[L] of the block's entry table.  It stops at an
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
// Bound.  At the main path's shapes (8,192 cursors, 3,248 rows, 526 blocks)
// the kernel moves 231 MB: tapes 213 MB, stream 12 MB, lookup tables 5 MB,
// count tables and cursors 1 MB, so 0.069 ms at 3.35 TB/s.  It is far from
// that, because each cursor is one serial chain: a symbol's table load
// waits for the previous symbol's length.  Only ~8k cursors run, about two
// warps an SM, so nothing hides that latency, and the kernel takes as long
// as its longest cursor: 2,276 symbols times the dependent latency of one
// symbol.  On an H100 at 1980 MHz that is ~700 cycles (probes/
// decode_breakdown.py): a step issues ~150 mostly dependent instructions
// and two table loads, each ~57 cycles as a chain from L1.  Without its tape
// stores the kernel takes ~60% of its time: a store from 32 lanes to 32
// rows holds up the loads issued after it.  The TPU kernel keeps 128
// cursors on the lanes of one vector unit and selects every dynamic index
// with where-chains; here one thread owns one cursor, and the design
// shortens its chain:
//
//   - inflate_lut_kernel builds, for every block, a table of 2^10 lit/len
//     entries and one of 2^8 distance entries, indexed by the window's first
//     bits: the entry the counting decode finds there, its code length and
//     the bits the symbol takes with its extra bits, or length 0 where no
//     code of at most that many bits matches (the counting match at length l
//     reads only the window's first l bits, so the table is exact).  A
//     symbol then costs one load from L1, and its length is read, not
//     computed.  A longer code is counted from length 11 (9) over count
//     tables each cursor holds in registers: arithmetic and one entry load,
//     since on a warp of 32 cursors a miss in any lane costs every lane.
//   - The stream lives in registers: the window's three words and the next
//     two, loaded a step or more before they enter it.  The window stops at
//     the slice's last three words, which is the old clamped fetch.
//   - The step has no branch for the warp to diverge on but a table miss:
//     the distance is looked up after every symbol and used after a length,
//     and the stop rules are selects.
//   - Rows go out four at a time as 16-byte stores, issued in the next step
//     once its table loads are, and each warp writes its rows' sentinel
//     tails together, row by row, in coalesced 16-byte stores.
//   - The kernel uses no shared memory.  Shared memory comes out of L1, and
//     a stage for the rows left too little of it for the tables, whose
//     loads then went to L2.
//
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 128, kLutThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kLutBits = 10, kDLutBits = 8;  // the decode's primary-table bits
constexpr int kLitRows = 288, kDistRows = 32, kTab = 96;
constexpr int kLC = 0, kDC = 48;  // count tables; first at +16, offset at +32
constexpr int kRun = 0, kStrideEnd = 1, kEob = 2, kErr = 3, kOob = 4;
constexpr int32_t kSent = 1 << 30;
constexpr uint32_t kLen = 1u << 23, kEobFlag = 1u << 24, kInvalid = 1u << 31;

__device__ __forceinline__ uint32_t lookup(const uint32_t* __restrict__ ents, int rows, int rank) {
  return __ldg(ents + min(max(rank, 0), rows - 1));
}

// The count tables of the code lengths L0..15 that a primary table of
// L0 - 1 bits does not resolve, held in registers for one block.
template <int L0>
struct LongCodes {
  static constexpr int n = 16 - L0;
  int count[n], first[n], off[n];

  __device__ __forceinline__ explicit LongCodes(const int32_t* __restrict__ t) {
#pragma unroll
    for (int q = 0; q < n; ++q) {
      count[q] = __ldg(t + L0 + q);
      first[q] = __ldg(t + 16 + L0 + q);
      off[q] = __ldg(t + 32 + L0 + q);
    }
  }

  // Counting decode of window w over lengths L0..15, the shortest match
  // winning.  Returns whether a length matched; an unmatched code reads
  // length 15.
  __device__ __forceinline__ bool decode(uint32_t w, const uint32_t* __restrict__ ents, int rows,
                                         uint32_t& ent, int& len) const {
    const int rv = static_cast<int>(__brev(w) >> 16);  // the first 16 bits, MSB-first
    bool ok = false;
    len = 15;
    int rank = off[n - 1] + (rv >> 1) - first[n - 1];
#pragma unroll
    for (int q = n - 1; q >= 0; --q) {
      const int code = rv >> (16 - L0 - q);
      if (code >= first[q] && code - first[q] < count[q]) {
        ok = true;
        len = L0 + q;
        rank = off[q] + code - first[q];
      }
    }
    ent = lookup(ents, rows, rank);
    return ok;
  }
};

// The extra-bit count of an entry.
__device__ __forceinline__ int extra_bits(uint32_t ent) { return (ent >> 19) & 0xF; }

// One symbol from window w: the primary table's entry where its code has
// at most BITS bits, else the counting decode from length BITS + 1.
// jump: its code length plus its extra bits, the bits it takes.
template <int BITS>
__device__ __forceinline__ bool decode_sym(uint32_t w, const uint2* __restrict__ lut,
                                           const LongCodes<BITS + 1>& longc,
                                           const uint32_t* __restrict__ ents, int rows,
                                           uint32_t& ent, int& len, int& jump) {
  const uint2 e = __ldg(lut + (w & ((1u << BITS) - 1)));
  if (e.y != 0) {
    ent = e.x;
    len = static_cast<int>(e.y & 0xFF);
    jump = static_cast<int>(e.y >> 8);
    return true;
  }
  const bool ok = longc.decode(w, ents, rows, ent, len);
  jump = len + extra_bits(ent);
  return ok;
}

// One thread per (block, table row): rows [0, 2^lbits) of a block are its
// lit/len table, the next 2^dbits its distance table.  Entry (ent, len |
// (len + extra bits) << 8) of window x is the counting decode of x where it
// matches a length of at most the table's bits, else (0, 0).
__global__ void __launch_bounds__(kLutThreads)
inflate_lut_kernel(const int32_t* __restrict__ tabs, const uint32_t* __restrict__ lents,
                   const uint32_t* __restrict__ dents, int nblk, int lbits, int dbits,
                   uint2* __restrict__ lut) {
  const int rows = (1 << lbits) + (1 << dbits);
  const long long i = static_cast<long long>(blockIdx.x) * kLutThreads + threadIdx.x;
  if (i >= static_cast<long long>(nblk) * rows) return;
  const int blk = static_cast<int>(i / rows), x = static_cast<int>(i % rows);
  const bool lit = x < (1 << lbits);
  const int bits = lit ? lbits : dbits;
  const uint32_t win = lit ? x : x - (1 << lbits);
  const int32_t* t = tabs + static_cast<long long>(blk) * kTab + (lit ? kLC : kDC);
  const int rv = static_cast<int>(__brev(win) >> 16);  // the first 16 bits, MSB-first
  int l = 1;
  for (; l <= bits; ++l) {
    const int code = rv >> (16 - l);
    const int f = __ldg(t + 16 + l);
    if (code >= f && code - f < __ldg(t + l)) break;
  }
  uint2 e = make_uint2(0u, 0u);
  if (l <= bits) {
    const int rank = __ldg(t + 32 + l) + (rv >> (16 - l)) - __ldg(t + 16 + l);
    e.x = lit ? lookup(lents + static_cast<long long>(blk) * kLitRows, kLitRows, rank)
              : lookup(dents + static_cast<long long>(blk) * kDistRows, kDistRows, rank);
    e.y = static_cast<uint32_t>(l | (l + extra_bits(e.x)) << 8);
  }
  lut[i] = e;
}

// One cursor's decode.  cur: 7 rows of K int32 (slice start word, start,
// stop, available bits relative to the slice, active, stops-at-EOB, block);
// lut: per block, 2^kLutBits lit/len then 2^kDLutBits distance entries.
struct Cursor {
  const uint32_t* w;  // the slice's words
  const uint32_t *le, *de;
  const uint2 *llut, *dlut;
  LongCodes<kLutBits + 1> llong;
  LongCodes<kDLutBits + 1> dlong;
  int nwp, stop, avail, off;
  bool active, expect;
  int pos, cnt = 0, eob_first = -1, status;
  // the register window: slice words rj .. rj + 2 in a, b, c, the next
  // two in d, e, loaded a step or more before they enter the window
  int rj;
  uint32_t a, b, c, d, e;

  __device__ __forceinline__ Cursor(int k, const uint32_t* __restrict__ words,
                                    const int32_t* __restrict__ cur, int K, int nwp_,
                                    const int32_t* __restrict__ tabs,
                                    const uint32_t* __restrict__ lents,
                                    const uint32_t* __restrict__ dents,
                                    const uint2* __restrict__ lut)
      : w(words + cur[k]),
        le(lents + static_cast<long long>(cur[6 * K + k]) * kLitRows),
        de(dents + static_cast<long long>(cur[6 * K + k]) * kDistRows),
        llut(lut + static_cast<long long>(cur[6 * K + k]) * ((1 << kLutBits) + (1 << kDLutBits))),
        dlut(llut + (1 << kLutBits)),
        llong(tabs + static_cast<long long>(cur[6 * K + k]) * kTab + kLC),
        dlong(tabs + static_cast<long long>(cur[6 * K + k]) * kTab + kDC),
        nwp(nwp_), stop(cur[2 * K + k]), avail(cur[3 * K + k]), off(cur[k] << 5),
        active(cur[4 * K + k] != 0), expect(cur[5 * K + k] != 0), pos(cur[K + k]) {
    status = active && pos < stop ? kRun : kStrideEnd;
    rj = min(max(pos >> 5, 0), nwp - 3);
    a = word(rj);
    b = word(rj + 1);
    c = word(rj + 2);
    d = word(rj + 3);
    e = word(rj + 4);
  }

  // word i of the slice; past its end, its last word (read, never used)
  __device__ __forceinline__ uint32_t word(int i) const { return __ldg(w + min(i, nwp - 1)); }

  // One step: decodes the symbol at pos and applies the stop rules.
  // Returns whether it makes a tape row, (tv, bv).  after_loads() runs once
  // both table loads are issued: a store put there waits in the memory
  // pipe behind them, not in front of them.
  template <class F>
  __device__ __forceinline__ bool step(int32_t& tv, int32_t& bv, F after_loads) {
    // The window starts at pos's word, clamped into the slice's last three
    // words; a symbol takes at most 60 bits, so it moves 0, 1 or 2 words.
    const int t = min(max(pos >> 5, 0), nwp - 3);
    const uint32_t sh = pos & 31;
    if (t != rj) {
      const bool one = t == rj + 1;
      const uint32_t na = one ? b : c, nb = one ? c : d, nc = one ? d : e;
      a = na;
      b = nb;
      c = nc;
      d = word(t + 3);
      e = word(t + 4);
      rj = t;
    }
    const uint32_t lo = __funnelshift_r(a, b, sh), hi = __funnelshift_r(b, c, sh);

    // literal/length symbol and its extra bits
    uint32_t ent;
    int len, jump1;  // jump1 at most 30
    const bool okl = decode_sym<kLutBits>(lo, llut, llong, le, kLitRows, ent, len, jump1);
    const int val = static_cast<int>(ent & 0x7FFF) +
                    static_cast<int>((lo >> len) & ((1u << extra_bits(ent)) - 1));
    const bool is_len = ent & kLen, is_eob = ent & kEobFlag;

    // the distance symbol and its extra bits: looked up for every symbol
    // (nothing for the warp to diverge on), used after a length
    const uint32_t w2 = __funnelshift_r(lo, hi, jump1), w2hi = hi >> jump1;
    const uint2 dl = __ldg(dlut + (w2 & ((1u << kDLutBits) - 1)));
    after_loads();
    uint32_t dent = dl.x;
    int dlen = static_cast<int>(dl.y & 0xFF), djump = static_cast<int>(dl.y >> 8);
    bool okd = true;
    if (is_len && dl.y == 0) {
      okd = dlong.decode(w2, de, kDistRows, dent, dlen);
      djump = dlen + extra_bits(dent);
    }
    const int dval = static_cast<int>(dent & 0x7FFF) +
                     static_cast<int>(__funnelshift_r(w2, w2hi, dlen) &
                                      ((1u << extra_bits(dent)) - 1));

    const bool bad = !okl || (ent & kInvalid) || (is_len && (!okd || (dent & kInvalid)));
    const int nxt = pos + jump1 + (is_len ? djump : 0);
    const bool oob = nxt > avail, real_eob = is_eob && expect;  // an EOB consumes its bits
    const bool row = !bad && !oob && !real_eob;
    status = bad ? kErr : oob ? kOob : real_eob ? kEob : nxt >= stop ? kStrideEnd : kRun;
    tv = static_cast<int32_t>(is_eob ? 1u << 26
                                     : static_cast<uint32_t>(val) |
                                           (static_cast<uint32_t>(is_len ? dval : 0) << 9) |
                                           (static_cast<uint32_t>(is_len) << 25));
    bv = pos + off;
    if (row && is_eob && eob_first < 0) eob_first = cnt;
    if (!bad && !oob) pos = nxt;
    return row;
  }
};

// Rows [from, cap) of the tapes of the warp's 32 cursors (a lane without a
// cursor passes from = cap) get tok 0 and bp kSent, written by the whole
// warp one row after another: coalesced 16-byte stores where the row is
// aligned.  (A lane filling its own tail when it stops would leave the
// warp to run 32 such loops one after another, each with one lane.)
__device__ __forceinline__ void fill_tails(int k, int from, int K, int cap,
                                           int32_t* __restrict__ tok, int32_t* __restrict__ bp) {
  const int lane = threadIdx.x & 31;
  for (int r = 0; r < 32; ++r) {
    const int kr = __shfl_sync(kFull, k, r), lo = __shfl_sync(kFull, from, r);
    if (kr >= K || lo >= cap) continue;
    int32_t* trow = tok + static_cast<long long>(kr) * cap;
    int32_t* brow = bp + static_cast<long long>(kr) * cap;
    int i = lo;
    if (((reinterpret_cast<uintptr_t>(trow) | reinterpret_cast<uintptr_t>(brow)) & 15) == 0) {
      const int h = min((lo + 3) & ~3, cap), groups = (cap - h) >> 2;
      if (lane < h - lo) {
        trow[lo + lane] = 0;
        brow[lo + lane] = kSent;
      }
      for (int q = lane; q < groups; q += 32) {
        reinterpret_cast<int4*>(trow + h)[q] = make_int4(0, 0, 0, 0);
        reinterpret_cast<int4*>(brow + h)[q] = make_int4(kSent, kSent, kSent, kSent);
      }
      i = h + 4 * groups;
    }
    for (int q = i + lane; q < cap; q += 32) {
      trow[q] = 0;
      brow[q] = kSent;
    }
  }
}

// One thread per cursor.  Where its tape rows are 16-byte aligned, a lane
// holds four rows in registers and stores them as one 16-byte store a
// tape, during the next step, once that step's table loads are issued (a
// store from 32 lanes to 32 rows delays the loads behind it); elsewhere it
// stores each value.  blockDim.x is a multiple of 32
// (every lane of a warp reaches the tail fill), at most kMaxThreads.
__global__ void __launch_bounds__(kMaxThreads)
inflate_decode_kernel(const uint32_t* __restrict__ words, const int32_t* __restrict__ cur,
                      int K, int nwp, int cap, const int32_t* __restrict__ tabs,
                      const uint32_t* __restrict__ lents, const uint32_t* __restrict__ dents,
                      const uint2* __restrict__ lut, int32_t* __restrict__ tok,
                      int32_t* __restrict__ bp, int32_t* __restrict__ fin) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  int cnt = cap;  // a lane without a cursor has no tail to write
  if (k < K) {
    Cursor cu(k, words, cur, K, nwp, tabs, lents, dents, lut);
    int32_t* trow = tok + static_cast<long long>(k) * cap;
    int32_t* brow = bp + static_cast<long long>(k) * cap;
    const bool vec = ((reinterpret_cast<uintptr_t>(trow) | reinterpret_cast<uintptr_t>(brow)) & 15) == 0;
    int4 tq = make_int4(0, 0, 0, 0), bq = tq;  // the open group of four rows
    int full = -1;  // a full group in tq, bq, not stored yet
    auto store_full = [&]() {
      if (full >= 0) {
        reinterpret_cast<int4*>(trow)[full] = tq;
        reinterpret_cast<int4*>(brow)[full] = bq;
        full = -1;
      }
    };
    for (int it = 0; it < cap && cu.status == kRun; ++it) {
      int32_t tv, bv;
      if (cu.step(tv, bv, store_full)) {
        const int n = cu.cnt++;
        if (vec) {
          const int s = n & 3;
          tq = make_int4(s == 0 ? tv : tq.x, s == 1 ? tv : tq.y, s == 2 ? tv : tq.z, tv);
          bq = make_int4(s == 0 ? bv : bq.x, s == 1 ? bv : bq.y, s == 2 ? bv : bq.z, bv);
          if (s == 3) full = n >> 2;
        } else {
          trow[n] = tv;
          brow[n] = bv;
        }
      }
    }
    cnt = cu.cnt;
    store_full();
    if (vec) {  // the open group's rows
      const int g = cnt & ~3;
      const int32_t ts[3] = {tq.x, tq.y, tq.z}, bs[3] = {bq.x, bq.y, bq.z};
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        if (g + q < cnt) {
          trow[g + q] = ts[q];
          brow[g + q] = bs[q];
        }
      }
    }
    fin[k] = cnt;
    fin[K + k] = cu.active ? cu.pos + cu.off : 0;
    fin[2 * K + k] = cu.status == kRun ? kErr : cu.status;  // still running: the tape overflowed
    fin[3 * K + k] = cu.eob_first;
  }
  fill_tails(k, cnt, K, cap, tok, bp);
}

}  // namespace

extern "C" int tz_inflate_lut(const void* tabs, const void* lents, const void* dents, int nblk,
                              int lbits, int dbits, void* lut, void* stream) {
  const long long n = static_cast<long long>(nblk) * ((1 << lbits) + (1 << dbits));
  const int grid = static_cast<int>((n + kLutThreads - 1) / kLutThreads);
  inflate_lut_kernel<<<grid, kLutThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(tabs), static_cast<const uint32_t*>(lents),
      static_cast<const uint32_t*>(dents), nblk, lbits, dbits, static_cast<uint2*>(lut));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tz_inflate_decode(const void* words, const void* cur, int K, int nwp, int cap,
                                 const void* tabs, const void* lents, const void* dents,
                                 const void* lut, int lbits, int dbits, int threads, void* tok,
                                 void* bp, void* fin, void* stream) {
  if (lbits != kLutBits || dbits != kDLutBits || threads % 32 || threads < 32 ||
      threads > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (K + threads - 1) / threads;
  inflate_decode_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const int32_t*>(cur), K, nwp, cap,
      static_cast<const int32_t*>(tabs), static_cast<const uint32_t*>(lents),
      static_cast<const uint32_t*>(dents), static_cast<const uint2*>(lut),
      static_cast<int32_t*>(tok), static_cast<int32_t*>(bp), static_cast<int32_t*>(fin));
  return static_cast<int>(cudaGetLastError());
}
