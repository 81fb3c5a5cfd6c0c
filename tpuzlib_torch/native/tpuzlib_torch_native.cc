// Host pieces of the port's inflate path (serial bitstream loops).
//
// Counterpart of the inflate entry points of tpuzlib/native/tpuzlib_native.cc,
// copied with the helpers they call and nothing else:
//   * tz_inflate_stream (with tz_state_new / tz_state_free) and
//     tz_inflate_raw: the serial raw-DEFLATE decoder of the host engine
//     (codec/engine.py, native/api.py), resumable mid-block from its state;
//   * tz_find_headers (with tz_scan_headers_range): full-stream dynamic-block
//     header discovery, the block planner's pass 1;
//   * tz_tokenize_midblock: the splice repair's bridge decoder;
//   * tz_inflate_tokenize: window-free tokenization of whole blocks (the
//     open-end tail, and the confirmation probe of the header scan);
//   * tz_expand_tokens: serial token-tape expansion (pass 3 on the host);
//   * tz_adler32, tz_crc32: the host checksums (kernels/adler32.py,
//     kernels/crc32.py), chained by seed.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread (native/bindings.py), at
// first use.  Exposed via ctypes.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {
constexpr int MAX_BITS = 15;
constexpr int LUT_SIZE = 1 << MAX_BITS;
constexpr uint32_t F_LEN = 1u << 23;
constexpr uint32_t F_EOB = 1u << 24;
constexpr uint32_t F_INVALID = 1u << 31;

const int32_t LENGTH_BASE[29] = {3,4,5,6,7,8,9,10,11,13,15,17,19,23,27,31,
                                 35,43,51,59,67,83,99,115,131,163,195,227,258};
const int32_t LENGTH_EXTRA[29] = {0,0,0,0,0,0,0,0,1,1,1,1,2,2,2,2,3,3,3,3,
                                  4,4,4,4,5,5,5,5,0};
const int32_t DIST_BASE[30] = {1,2,3,4,5,7,9,13,17,25,33,49,65,97,129,193,
                               257,385,513,769,1025,1537,2049,3073,4097,6145,
                               8193,12289,16385,24577};
const int32_t DIST_EXTRA[30] = {0,0,0,0,1,1,2,2,3,3,4,4,5,5,6,6,7,7,8,8,9,9,
                                10,10,11,11,12,12,13,13};
const int CLC_ORDER[19] = {16,17,18,0,8,7,9,6,10,5,11,4,12,3,13,2,14,1,15};

struct BitIn {
  const uint8_t* data;
  int64_t nbits;
  int64_t pos;
  bool ok;
  BitIn(const uint8_t* d, int64_t bits, int64_t start)
      : data(d), nbits(bits), pos(start), ok(true) {}
  inline uint64_t peek64() const {
    int64_t byte = pos >> 3;
    uint64_t w = 0;
    // safe unaligned little-endian load with tail clamp
    int64_t avail_bytes = ((nbits + 7) >> 3) - byte;
    if (avail_bytes >= 8) {
      memcpy(&w, data + byte, 8);
    } else if (avail_bytes > 0) {
      memcpy(&w, data + byte, (size_t)avail_bytes);
    }
    return w >> (pos & 7);
  }
  inline uint32_t bits(int n) {
    if (pos + n > nbits) { ok = false; return 0; }
    uint32_t v = (uint32_t)(peek64() & ((1u << n) - 1));
    pos += n;
    return v;
  }
  inline void align() { pos = (pos + 7) & ~7LL; }
};

// canonical-Huffman flat LUT build; kind 0=litlen 1=dist 2=codelen
// returns 0 ok, 1 oversubscribed, 2 incomplete.  The table is sized to the
// longest code actually present (*out_bits entries of 2^bits) so typical
// dynamic tables stay L1/L2-resident instead of a fixed 128 KiB.
int build_lut(const int32_t* lengths, int nsym, int kind, uint32_t* lut,
              int* out_bits) {
  int32_t counts[MAX_BITS + 1] = {0};
  int ncodes = 0;
  int max_len = 0;
  for (int s = 0; s < nsym; s++) {
    if (lengths[s] < 0 || lengths[s] > MAX_BITS) return 1;
    if (lengths[s] > 0) {
      counts[lengths[s]]++;
      ncodes++;
      if (lengths[s] > max_len) max_len = lengths[s];
    }
  }
  if (max_len == 0) max_len = 1;
  int lut_size = 1 << max_len;
  *out_bits = max_len;
  for (int i = 0; i < lut_size; i++) lut[i] = F_INVALID;
  if (ncodes == 0) return kind == 1 ? 0 : 2;
  int64_t kraft = 0;
  for (int b = 1; b <= MAX_BITS; b++) kraft += (int64_t)counts[b] << (MAX_BITS - b);
  if (kraft > LUT_SIZE) return 1;
  if (kraft < LUT_SIZE && !(ncodes == 1 && kind != 2)) return 2;
  uint32_t next_code[MAX_BITS + 2] = {0};
  uint32_t code = 0;
  for (int b = 1; b <= MAX_BITS; b++) {
    code = (code + counts[b - 1]) << 1;
    next_code[b] = code;
  }
  for (int s = 0; s < nsym; s++) {
    int l = lengths[s];
    if (l == 0) continue;
    uint32_t c = next_code[l]++;
    // bit-reverse l bits
    uint32_t rev = 0;
    for (int b = 0; b < l; b++) { rev = (rev << 1) | ((c >> b) & 1); }
    uint32_t ent;
    if (kind == 0) {
      if (s < 256) ent = (uint32_t)s;
      else if (s == 256) ent = F_EOB;
      else if (s <= 285) {
        int li = s - 257;
        ent = (uint32_t)LENGTH_BASE[li] | ((uint32_t)LENGTH_EXTRA[li] << 19) | F_LEN;
      } else ent = F_INVALID;
    } else if (kind == 1) {
      if (s <= 29) ent = (uint32_t)DIST_BASE[s] | ((uint32_t)DIST_EXTRA[s] << 19);
      else ent = F_INVALID;
    } else {
      ent = (uint32_t)s;
    }
    if (!(ent & F_INVALID)) ent |= (uint32_t)l << 15;
    else ent = F_INVALID;  // keep invalid marker clean
    for (uint32_t idx = rev; idx < (uint32_t)lut_size; idx += (1u << l)) lut[idx] = ent;
  }
  return 0;
}

// Fixed-tree decode tables, built eagerly at load time: a namespace-scope
// constructor is thread-safe, so threads that decode their first fixed
// block at once share one finished table.
struct FixedDecodeTables {
  uint32_t flit[1 << 9];
  uint32_t fdist[1 << 5];
  int flit_bits = 0, fdist_bits = 0;
  FixedDecodeTables() {
    int32_t ll[288];
    for (int i = 0; i < 144; i++) ll[i] = 8;
    for (int i = 144; i < 256; i++) ll[i] = 9;
    for (int i = 256; i < 280; i++) ll[i] = 7;
    for (int i = 280; i < 288; i++) ll[i] = 8;
    build_lut(ll, 288, 0, flit, &flit_bits);
    int32_t dl[32];
    for (int i = 0; i < 32; i++) dl[i] = 5;
    build_lut(dl, 32, 1, fdist, &fdist_bits);
  }
};
const FixedDecodeTables g_fixed_dec;

void fixed_tables(uint32_t* lit, uint32_t* dist, int* lit_bits,
                  int* dist_bits) {
  memcpy(lit, g_fixed_dec.flit, sizeof(g_fixed_dec.flit));
  memcpy(dist, g_fixed_dec.fdist, sizeof(g_fixed_dec.fdist));
  *lit_bits = g_fixed_dec.flit_bits;
  *dist_bits = g_fixed_dec.fdist_bits;
}

// The resumable decoder's state: the block's decode tables and mode
// persist across calls, so a stream fed in pieces continues mid-block.
struct TzState {
  uint32_t lit_lut[LUT_SIZE];
  uint32_t dist_lut[LUT_SIZE];
  int lit_bits;
  int dist_bits;
  int mode;  // 0=block header, 1=stored, 2=huffman, 3=done
  int last;
  int64_t stored_remaining;
};

}  // namespace

extern "C" {

void* tz_state_new() {
  TzState* st = new TzState();
  st->mode = 0;
  st->last = 0;
  st->stored_remaining = 0;
  return st;
}

void tz_state_free(void* p) { delete (TzState*)p; }

// error codes
// 0 ok; 1 need more input (truncated); 2 data error; 3 dst overflow
// On success or truncation, *out_len = bytes written, *consumed_bits set.
int tz_inflate_stream(void* state, const uint8_t* src, int64_t src_len,
                      int64_t start_bit, uint8_t* dst, int64_t dst_cap,
                      int64_t dict_len, int64_t* out_len,
                      int64_t* consumed_bits) {
  // dst buffer layout: dst[0..dict_len) preloaded with dictionary bytes;
  // new output begins at dict_len.  Window lookbacks go through dst.
  // The state persists Huffman tables + block mode so streaming callers
  // resume mid-block at symbol granularity (no partial-block re-decode).
  TzState* st = (TzState*)state;
  BitIn in(src, src_len * 8, start_bit);
  int64_t out = dict_len;
  uint32_t last = 0, btype = 0;
  uint32_t* lit_lut = st->lit_lut;
  uint32_t* dist_lut = st->dist_lut;
  uint32_t lit_mask, dist_mask;
  int64_t block_start = start_bit;
  int64_t block_start_out = out;

  if (st->mode == 3) { *out_len = 0; *consumed_bits = start_bit; return 0; }
  if (st->mode == 1) goto resume_stored;
  if (st->mode == 2) goto resume_huffman;

  for (;;) {
    block_start = in.pos;
    block_start_out = out;
    {
    last = in.bits(1);
    btype = in.bits(2);
    if (!in.ok) { in.pos = block_start; break; }
    if (btype == 3) { *out_len = out - dict_len; *consumed_bits = block_start; return 2; }
    if (btype == 0) {
      in.align();
      {
        uint32_t len = in.bits(16);
        uint32_t nlen = in.bits(16);
        if (!in.ok) { in.pos = block_start; break; }
        if (len != (~nlen & 0xFFFF)) { *out_len = out - dict_len; *consumed_bits = block_start; return 2; }
        st->stored_remaining = len;
        st->last = (int)last;
      }
      st->mode = 1;
resume_stored:
      {
        int64_t avail = src_len - (in.pos >> 3);
        int64_t take = st->stored_remaining < avail ? st->stored_remaining : avail;
        if (out + take > dst_cap) { *out_len = out - dict_len; *consumed_bits = in.pos; return 3; }
        if (take > 0) {
          memcpy(dst + out, src + (in.pos >> 3), (size_t)take);
          out += take;
          in.pos += take * 8;
          st->stored_remaining -= take;
        }
        if (st->stored_remaining > 0) {
          // need more input; resume in stored mode at a byte boundary
          *out_len = out - dict_len;
          *consumed_bits = in.pos;
          return 1;
        }
        st->mode = 0;
        if (st->last) { st->mode = 3; *out_len = out - dict_len; *consumed_bits = in.pos; return 0; }
        continue;
      }
    } else {
      if (btype == 1) {
        fixed_tables(lit_lut, dist_lut, &st->lit_bits, &st->dist_bits);
      } else {
        uint32_t hlit = in.bits(5) + 257;
        uint32_t hdist = in.bits(5) + 1;
        uint32_t hclen = in.bits(4) + 4;
        if (!in.ok) { in.pos = block_start; break; }
        if (hlit > 286 || hdist > 30) { *out_len = out - dict_len; *consumed_bits = block_start; return 2; }
        int32_t clc[19] = {0};
        for (uint32_t i = 0; i < hclen; i++) clc[CLC_ORDER[i]] = (int32_t)in.bits(3);
        if (!in.ok) { in.pos = block_start; break; }
        static thread_local uint32_t clc_lut[LUT_SIZE];
        int clc_bits;
        if (build_lut(clc, 19, 2, clc_lut, &clc_bits) != 0) { *out_len = out - dict_len; *consumed_bits = block_start; return 2; }
        const uint32_t clc_mask = (1u << clc_bits) - 1;
        int32_t lengths[286 + 30] = {0};
        uint32_t i = 0;
        while (i < hlit + hdist) {
          uint32_t ent = clc_lut[in.peek64() & clc_mask];
          if (ent & F_INVALID) { *out_len = out - dict_len; *consumed_bits = block_start; return in.pos + 7 >= in.nbits ? 1 : 2; }
          int nb = (ent >> 15) & 0xF;
          if (in.pos + nb > in.nbits) { in.pos = block_start; goto need_more; }
          uint32_t sym = ent & 0x7FFF;
          in.pos += nb;
          if (sym < 16) { lengths[i++] = (int32_t)sym; }
          else if (sym == 16) {
            if (i == 0) { *out_len = out - dict_len; *consumed_bits = block_start; return 2; }
            uint32_t rep = 3 + in.bits(2);
            if (!in.ok) { in.pos = block_start; goto need_more; }
            if (i + rep > hlit + hdist) { *out_len = out - dict_len; *consumed_bits = block_start; return 2; }
            int32_t prev = lengths[i - 1];
            for (uint32_t r = 0; r < rep; r++) lengths[i++] = prev;
          } else {
            uint32_t rep = sym == 17 ? 3 + in.bits(3) : 11 + in.bits(7);
            if (!in.ok) { in.pos = block_start; goto need_more; }
            if (i + rep > hlit + hdist) { *out_len = out - dict_len; *consumed_bits = block_start; return 2; }
            i += rep;  // zeros already there
          }
        }
        if (lengths[256] == 0) { *out_len = out - dict_len; *consumed_bits = block_start; return 2; }
        if (build_lut(lengths, (int)hlit, 0, lit_lut, &st->lit_bits) != 0) { *out_len = out - dict_len; *consumed_bits = block_start; return 2; }
        if (build_lut(lengths + hlit, (int)hdist, 1, dist_lut, &st->dist_bits) != 0) { *out_len = out - dict_len; *consumed_bits = block_start; return 2; }
      }
      st->mode = 2;
      st->last = (int)last;
resume_huffman:
      lit_mask = (1u << st->lit_bits) - 1;
      dist_mask = (1u << st->dist_bits) - 1;
      // symbol loop: a bounds-check-free fast loop while input has >=64
      // spare bits and output >=266 spare bytes (one unaligned 64-bit
      // load covers a whole len+dist token: 15+5+15+13 = 48 bits <= 57
      // usable after sub-byte shift), then the careful suspend/resume
      // path near the margins (reference infcodes.ts inflate_fast
      // :57-301 vs the per-symbol slow path :314-676).
      for (;;) {
        {
          const int64_t fast_in = in.nbits - 64;
          const int64_t fast_out = dst_cap - 266;
          while (in.pos <= fast_in && out <= fast_out) {
            uint64_t w;
            memcpy(&w, in.data + (in.pos >> 3), 8);
            w >>= (in.pos & 7);
            uint32_t ent = lit_lut[w & lit_mask];
            if (ent & F_INVALID) {
              *out_len = out - dict_len; *consumed_bits = in.pos; return 2;
            }
            int nb = (ent >> 15) & 0xF;
            if (!(ent & (F_EOB | F_LEN))) {
              dst[out++] = (uint8_t)(ent & 0xFF);
              in.pos += nb;
              // second literal from the same load (<=30 bits used)
              w >>= nb;
              ent = lit_lut[w & lit_mask];
              if (!(ent & (F_INVALID | F_EOB | F_LEN))) {
                dst[out++] = (uint8_t)(ent & 0xFF);
                in.pos += (ent >> 15) & 0xF;
              }
              continue;
            }
            if (ent & F_EOB) { in.pos += nb; goto end_of_block; }
            int eb = (ent >> 19) & 0xF;
            int32_t length = (int32_t)(ent & 0x7FFF) +
                             (int32_t)((w >> nb) & ((1u << eb) - 1));
            int adv = nb + eb;
            uint32_t dent = dist_lut[(w >> adv) & dist_mask];
            if (dent & F_INVALID) {
              *out_len = out - dict_len; *consumed_bits = in.pos; return 2;
            }
            int dnb = (dent >> 15) & 0xF;
            int deb = (dent >> 19) & 0xF;
            int32_t dist = (int32_t)(dent & 0x7FFF) +
                           (int32_t)((w >> (adv + dnb)) & ((1u << deb) - 1));
            in.pos += adv + dnb + deb;
            if (dist > out) {
              *out_len = out - dict_len; *consumed_bits = in.pos; return 2;
            }
            const uint8_t* from = dst + out - dist;
            uint8_t* to = dst + out;
            out += length;
            if (dist >= 8) {
              // 8-byte chunked copy; may write up to 7 bytes past the
              // match end — the 266-byte output margin covers it
              for (int32_t j = 0; j < length; j += 8) {
                uint64_t v; memcpy(&v, from + j, 8); memcpy(to + j, &v, 8);
              }
            } else if (dist == 1) {
              memset(to, from[0], (size_t)length);
            } else {
              for (int32_t j = 0; j < length; j++) to[j] = from[j];
            }
          }
        }
        // careful path (input or output margin exhausted): one symbol
        {
        uint64_t w = in.peek64();
        uint32_t ent = lit_lut[w & lit_mask];
        if (ent & F_INVALID) {
          if (in.pos + MAX_BITS >= in.nbits) goto need_more_symbol;
          *out_len = out - dict_len; *consumed_bits = in.pos; return 2;
        }
        int nb = (ent >> 15) & 0xF;
        int eb = (ent >> 19) & 0xF;
        if (in.pos + nb + eb > in.nbits) goto need_more_symbol;
        if (ent & F_EOB) { in.pos += nb; break; }
        if (!(ent & F_LEN)) {
          if (out >= dst_cap) { *out_len = out - dict_len; *consumed_bits = in.pos; return 3; }
          dst[out++] = (uint8_t)(ent & 0xFF);
          in.pos += nb;
          continue;
        }
        int32_t length = (int32_t)(ent & 0x7FFF) + (int32_t)((w >> nb) & ((1u << eb) - 1));
        int adv = nb + eb;
        uint32_t dent = dist_lut[(w >> adv) & dist_mask];
        if (dent & F_INVALID) {
          if (in.pos + adv + MAX_BITS >= in.nbits) goto need_more_symbol;
          *out_len = out - dict_len; *consumed_bits = in.pos; return 2;
        }
        int dnb = (dent >> 15) & 0xF;
        int deb = (dent >> 19) & 0xF;
        if (in.pos + adv + dnb + deb > in.nbits) goto need_more_symbol;
        int32_t dist = (int32_t)(dent & 0x7FFF) +
                       (int32_t)((w >> (adv + dnb)) & ((1u << deb) - 1));
        if (dist > out) { *out_len = out - dict_len; *consumed_bits = in.pos; return 2; }
        if (out + length > dst_cap) {
          // overflow BEFORE consuming the symbol: callers resume at
          // consumed_bits with a larger buffer and must re-see this token
          *out_len = out - dict_len; *consumed_bits = in.pos; return 3;
        }
        in.pos += adv + dnb + deb;
        const uint8_t* from = dst + out - dist;
        uint8_t* to = dst + out;
        out += length;
        if (dist >= length) {
          memcpy(to, from, (size_t)length);
        } else if (dist >= 8 && out + 8 <= dst_cap) {
          for (int32_t j = 0; j < length; j += 8) {
            uint64_t v; memcpy(&v, from + j, 8); memcpy(to + j, &v, 8);
          }
        } else {
          for (int32_t j = 0; j < length; j++) to[j] = from[j];
        }
        }
      }
end_of_block:;
    }
    }
    st->mode = 0;
    if (st->last) { st->mode = 3; *out_len = out - dict_len; *consumed_bits = in.pos; return 0; }
  }
need_more:
  // header-stage truncation: resume at the block start
  st->mode = 0;
  *out_len = out - dict_len;
  *consumed_bits = block_start;
  return 1;
need_more_symbol:
  // mid-block truncation: tables live in the state; resume at this symbol
  *out_len = out - dict_len;
  *consumed_bits = in.pos;
  return 1;
}

int tz_inflate_raw(const uint8_t* src, int64_t src_len, int64_t start_bit,
                   uint8_t* dst, int64_t dst_cap, int64_t dict_len,
                   int64_t* out_len, int64_t* consumed_bits) {
  static thread_local TzState st;
  st.mode = 0;
  st.last = 0;
  st.stored_remaining = 0;
  return tz_inflate_stream(&st, src, src_len, start_bit, dst, dst_cap,
                           dict_len, out_len, consumed_bits);
}


// Window-free tokenization for speculative parallel inflate: decode
// symbols from start_bit into a token tape (no output buffer, no window
// needed), stopping at the first block boundary at/after stop_bit or at
// the final block.  Returns token count; *end_bit/*finished report the
// chain position.  status: 0 ok, 2 data error, 3 tape overflow.
int64_t tz_inflate_tokenize(const uint8_t* src, int64_t src_len,
                            int64_t start_bit, int64_t stop_bit,
                            int32_t* out_litlen, int32_t* out_dist,
                            int64_t tape_cap, int64_t* end_bit,
                            int32_t* finished, int32_t* status) {
  BitIn in(src, src_len * 8, start_bit);
  static thread_local uint32_t lit_lut[LUT_SIZE];
  static thread_local uint32_t dist_lut[LUT_SIZE];
  int lit_bits = MAX_BITS, dist_bits = MAX_BITS;
  int64_t ntok = 0;
  *finished = 0;
  *status = 0;
  for (;;) {
    int64_t block_start = in.pos;
    uint32_t last = in.bits(1);
    uint32_t btype = in.bits(2);
    if (!in.ok || btype == 3) { *status = 2; *end_bit = block_start; return ntok; }
    if (btype == 0) {
      in.align();
      uint32_t len = in.bits(16);
      uint32_t nlen = in.bits(16);
      if (!in.ok || len != (~nlen & 0xFFFF)) { *status = 2; *end_bit = block_start; return ntok; }
      if ((in.pos >> 3) + len > (uint64_t)src_len) { *status = 2; *end_bit = block_start; return ntok; }
      if (ntok + (int64_t)len > tape_cap) { *status = 3; *end_bit = block_start; return ntok; }
      const uint8_t* p = src + (in.pos >> 3);
      for (uint32_t j = 0; j < len; j++) { out_litlen[ntok] = p[j]; out_dist[ntok] = 0; ntok++; }
      in.pos += (int64_t)len * 8;
    } else {
      if (btype == 1) {
        fixed_tables(lit_lut, dist_lut, &lit_bits, &dist_bits);
      } else {
        uint32_t hlit = in.bits(5) + 257;
        uint32_t hdist = in.bits(5) + 1;
        uint32_t hclen = in.bits(4) + 4;
        if (!in.ok || hlit > 286 || hdist > 30) { *status = 2; *end_bit = block_start; return ntok; }
        int32_t clc[19] = {0};
        for (uint32_t i = 0; i < hclen; i++) clc[CLC_ORDER[i]] = (int32_t)in.bits(3);
        if (!in.ok) { *status = 2; *end_bit = block_start; return ntok; }
        static thread_local uint32_t clc_lut[LUT_SIZE];
        int clc_bits;
        if (build_lut(clc, 19, 2, clc_lut, &clc_bits) != 0) { *status = 2; *end_bit = block_start; return ntok; }
        const uint32_t clc_mask = (1u << clc_bits) - 1;
        int32_t lengths[286 + 30] = {0};
        uint32_t i = 0;
        while (i < hlit + hdist) {
          uint32_t ent = clc_lut[in.peek64() & clc_mask];
          if (ent & F_INVALID) { *status = 2; *end_bit = block_start; return ntok; }
          int nb = (ent >> 15) & 0xF;
          if (in.pos + nb > in.nbits) { *status = 2; *end_bit = block_start; return ntok; }
          uint32_t sym = ent & 0x7FFF;
          in.pos += nb;
          if (sym < 16) { lengths[i++] = (int32_t)sym; }
          else if (sym == 16) {
            if (i == 0) { *status = 2; *end_bit = block_start; return ntok; }
            uint32_t rep = 3 + in.bits(2);
            if (!in.ok || i + rep > hlit + hdist) { *status = 2; *end_bit = block_start; return ntok; }
            int32_t prev = lengths[i - 1];
            for (uint32_t r = 0; r < rep; r++) lengths[i++] = prev;
          } else {
            uint32_t rep = sym == 17 ? 3 + in.bits(3) : 11 + in.bits(7);
            if (!in.ok || i + rep > hlit + hdist) { *status = 2; *end_bit = block_start; return ntok; }
            i += rep;
          }
        }
        if (lengths[256] == 0 ||
            build_lut(lengths, (int)hlit, 0, lit_lut, &lit_bits) != 0 ||
            build_lut(lengths + hlit, (int)hdist, 1, dist_lut, &dist_bits) != 0) {
          *status = 2; *end_bit = block_start; return ntok;
        }
      }
      const uint32_t lit_mask = (1u << lit_bits) - 1;
      const uint32_t dist_mask = (1u << dist_bits) - 1;
      for (;;) {
        uint64_t w = in.peek64();
        uint32_t ent = lit_lut[w & lit_mask];
        if (ent & F_INVALID) { *status = 2; *end_bit = in.pos; return ntok; }
        int nb = (ent >> 15) & 0xF;
        int eb = (ent >> 19) & 0xF;
        if (in.pos + nb + eb > in.nbits) { *status = 2; *end_bit = in.pos; return ntok; }
        if (ent & F_EOB) { in.pos += nb; break; }
        if (ntok >= tape_cap) { *status = 3; *end_bit = in.pos; return ntok; }
        if (!(ent & F_LEN)) {
          out_litlen[ntok] = (int32_t)(ent & 0xFF);
          out_dist[ntok] = 0;
          ntok++;
          in.pos += nb;
          continue;
        }
        int32_t length = (int32_t)(ent & 0x7FFF) + (int32_t)((w >> nb) & ((1u << eb) - 1));
        int adv = nb + eb;
        uint32_t dent = dist_lut[(w >> adv) & dist_mask];
        if (dent & F_INVALID) { *status = 2; *end_bit = in.pos; return ntok; }
        int dnb = (dent >> 15) & 0xF;
        int deb = (dent >> 19) & 0xF;
        if (in.pos + adv + dnb + deb > in.nbits) { *status = 2; *end_bit = in.pos; return ntok; }
        int32_t dist = (int32_t)(dent & 0x7FFF) +
                       (int32_t)((w >> (adv + dnb)) & ((1u << deb) - 1));
        in.pos += adv + dnb + deb;
        out_litlen[ntok] = length;
        out_dist[ntok] = dist;
        ntok++;
      }
    }
    if (last) { *finished = 1; *end_bit = in.pos; return ntok; }
    if (in.pos >= stop_bit) { *end_bit = in.pos; return ntok; }
  }
}

// Mid-block tokenize with caller-supplied code lengths (the splice
// repair's bridge decoder): the serial O(symbols) walk from a known chain
// position with the block's already-parsed tables.  Returns ntok; *hit_eob=1 when the block's EOB was
// consumed (end_bit then points past it); *status: 0 ok (cap reached
// or EOB), 2 data error/truncation.
int64_t tz_tokenize_midblock(const uint8_t* src, int64_t src_len,
                             int64_t start_bit,
                             const int32_t* litlens, int32_t nlit,
                             const int32_t* distlens, int32_t ndist,
                             int32_t* out_litlen, int32_t* out_dist,
                             int64_t cap, int64_t* end_bit,
                             int32_t* hit_eob, int32_t* status) {
  *hit_eob = 0;
  *status = 0;
  static thread_local uint32_t lit_lut[LUT_SIZE];
  static thread_local uint32_t dist_lut[LUT_SIZE];
  static thread_local int32_t cached_lit[288], cached_dist[32];
  static thread_local int32_t cached_nlit = -1, cached_ndist = -1;
  static thread_local int lit_bits = 0, dist_bits = 0;
  bool same = cached_nlit == nlit && cached_ndist == ndist;
  if (same) {
    for (int s = 0; s < nlit && same; s++) same = cached_lit[s] == litlens[s];
    for (int s = 0; s < ndist && same; s++)
      same = cached_dist[s] == distlens[s];
  }
  if (!same) {
    if (build_lut(litlens, nlit, 0, lit_lut, &lit_bits) != 0 ||
        build_lut(distlens, ndist, 1, dist_lut, &dist_bits) != 0) {
      *status = 2;
      *end_bit = start_bit;
      return 0;
    }
    cached_nlit = nlit;
    cached_ndist = ndist;
    for (int s = 0; s < nlit; s++) cached_lit[s] = litlens[s];
    for (int s = 0; s < ndist; s++) cached_dist[s] = distlens[s];
  }
  BitIn in(src, src_len * 8, start_bit);
  const uint32_t lit_mask = (1u << lit_bits) - 1;
  const uint32_t dist_mask = (1u << dist_bits) - 1;
  int64_t ntok = 0;
  while (ntok < cap) {
    uint64_t w = in.peek64();
    uint32_t ent = lit_lut[w & lit_mask];
    if (ent & F_INVALID) { *status = 2; *end_bit = in.pos; return ntok; }
    int nb = (ent >> 15) & 0xF;
    int eb = (ent >> 19) & 0xF;
    if (in.pos + nb + eb > in.nbits) { *status = 2; *end_bit = in.pos; return ntok; }
    if (ent & F_EOB) { in.pos += nb; *hit_eob = 1; break; }
    if (!(ent & F_LEN)) {
      out_litlen[ntok] = (int32_t)(ent & 0xFF);
      out_dist[ntok] = 0;
      ntok++;
      in.pos += nb;
      continue;
    }
    int32_t length = (int32_t)(ent & 0x7FFF) +
                     (int32_t)((w >> nb) & ((1u << eb) - 1));
    int adv = nb + eb;
    uint32_t dent = dist_lut[(w >> adv) & dist_mask];
    if (dent & F_INVALID) { *status = 2; *end_bit = in.pos; return ntok; }
    int dnb = (dent >> 15) & 0xF;
    int deb = (dent >> 19) & 0xF;
    if (in.pos + adv + dnb + deb > in.nbits) {
      *status = 2; *end_bit = in.pos; return ntok;
    }
    int32_t dist = (int32_t)(dent & 0x7FFF) +
                   (int32_t)((w >> (adv + dnb)) & ((1u << deb) - 1));
    in.pos += adv + dnb + deb;
    out_litlen[ntok] = length;
    out_dist[ntok] = dist;
    ntok++;
  }
  *end_bit = in.pos;
  return ntok;
}

// Full-stream dynamic-block header scan (the block planner's pass 1;
// python counterpart: parallel/speculative.find_all_block_starts).
// For every bit position: cheap field checks (BTYPE==10, HLIT/HDIST in
// range, optional BFINAL==0), the code-length-code Kraft-completeness
// test (rapidgzip-style reject), then CONFIRMATION by a bounded decode
// through tz_inflate_tokenize (a real header parses and yields >=8
// symbols or overflows a 64-token cap).  Returns the number of
// confirmed header bit positions written to out_pos.
static int64_t tz_scan_headers_range(const uint8_t* src, int64_t src_len,
                                     int64_t from_bit, int64_t to_bit,
                                     int32_t allow_final,
                                     int64_t* out_pos, int64_t cap) {
  const int64_t nbits = src_len * 8;
  int64_t found = 0;
  // bound keeps both 8-byte memcpy windows in range (a real dynamic
  // header + EOB needs >100 bits, so nothing is missed at the tail)
  for (int64_t bit = from_bit; bit < to_bit && bit + 81 <= nbits; bit++) {
    const int64_t byte = bit >> 3;
    const int s = (int)(bit & 7);
    uint64_t w0;
    memcpy(&w0, src + byte, 8);
    const uint32_t w = (uint32_t)(w0 >> s);
    if (((w >> 1) & 3) != 2) continue;
    if (!allow_final && (w & 1)) continue;
    const uint32_t hlit = (w >> 3) & 31;
    const uint32_t hdist = (w >> 8) & 31;
    if (hlit > 29 || hdist > 29) continue;
    const int hclen = (int)((w >> 13) & 15) + 4;
    // 19 CLC entries start at bit+17 and span <=57 bits: one u64 window
    const int64_t cb = bit + 17;
    uint64_t k0;
    memcpy(&k0, src + (cb >> 3), 8);
    const uint64_t k = k0 >> (cb & 7);
    int kraft = 0, nz = 0;
    for (int j = 0; j < hclen; j++) {
      const int lj = (int)((k >> (3 * j)) & 7);
      if (lj) { kraft += 1 << (7 - lj); nz++; }
    }
    if (kraft != 128 || nz < 2) continue;
    int32_t ll[64], dd[64];
    int64_t eb;
    int32_t fin, st;
    int64_t n = tz_inflate_tokenize(src, src_len, bit, bit + 1, ll, dd, 64,
                                    &eb, &fin, &st);
    // confirm: tape overflow (plenty of symbols parse) OR a clean parse
    // of >=8 symbols OR a clean bounded parse straight through the final
    // EOB — the last case covers genuine tiny final blocks (<8 symbols),
    // which a count-only rule would silently never discover 
    if (st == 3 || (st == 0 && (n >= 8 || fin))) {
      out_pos[found++] = bit;
      if (found >= cap) return found;
    }
  }
  return found;
}

int64_t tz_find_headers(const uint8_t* src, int64_t src_len,
                        int64_t from_bit, int32_t allow_final,
                        int64_t* out_pos, int64_t cap) {
  const int64_t nbits = src_len * 8;
  // the scan is embarrassingly parallel per bit position (confirmation
  // decodes read the GLOBAL stream, so range splits have no boundary
  // effects): split across hardware threads for streams long enough to
  // amortize thread startup; at most 4 threads
  int nt = (int)std::thread::hardware_concurrency();
  if (nt > 4) nt = 4;
  if (nt < 2 || nbits - from_bit < (1 << 21)) {
    return tz_scan_headers_range(src, src_len, from_bit, nbits, allow_final,
                                 out_pos, cap);
  }
  std::vector<std::vector<int64_t>> parts(nt);
  std::vector<std::thread> threads;
  const int64_t span = (nbits - from_bit + nt - 1) / nt;
  for (int t = 0; t < nt; t++) {
    const int64_t lo = from_bit + t * span;
    const int64_t hi = std::min(lo + span, nbits);
    threads.emplace_back([&, t, lo, hi]() {
      std::vector<int64_t>& mine = parts[t];
      mine.resize((size_t)cap);
      int64_t n = tz_scan_headers_range(src, src_len, lo, hi, allow_final,
                                        mine.data(), cap);
      mine.resize((size_t)n);
    });
  }
  for (auto& th : threads) th.join();
  int64_t found = 0;
  for (int t = 0; t < nt; t++) {
    for (int64_t p : parts[t]) {
      out_pos[found++] = p;
      if (found >= cap) return found;
    }
  }
  return found;
}

// Token-tape expansion: the serial host counterpart of the device
// pointer-doubling expansion (kernels/inflate_device2.make_expand_v2).  dst[0..dict_len) holds
// window context; returns output length (excluding context) or -1 on
// overflow / -2 on invalid distance.
int64_t tz_expand_tokens(const int32_t* litlen, const int32_t* dist,
                         int64_t ntok, uint8_t* dst, int64_t dst_cap,
                         int64_t dict_len) {
  int64_t out = dict_len;
  for (int64_t t = 0; t < ntok; t++) {
    int32_t d = dist[t];
    if (d == 0) {
      if (out >= dst_cap) return -1;
      dst[out++] = (uint8_t)litlen[t];
      continue;
    }
    int32_t len = litlen[t];
    if (d > out) return -2;
    if (out + len > dst_cap) return -1;
    const uint8_t* from = dst + out - d;
    uint8_t* to = dst + out;
    out += len;
    if (d >= len) {
      memcpy(to, from, (size_t)len);
    } else if (d >= 8 && out + 8 <= dst_cap) {
      for (int32_t j = 0; j < len; j += 8) {
        uint64_t v; memcpy(&v, from + j, 8); memcpy(to + j, &v, 8);
      }
    } else {
      for (int32_t j = 0; j < len; j++) to[j] = from[j];
    }
  }
  return out - dict_len;
}

// ---------------------------------------------------------------------------
// Host checksums: serial-stream mirrors of the device kernels
// (kernels/adler32.py, kernels/crc32.py).  Seed-chainable like the
// reference API (adler32.ts:17, crc32.ts:17).
// ---------------------------------------------------------------------------

uint32_t tz_adler32(const uint8_t* p, int64_t n, uint32_t seed) {
  constexpr uint32_t BASE = 65521;
  constexpr int64_t NMAX = 5552;  // max bytes before s2 can overflow u32
  uint32_t s1 = seed & 0xFFFF;
  uint32_t s2 = (seed >> 16) & 0xFFFF;
  int64_t i = 0;
  while (i < n) {
    int64_t blk = n - i < NMAX ? n - i : NMAX;
    int64_t j = 0;
    for (; j + 16 <= blk; j += 16) {
      const uint8_t* q = p + i + j;
      for (int k = 0; k < 16; k++) { s1 += q[k]; s2 += s1; }
    }
    for (; j < blk; j++) { s1 += p[i + j]; s2 += s1; }
    s1 %= BASE;
    s2 %= BASE;
    i += blk;
  }
  return (s2 << 16) | s1;
}

namespace {
struct CrcTables {
  uint32_t t[8][256];
  CrcTables() {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      t[0][i] = c;
    }
    for (int s = 1; s < 8; s++)
      for (uint32_t i = 0; i < 256; i++)
        t[s][i] = t[0][t[s - 1][i] & 0xFF] ^ (t[s - 1][i] >> 8);
  }
};
const CrcTables g_crc;
}  // namespace

uint32_t tz_crc32(const uint8_t* p, int64_t n, uint32_t seed) {
  uint32_t c = ~seed;
  int64_t i = 0;
  // slice-by-8
  for (; i + 8 <= n; i += 8) {
    uint32_t lo, hi;
    memcpy(&lo, p + i, 4);
    memcpy(&hi, p + i + 4, 4);
    lo ^= c;
    c = g_crc.t[7][lo & 0xFF] ^ g_crc.t[6][(lo >> 8) & 0xFF] ^
        g_crc.t[5][(lo >> 16) & 0xFF] ^ g_crc.t[4][lo >> 24] ^
        g_crc.t[3][hi & 0xFF] ^ g_crc.t[2][(hi >> 8) & 0xFF] ^
        g_crc.t[1][(hi >> 16) & 0xFF] ^ g_crc.t[0][hi >> 24];
  }
  for (; i < n; i++) c = g_crc.t[0][(c ^ p[i]) & 0xFF] ^ (c >> 8);
  return ~c;
}

}  // extern "C"
