// The inflate primitive probe kernels: the steps the TPU decode kernel was
// built from, each alone, over L lanes (a lane is a column, as a cursor
// was a lane of the TPU kernel; the tools run 128).
//
// Replace the Pallas kernels of tools/probe_inflate_prims.py and
// probe_inflate_prims2.py:
//   vec_cond_while     :81 k_c, a while loop on one condition for the whole
//                      vector (any lane below 100, fewer than 64 steps),
//                      adding 1 to each lane below 100 a step;
//   fetch_rows         :105 k_d, words[j + i] for i < k (the tool's k = 3),
//                      0 outside the rows;
//   row_store_loop     :58 k_b, row `it` of the output set to `it` in step
//                      `it` of a loop;
//   gather_store_loop  :131 k_e, a loop that stores words[j] to row `it`
//                      and steps j to (j + 3) mod (nw - 1);
//   col_min_sum        prims2 :46 k_f, each column's min and int32 sum;
//   var_shifts         prims2 :58 k_g, r >> (16 - L) for L < 16 and the
//                      mask (1 << e) - 1 in uint32;
//   tree_decode        prims2 :82 k_h, the counting decode over 16 code
//                      lengths of a 16-bit window (bit-reversed);
//   window64           prims2 :139 k_j, a 64-bit window from three words
//                      at a bit shift, and its re-window.
// k_a (:50) and k_i (prims2 :115) are take_along on axis 0
// (gather_probe.cu).  k_d, k_e and k_i select their word by a where-chain
// over 8-row tiles, a TPU workaround; here each lane loads its word, and a
// row outside [0, nw) gives 0 as the chain did.  Every lane's arithmetic
// is the tools' in 32 bits: sums add as unsigned (the int32 wrap), a shift
// of a uint32 by 32 or more gives 0, and k_j's selects for a shift of 0
// stay (w << 32 is undefined in C++).
//
// Bounds (H100 SXM): a few words a lane in and out, so at the tools' 128
// lanes and at 8,192 (the TPU decode's cursors) every kernel is held by
// its launch.  Designs: one thread a lane, rows a loop inside it, stores
// coalesced across lanes.
//
// gather_store_loop, col_min_sum, fetch_rows and tree_decode are held by
// the round trips to the L2 inside the launch: each step or row is a
// load.  A thread computes a chunk of 16 steps' rows in registers, from
// one floor mod and then one add and compare a step on offsets summed
// beforehand (no division and no chain of steps), or takes 16 rows, or
// fetch_rows' rows j + i after j's load (4 at a time, the last chunk
// predicated), and issues all their loads through the read-only path
// before it uses any, so a chunk of steps or rows costs one round trip.  tree_decode loads w and rows
// 1-15 of its three tables (row 0 is never selected) before any compare
// and selects the rank in registers, so it makes one round trip where a
// load at the selected row would make a second.  Their grids
// spread the lanes over every SM (blocks of 64 threads at 8,192 lanes,
// 128 blocks), and up to 128 lanes are one block.
//
// vec_cond_while is one CUDA block that holds every lane and tests the
// condition with __syncthreads_or, since lanes in different blocks could
// not share it.  Its 64 steps depend on each other through that vote, so
// the steps' latency holds it, not its bytes or adds: a step that goes
// through device memory (each lane loaded and stored again before the
// vote) took ~1,660 cycles on an H100.  So the lanes stay on the SM: each
// thread keeps its lanes in registers across the steps, up to kRegs a
// thread (8,192 lanes in a block of 1,024; route "regs"); more lanes, up
// to the shared memory a block may opt in to, live in shared memory
// (route "smem"); past that each step goes through device memory (route
// "global").  A step is then the adds and the one vote, and `out` is
// written once, at the end.  The loop stays: one min over the lanes and
// one pass would compute the same function in closed form, but it would
// not be the primitive, a vector while loop on one condition, that the
// probe exists to measure.

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kOneBlock = 128;  // lanes up to which a grid spread over the SMs is one block
constexpr int kChunk = 16;      // steps or rows whose loads a thread issues together
constexpr int kFetchChunk = 4;  // fetch_rows: rows whose loads a thread issues together
constexpr int kWhileThreads = 1024;  // vec_cond_while's one block
constexpr int kRegs = 8;  // vec_cond_while: lanes a thread keeps in registers
constexpr int kLimit = 100, kMaxSteps = 64;  // k_c's condition

__host__ __device__ __forceinline__ unsigned blocks_for(int lanes) {
  return static_cast<unsigned>((lanes + kThreads - 1) / kThreads);
}

// threads a block for a kernel of a thread a lane: one block (whole
// warps) up to kOneBlock lanes; past that the fewest, a power of two from
// 32 up to kThreads, that spread the lanes over every SM
int spread_threads(int lanes, int sms) {
  if (lanes <= kOneBlock) return (lanes + 31) / 32 * 32;
  const int per = (lanes + sms - 1) / sms;
  int t = 32;
  while (t < per && t < kThreads) t *= 2;
  return t;
}

__device__ __forceinline__ uint32_t shr(uint32_t x, uint32_t s) { return s < 32u ? x >> s : 0u; }
__device__ __forceinline__ uint32_t shl(uint32_t x, uint32_t s) { return s < 32u ? x << s : 0u; }

// route "regs": lane t + r * blockDim.x of each thread in v[r]; a lane
// past the input starts at the limit, so it never votes and never moves
template <int R>
__global__ void __launch_bounds__(kWhileThreads)
vec_cond_while_regs_kernel(const int32_t* __restrict__ x, int lanes, int32_t* __restrict__ out) {
  int32_t v[R];
  int below = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int l = threadIdx.x + r * blockDim.x;
    v[r] = l < lanes ? x[l] : kLimit;
    below |= v[r] < kLimit;
  }
  // a lane's step is a compare and a predicated add, written in PTX: from
  // `v += v < kLimit` or `if (v < kLimit) ++v` ptxas makes an add, a
  // select and a copy a lane, and the steps ran 1.27x longer at 8,192
  // lanes on an H100; the vote is one min (ptxas: a 3-input min) for two lanes
  for (int it = 0; __syncthreads_or(below) && it < kMaxSteps; ++it) {
    int32_t m = kLimit;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      asm("{\n\t.reg .pred p;\n\tsetp.lt.s32 p, %0, %1;\n\t@p add.s32 %0, %0, 1;\n\t}"
          : "+r"(v[r])
          : "n"(kLimit));
      m = min(m, v[r]);
    }
    below = m < kLimit;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int l = threadIdx.x + r * blockDim.x;
    if (l < lanes) out[l] = v[r];
  }
}

// routes "smem" (lanes in dynamic shared memory) and "global" (lanes in
// `out`, each step loading and storing them): a thread reads and writes
// only its own lanes, and the vote's barrier orders the steps
template <bool Shared>
__global__ void __launch_bounds__(kWhileThreads)
vec_cond_while_kernel(const int32_t* __restrict__ x, int lanes, int32_t* __restrict__ out) {
  extern __shared__ int32_t staged[];
  int32_t* v = Shared ? staged : out;
  int below = 0;
  for (int l = threadIdx.x; l < lanes; l += kWhileThreads) {
    const int32_t a = x[l];
    v[l] = a;
    below |= a < kLimit;
  }
  for (int it = 0; __syncthreads_or(below) && it < kMaxSteps; ++it) {
    below = 0;
    for (int l = threadIdx.x; l < lanes; l += kWhileThreads) {
      int32_t a = v[l];
      a += a < kLimit;
      v[l] = a;
      below |= a < kLimit;
    }
  }
  if (Shared) {
    for (int l = threadIdx.x; l < lanes; l += kWhileThreads) out[l] = v[l];
  }
}

__global__ void __launch_bounds__(kThreads)
row_store_loop_kernel(int rows, int lanes, int32_t* __restrict__ out) {
  const int l = blockIdx.x * kThreads + threadIdx.x;
  if (l >= lanes) return;
  for (int it = 0; it < rows; ++it) out[static_cast<long long>(it) * lanes + l] = it;
}

// ---- gather_store_loop and col_min_sum: a lane's loads all in flight -------
//
// A chunk of kChunk steps (gather_store_loop) or rows (col_min_sum) is
// loaded, every load issued, before the first of them is used: one round
// trip to the L2 a chunk.  gather_store_loop's rows come first, from
// registers: step 0 reads row j0 (0 outside [0, nw)); step t >= 1 row
// (r1 + (t - 1) s) mod m, where m = nw - 1, r1 = floor_mod(wrap32(j0 + 3),
// m) and s = 3 mod m, which is the tool's (j + 3) mod m a step.  The
// offsets d[k] = k s mod m are the same for every lane and are summed
// while j's load is in flight; a step's row is then one add_mod of its
// chunk's first row and its offset, no step waits on the one before, and
// the chunks' first rows step by 16 s mod m.  All values lie in [0, m), so
// no sum wraps and no range check is left after step 0.

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b, uint32_t m) {
  const uint32_t t = a + b;
  return t >= m ? t - m : t;
}

// steps t0 .. t0 + kChunk - 1 (those before `steps` where Tail): their
// rows, then their loads, then their stores; `base` is the row of step t0
// (of step 1 in the first chunk, whose step 0 reads j0)
template <bool First, bool Tail>
__device__ __forceinline__ void store_chunk(const int32_t* __restrict__ col, int nw, int lanes,
                                            int t0, int steps, int32_t j0, uint32_t base,
                                            const uint32_t (&d)[kChunk], uint32_t m,
                                            int32_t* __restrict__ oc) {
  uint32_t at[kChunk];
  bool ok[kChunk];
#pragma unroll
  for (int k = 0; k < kChunk; ++k) {
    if (First && k == 0) {
      at[k] = static_cast<uint32_t>(j0);
      ok[k] = at[k] < static_cast<uint32_t>(nw);
    } else {
      at[k] = add_mod(base, d[First ? k - 1 : k], m);
      ok[k] = true;
    }
    if (Tail) ok[k] = ok[k] && t0 + k < steps;
  }
  int32_t v[kChunk];
#pragma unroll
  for (int k = 0; k < kChunk; ++k)
    v[k] = ok[k] ? __ldg(col + static_cast<long long>(at[k]) * lanes) : 0;
#pragma unroll
  for (int k = 0; k < kChunk; ++k)
    if (!Tail || t0 + k < steps) oc[static_cast<long long>(t0 + k) * lanes] = v[k];
}

__global__ void __launch_bounds__(kThreads)
gather_store_loop_kernel(const int32_t* __restrict__ words, int nw, int lanes,
                         const int32_t* __restrict__ j, int steps, uint32_t s,
                         int32_t* __restrict__ out) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  const int32_t* col = words + l;
  int32_t* oc = out + l;
  const int32_t j0 = __ldg(j + l);
  const uint32_t m = static_cast<uint32_t>(nw - 1);
  uint32_t d[kChunk];
  d[0] = 0u;
#pragma unroll
  for (int k = 1; k < kChunk; ++k) d[k] = add_mod(d[k - 1], s, m);
  const int r = static_cast<int32_t>(static_cast<uint32_t>(j0) + 3u) % (nw - 1);  // jnp's %: a floor mod
  uint32_t base = static_cast<uint32_t>(r < 0 ? r + (nw - 1) : r);
  if (steps < kChunk) {
    store_chunk<true, true>(col, nw, lanes, 0, steps, j0, base, d, m, oc);
    return;
  }
  store_chunk<true, false>(col, nw, lanes, 0, steps, j0, base, d, m, oc);
  base = add_mod(base, d[kChunk - 1], m);  // the row of step kChunk
  const uint32_t dn = add_mod(d[kChunk - 1], s, m);
  int t0 = kChunk;
  for (; t0 + kChunk <= steps; t0 += kChunk, base = add_mod(base, dn, m))
    store_chunk<false, false>(col, nw, lanes, t0, steps, j0, base, d, m, oc);
  if (t0 < steps) store_chunk<false, true>(col, nw, lanes, t0, steps, j0, base, d, m, oc);
}

// rows r0 .. r0 + kChunk - 1 (those before `rows` where Tail) loaded, then
// folded into the min and the uint32 (wrapping) sum
template <bool Tail>
__device__ __forceinline__ void min_sum_chunk(const int32_t* __restrict__ col, int lanes, int r0,
                                              int rows, int32_t& mn, uint32_t& sum) {
  int32_t v[kChunk];
#pragma unroll
  for (int k = 0; k < kChunk; ++k)
    if (!Tail || r0 + k < rows) v[k] = __ldg(col + static_cast<long long>(r0 + k) * lanes);
#pragma unroll
  for (int k = 0; k < kChunk; ++k) {
    if (Tail && r0 + k >= rows) break;
    mn = min(mn, v[k]);
    sum += static_cast<uint32_t>(v[k]);
  }
}

__global__ void __launch_bounds__(kThreads)
col_min_sum_kernel(const int32_t* __restrict__ x, int rows, int lanes, int32_t* __restrict__ out) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  const int32_t* col = x + l;
  int32_t mn = INT32_MAX;
  uint32_t sum = 0u;
  int r0 = 0;
  for (; r0 + kChunk <= rows; r0 += kChunk) min_sum_chunk<false>(col, lanes, r0, rows, mn, sum);
  if (r0 < rows) min_sum_chunk<true>(col, lanes, r0, rows, mn, sum);
  out[l] = mn;
  out[lanes + l] = static_cast<int32_t>(sum);
}

// out (17, lanes): rows 0-15 r >> (16 - L) (arithmetic), row 16 the mask
__global__ void __launch_bounds__(kThreads)
var_shifts_kernel(const int32_t* __restrict__ r, const int32_t* __restrict__ e, int lanes,
                  int32_t* __restrict__ out) {
  const int l = blockIdx.x * kThreads + threadIdx.x;
  if (l >= lanes) return;
  const int32_t rv = r[l];
#pragma unroll
  for (int L = 0; L < 16; ++L) out[static_cast<long long>(L) * lanes + l] = rv >> (16 - L);
  out[16LL * lanes + l] = static_cast<int32_t>(shl(1u, static_cast<uint32_t>(e[l])) - 1u);
}

__device__ __forceinline__ uint32_t rev16(uint32_t w) {
  return __brev(w & 0xFFFFu) >> 16;
}

// ---- fetch_rows and tree_decode: a lane's loads all in flight -------------
//
// fetch_rows: j's load, then rows j + i in chunks of kFetchChunk, each
// chunk's rows loaded through the read-only path before its first store,
// then stored a row at a time (coalesced across lanes); a row outside [0,
// nw) gives 0.  Whole chunks while kFetchChunk rows are left, then one
// chunk predicated on i < k: the probes' k = 3 is that one chunk.  On an
// H100 the same chunks in one predicated loop issued each load after the
// last one's store, and chunks of 16 were slower at k = 3.  The range
// test j >= -i && j < nw - i is exact in 32 bits for i < 2^20 (the entry
// point refuses a larger k): no sum wraps at int32's ends, and j + i is
// formed only for a row inside.
template <bool Tail>
__device__ __forceinline__ void fetch_chunk(const int32_t* __restrict__ col, int nw, int lanes,
                                            int32_t j0, int i0, int k, int32_t* __restrict__ oc) {
  int32_t v[kFetchChunk];
#pragma unroll
  for (int t = 0; t < kFetchChunk; ++t) {
    const int i = i0 + t;
    v[t] = (!Tail || i < k) && j0 >= -i && j0 < nw - i
               ? __ldg(col + static_cast<long long>(j0 + i) * lanes)
               : 0;
  }
#pragma unroll
  for (int t = 0; t < kFetchChunk; ++t)
    if (!Tail || i0 + t < k) oc[static_cast<long long>(i0 + t) * lanes] = v[t];
}

__global__ void __launch_bounds__(kThreads)
fetch_rows_kernel(const int32_t* __restrict__ words, int nw, int lanes,
                  const int32_t* __restrict__ j, int k, int32_t* __restrict__ out) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  const int32_t j0 = __ldg(j + l);
  const int32_t* col = words + l;
  int32_t* oc = out + l;
  int i0 = 0;
  for (; i0 + kFetchChunk <= k; i0 += kFetchChunk)
    fetch_chunk<false>(col, nw, lanes, j0, i0, k, oc);
  if (i0 < k) fetch_chunk<true>(col, nw, lanes, j0, i0, k, oc);
}

// tree_decode, out (2, lanes): the first code length L >= 1 whose table
// range holds the window's L-bit prefix (99 for none), and the rank at L
// clipped to [0, 15]; cnt, first, off: int32 (16, lanes).  The length
// selected is 1..15 (99 clips to 15), so row 0 is never read: w and rows
// 1-15 of the three tables, 46 loads, go out through the read-only path
// before any compare, one round trip.  A chain from L = 15 down to 1,
// unrolled and in registers, keeps the last (shortest) length whose range
// holds its code and the rank there, off + code - first in uint32; it
// starts from L = 15's rank, the no-match case.  The match is the tools'
// int32 compare on the wrapped difference.  The rank is summed at every
// length and selected, not assigned in a branch: from `if (match) { off_sel
// = off[L]; ... }` ptxas made each off[L] a load predicated on its match
// into one register, and loads that write one register wait for each
// other, a round trip each.  The kernel takes a ceiling of 128 registers
// in place of the launch bound (its blocks stay at most kThreads): under
// __launch_bounds__(kThreads) ptxas kept to 64 and issued the loads in
// two batches behind a wait.
__global__ void __maxnreg__(128)
tree_decode_kernel(const int32_t* __restrict__ w, const int32_t* __restrict__ cnt,
                   const int32_t* __restrict__ first, const int32_t* __restrict__ off, int lanes,
                   int32_t* __restrict__ out) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  const uint32_t wl = static_cast<uint32_t>(__ldg(w + l));
  int32_t c[16], f[16], o[16];  // rows 1-15; [0] unused
#pragma unroll
  for (int L = 1; L < 16; ++L) {
    const long long at = static_cast<long long>(L) * lanes + l;
    c[L] = __ldg(cnt + at);
    f[L] = __ldg(first + at);
    o[L] = __ldg(off + at);
  }
  const int32_t rv = static_cast<int32_t>(rev16(wl));
  int sel = 99;
  uint32_t rank = static_cast<uint32_t>(o[15]) + static_cast<uint32_t>(rv >> 1) -
                  static_cast<uint32_t>(f[15]);
#pragma unroll
  for (int L = 15; L >= 1; --L) {
    const int32_t cl = rv >> (16 - L);
    const int32_t d = static_cast<int32_t>(static_cast<uint32_t>(cl) - static_cast<uint32_t>(f[L]));
    const bool hit = cl >= f[L] && d < c[L];
    sel = hit ? L : sel;
    rank = hit ? static_cast<uint32_t>(o[L]) + static_cast<uint32_t>(cl) - static_cast<uint32_t>(f[L])
               : rank;
  }
  out[l] = sel;
  out[lanes + l] = static_cast<int32_t>(rank);
}

// out (3, lanes): the 64-bit window's low and high words at bit sh of
// (a, b, c), and its low word re-windowed by o clipped to [0, 31]
__global__ void __launch_bounds__(kThreads)
window64_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                const int32_t* __restrict__ c, const int32_t* __restrict__ sh,
                const int32_t* __restrict__ o, int lanes, int32_t* __restrict__ out) {
  const int l = blockIdx.x * kThreads + threadIdx.x;
  if (l >= lanes) return;
  const uint32_t wa = a[l], wb = b[l], wc = c[l];
  const uint32_t shv = static_cast<uint32_t>(sh[l]);
  const uint32_t nsh = (32u - shv) & 31u;
  const uint32_t hi_b = shv == 0u ? 0u : wb << nsh;
  const uint32_t hi_c = shv == 0u ? 0u : wc << nsh;
  const uint32_t lo = shr(wa, shv) | hi_b;
  const uint32_t hi = shr(wb, shv) | hi_c;
  const int32_t oc = min(max(o[l], 0), 31);
  const uint32_t ov = static_cast<uint32_t>(oc), no = (32u - ov) & 31u;
  const uint32_t w2 = ov == 0u ? lo : (lo >> ov) | (hi << no);
  out[l] = static_cast<int32_t>(lo);
  out[lanes + l] = static_cast<int32_t>(hi);
  out[2LL * lanes + l] = static_cast<int32_t>(w2);
}

int done() { return static_cast<int>(cudaGetLastError()); }
int invalid() { return static_cast<int>(cudaErrorInvalidValue); }

}  // namespace

// Every array is int32 (rows, lanes), row-major; uint32 values pass as
// their bits.  lanes >= 1.

// route: 0 "regs" (lanes <= kWhileThreads * kRegs), 1 "smem" (lanes * 4
// bytes within the shared memory a block may opt in to), 2 "global"
extern "C" int tz_vec_cond_while(const void* x, int lanes, int route, void* out, void* stream) {
  const auto* xs = static_cast<const int32_t*>(x);
  auto* o = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (lanes <= 0) return invalid();
  if (route == 0) {
    if (lanes > kWhileThreads * kRegs) return invalid();
    // the fewest lanes a thread (1, 2, 4, 8); a block of whole warps
    const int per = (lanes + kWhileThreads - 1) / kWhileThreads;
    const int r = per <= 1 ? 1 : per <= 2 ? 2 : per <= 4 ? 4 : 8;
    const int threads = ((lanes + r - 1) / r + 31) / 32 * 32;
    switch (r) {
      case 1: vec_cond_while_regs_kernel<1><<<1, threads, 0, s>>>(xs, lanes, o); break;
      case 2: vec_cond_while_regs_kernel<2><<<1, threads, 0, s>>>(xs, lanes, o); break;
      case 4: vec_cond_while_regs_kernel<4><<<1, threads, 0, s>>>(xs, lanes, o); break;
      default: vec_cond_while_regs_kernel<8><<<1, threads, 0, s>>>(xs, lanes, o); break;
    }
    return done();
  }
  if (route == 1) {
    const size_t bytes = static_cast<size_t>(lanes) * 4;
    const cudaError_t err = cudaFuncSetAttribute(
        vec_cond_while_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    vec_cond_while_kernel<true><<<1, kWhileThreads, bytes, s>>>(xs, lanes, o);
    return done();
  }
  if (route != 2) return invalid();
  vec_cond_while_kernel<false><<<1, kWhileThreads, 0, s>>>(xs, lanes, o);
  return done();
}

// words (nw, lanes), j (1, lanes), out (k, lanes); k in [1, 2^20)
extern "C" int tz_fetch_rows(const void* words, int nw, int lanes, const void* j, int k,
                             void* out, void* stream) {
  if (lanes <= 0 || nw < 0 || k <= 0 || k >= 1 << 20) return invalid();
  int sms = 0;
  const cudaError_t err = tz::sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = spread_threads(lanes, sms);
  fetch_rows_kernel<<<(lanes + threads - 1) / threads, threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(words), nw, lanes, static_cast<const int32_t*>(j), k,
      static_cast<int32_t*>(out));
  return done();
}

// out (rows, lanes); rows >= 1
extern "C" int tz_row_store_loop(int rows, int lanes, void* out, void* stream) {
  if (lanes <= 0 || rows <= 0) return invalid();
  row_store_loop_kernel<<<blocks_for(lanes), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      rows, lanes, static_cast<int32_t*>(out));
  return done();
}

// words (nw, lanes) with nw >= 2, j (1, lanes), out (steps, lanes); steps >= 1
extern "C" int tz_gather_store_loop(const void* words, int nw, int lanes, const void* j, int steps,
                                    void* out, void* stream) {
  if (lanes <= 0 || nw < 2 || steps <= 0) return invalid();
  int sms = 0;
  const cudaError_t err = tz::sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = spread_threads(lanes, sms);
  gather_store_loop_kernel<<<(lanes + threads - 1) / threads, threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(words), nw, lanes, static_cast<const int32_t*>(j), steps,
      3u % static_cast<uint32_t>(nw - 1), static_cast<int32_t*>(out));
  return done();
}

// x (rows, lanes) with rows >= 1, out (2, lanes)
extern "C" int tz_col_min_sum(const void* x, int rows, int lanes, void* out, void* stream) {
  if (lanes <= 0 || rows <= 0) return invalid();
  int sms = 0;
  const cudaError_t err = tz::sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = spread_threads(lanes, sms);
  col_min_sum_kernel<<<(lanes + threads - 1) / threads, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(static_cast<const int32_t*>(x), rows,
                                                            lanes, static_cast<int32_t*>(out));
  return done();
}

// r, e (1, lanes), out (17, lanes)
extern "C" int tz_var_shifts(const void* r, const void* e, int lanes, void* out, void* stream) {
  if (lanes <= 0) return invalid();
  var_shifts_kernel<<<blocks_for(lanes), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(r), static_cast<const int32_t*>(e), lanes,
      static_cast<int32_t*>(out));
  return done();
}

// w (1, lanes), cnt, first, off (16, lanes), out (2, lanes)
extern "C" int tz_tree_decode(const void* w, const void* cnt, const void* first, const void* off,
                              int lanes, void* out, void* stream) {
  if (lanes <= 0) return invalid();
  int sms = 0;
  const cudaError_t err = tz::sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = spread_threads(lanes, sms);
  tree_decode_kernel<<<(lanes + threads - 1) / threads, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(w), static_cast<const int32_t*>(cnt),
      static_cast<const int32_t*>(first), static_cast<const int32_t*>(off), lanes,
      static_cast<int32_t*>(out));
  return done();
}

// a, b, c, sh, o (1, lanes), out (3, lanes)
extern "C" int tz_window64(const void* a, const void* b, const void* c, const void* sh,
                           const void* o, int lanes, void* out, void* stream) {
  if (lanes <= 0) return invalid();
  window64_kernel<<<blocks_for(lanes), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), static_cast<const int32_t*>(b),
      static_cast<const int32_t*>(c), static_cast<const int32_t*>(sh),
      static_cast<const int32_t*>(o), lanes, static_cast<int32_t*>(out));
  return done();
}
