// LZ77 match screens of the batched device deflate encoder.
//
// Replace tpuzlib/kernels/screen_pallas.py:_near_kernel (via near_screen)
// and :_far_kernel (via far_screen).  Both read the flat batch's bytes:
// the window of position q is bytes q..q+15, bytes at or past `total`
// reading as zero.  The TPU kernels' roll-and-halo shifts exist only for
// the (8, 128) tiling and have no counterpart here.
//
// near_screen's bound is device memory: 1 byte in and three int32 (two in,
// one out) a position, 13 bytes.  What stands in its way are its 24 window
// compares a position, as shared-memory loads and as integer operations.
// Nearly all compares fail in the first three bytes (0.19% of them match
// three on the mixed corpus), so a block stages its bytes once in shared
// memory and each thread owns R consecutive positions, keeps their windows
// in registers and walks its candidates four at a time on their first
// three bytes alone: two 4-byte loads and a few funnel shifts test four
// candidates against all R positions.  Only where three bytes match is a
// full window built from the staged bytes and screened, position by
// position.  A lane gets there about 0.09 times in its whole walk, but its
// warp waits whenever any of 32 lanes does, so the screen is kept out of
// the common path rather than made cheap: screening every candidate
// without a branch cost more than the loads it saved, and so did full
// windows built once in shared memory.  The walk runs from the nearest
// candidate out, down to the lowest mincand; a position whose screen
// reaches its cap lim16 drops out of the three-byte test (a farther
// candidate with the same screen gives a smaller key).
//
// far_screen's bound is device memory too: per row its sorted hash and
// position, the bytes, and its key read and written in the position
// domain.  Rows are stably sorted by hash, so within a bucket positions
// ascend and the walk over a row's k predecessors stops exactly at the
// first row of another hash, the first gap over 32768, or the first
// 16-byte screen: a few trips a row instead of k.  A block stages its
// rows and the k before them in shared memory: hash and position, and the
// window gathered from the bytes for each row that shares a hash with a
// neighbour (no other row is ever compared).  A gathered window is two
// aligned 16-byte loads from L2, where the batch's bytes stay, not five
// 4-byte ones: a scattered load costs an L1 wavefront a lane.  Each step
// of the walk loads two predecessors before screening either, without a
// branch.  Each row with a key raises its position's key in place with
// atomicMax: the rows are a permutation, so no two rows meet at one
// position, but the atomic is a reduction done at L2 and spares the
// thread a scattered load of the old key before a store (a third less
// time for the whole kernel on the mixed corpus).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWindow = 1 << 15;
constexpr int kNearR = 4;  // positions a near-screen thread owns (2 and 8 were slower)

// The 16 bytes at byte offset o of the 4-byte-aligned words w.
__device__ __forceinline__ uint4 window_of(const uint32_t* w, int o) {
  const uint32_t* p = w + (o >> 2);
  const int s = (o & 3) * 8;
  return make_uint4(__funnelshift_r(p[0], p[1], s), __funnelshift_r(p[1], p[2], s),
                    __funnelshift_r(p[2], p[3], s), __funnelshift_r(p[3], p[4], s));
}

// Bytes g..g+15 of data, zero outside [0, total).
__device__ __forceinline__ uint4 bytes16(const uint8_t* __restrict__ data, int g, int total) {
  uint32_t v[4] = {0, 0, 0, 0};
#pragma unroll
  for (int b = 0; b < 16; ++b) {
    if (g + b >= 0 && g + b < total) v[b >> 2] |= static_cast<uint32_t>(data[g + b]) << (8 * (b & 3));
  }
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// The window of position q (0 <= q < total): the two aligned 16-byte
// granules that hold it, shifted by word and then by byte, where they lie
// inside the data; else byte by byte.
__device__ __forceinline__ uint4 load_window(const uint8_t* __restrict__ data, int q, int total) {
  if (q + 32 > total) return bytes16(data, q, total);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(data + q);
  const uint4* g = reinterpret_cast<const uint4*>(addr & ~uintptr_t(15));
  const uint4 lo = __ldg(g), hi = __ldg(g + 1);
  const uint32_t v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const int o = static_cast<int>(addr & 15);
  uint32_t u[6], t[5];
#pragma unroll
  for (int j = 0; j < 6; ++j) u[j] = o & 8 ? v[j + 2] : v[j];
#pragma unroll
  for (int j = 0; j < 5; ++j) t[j] = o & 4 ? u[j + 1] : u[j];
  return window_of(t, o & 3);
}

// v[r] = src[p0 + r] (0 past total), as 8- or 16-byte loads where aligned.
template <int R>
__device__ __forceinline__ void load_ints(const int* __restrict__ src, int p0, int total, int (&v)[R]) {
  constexpr int V = R < 4 ? R : 4;
  if (p0 + R <= total && reinterpret_cast<uintptr_t>(src + p0) % (4 * V) == 0) {
#pragma unroll
    for (int r = 0; r < R; r += V) {
      if constexpr (V == 4) {
        const int4 x = __ldg(reinterpret_cast<const int4*>(src + p0 + r));
        v[r] = x.x, v[r + 1] = x.y, v[r + 2] = x.z, v[r + 3] = x.w;
      } else {
        const int2 x = __ldg(reinterpret_cast<const int2*>(src + p0 + r));
        v[r] = x.x, v[r + 1] = x.y;
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = p0 + r < total ? src[p0 + r] : 0;
  }
}

// dst[p0 + r] = v[r] for p0 + r < total, as in load_ints.
template <int R>
__device__ __forceinline__ void store_ints(int* __restrict__ dst, int p0, int total, const int (&v)[R]) {
  constexpr int V = R < 4 ? R : 4;
  if (p0 + R <= total && reinterpret_cast<uintptr_t>(dst + p0) % (4 * V) == 0) {
#pragma unroll
    for (int r = 0; r < R; r += V) {
      if constexpr (V == 4) {
        *reinterpret_cast<int4*>(dst + p0 + r) = make_int4(v[r], v[r + 1], v[r + 2], v[r + 3]);
      } else {
        *reinterpret_cast<int2*>(dst + p0 + r) = make_int2(v[r], v[r + 1]);
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (p0 + r < total) dst[p0 + r] = v[r];
    }
  }
}

constexpr uint32_t kNone = 0xFFFFFFFFu;  // no three-byte prefix equals it

// The window of staged byte i (position base + i): zero before position 0.
__device__ __forceinline__ uint4 staged_window(const uint32_t* words, int base, int i) {
  return base + i >= 0 ? window_of(words, i) : make_uint4(0, 0, 0, 0);
}

// Screen candidate c (window w, first three bytes v) for the owned
// position p0 + r if its first three bytes match: keep its key where it
// is the best so far, and retire the position once its screen reaches
// the cap (a farther candidate cannot beat it).
template <int R>
__device__ __forceinline__ void near_candidate(int r, int c, uint4 w, uint32_t v, int p0, int nd,
                                               const uint4 (&a)[R], uint32_t (&a3)[R],
                                               const int (&mc)[R], const int (&lim)[R],
                                               int (&best)[R]) {
  const int d = p0 + r - c;
  if (v != a3[r] || d > nd || c < mc[r]) return;
  const int sc = min(tz::prefix16(a[r], w), lim[r]);
  best[r] = max(best[r], tz::pack_key(sc, d));
  if (sc == lim[r]) a3[r] = kNone;
}

// key[p] = max over d = 1..nd of pack_key(screen, d) where the 16-byte
// screen of the windows at p and p-d, clipped to lim16[p], is >= 3 and
// d <= p - mincand[p].  Windows before position 0 are zero windows.
// `halo` is nd rounded up to 16: a block stages the bytes from `halo`
// before its first position to 32 past its last.  A thread walks its
// candidates four at a time on their first three bytes (two 4-byte loads
// for four candidates) and builds a full window from the staged bytes
// only where three bytes match.
template <int R>
__global__ void __launch_bounds__(kThreads)
near_screen_kernel(const uint8_t* __restrict__ data, const int* __restrict__ mincand,
                   const int* __restrict__ lim16, int* __restrict__ key, int total, int nd,
                   int halo) {
  extern __shared__ uint4 raw[];  // bytes base .. base + halo + R * kThreads + 31
  constexpr int P = R * kThreads;  // positions a block
  const int start = blockIdx.x * P;
  const int base = start - halo;
  const bool aligned = reinterpret_cast<uintptr_t>(data) % 16 == 0;
  for (int c = threadIdx.x; c < (halo + P) / 16 + 2; c += kThreads) {
    const int g = base + 16 * c;
    raw[c] = aligned && g >= 0 && g + 16 <= total ? __ldg(reinterpret_cast<const uint4*>(data + g))
                                                  : bytes16(data, g, total);
  }
  const int p0 = start + R * threadIdx.x;
  int mc[R], lim[R], best[R];
  load_ints<R>(mincand, p0, total, mc);
  load_ints<R>(lim16, p0, total, lim);
  __syncthreads();
  const uint32_t* words = reinterpret_cast<const uint32_t*>(raw);

  const int i0 = p0 - base;
  uint4 a[R];
  uint32_t a3[R];  // the first three bytes of an owned window; kNone once it cannot gain
  int lo = p0;     // the lowest candidate any of them takes
#pragma unroll
  for (int r = 0; r < R; ++r) {
    a[r] = staged_window(words, base, i0 + r);
    a3[r] = kNone;
    best[r] = 0;
    if (p0 + r < total && lim[r] >= tz::kMinMatch && mc[r] < p0 + r) {
      a3[r] = a[r].x & 0xFFFFFFu;
      lo = min(lo, mc[r]);
    }
  }
  // nearest first: the owned positions before each one, then the rest
#pragma unroll
  for (int rc = R - 2; rc >= 0; --rc) {
#pragma unroll
    for (int r = rc + 1; r < R; ++r) {
      near_candidate<R>(r, p0 + rc, a[rc], a[rc].x & 0xFFFFFFu, p0, nd, a, a3, mc, lim, best);
    }
  }
  lo = max(lo, p0 - nd);
  for (int g = (i0 - 1) >> 2; g >= (lo - base) >> 2; --g) {
    // the first three bytes of the windows at staged bytes 4g .. 4g + 3
    const uint32_t x = words[g], y = words[g + 1];
    uint32_t v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = (base + 4 * g + u >= 0 ? __funnelshift_r(x, y, 8 * u) : 0) & 0xFFFFFFu;
    bool any = false;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int r = 0; r < R; ++r) any |= v[u] == a3[r];
    }
    if (!any) continue;
#pragma unroll
    for (int u = 3; u >= 0; --u) {
      const int i = 4 * g + u;
      bool hit = false;
#pragma unroll
      for (int r = 0; r < R; ++r) hit |= v[u] == a3[r];
      if (!hit || i >= i0) continue;  // i >= i0: an owned position, screened above
      const uint4 w = staged_window(words, base, i);
#pragma unroll
      for (int r = 0; r < R; ++r) near_candidate<R>(r, base + i, w, v[u], p0, nd, a, a3, mc, lim, best);
    }
  }
  store_ints<R>(key, p0, total, best);
}

// Rows are stably sorted by chunk-tagged hash `sh`; `sp` holds each row's
// position, ascending within a bucket.  best[sp[i]] = max(best[sp[i]],
// key_i), key_i = max over j = 1..k of pack_key(screen, pos gap) where row
// i-j has the same hash, the gap is <= 32768 and the 16-byte screen of
// the two rows' windows is >= 3.  A row before row 0 has hash -1, pos -1
// and a zero window; a row past the end has hash -2, pos 0 and a zero
// window.  best holds keys (>= 0).  A position outside [0, total) reads
// a zero window and writes nothing.
__global__ void __launch_bounds__(kThreads)
far_screen_kernel(const int* __restrict__ sh, const long long* __restrict__ sp,
                  const uint8_t* __restrict__ data, int* __restrict__ best, int total, int k) {
  extern __shared__ uint4 smem[];
  const int rows = k + kThreads;
  uint4* win = smem;                               // [rows]
  int2* hp = reinterpret_cast<int2*>(win + rows);  // [rows]: hash, position
  const int start = blockIdx.x * kThreads;
  for (int i = threadIdx.x; i < rows; i += kThreads) {
    const int r = start - k + i;
    hp[i] = r >= 0 && r < total ? make_int2(sh[r], static_cast<int>(sp[r]))
                                : (r < 0 ? make_int2(-1, -1) : make_int2(-2, 0));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows; i += kThreads) {
    const int r = start - k + i;
    const int h = hp[i].x;
    if ((i > 0 && hp[i - 1].x == h) || (i + 1 < rows && hp[i + 1].x == h)) {
      const int q = hp[i].y;
      win[i] = r >= 0 && r < total && q >= 0 && q < total ? load_window(data, q, total)
                                                          : make_uint4(0, 0, 0, 0);
    }
  }
  __syncthreads();
  if (start + static_cast<int>(threadIdx.x) >= total) return;
  const int row = k + threadIdx.x;
  const int2 me = hp[row];
  if (hp[row - 1].x != me.x) return;
  const uint4 a = win[row];
  // two predecessors a step, both loaded before either is screened
  int key = 0;
  for (int j = 1; j <= k; j += 2) {
    const int j1 = j < k ? j + 1 : j;  // row - k - 1 may lie before the staged rows
    const int2 q0 = hp[row - j], q1 = hp[row - j1];
    const uint4 w0 = win[row - j], w1 = win[row - j1];
    const int d0 = me.y - q0.y;
    if (q0.x != me.x || d0 > kWindow) break;
    const int sc0 = tz::prefix16(a, w0);
    key = sc0 >= tz::kMinMatch ? max(key, tz::pack_key(sc0, d0)) : key;
    const int d1 = me.y - q1.y;
    if (sc0 == 16 || j == k || q1.x != me.x || d1 > kWindow) break;
    const int sc1 = tz::prefix16(a, w1);
    key = sc1 >= tz::kMinMatch ? max(key, tz::pack_key(sc1, d1)) : key;
    if (sc1 == 16) break;
  }
  if (key > 0 && static_cast<unsigned>(me.y) < static_cast<unsigned>(total)) {
    atomicMax(best + me.y, key);
  }
}

}  // namespace

extern "C" int tz_near_screen(const void* data, const void* mincand, const void* lim16, void* key,
                              int total, int nd, void* stream) {
  constexpr int P = kNearR * kThreads;
  const int halo = (nd + 15) & ~15;
  const int nwin = halo + P;
  const size_t smem = static_cast<size_t>(nwin / 16 + 2) * sizeof(uint4);
  const int blocks = (total + P - 1) / P;
  near_screen_kernel<kNearR><<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<const int*>(mincand),
      static_cast<const int*>(lim16), static_cast<int*>(key), total, nd, halo);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tz_far_screen(const void* sh, const void* sp, const void* data, void* best, int total,
                             int k, void* stream) {
  const int blocks = (total + kThreads - 1) / kThreads;
  const size_t smem = static_cast<size_t>(k + kThreads) * (sizeof(uint4) + sizeof(int2));
  far_screen_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(sh), static_cast<const long long*>(sp),
      static_cast<const uint8_t*>(data), static_cast<int*>(best), total, k);
  return static_cast<int>(cudaGetLastError());
}
