// The gather and primitive probe kernels: gathers along either axis of a
// 2-D array, a loop of them, a gather from a flat table, a column
// scatter-max, and the global shift screen.
//
// Replace the Pallas kernels of the tools' gather and primitive probes:
//   take_along       tools/probe_gather.py:54 and :75 (take_along_axis on
//                    axis 1 and 0), tools/probe_primitives.py:167 k_tala
//                    and :188 k_tala0, and the sublane gathers of
//                    tools/probe_inflate_prims.py:50 k_a and
//                    probe_inflate_prims2.py:115 k_i;
//   take_along_loop  tools/probe_gather.py:96-103 (loop_cost's kern: the sum
//                    of `iters` gathers at indices shifted by the step);
//   flat_gather      tools/probe_primitives.py:176 k_flatgather;
//   scatter_max      tools/probe_primitives.py:196 k_scatter;
//   shift_screen     tools/probe_primitives.py:208 k_roll.
//
// Index rules, as jnp gives them: take_along maps an index i in [-n, 0)
// to i + n and gives `fill` for any other index outside [0, n) (jnp's
// fill: INT32_MIN for int32, 0xFFFFFFFF for uint32 bits); flat_gather maps
// i < 0 to i + T, then clamps to [0, T - 1]; scatter_max maps i < 0 to
// i + rows and drops what is still outside [0, rows).
//
// Bounds (H100 SXM): every kernel reads each input once and writes each
// output once, a few integer steps an element; at the tools' sizes (a few
// MiB at most) that is microseconds, about the launch itself.
//
// take_along and flat_gather stream their indices in and their outputs
// out, and gather in between.  What bounds them is the memory system's
// requests, not its bytes: a gather of 4 bytes at a random place costs a
// 32-byte sector of L2 (a sublane gather's x, at most 9.4 MiB in the
// tools, stays in the 50 MB L2), and a warp's 32 gathers through L1 cost
// up to 32 wavefronts.  Their designs:
//   - a thread takes 4 indices as one 16-byte load, issues 4 independent
//     gathers and stores 4 outputs as one 16-byte store, where the index
//     row's width is a multiple of 4 and every pointer is 16-byte aligned
//     (else one element at a time), and loads its next indices while it
//     gathers (one load ahead);
//   - take_along walks a 2-D grid, rows on y and a row's columns on x, so
//     no element pays a division, with 32-bit offsets where x and idx hold
//     fewer than 2^31 elements;
//   - where a gather's whole source fits one block's shared memory (an
//     axis-1 row of x, or flat_gather's table: up to 227 KB on the H100),
//     the block stages it with cp.async while its first indices load, and
//     reads the gathers from shared memory, a few bank conflicts a warp;
//     flat_gather runs a persistent grid of one or two blocks an SM that
//     stage the table once; take_along a block per row in turn;
//   - wider rows, larger tables and the sublane gather (axis 0: rows are
//     random within a column) gather through the read-only cache (__ldg);
//   - the grids are sized from the card's SM count.
// Measured on an H100 (probes/gather_breakdown.py): staging makes the lane
// gather 1.3x and flat_gather 1.7x faster than a thread an element; the
// sublane gather is unchanged, held by its x sectors (2.36 M of 32 bytes
// from L2 on the encoder batch's (18,432, 128), ~3.5 TB/s of L2 traffic).
// The design is chosen by shape in the entry points (the staged one up to
// tz_gather_staged_words()), never by what fails.
//
// take_along_loop makes 64 gathers an element (the tools' loop), each at
// a random place, so the requests bound it: on (4352, 128) 35.7 M gathers,
// 1.11 M warp requests.  Where a line along the axis (a column on axis
// 0, a row on axis 1) fits shared memory, a block stages up to 8 lines
// with cp.async (a 32-byte sector of each row on axis 0; fewer where two
// blocks would not fit an SM) and gives its threads the outputs of those
// lines over a range of positions, the grid split so that it gives two
// blocks an SM; every gather is then a shared-memory load, a warp's 32 at
// random banks (~3.5 wavefronts a request).  A longer line is gathered
// through the read-only cache, a thread an element.  Both step the index:
// one floor mod a thread, then one up with a reset at n; the int32 wrap of
// idx + t comes at most once, at t = 2^31 - idx, where the floor mod is
// taken afresh.  The sum is kept in a register and added as unsigned, so
// that the int32 wrap is defined.  The wrapper chooses the design by shape.
// Measured on an H100 (probes/forms_breakdown.py): 7.4x faster on (4352,
// 128) than a thread an element with a % a step.
//
// scatter_max moves its indices and values in and its output out once
// (28.3 MB on the encoder batch's (8, 2304, 128): 8.5 us at 3.35 TB/s).
// Chunk k, column c only ever writes column c of chunk k, so a CUDA block
// owns a chunk and a slab of adjacent columns and max-scatters them in
// shared memory (route "smem", its note below); where not even one
// column's output fits a block's shared memory, a thread an element
// atomicMaxes into the output, which the caller zeroes (route "global").
// shift_screen keeps a warp's 128 words and their 16 predecessors in
// registers (its note, below).

#include <atomic>
#include <cstdint>
#include <mutex>
#include <utility>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGrid = 1 << 16;  // blocks of a grid-stride launch
constexpr int kStagedThreads = 512;  // the staged designs' largest block
constexpr int kSmThreads = 2048;     // resident threads an SM
constexpr int kMaxDevices = 64;

__host__ __device__ __forceinline__ unsigned grid_for(long long n) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks < kMaxGrid ? blocks : kMaxGrid);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// ---- the streams and the staging -------------------------------------------------

// unit u of p: 4 indices from one 16-byte load where Vec, else one in .x
template <bool Vec>
__device__ __forceinline__ int4 load_unit(const int32_t* p, long long u) {
  if (Vec) return __ldg(reinterpret_cast<const int4*>(p) + u);
  return make_int4(__ldg(p + u), 0, 0, 0);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// the block copies src[0, n) into dst, 16 bytes a copy from a 16-byte
// aligned src where vec (the last n % 4 words 4 bytes each), else 4;
// asynchronous until cp_async_wait_all() and __syncthreads()
__device__ __forceinline__ void stage(int32_t* dst, const int32_t* src, int n, bool vec) {
  int done = 0;
  if (vec) {
    done = n & ~3;
    for (int k = threadIdx.x * 4; k < done; k += blockDim.x * 4) cp_async16(dst + k, src + k);
  }
  for (int k = done + threadIdx.x; k < n; k += blockDim.x) cp_async4(dst + k, src + k);
}

// ---- take_along ------------------------------------------------------------------

// jnp's rule: the place of index i in [0, span), or -1 where it gives fill
__device__ __forceinline__ int take_index(int i, int span) {
  if (i < 0) i += span;  // no overflow: span <= INT32_MAX
  return static_cast<unsigned>(i) < static_cast<unsigned>(span) ? i : -1;
}

// x[i, c] (Axis 0) or xrow[i] (Axis 1) through the read-only cache, or
// fill; the load is issued for every index (place 0 where fill), so that
// a thread's four gathers go out together
template <int Axis, typename Off>
__device__ __forceinline__ int32_t ldg_at(const int32_t* x, const int32_t* xrow, int xc, int span,
                                          int i, int c, int fill) {
  const int j = take_index(i, span);
  const int k = j < 0 ? 0 : j;
  const int32_t v = __ldg(Axis == 0 ? x + static_cast<Off>(k) * xc + c : xrow + k);
  return j < 0 ? fill : v;
}

__device__ __forceinline__ int32_t smem_at(const int32_t* row, int span, int i, int fill) {
  const int j = take_index(i, span);
  const int32_t v = row[j < 0 ? 0 : j];
  return j < 0 ? fill : v;
}

// out (ir, ic) from x (xr, xc): out[r, c] = x[idx[r, c], c] (Axis 0) or
// x[r, idx[r, c]] (Axis 1); ic == xc for Axis 0, ir == xr for Axis 1.
// Gathers through the read-only cache.  Rows walk y (blockIdx.y,
// threadIdx.y), a row's units x (4 columns where Vec, else 1).
template <int Axis, bool Vec, typename Off>
__global__ void __launch_bounds__(kThreads)
take_along_ldg(const int32_t* __restrict__ x, int xr, int xc, const int32_t* __restrict__ idx,
               int ir, int ic, int fill, int32_t* __restrict__ out) {
  const int span = Axis == 0 ? xr : xc;
  const unsigned units = Vec ? static_cast<unsigned>(ic) >> 2 : static_cast<unsigned>(ic);
  const unsigned ustep = gridDim.x * blockDim.x, rstep = gridDim.y * blockDim.y;
  for (unsigned r = blockIdx.y * blockDim.y + threadIdx.y; r < static_cast<unsigned>(ir);
       r += rstep) {
    const int32_t* irow = idx + static_cast<Off>(r) * ic;
    int32_t* orow = out + static_cast<Off>(r) * ic;
    const int32_t* xrow = Axis == 1 ? x + static_cast<Off>(r) * xc : x;
    for (unsigned u = blockIdx.x * blockDim.x + threadIdx.x; u < units; u += ustep) {
      const int4 iv = load_unit<Vec>(irow, u);
      if (Vec) {
        const int c = static_cast<int>(u) * 4;
        int4 ov;
        ov.x = ldg_at<Axis, Off>(x, xrow, xc, span, iv.x, c, fill);
        ov.y = ldg_at<Axis, Off>(x, xrow, xc, span, iv.y, c + 1, fill);
        ov.z = ldg_at<Axis, Off>(x, xrow, xc, span, iv.z, c + 2, fill);
        ov.w = ldg_at<Axis, Off>(x, xrow, xc, span, iv.w, c + 3, fill);
        reinterpret_cast<int4*>(orow)[u] = ov;
      } else {
        orow[u] = ldg_at<Axis, Off>(x, xrow, xc, span, iv.x, static_cast<int>(u), fill);
      }
    }
  }
}

// Axis 1 with x's row in shared memory (xc words): block b takes rows b,
// b + gridDim.x, ...; it stages the row (16-byte copies where xvec: x
// 16-byte aligned and xc % 4 == 0) while each thread loads its first
// unit of indices, then gathers from shared memory, the next unit's
// indices in flight.
template <bool Vec, typename Off>
__global__ void __launch_bounds__(kStagedThreads)
take_along_staged(const int32_t* __restrict__ x, int xc, bool xvec,
                  const int32_t* __restrict__ idx, int ir, int ic, int fill,
                  int32_t* __restrict__ out) {
  extern __shared__ int4 staged4[];
  int32_t* row = reinterpret_cast<int32_t*>(staged4);
  const unsigned units = Vec ? static_cast<unsigned>(ic) >> 2 : static_cast<unsigned>(ic);
  for (unsigned r = blockIdx.x; r < static_cast<unsigned>(ir); r += gridDim.x) {
    const int32_t* irow = idx + static_cast<Off>(r) * ic;
    int32_t* orow = out + static_cast<Off>(r) * ic;
    __syncthreads();  // every read of the previous row is done
    stage(row, x + static_cast<Off>(r) * xc, xc, xvec);
    unsigned u = threadIdx.x;
    int4 next = u < units ? load_unit<Vec>(irow, u) : make_int4(0, 0, 0, 0);
    cp_async_wait_all();
    __syncthreads();
    for (; u < units; u += blockDim.x) {
      const int4 iv = next;
      if (u + blockDim.x < units) next = load_unit<Vec>(irow, u + blockDim.x);
      if (Vec) {
        int4 ov;
        ov.x = smem_at(row, xc, iv.x, fill);
        ov.y = smem_at(row, xc, iv.y, fill);
        ov.z = smem_at(row, xc, iv.z, fill);
        ov.w = smem_at(row, xc, iv.w, fill);
        reinterpret_cast<int4*>(orow)[u] = ov;
      } else {
        orow[u] = smem_at(row, xc, iv.x, fill);
      }
    }
  }
}

// take_along_loop's index: (idx + t) wrapped as int32, then its floor mod n.
// Stepped by one from j = floor_mod(idx, n), back to 0 at n; the int32
// wrap of idx + t comes at most once for t < 2^31, at t = 2^31 - idx, where
// the index starts again from floor_mod(INT32_MIN, n).
__device__ __forceinline__ int floor_mod(int v, int n) {
  const int j = v % n;
  return j < 0 ? j + n : j;
}

// the step at which idx + t wraps, or iters where it does not
__device__ __forceinline__ int wrap_step(int idx, int iters) {
  const long long w = (1LL << 31) - idx;
  return w < iters ? static_cast<int>(w) : iters;
}

// the unsigned sum over t < iters of at(j_t), j_t the loop's index of i0
template <typename At>
__device__ __forceinline__ uint32_t loop_sum(int i0, int n, int iters, int jmin, At at) {
  uint32_t acc = 0u;
  int j = floor_mod(i0, n);
  const int wrap = wrap_step(i0, iters);
  for (int t = 0; t < iters; ++t) {
    if (t == wrap) j = jmin;
    acc += static_cast<uint32_t>(at(j));
    j = j + 1 == n ? 0 : j + 1;
  }
  return acc;
}

// out (r, c) = the sum over t < iters of take_along(x, (idx + t) mod n),
// n = x's extent on the axis, through the read-only cache: a thread an
// element, its index stepped (loop_sum).
template <int Axis>
__global__ void __launch_bounds__(kThreads)
take_along_loop_ldg(const int32_t* __restrict__ x, int xr, int xc,
                    const int32_t* __restrict__ idx, int iters, int32_t* __restrict__ out) {
  const long long n = static_cast<long long>(xr) * xc;
  const int span = Axis == 0 ? xr : xc;
  const int jmin = floor_mod(INT32_MIN, span);
  for (long long e = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; e < n;
       e += static_cast<long long>(gridDim.x) * kThreads) {
    const long long r = e / xc, c = e - r * xc;
    const int32_t* line = Axis == 0 ? x + c : x + r * xc;
    const long long step = Axis == 0 ? xc : 1;
    out[e] = static_cast<int32_t>(
        loop_sum(__ldg(idx + e), span, iters, jmin, [&](int j) { return __ldg(line + j * step); }));
  }
}

// The staged design: lines are x's columns (Axis 0) or rows (Axis 1), each
// n words along the axis.  Block (bx, by) stages lines [bx * lines, + lines)
// whole in shared memory with cp.async (Axis 0: the columns as their rows'
// pieces, s[j * lines + g]; Axis 1: the rows as they are, s[g * n + j]), then
// gives its threads the outputs of those lines at positions [by * len, +
// len) along the axis, neighbouring threads on neighbouring elements of
// out (Axis 0: a row's lines; Axis 1: a row's positions), each summing its
// gathers from shared memory (loop_sum).  vec: 16-byte copies (the pieces
// 16-byte aligned, whole multiples of 4 words).
template <int Axis>
__global__ void __launch_bounds__(kThreads)
take_along_loop_staged(const int32_t* __restrict__ x, int xr, int xc,
                       const int32_t* __restrict__ idx, int iters, int lines, int len, bool vec,
                       int32_t* __restrict__ out) {
  extern __shared__ int4 staged4[];
  int32_t* s = reinterpret_cast<int32_t*>(staged4);
  const int n = Axis == 0 ? xr : xc, m = Axis == 0 ? xc : xr;
  const int l0 = blockIdx.x * lines, p0 = blockIdx.y * len;
  const int nl = min(lines, m - l0), np = min(len, n - p0);
  if (Axis == 1) {
    stage(s, x + static_cast<long long>(l0) * xc, nl * n, vec);
  } else if (vec) {  // nl == lines, a multiple of 4
    const int q = lines / 4;
    for (int k = threadIdx.x; k < n * q; k += blockDim.x)
      cp_async16(s + 4 * k, x + static_cast<long long>(k / q) * xc + l0 + 4 * (k % q));
  } else {
    for (int k = threadIdx.x; k < n * nl; k += blockDim.x)
      cp_async4(s + k / nl * lines + k % nl, x + static_cast<long long>(k / nl) * xc + l0 + k % nl);
  }
  cp_async_wait_all();
  __syncthreads();
  const int jmin = floor_mod(INT32_MIN, n);
  for (int e = threadIdx.x; e < nl * np; e += blockDim.x) {
    const int g = Axis == 0 ? e % nl : e / np, p = p0 + (Axis == 0 ? e / nl : e % np);
    const long long at = Axis == 0 ? static_cast<long long>(p) * xc + l0 + g
                                   : static_cast<long long>(l0 + g) * xc + p;
    const int32_t* line = Axis == 0 ? s + g : s + g * n;
    const int step = Axis == 0 ? lines : 1;
    out[at] = static_cast<int32_t>(
        loop_sum(__ldg(idx + at), n, iters, jmin, [&](int j) { return line[j * step]; }));
  }
}

// table.reshape(-1)[idx] with flat_gather's clamp: i < 0 counts from the
// end, then [0, T - 1]
__device__ __forceinline__ long long flat_index(int i, long long T) {
  long long j = i;
  if (j < 0) j += T;
  return j < 0 ? 0 : (j >= T ? T - 1 : j);
}

// out[e] = table[idx[e]] over the flat idx (n), clamped.  Staged: the
// table (T words, 16-byte copies where tvec: the table 16-byte aligned)
// in shared memory, copied once by each block of a persistent grid while
// its threads load their first indices; else gathered through the
// read-only cache.  Units of 4 indices where Vec (the last n % 4 one at a
// time), else of 1; each thread has its next unit in flight.
template <bool Staged, bool Vec>
__global__ void __launch_bounds__(kStagedThreads, 2)
flat_gather_kernel(const int32_t* __restrict__ table, long long T, bool tvec,
                   const int32_t* __restrict__ idx, long long n, int32_t* __restrict__ out) {
  extern __shared__ int4 staged4[];
  int32_t* staged = reinterpret_cast<int32_t*>(staged4);
  const long long units = Vec ? n >> 2 : n;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (Staged) stage(staged, table, static_cast<int>(T), tvec);
  long long u = first;
  int4 next = u < units ? load_unit<Vec>(idx, u) : make_int4(0, 0, 0, 0);
  if (Staged) {
    cp_async_wait_all();
    __syncthreads();
  }
  const int ts = static_cast<int>(Staged ? T : 1);  // a staged table fits an int
  auto at = [&](int i) {
    if (Staged) {
      const int j = i < 0 ? i + ts : i;  // no overflow: ts < 2^16
      return staged[j < 0 ? 0 : (j >= ts ? ts - 1 : j)];
    }
    return __ldg(table + flat_index(i, T));
  };
  for (; u < units; u += step) {
    const int4 iv = next;
    if (u + step < units) next = load_unit<Vec>(idx, u + step);
    if (Vec) {
      int4 ov;
      ov.x = at(iv.x);
      ov.y = at(iv.y);
      ov.z = at(iv.z);
      ov.w = at(iv.w);
      reinterpret_cast<int4*>(out)[u] = ov;
    } else {
      out[u] = at(iv.x);
    }
  }
  if (Vec && first < (n & 3)) {  // the last n % 4 elements
    const long long e = (n & ~3LL) + first;
    out[e] = at(__ldg(idx + e));
  }
}

// ---- scatter_max -----------------------------------------------------------------
//
// b chunks of (r, w) indices and values into b chunks of (rows, w):
// out[k, idx[k, i, c], c] = max(out[...], vals[k, i, c]); out starts at 0.
//
// Route "smem": block blockIdx.x owns chunk k and the slab of nc <= cols
// adjacent columns from c0 (the host chooses cols and the block size,
// gather_probe.scatter_slabs):
//   - the thread of unit q of row t / L (L units a row: 4 columns each
//     by one 16-byte load where Vec, else 1) issues the loads of
//     kScatterBatch of its rows, idx and vals, then zeroes its share of
//     the (rows, nc) slab in shared memory while they are in flight;
//   - after __syncthreads() it applies each element by a shared-memory
//     atomicMax (ATOMS.MAX), then loads its next rows; a value of 0 or
//     less changes nothing in a slab that starts at 0, and is skipped;
//   - after __syncthreads() the block writes the slab out once, a row's
//     nc words a unit (16-byte stores where Vec), so every output word is
//     written by the kernel, with no global atomic and no zeroing launch.
// The slab is column-major (slab_at): a warp's atomics on one column land
// on banks of random rows, and a slab needs rows * nc words, so one
// column fits up to rows = tz_gather_staged_words().  Measured on an H100
// (probes/scatter_breakdown.py, (8, 2304, 128)): 3.0x faster than an
// atomic an element into zeros, 2.2x with the L2 evicted; slabs of 8
// columns (a 32-byte sector of a row) beat 4 and 16; row-major slabs, with
// or without padding, lost; one row's loads a thread won 5% in a warm L2
// and lost 25% in a cold one.
constexpr int kScatterBatch = 4;  // a thread's rows loaded before it updates

__host__ __device__ __forceinline__ long long slab_words(int rows, int cols) {
  return static_cast<long long>(rows) * cols;
}

__device__ __forceinline__ int slab_at(int row, int j, int rows, int cols) {
  return j * rows + row;
}

// slab = max(slab, v) at idx's row of column j, by scatter_max's index rule
__device__ __forceinline__ void slab_max(int32_t* slab, int i, int32_t v, int j, int rows,
                                         int cols) {
  if (i < 0) i += rows;  // no overflow: rows < 2^31
  if (v > 0 && static_cast<unsigned>(i) < static_cast<unsigned>(rows))
    atomicMax(slab + slab_at(i, j, rows, cols), v);
}

template <bool Vec>
__global__ void __launch_bounds__(kStagedThreads)
scatter_max_smem(const int32_t* __restrict__ idx, const int32_t* __restrict__ vals, int r, int w,
                 int rows, int cols, int32_t* __restrict__ out) {
  extern __shared__ int4 staged4[];
  int32_t* slab = reinterpret_cast<int32_t*>(staged4);
  const int slabs = (w + cols - 1) / cols;
  const int k = blockIdx.x / slabs, c0 = (blockIdx.x - k * slabs) * cols;
  const int nc = min(cols, w - c0);
  constexpr int per = Vec ? 4 : 1;  // columns a unit
  const int units = nc / per, pass = blockDim.x / units;  // pass: rows a pass
  const int q = threadIdx.x % units, first = threadIdx.x / units;
  const bool active = first < pass;
  const int j0 = q * per;
  const long long base = static_cast<long long>(k) * r * w + c0 + j0;
  const int step = kScatterBatch * pass;
  int4 iv[kScatterBatch], vv[kScatterBatch];
  auto load = [&](int r0) {
#pragma unroll
    for (int u = 0; u < kScatterBatch; ++u) {
      const int row = r0 + u * pass;
      if (row < r) {
        const long long at = base + static_cast<long long>(row) * w;
        iv[u] = load_unit<Vec>(idx + at, 0);
        vv[u] = load_unit<Vec>(vals + at, 0);
      }
    }
  };
  if (active) load(first);
  const int words = static_cast<int>(slab_words(rows, nc));
  for (int e = threadIdx.x * 4; e + 3 < words; e += blockDim.x * 4)
    *reinterpret_cast<int4*>(slab + e) = make_int4(0, 0, 0, 0);
  for (int e = (words & ~3) + threadIdx.x; e < words; e += blockDim.x) slab[e] = 0;
  __syncthreads();
  if (active) {
    for (int r0 = first; r0 < r; r0 += step) {
      if (r0 != first) load(r0);
#pragma unroll
      for (int u = 0; u < kScatterBatch; ++u) {
        if (r0 + u * pass >= r) break;
        slab_max(slab, iv[u].x, vv[u].x, j0, rows, nc);
        if (Vec) {
          slab_max(slab, iv[u].y, vv[u].y, j0 + 1, rows, nc);
          slab_max(slab, iv[u].z, vv[u].z, j0 + 2, rows, nc);
          slab_max(slab, iv[u].w, vv[u].w, j0 + 3, rows, nc);
        }
      }
    }
  }
  __syncthreads();
  if (!active) return;
  int32_t* o = out + static_cast<long long>(k) * rows * w + c0 + j0;
  for (int row = first; row < rows; row += pass) {
    int32_t* orow = o + static_cast<long long>(row) * w;
    if (Vec) {
      *reinterpret_cast<int4*>(orow) =
          make_int4(slab[slab_at(row, j0, rows, nc)], slab[slab_at(row, j0 + 1, rows, nc)],
                    slab[slab_at(row, j0 + 2, rows, nc)], slab[slab_at(row, j0 + 3, rows, nc)]);
    } else {
      *orow = slab[slab_at(row, j0, rows, nc)];
    }
  }
}

// Route "global": a thread an element, atomicMax into the zeroed output.
__global__ void __launch_bounds__(kThreads)
scatter_max_kernel(const int32_t* __restrict__ idx, const int32_t* __restrict__ vals, int b,
                   int r, int w, int rows, int32_t* __restrict__ out) {
  const long long chunk = static_cast<long long>(r) * w;
  const long long n = chunk * b;
  for (long long e = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; e < n;
       e += static_cast<long long>(gridDim.x) * kThreads) {
    int i = idx[e];
    if (i < 0) i += rows;
    if (i < 0 || i >= rows) continue;
    const long long k = e / chunk, c = e % w;
    atomicMax(out + (k * rows + i) * w + c, vals[e]);
  }
}

// b chunks of n words, each shifted within itself: out[p] = the signed max
// over s in [1, steps] of x[(p - s) mod n] ^ x[p], and 0.
//
// Bound: 8 bytes a word (x read, out written) at 3.35 TB/s; a word's steps
// xors and maxes come near that at steps = 16 (32 integer steps a word on
// 64 lanes an SM and clock).  So the register route keeps every operand in
// registers and moves 16 bytes a load and a store:
//   - a chunk's body, from the first 16-byte boundary at or past its word
//     kShiftWindow to its last whole 16 bytes, goes in warp tiles of 32 int4s,
//     each lane one int4 (4 words) in and one out;
//   - a lane's 16 predecessors are the int4s of the 4 lanes before it, by 4
//     shuffles a word; where they lie before the tile, lanes 28-31 hold them
//     (one more 16-byte load each, the tile's 16 words before it, from L1 or
//     L2) and send them in place of their own for the shuffles that wrap;
//   - a grid-stride loop over the tiles, up to a card's worth of resident
//     blocks (loading the next tile before the current one's arithmetic
//     measured slower, probes/bits_shift_breakdown.py); offsets within a
//     tile are 32-bit;
//   - the words before the body (which may wrap, the only ones) and after
//     it, at most 19 + 3 a chunk, go one a thread, each with its
//     predecessors' loads issued together; only they wrap, more than once
//     only where the chunk is shorter than the shift.
// Steps above kShiftWindow take the staged route: a block's words and the
// `steps` before them in shared memory, the wrap only in a chunk's first
// blocks.
constexpr int kShiftWindow = 16;  // the register route's steps at most
constexpr int kShiftWarps = 8;    // warps of a register-route block

// word p of the chunk at cx (n words) screened alone, against its steps
// (at most kShiftWindow) predecessors, their loads issued together
__device__ __forceinline__ int32_t shift_word(const int32_t* cx, long long n, long long p,
                                              int steps) {
  const int32_t cur = __ldg(cx + p);
  int32_t v[kShiftWindow];
#pragma unroll
  for (int s = 1; s <= kShiftWindow; ++s) {
    long long q = p - s;
    while (q < 0) q += n;  // more than once only in a chunk shorter than the shift
    v[s - 1] = s <= steps ? __ldg(cx + q) : cur;  // cur ^ cur adds nothing
  }
  int32_t acc = 0;
#pragma unroll
  for (int s = 0; s < kShiftWindow; ++s) acc = max(acc, v[s] ^ cur);
  return acc;
}

// the tile at tp (32 int4s of a chunk's body; `left` of them from tp on):
// lane's int4, zeros past the body, and for lanes 28-31 the int4 32 before
// theirs (the tile's 16 words before it)
__device__ __forceinline__ void load_tile(const int4* tp, long long left, int lane, int4& cur,
                                          int4& hd) {
  cur = lane < left ? __ldg(tp + lane) : make_int4(0, 0, 0, 0);
  hd = lane >= 28 ? __ldg(tp + lane - 32) : make_int4(0, 0, 0, 0);
}

// a lane's 4 words screened against their 16 predecessors: w[16 + k] is
// word k of its int4, w[16 - 4d + k] word k of the int4 d before it, taken
// from lane - d, or for d > lane from the hd of lane 32 - d + lane, which
// sends hd in place of cur for the shuffles of distance 32 - lane or more
template <bool Full>
__device__ __forceinline__ int4 screen4(const int4& cur, const int4& hd, int lane, int steps) {
  int32_t w[20];
  w[16] = cur.x, w[17] = cur.y, w[18] = cur.z, w[19] = cur.w;
#pragma unroll
  for (int d = 1; d <= 4; ++d) {
    const int4 src = lane >= 32 - d ? hd : cur;
    const int from = (lane - d) & 31;
    w[16 - 4 * d] = __shfl_sync(0xffffffffu, src.x, from);
    w[17 - 4 * d] = __shfl_sync(0xffffffffu, src.y, from);
    w[18 - 4 * d] = __shfl_sync(0xffffffffu, src.z, from);
    w[19 - 4 * d] = __shfl_sync(0xffffffffu, src.w, from);
  }
  int32_t o[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int32_t c = w[16 + k];
    int32_t acc = 0;
#pragma unroll
    for (int s = 1; s <= kShiftWindow; ++s)
      if (Full || s <= steps) acc = max(acc, w[16 + k - s] ^ c);
    o[k] = acc;
  }
  return make_int4(o[0], o[1], o[2], o[3]);
}

// the register route, steps <= kShiftWindow (Full: steps == kShiftWindow);
// chunk blockIdx.y; x and out equally far past a 16-byte boundary
template <bool Full>
__global__ void __launch_bounds__(kShiftWarps * 32)
shift_screen_regs(const int32_t* __restrict__ x, long long n, int steps,
                  int32_t* __restrict__ out) {
  const long long first = static_cast<long long>(blockIdx.y) * n;
  const int32_t* cx = x + first;
  int32_t* co = out + first;
  // the body: words [v0, v0 + 4 n4), v0 the first on a 16-byte boundary
  // at or past word kShiftWindow
  const int v0 =
      kShiftWindow + static_cast<int>(((16 - (reinterpret_cast<uintptr_t>(cx) & 15)) & 15) >> 2);
  const long long n4 = n > v0 ? (n - v0) >> 2 : 0, v1 = v0 + 4 * n4;
  if (blockIdx.x == 0) {  // the words before the body and after it, a thread each
    const int head = static_cast<int>(n < v0 ? n : v0);
    const long long t = threadIdx.x;
    if (t < head) co[t] = shift_word(cx, n, t, steps);
    else if (v1 + t - head < n) co[v1 + t - head] = shift_word(cx, n, v1 + t - head, steps);
  }
  const int lane = threadIdx.x & 31;
  const long long tiles = (n4 + 31) >> 5, stride = static_cast<long long>(gridDim.x) * kShiftWarps;
  long long tile = static_cast<long long>(blockIdx.x) * kShiftWarps + (threadIdx.x >> 5);
  const int4* bx = reinterpret_cast<const int4*>(cx + v0);
  int4* bo = reinterpret_cast<int4*>(co + v0);
  for (; tile < tiles; tile += stride) {
    int4 cur, hd;
    load_tile(bx + 32 * tile, n4 - 32 * tile, lane, cur, hd);
    const int4 r = screen4<Full>(cur, hd, lane, steps);
    if (lane < n4 - 32 * tile) bo[32 * tile + lane] = r;
  }
}

// the staged route: a block owns kThreads words of chunk blockIdx.y and
// stages them with the `steps` words before them
__global__ void __launch_bounds__(kThreads)
shift_screen_staged(const int32_t* __restrict__ x, long long n, int steps,
                    int32_t* __restrict__ out) {
  extern __shared__ int32_t tile[];  // steps + kThreads words
  const long long first = static_cast<long long>(blockIdx.y) * n;
  const int32_t* cx = x + first;
  const long long base = static_cast<long long>(blockIdx.x) * kThreads;
  const long long left = n - base;
  const int count = steps + static_cast<int>(left < kThreads ? left : kThreads);
  if (base >= steps) {
    const int32_t* bx = cx + (base - steps);
    for (int j = threadIdx.x; j < count; j += kThreads) tile[j] = __ldg(bx + j);
  } else {  // a chunk's first words: their predecessors wrap
    for (int j = threadIdx.x; j < count; j += kThreads) {
      long long p = base - steps + j;
      if (p < 0) {
        p += n;
        if (p < 0) p = (p % n + n) % n;  // a chunk shorter than the shift
      }
      tile[j] = __ldg(cx + p);
    }
  }
  __syncthreads();
  const int t = threadIdx.x;
  if (t >= left) return;
  const int32_t cur = tile[steps + t];
  int32_t acc = 0;
  for (int s = 1; s <= steps; ++s) acc = max(acc, tile[steps + t - s] ^ cur);
  out[first + base + t] = acc;
}

// ---- the card --------------------------------------------------------------------

struct Card {
  int sms;            // streaming multiprocessors
  int smem_block;     // dynamic shared memory a block may opt in to, bytes
  int smem_sm;        // shared memory an SM holds, bytes
  int smem_reserved;  // shared memory the system keeps a block, bytes
};

// the current device's Card, read once a device; the staged kernels are
// allowed its whole smem_block on first use
cudaError_t current_card(const Card** out) {
  static Card cards[kMaxDevices];
  static std::atomic<bool> ready[kMaxDevices];
  static std::mutex mu;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!ready[dev].load(std::memory_order_acquire)) {
    std::lock_guard<std::mutex> lock(mu);
    if (!ready[dev].load(std::memory_order_relaxed)) {
      Card c{};
      const std::pair<int*, cudaDeviceAttr> attrs[] = {
          {&c.sms, cudaDevAttrMultiProcessorCount},
          {&c.smem_block, cudaDevAttrMaxSharedMemoryPerBlockOptin},
          {&c.smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor},
          {&c.smem_reserved, cudaDevAttrReservedSharedMemoryPerBlock}};
      for (const auto& a : attrs)
        if ((err = cudaDeviceGetAttribute(a.first, a.second, dev)) != cudaSuccess) return err;
      const void* staged[] = {
          reinterpret_cast<const void*>(take_along_staged<true, int>),
          reinterpret_cast<const void*>(take_along_staged<true, long long>),
          reinterpret_cast<const void*>(take_along_staged<false, int>),
          reinterpret_cast<const void*>(take_along_staged<false, long long>),
          reinterpret_cast<const void*>(flat_gather_kernel<true, true>),
          reinterpret_cast<const void*>(flat_gather_kernel<true, false>),
          reinterpret_cast<const void*>(take_along_loop_staged<0>),
          reinterpret_cast<const void*>(take_along_loop_staged<1>),
          reinterpret_cast<const void*>(scatter_max_smem<true>),
          reinterpret_cast<const void*>(scatter_max_smem<false>)};
      for (const void* k : staged)
        if ((err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        c.smem_block)) != cudaSuccess)
          return err;
      cards[dev] = c;
      ready[dev].store(true, std::memory_order_release);
    }
  }
  *out = &cards[dev];
  return cudaSuccess;
}

// the staged design serves a source (an axis-1 row of x, a flat table) of
// `words` int32 where it fits one block's shared memory
bool staged_fits(const Card& c, long long words) { return words * 4 <= c.smem_block; }

// blocks of `threads` that fit an SM beside each other, each holding
// `bytes` of shared memory, at most `most`
int blocks_an_sm(const Card& c, int threads, long long bytes, int most) {
  long long k = c.smem_sm / (bytes + c.smem_reserved);
  if (k > kSmThreads / threads) k = kSmThreads / threads;
  if (k > most) k = most;
  return k < 1 ? 1 : static_cast<int>(k);
}

int pow2_at_least(unsigned n, int lo, int hi) {
  int p = lo;
  while (p < hi && static_cast<unsigned>(p) < n) p *= 2;
  return p;
}

// f(std::integral_constant<bool, vec>{}, Off{}) with Off int where narrow
template <typename F>
void with_modes(bool vec, bool narrow, F&& f) {
  if (vec) {
    if (narrow) f(std::true_type{}, int{});
    else f(std::true_type{}, 0LL);
  } else {
    if (narrow) f(std::false_type{}, int{});
    else f(std::false_type{}, 0LL);
  }
}

}  // namespace

// The most int32 words of a source (an axis-1 row of x, a flat table)
// that take_along and flat_gather stage in shared memory on the current
// device (a wider one is gathered through the read-only cache), or a
// negative cudaError_t where the card cannot be read.
extern "C" int tz_gather_staged_words() {
  const Card* c = nullptr;
  const cudaError_t err = current_card(&c);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return c->smem_block / 4;
}

// x: int32 (xr, xc); idx: int32 (ir, ic), ic == xc for axis 0, ir == xr
// for axis 1; out: int32 (ir, ic).
extern "C" int tz_take_along(const void* x, int xr, int xc, const void* idx, int ir, int ic,
                             int axis, int fill, void* out, void* stream) {
  if (xr <= 0 || xc <= 0 || ir <= 0 || ic <= 0 || axis < 0 || axis > 1 ||
      (axis == 0 ? ic != xc : ir != xr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Card* c = nullptr;
  const cudaError_t err = current_card(&c);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* xs = static_cast<const int32_t*>(x);
  const auto* is = static_cast<const int32_t*>(idx);
  auto* o = static_cast<int32_t*>(out);
  const bool vec = ic % 4 == 0 && aligned16(idx) && aligned16(out);
  const bool narrow = static_cast<long long>(xr) * xc < (1LL << 31) &&
                      static_cast<long long>(ir) * ic < (1LL << 31);
  const unsigned units = vec ? static_cast<unsigned>(ic) / 4 : static_cast<unsigned>(ic);
  if (axis == 1 && staged_fits(*c, xc)) {
    const int threads = pow2_at_least(units, 32, kStagedThreads);
    const long long bytes = 4LL * xc;
    const long long most = static_cast<long long>(c->sms) * blocks_an_sm(*c, threads, bytes, 32);
    const unsigned blocks = static_cast<unsigned>(ir < most ? ir : most);
    const bool xvec = xc % 4 == 0 && aligned16(x);
    with_modes(vec, narrow, [&](auto v, auto off) {
      take_along_staged<decltype(v)::value, decltype(off)>
          <<<blocks, threads, bytes, s>>>(xs, xc, xvec, is, ir, ic, fill, o);
    });
  } else {
    // a block of 256 threads: tx a row's units, ty rows
    const int tx = pow2_at_least(units, 1, kThreads), ty = kThreads / tx;
    const long long most = static_cast<long long>(c->sms) * (kSmThreads / kThreads);
    long long gx = (units + tx - 1) / tx, gy = (ir + ty - 1LL) / ty;
    if (gx > most) gx = most;
    const long long gy_most = most / gx > 0 ? most / gx : 1;
    if (gy > gy_most) gy = gy_most;
    if (gy > 65535) gy = 65535;
    const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy)), block(tx, ty);
    with_modes(vec, narrow, [&](auto v, auto off) {
      constexpr bool V = decltype(v)::value;
      using Off = decltype(off);
      if (axis == 0) take_along_ldg<0, V, Off><<<grid, block, 0, s>>>(xs, xr, xc, is, ir, ic, fill, o);
      else take_along_ldg<1, V, Off><<<grid, block, 0, s>>>(xs, xr, xc, is, ir, ic, fill, o);
    });
  }
  return static_cast<int>(cudaGetLastError());
}

// x, idx, out: int32 (xr, xc), xr, xc >= 1; iters >= 0; staged: 1 for the
// staged design (the axis's extent at most tz_gather_staged_words()), 0
// for the read-only-cache one.
extern "C" int tz_take_along_loop(const void* x, int xr, int xc, const void* idx, int axis,
                                  int iters, int staged, void* out, void* stream) {
  const long long n = static_cast<long long>(xr) * xc;
  const int span = axis == 0 ? xr : xc, other = axis == 0 ? xc : xr;
  if (xr <= 0 || xc <= 0 || iters < 0 || axis < 0 || axis > 1 || staged < 0 || staged > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Card* c = nullptr;
  const cudaError_t err = current_card(&c);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* xs = static_cast<const int32_t*>(x);
  const auto* is = static_cast<const int32_t*>(idx);
  auto* o = static_cast<int32_t*>(out);
  if (!staged) {
    if (axis == 0) take_along_loop_ldg<0><<<grid_for(n), kThreads, 0, s>>>(xs, xr, xc, is, iters, o);
    else take_along_loop_ldg<1><<<grid_for(n), kThreads, 0, s>>>(xs, xr, xc, is, iters, o);
    return static_cast<int>(cudaGetLastError());
  }
  if (!staged_fits(*c, span)) return static_cast<int>(cudaErrorInvalidValue);
  // lines a block: up to 8 (a 32-byte sector of each row on axis 0) while
  // two blocks fit an SM, at least 1; then the positions split so that
  // the grid gives two blocks an SM, at least 64 a block
  int lines = 8;
  while (lines > 1 && (lines > other || 4LL * lines * span > c->smem_sm / 2 - c->smem_reserved))
    lines /= 2;
  const long long groups = (other + lines - 1) / lines;
  long long parts = (2LL * c->sms + groups - 1) / groups;
  const long long most = (span + 63) / 64;
  if (parts > most) parts = most;
  if (parts > 65535) parts = 65535;
  const int len = static_cast<int>((span + parts - 1) / parts);
  parts = (span + len - 1) / len;
  const long long bytes = 4LL * lines * span;
  const dim3 grid(static_cast<unsigned>(groups), static_cast<unsigned>(parts));
  if (axis == 0) {
    const bool vec = lines % 4 == 0 && other % lines == 0 && xc % 4 == 0 && aligned16(x);
    take_along_loop_staged<0><<<grid, kThreads, bytes, s>>>(xs, xr, xc, is, iters, lines, len,
                                                            vec, o);
  } else {
    const bool vec = xc % 4 == 0 && aligned16(x);
    take_along_loop_staged<1><<<grid, kThreads, bytes, s>>>(xs, xr, xc, is, iters, lines, len,
                                                            vec, o);
  }
  return static_cast<int>(cudaGetLastError());
}

// table: int32[T], T >= 1; idx, out: int32[n], n >= 1.
extern "C" int tz_flat_gather(const void* table, long long T, const void* idx, long long n,
                              void* out, void* stream) {
  if (T <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Card* c = nullptr;
  const cudaError_t err = current_card(&c);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* ts = static_cast<const int32_t*>(table);
  const auto* is = static_cast<const int32_t*>(idx);
  auto* o = static_cast<int32_t*>(out);
  const bool vec = aligned16(idx) && aligned16(out);
  const long long units = vec ? n / 4 : n;
  const bool staged = staged_fits(*c, T);
  const int threads = staged ? kStagedThreads : kThreads;
  const long long bytes = staged ? 4 * T : 0;
  // staged: a persistent grid of one or two blocks an SM, each copying
  // the table once; else enough blocks to fill the card
  const long long most = static_cast<long long>(c->sms) *
                         (staged ? blocks_an_sm(*c, threads, bytes, 2) : kSmThreads / threads);
  long long blocks = (units + threads - 1) / threads;
  if (blocks > most) blocks = most;
  if (blocks < 1) blocks = 1;  // n < 4: the tail alone
  const bool tvec = aligned16(table);
  with_modes(vec, true, [&](auto v, auto) {
    constexpr bool V = decltype(v)::value;
    if (staged)
      flat_gather_kernel<true, V><<<static_cast<unsigned>(blocks), threads, bytes, s>>>(
          ts, T, tvec, is, n, o);
    else
      flat_gather_kernel<false, V><<<static_cast<unsigned>(blocks), threads, 0, s>>>(
          ts, T, tvec, is, n, o);
  });
  return static_cast<int>(cudaGetLastError());
}

// idx, vals: int32 (b, r, w); out: int32 (b, rows, w).  cols >= 1: route
// "smem", slabs of `cols` columns on blocks of `threads` (a multiple of 32
// from 32 to 512, at least cols), every output word written by the kernel;
// the slab, slab_words(rows, cols) words, must fit a block's shared
// memory.  cols == 0: route "global", out zeroed by the caller.
extern "C" int tz_scatter_max(const void* idx, const void* vals, int b, int r, int w, int rows,
                              int cols, int threads, void* out, void* stream) {
  const long long n = static_cast<long long>(b) * r * w;
  if (b <= 0 || r <= 0 || w <= 0 || rows <= 0 || cols < 0) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* is = static_cast<const int32_t*>(idx);
  const auto* vs = static_cast<const int32_t*>(vals);
  auto* o = static_cast<int32_t*>(out);
  if (cols == 0) {
    scatter_max_kernel<<<grid_for(n), kThreads, 0, s>>>(is, vs, b, r, w, rows, o);
    return static_cast<int>(cudaGetLastError());
  }
  const Card* c = nullptr;
  const cudaError_t err = current_card(&c);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>(b) * ((w + cols - 1LL) / cols);
  const long long bytes = 4 * slab_words(rows, cols);
  if (threads < 32 || threads > kStagedThreads || threads % 32 || threads < cols ||
      blocks > 0x7FFFFFFFLL || bytes > c->smem_block)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = w % 4 == 0 && cols % 4 == 0 && aligned16(idx) && aligned16(vals) &&
                   aligned16(out);
  if (vec)
    scatter_max_smem<true><<<static_cast<unsigned>(blocks), threads, bytes, s>>>(is, vs, r, w, rows,
                                                                                 cols, o);
  else
    scatter_max_smem<false><<<static_cast<unsigned>(blocks), threads, bytes, s>>>(is, vs, r, w,
                                                                                  rows, cols, o);
  return static_cast<int>(cudaGetLastError());
}

// x, out: int32 (b, n), 1 <= b <= 65535, n >= 1, each as far past a 16-byte
// boundary as the other; route: 0 the registers (0 <= steps <= 16), 1 the
// staged route (0 <= steps <= 4096; shared memory: 4 (steps + 256) bytes).
extern "C" int tz_shift_screen(const void* x, int b, long long n, int steps, int route, void* out,
                               void* stream) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (b <= 0 || b > 65535 || n <= 0 || steps < 0 || steps > 4096 || blocks > 0x7FFFFFFFLL ||
      (route != 0 && route != 1) || (route == 0 && steps > kShiftWindow) ||
      reinterpret_cast<uintptr_t>(x) % 4 ||
      (reinterpret_cast<uintptr_t>(x) - reinterpret_cast<uintptr_t>(out)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* xs = static_cast<const int32_t*>(x);
  auto* o = static_cast<int32_t*>(out);
  if (route == 1) {
    shift_screen_staged<<<dim3(static_cast<unsigned>(blocks), b), kThreads,
                          (steps + kThreads) * sizeof(int32_t), s>>>(xs, n, steps, o);
    return static_cast<int>(cudaGetLastError());
  }
  const Card* c = nullptr;
  const cudaError_t err = current_card(&c);
  if (err != cudaSuccess) return static_cast<int>(err);
  // a warp a tile of 128 words; blocks enough for the chunks' tiles, at
  // most a card's worth of resident blocks across the chunks (at least 1:
  // a chunk's first block also takes its words outside the body)
  long long grid = (n / 4 + 32 * kShiftWarps - 1) / (32 * kShiftWarps);
  const long long fill = (static_cast<long long>(c->sms) * (kSmThreads / (kShiftWarps * 32)) + b - 1) / b;
  if (grid > fill) grid = fill;
  if (grid < 1) grid = 1;
  const dim3 g(static_cast<unsigned>(grid), b);
  if (steps == kShiftWindow) shift_screen_regs<true><<<g, kShiftWarps * 32, 0, s>>>(xs, n, steps, o);
  else shift_screen_regs<false><<<g, kShiftWarps * 32, 0, s>>>(xs, n, steps, o);
  return static_cast<int>(cudaGetLastError());
}
