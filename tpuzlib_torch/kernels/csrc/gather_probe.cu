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
// MiB at most) that is microseconds, below the launch itself.  Designs,
// simple first: one thread an output element, neighbouring threads on
// neighbouring elements, so that the index reads and the output writes
// coalesce and the gathers fall in L1 or L2 (the tools' arrays fit in L2).
// take_along_loop keeps its sum in a register and adds as unsigned, so
// that the int32 wrap is defined.  scatter_max has each thread atomicMax
// its value into the zeroed output.  shift_screen stages a block's words
// and the `steps` words before them (wrapping within the chunk) in shared
// memory, and each thread reads its predecessors there.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGrid = 1 << 16;  // blocks of a grid-stride launch

__host__ __device__ __forceinline__ unsigned grid_for(long long n) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks < kMaxGrid ? blocks : kMaxGrid);
}

// out (ir, ic) from x (xr, xc): out[r, c] = x[idx[r, c], c] (Axis 0) or
// x[r, idx[r, c]] (Axis 1); ic == xc for Axis 0, ir == xr for Axis 1.
template <int Axis>
__global__ void __launch_bounds__(kThreads)
take_along_kernel(const int32_t* __restrict__ x, int xr, int xc, const int32_t* __restrict__ idx,
                  int ir, int ic, int fill, int32_t* __restrict__ out) {
  const long long n = static_cast<long long>(ir) * ic;
  const int span = Axis == 0 ? xr : xc;
  for (long long e = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; e < n;
       e += static_cast<long long>(gridDim.x) * kThreads) {
    int i = idx[e];
    if (i < 0) i += span;  // no overflow: span <= INT32_MAX
    int32_t v = fill;
    if (i >= 0 && i < span) {
      const long long r = e / ic, c = e - r * ic;
      v = __ldg(x + (Axis == 0 ? static_cast<long long>(i) * xc + c : r * xc + i));
    }
    out[e] = v;
  }
}

// out (r, c) = the sum over t < iters of take_along(x, (idx + t) mod n),
// n = x's extent on the axis; idx + t wraps as int32, then a floor mod.
template <int Axis>
__global__ void __launch_bounds__(kThreads)
take_along_loop_kernel(const int32_t* __restrict__ x, int xr, int xc,
                       const int32_t* __restrict__ idx, int iters, int32_t* __restrict__ out) {
  const long long n = static_cast<long long>(xr) * xc;
  const int span = Axis == 0 ? xr : xc;
  for (long long e = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; e < n;
       e += static_cast<long long>(gridDim.x) * kThreads) {
    const long long r = e / xc, c = e - r * xc;
    const uint32_t i0 = static_cast<uint32_t>(idx[e]);
    uint32_t acc = 0u;
#pragma unroll 4
    for (int t = 0; t < iters; ++t) {
      int j = static_cast<int>(i0 + static_cast<uint32_t>(t)) % span;
      if (j < 0) j += span;
      acc += static_cast<uint32_t>(
          __ldg(x + (Axis == 0 ? static_cast<long long>(j) * xc + c : r * xc + j)));
    }
    out[e] = static_cast<int32_t>(acc);
  }
}

__global__ void __launch_bounds__(kThreads)
flat_gather_kernel(const int32_t* __restrict__ table, long long T,
                   const int32_t* __restrict__ idx, long long n, int32_t* __restrict__ out) {
  for (long long e = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; e < n;
       e += static_cast<long long>(gridDim.x) * kThreads) {
    long long i = idx[e];
    if (i < 0) i += T;
    i = i < 0 ? 0 : (i >= T ? T - 1 : i);
    out[e] = __ldg(table + i);
  }
}

// b chunks of (r, w) indices and values into b chunks of (rows, w):
// out[k, idx[k, i, c], c] = max(out[...], vals[k, i, c]); out starts at 0.
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
// over s in [1, steps] of x[(p - s) mod n] ^ x[p], and 0.  A block owns
// kThreads words of one chunk (blockIdx.y) and stages them with the
// `steps` words before them.
__global__ void __launch_bounds__(kThreads)
shift_screen_kernel(const int32_t* __restrict__ x, long long n, int steps,
                    int32_t* __restrict__ out) {
  extern __shared__ int32_t tile[];  // steps + kThreads words
  const int32_t* cx = x + static_cast<long long>(blockIdx.y) * n;
  const long long base = static_cast<long long>(blockIdx.x) * kThreads;
  for (int j = threadIdx.x; j < steps + kThreads; j += kThreads) {
    long long p = (base - steps + j) % n;  // may wrap more than once when n < steps
    if (p < 0) p += n;
    tile[j] = cx[p];
  }
  __syncthreads();
  const long long p = base + threadIdx.x;
  if (p >= n) return;
  const int32_t cur = tile[steps + threadIdx.x];
  int32_t acc = 0;
  for (int s = 1; s <= steps; ++s) acc = max(acc, tile[steps + threadIdx.x - s] ^ cur);
  out[static_cast<long long>(blockIdx.y) * n + p] = acc;
}

}  // namespace

// x: int32 (xr, xc); idx: int32 (ir, ic), ic == xc for axis 0, ir == xr
// for axis 1; out: int32 (ir, ic).
extern "C" int tz_take_along(const void* x, int xr, int xc, const void* idx, int ir, int ic,
                             int axis, int fill, void* out, void* stream) {
  const long long n = static_cast<long long>(ir) * ic;
  if (n <= 0 || (axis == 0 ? ic != xc : ir != xr)) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* xs = static_cast<const int32_t*>(x);
  const auto* is = static_cast<const int32_t*>(idx);
  auto* o = static_cast<int32_t*>(out);
  if (axis == 0) take_along_kernel<0><<<grid_for(n), kThreads, 0, s>>>(xs, xr, xc, is, ir, ic, fill, o);
  else if (axis == 1) take_along_kernel<1><<<grid_for(n), kThreads, 0, s>>>(xs, xr, xc, is, ir, ic, fill, o);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// x, idx, out: int32 (xr, xc), xr, xc >= 1; iters >= 0.
extern "C" int tz_take_along_loop(const void* x, int xr, int xc, const void* idx, int axis,
                                  int iters, void* out, void* stream) {
  const long long n = static_cast<long long>(xr) * xc;
  if (xr <= 0 || xc <= 0 || iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* xs = static_cast<const int32_t*>(x);
  const auto* is = static_cast<const int32_t*>(idx);
  auto* o = static_cast<int32_t*>(out);
  if (axis == 0) take_along_loop_kernel<0><<<grid_for(n), kThreads, 0, s>>>(xs, xr, xc, is, iters, o);
  else if (axis == 1) take_along_loop_kernel<1><<<grid_for(n), kThreads, 0, s>>>(xs, xr, xc, is, iters, o);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// table: int32[T], T >= 1; idx, out: int32[n], n >= 1.
extern "C" int tz_flat_gather(const void* table, long long T, const void* idx, long long n,
                              void* out, void* stream) {
  if (T <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  flat_gather_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(table), T, static_cast<const int32_t*>(idx), n,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// idx, vals: int32 (b, r, w); out: int32 (b, rows, w), zeroed by the caller.
extern "C" int tz_scatter_max(const void* idx, const void* vals, int b, int r, int w, int rows,
                              void* out, void* stream) {
  const long long n = static_cast<long long>(b) * r * w;
  if (n <= 0 || rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  scatter_max_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(idx), static_cast<const int32_t*>(vals), b, r, w, rows,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// x, out: int32 (b, n); 0 <= steps <= 4096 (shared memory: 4 (steps + 256) bytes).
extern "C" int tz_shift_screen(const void* x, int b, long long n, int steps, void* out,
                               void* stream) {
  if (b <= 0 || n <= 0 || steps < 0 || steps > 4096) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL || b > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(b));
  shift_screen_kernel<<<grid, kThreads, (steps + kThreads) * sizeof(int32_t),
                        static_cast<cudaStream_t>(stream)>>>(static_cast<const int32_t*>(x), n,
                                                             steps, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
