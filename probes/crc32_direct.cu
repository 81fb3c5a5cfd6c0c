// The CRC-32 forms kernel as first redesigned, kept for timing only
// (probes/crc_breakdown.py builds it beside tpuzlib_torch/kernels/csrc/
// crc32.cu): the same contract and arithmetic, but each thread loads its
// own 1 KiB block as aligned 16-byte words straight from device memory and
// folds it as kChains chains of kPiece bytes, joined with A^kPiece through
// byte tables.  On the card its loads were the limit: a warp's loads touch
// 32 lines at a time and 8 chains a thread keep so many lines open that
// the L1 cache thrashes; with the lookups replaced by shifts it took as
// long as with them.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 1024;             // bytes per form
constexpr int kLogBlock = 10;
constexpr int kThreads = 256;            // 1 KiB blocks per CUDA block (one span)
constexpr int kLevels = 8;               // log2(kThreads)
constexpr int kChains = 8;               // independent chains a thread
constexpr int kPiece = kBlock / kChains; // bytes a chain
constexpr int kSteps = kPiece / 16;      // 16-byte words a chain
constexpr int kPowers = 64;              // A^(2^k) for k < kPowers

struct Args {
  const uint8_t* data;
  long long n, pad;           // data bytes; virtual zero bytes in front
  const uint32_t* table;      // the CRC table (256)
  const uint32_t* powers;     // A^(2^k), k < kPowers, 32 packed columns each
  uint32_t* out;              // forms: one a block (tile 1) or a span (tile 256)
  long long nb;               // 1 KiB blocks of zeros(pad) | data
  int tile;
};

__host__ __device__ constexpr int log2i(int v) { return v > 1 ? 1 + log2i(v / 2) : 0; }

// mat (32 packed columns) applied to v
__device__ __forceinline__ uint32_t apply(const uint32_t* cols, uint32_t v) {
  uint32_t r = 0;
#pragma unroll
  for (int b = 0; b < 32; ++b) r ^= cols[b] & (0u - ((v >> b) & 1u));
  return r;
}

// the 16 bytes at data[i, i + 16), data + i 16-byte aligned; kEdge: bytes
// outside [0, n) read as 0 and are not loaded
template <bool kEdge>
__device__ __forceinline__ uint4 load16(const uint8_t* data, long long n, long long i) {
  if (!kEdge || (i >= 0 && i + 16 <= n)) return __ldg(reinterpret_cast<const uint4*>(data + i));
  uint32_t w[4] = {0, 0, 0, 0};
  if (i + 16 > 0 && i < n) {
#pragma unroll
    for (int b = 0; b < 16; ++b)
      if (i + b >= 0 && i + b < n) w[b >> 2] |= static_cast<uint32_t>(data[i + b]) << (8 * (b & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// one byte through the lane's own table copy (tl = table + lane)
__device__ __forceinline__ uint32_t step(const uint32_t* tl, uint32_t x) {
  return tl[(x & 0xFFu) << 5] ^ (x >> 8);
}

// word j (0..3) of the 16 bytes that start Q * 4 + sh / 8 bytes into the
// two aligned words (a, b)
template <int Q>
__device__ __forceinline__ uint32_t word_at(const uint4& a, const uint4& b, int j, int sh) {
  const uint32_t x[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  return __funnelshift_r(x[j + Q], x[j + Q + 1], sh);
}

// the form of the 1 KiB block whose first byte is data[at], the aligned
// word at data[i0] holding it at byte 4 Q + sh / 8
template <int Q, bool kEdge>
__device__ __forceinline__ uint32_t fold_block(const Args& a, long long i0, int sh,
                                               const uint32_t* tl, const uint32_t* join) {
  uint32_t crc[kChains];
  uint4 cur[kChains];
#pragma unroll
  for (int c = 0; c < kChains; ++c) {
    crc[c] = 0;
    cur[c] = load16<kEdge>(a.data, a.n, i0 + c * kPiece);
  }
#pragma unroll 1
  for (int k = 0; k < kSteps; ++k) {
    uint4 nxt[kChains];
#pragma unroll
    for (int c = 0; c < kChains; ++c) nxt[c] = load16<kEdge>(a.data, a.n, i0 + c * kPiece + 16 * (k + 1));
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int c = 0; c < kChains; ++c) crc[c] ^= word_at<Q>(cur[c], nxt[c], j, sh);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
#pragma unroll
        for (int c = 0; c < kChains; ++c) crc[c] = step(tl, crc[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < kChains; ++c) cur[c] = nxt[c];
  }
  uint32_t f = crc[0];
#pragma unroll
  for (int c = 1; c < kChains; ++c)
    f = join[f & 0xFF] ^ join[256 + ((f >> 8) & 0xFF)] ^ join[512 + ((f >> 16) & 0xFF)] ^
        join[768 + (f >> 24)] ^ crc[c];
  return f;
}

// The form of kThreads consecutive pieces of 2^lg bytes, thread t's form v
// being piece t's; thread 0 returns it.  Every thread calls it.
__device__ uint32_t block_tree(uint32_t v, const uint32_t* pw, int lg, uint32_t* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // after level l, lane i = 0 mod 2^(l+1) holds the form of lanes [i, i + 2^(l+1))
#pragma unroll
  for (int l = 0; l < 5; ++l) {
    const uint32_t right = __shfl_down_sync(0xFFFFFFFFu, v, 1 << l);
    v = apply(pw + (lg + l) * 32, v) ^ right;
  }
  __syncthreads();  // part is free
  if (lane == 0) part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kThreads / 32 ? part[lane] : 0;
#pragma unroll
    for (int l = 5; l < kLevels; ++l) {
      const uint32_t right = __shfl_down_sync(0xFFFFFFFFu, v, 1 << (l - 5));
      v = apply(pw + (lg + l) * 32, v) ^ right;
    }
  }
  return v;
}

template <int Q>
__global__ void __launch_bounds__(kThreads, 2) crc32_kernel(Args a) {
  __shared__ uint32_t lanes[256 * 32];   // entry e of the table at word e * 32 + lane
  __shared__ uint32_t join[4 * 256];     // byte tables of A^kPiece
  __shared__ uint32_t pw[kPowers * 32];  // A^(2^k)
  __shared__ uint32_t part[kThreads / 32];
  const int tid = threadIdx.x;
  for (int i = tid; i < 256 * 32; i += kThreads) lanes[i] = a.table[i >> 5];
  for (int i = tid; i < kPowers * 32; i += kThreads) pw[i] = a.powers[i];
  __syncthreads();
  for (int i = tid; i < 4 * 256; i += kThreads) {
    const uint32_t* cols = pw + log2i(kPiece) * 32 + 8 * (i >> 8);
    uint32_t r = 0;
#pragma unroll
    for (int b = 0; b < 8; ++b) r ^= cols[b] & (0u - ((i >> b) & 1u));
    join[i] = r;
  }
  __syncthreads();

  const long long blk = static_cast<long long>(blockIdx.x) * kThreads + tid;
  uint32_t form = 0;
  if (blk < a.nb) {
    const long long at = blk * kBlock - a.pad;  // data index of the block's first byte
    const int s = static_cast<int>((reinterpret_cast<uintptr_t>(a.data) + at) & 15);
    const long long i0 = at - s;
    const uint32_t* tl = lanes + (tid & 31);
    form = (i0 >= 0 && i0 + kBlock + 16 <= a.n)
               ? fold_block<Q, false>(a, i0, 8 * (s & 3), tl, join)
               : fold_block<Q, true>(a, i0, 8 * (s & 3), tl, join);
  }
  if (a.tile == 1) {
    if (blk < a.nb) a.out[blk] = form;
  } else {
    form = block_tree(form, pw, kLogBlock, part);
    if (tid == 0) a.out[blockIdx.x] = form;
  }
}

int launch(const Args& a, cudaStream_t stream) {
  const long long grid = (a.nb + kThreads - 1) / kThreads;
  // the word part of the byte offset of every block in its aligned word
  const int q = static_cast<int>(((reinterpret_cast<uintptr_t>(a.data) - a.pad) & 15) >> 2);
  const dim3 g(static_cast<unsigned>(grid));
  switch (q) {
    case 0: crc32_kernel<0><<<g, kThreads, 0, stream>>>(a); break;
    case 1: crc32_kernel<1><<<g, kThreads, 0, stream>>>(a); break;
    case 2: crc32_kernel<2><<<g, kThreads, 0, stream>>>(a); break;
    default: crc32_kernel<3><<<g, kThreads, 0, stream>>>(a); break;
  }
  return static_cast<int>(cudaGetLastError());
}

Args make_args(const void* data, long long n, long long pad, const void* table,
               const void* powers, void* out, long long nb, int tile) {
  Args a{};
  a.data = static_cast<const uint8_t*>(data);
  a.n = n;
  a.pad = pad;
  a.table = static_cast<const uint32_t*>(table);
  a.powers = static_cast<const uint32_t*>(powers);
  a.out = static_cast<uint32_t*>(out);
  a.nb = nb;
  a.tile = tile;
  return a;
}

}  // namespace

extern "C" int tz_crc32_forms(const void* data, long long n, long long pad, const void* table,
                              const void* powers, void* out, long long nb, int tile,
                              void* stream) {
  if (tile != 1 && tile != kThreads) return static_cast<int>(cudaErrorInvalidValue);
  return launch(make_args(data, n, pad, table, powers, out, nb, tile),
                static_cast<cudaStream_t>(stream));
}
