// The CRC-32 forms kernel as second redesigned, kept for timing only
// (probes/crc_breakdown.py builds it beside tpuzlib_torch/kernels/csrc/
// crc32.cu): the same contract and arithmetic, but a lane folds kChains
// whole 1 KiB blocks, and a warp stages its 32 * kChains blocks
// kRoundWords 16-byte words a block a round with cp.async (runs of 32
// bytes at a 1 KiB stride), double-buffered.  On the card its loads were
// still the limit: with the lookups replaced by shifts it took as long.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 1024;             // bytes per form
constexpr int kLogBlock = 10;
constexpr int kThreads = 256;            // threads a CUDA block
constexpr int kWarps = kThreads / 32;
constexpr int kLevels = 8;               // log2(blocks a span)
constexpr int kSpan = 256;               // 1 KiB blocks a span
constexpr int kChains = 4;               // blocks a lane folds at once
constexpr int kRoundWords = 2;           // 16-byte words of each block a round stages
constexpr int kRounds = kBlock / 16 / kRoundWords;
constexpr int kBlocksPerCta = kThreads * kChains;
constexpr int kPowers = 64;              // A^(2^k) for k < kPowers
// a warp's staging buffer: kChains * 32 blocks * kRoundWords words, two of them
constexpr int kStageWords = kChains * 32 * kRoundWords;
// dynamic shared memory: the lane tables, the powers, the forms of the
// CUDA block's blocks, the tree's warp forms, then the staging buffers
constexpr int kSmemWords = 256 * 32 + kPowers * 32 + kBlocksPerCta + kWarps;
constexpr int kSmemBytes = kSmemWords * 4 + kWarps * 2 * kStageWords * 16;

struct Args {
  const uint8_t* data;
  long long n, pad;           // data bytes; virtual zero bytes in front
  const uint32_t* table;      // the CRC table (256)
  const uint32_t* powers;     // A^(2^k), k < kPowers, 32 packed columns each
  uint32_t* out;              // forms: one a block (tile 1) or a span (tile 256)
  long long nb;               // 1 KiB blocks of zeros(pad) | data
  int tile;
};

// mat (32 packed columns) applied to v
__device__ __forceinline__ uint32_t apply(const uint32_t* cols, uint32_t v) {
  uint32_t r = 0;
#pragma unroll
  for (int b = 0; b < 32; ++b) r ^= cols[b] & (0u - ((v >> b) & 1u));
  return r;
}

// the 16 bytes at data[i, i + 16), data + i 16-byte aligned; bytes outside
// [0, n) read as 0 and are not loaded
__device__ __forceinline__ uint4 load16(const uint8_t* data, long long n, long long i) {
  if (i >= 0 && i + 16 <= n) return __ldg(reinterpret_cast<const uint4*>(data + i));
  uint32_t w[4] = {0, 0, 0, 0};
  if (i + 16 > 0 && i < n) {
#pragma unroll
    for (int b = 0; b < 16; ++b)
      if (i + b >= 0 && i + b < n) w[b >> 2] |= static_cast<uint32_t>(data[i + b]) << (8 * (b & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void cp_async16(uint4* dst, const uint8_t* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// word u of block slot bl in a staging buffer: lane l reads slot j * 32 + l,
// so the words are swizzled to spread a warp's 16-byte reads over all banks
__device__ __forceinline__ int slot(int bl, int u) {
  return bl * kRoundWords + (u ^ ((bl / (8 / kRoundWords)) % kRoundWords));
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

// Stage round r's words of the warp's blocks: words r * kRoundWords + 1 ..
// of each block, whose aligned word 0 is at data[w0 + bl * kBlock].
template <bool kEdge>
__device__ __forceinline__ void stage(const Args& a, uint4* buf, long long w0, int r, int lane) {
#pragma unroll
  for (int t = 0; t < kStageWords / 32; ++t) {
    const int q = t * 32 + lane, u = q % kRoundWords, bl = q / kRoundWords;
    const long long i = w0 + static_cast<long long>(bl) * kBlock + 16 * (r * kRoundWords + 1 + u);
    if (!kEdge || (i >= 0 && i + 16 <= a.n)) cp_async16(buf + slot(bl, u), a.data + i);
    else buf[slot(bl, u)] = load16(a.data, a.n, i);
  }
  cp_async_commit();
}

// The forms of the warp's kChains * 32 blocks, lane l folding blocks
// j * 32 + l: word 0 of each straight from device memory, the rest staged
// a round at a time, the next round in flight while this one folds.
template <int Q, bool kEdge>
__device__ __forceinline__ void fold_blocks(const Args& a, long long w0, int sh, uint4* bufs,
                                            const uint32_t* tl, int lane, uint32_t* crc) {
  uint4 prev[kChains];
#pragma unroll
  for (int j = 0; j < kChains; ++j) {
    crc[j] = 0;
    prev[j] = load16(a.data, a.n, w0 + static_cast<long long>(j * 32 + lane) * kBlock);
  }
  stage<kEdge>(a, bufs, w0, 0, lane);
#pragma unroll 1
  for (int r = 0; r < kRounds; ++r) {
    if (r + 1 < kRounds) stage<kEdge>(a, bufs + ((r + 1) & 1) * kStageWords, w0, r + 1, lane);
    else cp_async_commit();
    cp_async_wait1();
    __syncwarp();
    const uint4* buf = bufs + (r & 1) * kStageWords;
#pragma unroll
    for (int u = 0; u < kRoundWords; ++u) {
      uint4 cur[kChains];
#pragma unroll
      for (int j = 0; j < kChains; ++j) cur[j] = buf[slot(j * 32 + lane, u)];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
#pragma unroll
        for (int j = 0; j < kChains; ++j) crc[j] ^= word_at<Q>(prev[j], cur[j], k, sh);
#pragma unroll
        for (int b = 0; b < 4; ++b) {
#pragma unroll
          for (int j = 0; j < kChains; ++j) crc[j] = step(tl, crc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kChains; ++j) prev[j] = cur[j];
    }
    __syncwarp();  // the buffer is read before round r + 2 refills it
  }
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
    v = lane < kWarps ? part[lane] : 0;
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
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* lanes = smem;                    // entry e of the table at word e * 32 + lane
  uint32_t* pw = lanes + 256 * 32;           // A^(2^k)
  uint32_t* forms = pw + kPowers * 32;       // the CUDA block's block forms (tile 256)
  uint32_t* part = forms + kBlocksPerCta;
  uint4* stages = reinterpret_cast<uint4*>(smem + kSmemWords);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < 256 * 32; i += kThreads) lanes[i] = a.table[i >> 5];
  for (int i = tid; i < kPowers * 32; i += kThreads) pw[i] = a.powers[i];
  __syncthreads();

  // the warp's blocks: [b0, b0 + kChains * 32) of zeros(pad) | data
  const long long b0 = (static_cast<long long>(blockIdx.x) * kWarps + warp) * kChains * 32;
  uint32_t crc[kChains] = {};
  if (b0 < a.nb) {
    const long long at = b0 * kBlock - a.pad;  // data index of the first block's first byte
    const int s = static_cast<int>((reinterpret_cast<uintptr_t>(a.data) + at) & 15);
    const long long w0 = at - s;
    uint4* bufs = stages + warp * 2 * kStageWords;
    const uint32_t* tl = lanes + lane;
    if (w0 >= 0 && w0 + static_cast<long long>(kChains) * 32 * kBlock + 16 <= a.n)
      fold_blocks<Q, false>(a, w0, 8 * (s & 3), bufs, tl, lane, crc);
    else
      fold_blocks<Q, true>(a, w0, 8 * (s & 3), bufs, tl, lane, crc);
  }
  if (a.tile == 1) {
#pragma unroll
    for (int j = 0; j < kChains; ++j) {
      const long long blk = b0 + j * 32 + lane;
      if (blk < a.nb) a.out[blk] = crc[j];
    }
  } else {
#pragma unroll
    for (int j = 0; j < kChains; ++j) forms[(warp * kChains + j) * 32 + lane] = crc[j];
    __syncthreads();
    const long long sp0 = static_cast<long long>(blockIdx.x) * (kBlocksPerCta / kSpan);
    for (int sp = 0; sp < kBlocksPerCta / kSpan; ++sp) {
      const uint32_t f = block_tree(forms[sp * kSpan + tid], pw, kLogBlock, part);
      if (tid == 0 && (sp0 + sp) * kSpan < a.nb) a.out[sp0 + sp] = f;
    }
  }
}

template <int Q>
int launch_q(const Args& a, unsigned grid, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      crc32_kernel<Q>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  crc32_kernel<Q><<<grid, kThreads, kSmemBytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int launch(const Args& a, cudaStream_t stream) {
  const unsigned grid = static_cast<unsigned>((a.nb + kBlocksPerCta - 1) / kBlocksPerCta);
  // the word part of the byte offset of every block in its aligned word
  switch (((reinterpret_cast<uintptr_t>(a.data) - a.pad) & 15) >> 2) {
    case 0: return launch_q<0>(a, grid, stream);
    case 1: return launch_q<1>(a, grid, stream);
    case 2: return launch_q<2>(a, grid, stream);
    default: return launch_q<3>(a, grid, stream);
  }
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
