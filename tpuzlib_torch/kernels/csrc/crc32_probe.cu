// The CRC-32 probe kernels: the read floor, the bit unpack, and the GF(2)
// bit-plane product on the tensor cores, alone and fused with the unpack.
//
// Replace the Pallas kernels of the tools' CRC probes:
//   crc_rowsum    tools/probe_crc2.py:mk_sum_kernel (row sums of u8 rows;
//                 the TPU broadcasts each sum over 128 lanes, a layout
//                 workaround: here one int32 a row);
//   crc_unpack    tools/probe_crc2.py:mk_unpack_kernel (8 bit planes summed
//                 in u8, i32 or bf16, then row sums);
//   gf2_bits_mm   tools/probe_crc2.py:mm_kernel (bf16 bits unpacked
//                 beforehand, (nb, K) @ M (K, 32), & 1);
//   crc_forms_mm  tools/probe_crc.py:make_forms_kernel and
//                 tools/probe_crc3.py:make_forms_seeded (u8 blocks (nb, B) ->
//                 the parity columns of bits(block) @ M_B, the CRC's raw
//                 linear forms, in bf16 or int8).
//
// The product's K order is plane-major, K = i * B + j for bit i of byte j,
// as in the tools; there the "plane" and "cat" modes differ only in feeding
// Mosaic eight dots or one, and on the card they are this one kernel.
//
// Bounds (H100 SXM): crc_rowsum and crc_unpack read each byte once (256 MiB
// is about 80 us at 3.35 TB/s); their arithmetic is a few integer steps a
// byte.  The forms take 8 bits x 32 columns x 2 = 512 operations a byte: in
// bf16 (989 T/s dense) that is above the byte bound, in int8 (1,979 T/s) at
// it.  gf2_bits_mm reads 16 bytes of bits a data byte and is held by them.
//
// Designs, simple first: the row kernels give a warp a row, read it in
// 16-byte loads from its first 16-byte boundary (bytes before and after it
// one at a time, so a row may start anywhere) and reduce with shuffles.  The
// product kernels use warp-level nvcuda::wmma, m16n16k16 (bf16 with a float
// accumulator, s8 with an int accumulator); N = 32 is two accumulator
// fragments per 16-row tile.  A CUDA block of 8 warps owns `tile` rows (the
// tools' tile: 256, 512 or 1024), each warp tile / 128 row tiles.  M does not fit
// in shared memory (8192 x 32 bf16 is 512 KiB at B = 1024), so the block
// walks K in slices: it stages 32 bytes of each of its rows and the 8 x 32
// rows of M they meet (read from L2, where M stays: every block reads all
// of it, so M's L2 traffic is |M| / tile a row), with all of a thread's
// loads issued before the block waits for the last slice to be consumed;
// then each warp writes each bit plane of its rows into a 16 x 16 tile in
// shared memory (bf16 1.0 is 0x3F80: a byte's bit i times 0x3F80, two at a
// time) and multiplies it with the plane's two M fragments.  The bits never
// reach device memory.  gf2_bits_mm has its bits in memory already: a
// block owns 32 rows and its 8 warps split K, loading their fragments
// straight from device memory, so that the 8 MiB of the tool (8,192 rows)
// still give 256 blocks.  Sums reach 8 * B = 32,768 at most: exact in float
// and int, and & 1 gives GF(2).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

// ---- row sums: the read floor and the bit unpack ------------------------

constexpr int kRowWarps = 8;  // rows per CUDA block

enum RowMode { kSum = 0, kU8 = 1, kI32 = 2, kBf16 = 3 };

// The sum over a 32-bit word's four bytes of what the mode computes a byte
// (the byte itself, or its 8 bits summed in the mode's type).  A lone byte
// is a word whose other bytes are 0, which add 0 in every mode.
template <int Mode>
__device__ __forceinline__ uint32_t word_sum(uint32_t w) {
  if (Mode == kSum) return __vsadu4(w, 0u);
  if (Mode == kU8) {  // four u8 lanes, each at most 8
    uint32_t acc = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc += (w >> i) & 0x01010101u;
    return __vsadu4(acc, 0u);
  }
  if (Mode == kI32) {
    uint32_t s = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int b = static_cast<int>((w >> (8 * k)) & 0xFFu);
      int e = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) e += (b >> i) & 1;
      s += static_cast<uint32_t>(e);
    }
    return s;
  }
  // bf16: each bit converted to bf16 and added in bf16, two bytes a pair
  const uint32_t lo = __byte_perm(w, 0, 0x4140), hi = __byte_perm(w, 0, 0x4342);
  __nv_bfloat162 a = __float2bfloat162_rn(0.f), b = a;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    a = __hadd2(a, __halves2bfloat162(__uint2bfloat16_rn((lo >> i) & 1u),
                                      __uint2bfloat16_rn((lo >> (16 + i)) & 1u)));
    b = __hadd2(b, __halves2bfloat162(__uint2bfloat16_rn((hi >> i) & 1u),
                                      __uint2bfloat16_rn((hi >> (16 + i)) & 1u)));
  }
  return static_cast<uint32_t>(__low2float(a)) + static_cast<uint32_t>(__high2float(a)) +
         static_cast<uint32_t>(__low2float(b)) + static_cast<uint32_t>(__high2float(b));
}

template <int Mode>
__global__ void __launch_bounds__(kRowWarps * 32)
crc_rowsum_kernel(const uint8_t* __restrict__ data, long long nb, int row,
                  int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long r = static_cast<long long>(blockIdx.x) * kRowWarps + (threadIdx.x >> 5);
  if (r >= nb) return;  // whole warps leave together
  const uint8_t* p = data + r * row;
  int head = static_cast<int>((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15);
  head = head < row ? head : row;
  uint32_t s = lane < head ? word_sum<Mode>(p[lane]) : 0u;
  const int nvec = (row - head) >> 4;
  const uint4* v = reinterpret_cast<const uint4*>(p + head);
#pragma unroll 4
  for (int k = lane; k < nvec; k += 32) {
    const uint4 x = v[k];
    s += word_sum<Mode>(x.x) + word_sum<Mode>(x.y) + word_sum<Mode>(x.z) + word_sum<Mode>(x.w);
  }
  for (int k = head + nvec * 16 + lane; k < row; k += 32) s += word_sum<Mode>(p[k]);
#pragma unroll
  for (int off = 16; off; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  if (lane == 0) out[r] = static_cast<int32_t>(s);
}

// ---- the GF(2) products on the tensor cores ------------------------------

constexpr int kWarps = 8;  // warps a CUDA block of crc_forms_mm
constexpr int kThreads = kWarps * 32;
constexpr int kJ = 32;       // bytes of each row staged per K slice (8 planes x 32 K rows)
constexpr int kXs = kJ + 16;  // staged byte row: 16-byte stores, 8-byte reads free of conflicts
constexpr int kSplit = 8;    // gf2_bits_mm: warps of a CUDA block, each a K range of its rows
constexpr int kBitsR = 2;    // gf2_bits_mm: row tiles of 16 a warp (32 rows a CUDA block)

template <typename T> struct AccOf;
template <> struct AccOf<__nv_bfloat16> { using type = float; };
template <> struct AccOf<signed char> { using type = int; };

template <typename T, int R>
using AccFrags = wmma::fragment<wmma::accumulator, 16, 16, 16, typename AccOf<T>::type>[R][2];

// 16 bytes at p, from one load when p is 16-byte aligned.
__device__ __forceinline__ uint4 load16(const uint8_t* p, bool aligned) {
  if (aligned) return *reinterpret_cast<const uint4*>(p);
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    w[k] = p[4 * k] | (p[4 * k + 1] << 8) | (p[4 * k + 2] << 16) |
           (static_cast<uint32_t>(p[4 * k + 3]) << 24);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Bit `i` of 8 bytes (lo: bytes 0-3, hi: bytes 4-7) as 8 elements at dst.
__device__ __forceinline__ void put_plane(__nv_bfloat16* dst, uint32_t lo, uint32_t hi, int i) {
  const uint32_t p0 = (lo >> i) & 0x01010101u, p1 = (hi >> i) & 0x01010101u;
  // bytes b0..b3 of 0/1 -> b0 | b1 << 16, b2 | b3 << 16; times 0x3F80 (bf16 1.0)
  *reinterpret_cast<uint4*>(dst) =
      make_uint4(__byte_perm(p0, 0, 0x4140) * 0x3F80u, __byte_perm(p0, 0, 0x4342) * 0x3F80u,
                 __byte_perm(p1, 0, 0x4140) * 0x3F80u, __byte_perm(p1, 0, 0x4342) * 0x3F80u);
}

__device__ __forceinline__ void put_plane(signed char* dst, uint32_t lo, uint32_t hi, int i) {
  *reinterpret_cast<uint2*>(dst) = make_uint2((lo >> i) & 0x01010101u, (hi >> i) & 0x01010101u);
}

// The accumulators' parity (sum & 1) into out (nb, 32) for this warp's row
// tiles, through a 16 x 32 scratch of the warp.
template <typename T, int R>
__device__ __forceinline__ void store_parity(AccFrags<T, R>& acc, typename AccOf<T>::type* cs,
                                             int32_t* __restrict__ out, long long first,
                                             long long nb) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    wmma::store_matrix_sync(cs, acc[r][0], 32, wmma::mem_row_major);
    wmma::store_matrix_sync(cs + 16, acc[r][1], 32, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 16 * 32; e += 32) {
      const long long g = first + r * 16 + (e >> 5);
      if (g < nb) out[g * 32 + (e & 31)] = static_cast<int32_t>(cs[e]) & 1;
    }
    __syncwarp();
  }
}

template <typename T, int R>
constexpr size_t forms_smem() {
  return static_cast<size_t>(kWarps * R * 16) * kXs + 8 * kJ * 32 * sizeof(T) +
         kWarps * R * 256 * sizeof(T) + kWarps * 512 * 4;
}

// crc_forms_mm: out[row] = bits(data[row]) @ M (8B x 32, plane-major) & 1.
template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
crc_forms_mm_kernel(const uint8_t* __restrict__ data, long long nb, int block,
                    const T* __restrict__ m, int32_t* __restrict__ out, bool aligned) {
  using Acc = typename AccOf<T>::type;
  constexpr int kTile = kWarps * R * 16;
  constexpr int kSeg = 32 * sizeof(T) / 16;  // 16-byte pieces of an M row
  static_assert(kTile * (kJ / 16) == R * kThreads && 8 * kJ == kThreads,
                "a thread stages R pieces of the rows and kSeg of M");
  extern __shared__ __align__(128) unsigned char smem[];
  uint8_t* xs = smem;                                        // kTile x kXs bytes
  T* ms = reinterpret_cast<T*>(smem + kTile * kXs);          // 2 halves x (8 kJ) x 16
  T* as = ms + 8 * kJ * 32;                                  // a warp's R A tiles
  Acc* cs = reinterpret_cast<Acc*>(as + kWarps * R * 256);   // a warp's 16 x 32 sums
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long row0 = static_cast<long long>(blockIdx.x) * kTile;
  T* as_w = as + w * R * 256;
  AccFrags<T, R> acc;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    wmma::fill_fragment(acc[r][0], Acc(0));
    wmma::fill_fragment(acc[r][1], Acc(0));
  }
  for (int c = 0; c < block / kJ; ++c) {
    // this thread's pieces of the slice, every load in flight before the
    // block waits for the last slice to be consumed: R 16-byte pieces of
    // the rows, and kSeg of M's rows for plane i, byte k of the slice (M
    // row i * B + c * kJ + k), staged as two column halves, each (8 kJ, 16)
    // row-major, so that every fragment pointer is 32-byte aligned
    uint4 xv[R], mv[kSeg];
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const int q = threadIdx.x + u * kThreads;
      const long long g = row0 + q / (kJ / 16);
      xv[u] = g < nb ? load16(data + g * block + c * kJ + q % (kJ / 16) * 16, aligned)
                     : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kSeg; ++u) {
      const int q = threadIdx.x + u * kThreads, k = q / kSeg;
      const T* row = m + (static_cast<long long>(k / kJ) * block + c * kJ + k % kJ) * 32;
      mv[u] = *reinterpret_cast<const uint4*>(reinterpret_cast<const uint8_t*>(row) +
                                               q % kSeg * 16);
    }
    __syncthreads();  // the last slice is consumed
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const int q = threadIdx.x + u * kThreads;
      *reinterpret_cast<uint4*>(xs + q / (kJ / 16) * kXs + q % (kJ / 16) * 16) = xv[u];
    }
#pragma unroll
    for (int u = 0; u < kSeg; ++u) {
      const int q = threadIdx.x + u * kThreads, k = q / kSeg, g = q % kSeg;
      *reinterpret_cast<uint4*>(reinterpret_cast<uint8_t*>(ms) +
                                ((g / (kSeg / 2)) * 8 * kJ * 16 + k * 16) * sizeof(T) +
                                g % (kSeg / 2) * 16) = mv[u];
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < kJ / 16; ++s) {
      uint2 v[R];  // this lane's 8 bytes (row lane / 2, bytes 8 * (lane % 2)) of each tile
#pragma unroll
      for (int r = 0; r < R; ++r) {
        v[r] = *reinterpret_cast<const uint2*>(xs + (w * R * 16 + r * 16 + (lane >> 1)) * kXs +
                                               s * 16 + (lane & 1) * 8);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          put_plane(as_w + r * 256 + (lane >> 1) * 16 + (lane & 1) * 8, v[r].x, v[r].y, i);
        }
        __syncwarp();
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> b0, b1;
        wmma::load_matrix_sync(b0, ms + (i * kJ + s * 16) * 16, 16);
        wmma::load_matrix_sync(b1, ms + 8 * kJ * 16 + (i * kJ + s * 16) * 16, 16);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
          wmma::load_matrix_sync(a, as_w + r * 256, 16);
          wmma::mma_sync(acc[r][0], a, b0, acc[r][0]);
          wmma::mma_sync(acc[r][1], a, b1, acc[r][1]);
        }
        __syncwarp();  // the A tiles are read before the next plane's
      }
    }
  }
  store_parity<T, R>(acc, cs + w * 512, out, row0 + w * R * 16, nb);
}

// gf2_bits_mm: out[row] = bits[row] (K bf16 0/1) @ M (K x 32 bf16 0/1) & 1.
// A CUDA block owns 32 rows; its 8 warps split K, each loading its A and B
// fragments straight from device memory (M stays in L2), and add their sums
// in shared memory at the end.  Bits that are not 32-byte aligned, and the
// last rows of a ragged nb, go through a staged tile of the warp.
__global__ void __launch_bounds__(kSplit * 32)
gf2_bits_mm_kernel(const __nv_bfloat16* __restrict__ bits, long long nb, int K,
                   const __nv_bfloat16* __restrict__ m, int32_t* __restrict__ out, bool aligned) {
  constexpr int R = kBitsR;
  __shared__ __align__(32) float part[kSplit][R * 16 * 32];
  __shared__ __align__(32) __nv_bfloat16 stage[kSplit][16 * 16];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long row0 = static_cast<long long>(blockIdx.x) * R * 16;
  const bool direct = aligned && row0 + R * 16 <= nb;
  const int span = K / kSplit;
  AccFrags<__nv_bfloat16, R> acc;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    wmma::fill_fragment(acc[r][0], 0.f);
    wmma::fill_fragment(acc[r][1], 0.f);
  }
#pragma unroll 2
  for (int k = w * span; k < (w + 1) * span; k += 16) {
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b0, b1;
    wmma::load_matrix_sync(b0, m + static_cast<long long>(k) * 32, 32);
    wmma::load_matrix_sync(b1, m + static_cast<long long>(k) * 32 + 16, 32);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      const long long first = row0 + r * 16;
      if (direct) {
        wmma::load_matrix_sync(a, bits + first * K + k, K);
      } else {  // lane: row lane / 2, elements 8 * (lane % 2) of the tile
        const long long g = first + (lane >> 1);
        uint32_t u[4] = {0u, 0u, 0u, 0u};
        if (g < nb) {
          const uint16_t* h = reinterpret_cast<const uint16_t*>(bits + g * K + k + (lane & 1) * 8);
#pragma unroll
          for (int e = 0; e < 4; ++e) u[e] = h[2 * e] | (static_cast<uint32_t>(h[2 * e + 1]) << 16);
        }
        *reinterpret_cast<uint4*>(stage[w] + (lane >> 1) * 16 + (lane & 1) * 8) =
            make_uint4(u[0], u[1], u[2], u[3]);
        __syncwarp();
        wmma::load_matrix_sync(a, stage[w], 16);
        __syncwarp();
      }
      wmma::mma_sync(acc[r][0], a, b0, acc[r][0]);
      wmma::mma_sync(acc[r][1], a, b1, acc[r][1]);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    wmma::store_matrix_sync(part[w] + r * 512, acc[r][0], 32, wmma::mem_row_major);
    wmma::store_matrix_sync(part[w] + r * 512 + 16, acc[r][1], 32, wmma::mem_row_major);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < R * 16 * 32; e += kSplit * 32) {
    float s = 0.f;  // exact: every partial and the total are integers below 2^24
#pragma unroll
    for (int v = 0; v < kSplit; ++v) s += part[v][e];
    const long long g = row0 + (e >> 5);
    if (g < nb) out[g * 32 + (e & 31)] = static_cast<int32_t>(s) & 1;
  }
}

template <typename T, int R>
int launch_forms(const void* data, long long nb, int block, const void* m, void* out,
                 cudaStream_t stream) {
  constexpr int kTile = kWarps * R * 16;
  const size_t smem = forms_smem<T, R>();
  cudaError_t err = cudaFuncSetAttribute(crc_forms_mm_kernel<T, R>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool aligned = (reinterpret_cast<uintptr_t>(data) & 15) == 0;
  crc_forms_mm_kernel<T, R><<<static_cast<unsigned>((nb + kTile - 1) / kTile), kThreads, smem,
                              stream>>>(static_cast<const uint8_t*>(data), nb, block,
                                        static_cast<const T*>(m), static_cast<int32_t*>(out),
                                        aligned);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_forms_tile(const void* data, long long nb, int block, int tile, const void* m,
                      void* out, cudaStream_t stream) {
  switch (tile) {
    case 256: return launch_forms<T, 2>(data, nb, block, m, out, stream);
    case 512: return launch_forms<T, 4>(data, nb, block, m, out, stream);
    case 1024: return launch_forms<T, 8>(data, nb, block, m, out, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// mode: 0 the bytes' sum (crc_rowsum); 1, 2, 3 the bit unpack in u8, i32,
// bf16 (crc_unpack).  out: int32[nb].
extern "C" int tz_crc_rowsum(const void* data, long long nb, int row, int mode, void* out,
                             void* stream) {
  const unsigned grid = static_cast<unsigned>((nb + kRowWarps - 1) / kRowWarps);
  const auto* d = static_cast<const uint8_t*>(data);
  auto* o = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kSum: crc_rowsum_kernel<kSum><<<grid, kRowWarps * 32, 0, s>>>(d, nb, row, o); break;
    case kU8: crc_rowsum_kernel<kU8><<<grid, kRowWarps * 32, 0, s>>>(d, nb, row, o); break;
    case kI32: crc_rowsum_kernel<kI32><<<grid, kRowWarps * 32, 0, s>>>(d, nb, row, o); break;
    case kBf16: crc_rowsum_kernel<kBf16><<<grid, kRowWarps * 32, 0, s>>>(d, nb, row, o); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 bf16, 1 int8 (m is (8 * block, 32) of that type).  block: a
// multiple of 32; tile: 256, 512 or 1024 rows a CUDA block.
// out: int32[nb, 32].
extern "C" int tz_crc_forms_mm(const void* data, long long nb, int block, int tile, int dtype,
                               const void* m, void* out, void* stream) {
  if (block <= 0 || block % kJ) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_forms_tile<__nv_bfloat16>(data, nb, block, tile, m, out, s);
  if (dtype == 1) return launch_forms_tile<signed char>(data, nb, block, tile, m, out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// bits: bf16[nb, K], m: bf16[K, 32] (32-byte aligned), K a multiple of 128.
// out: int32[nb, 32].
extern "C" int tz_gf2_bits_mm(const void* bits, long long nb, int K, const void* m, void* out,
                              void* stream) {
  if (K <= 0 || K % (16 * kSplit)) return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned = (reinterpret_cast<uintptr_t>(bits) & 31) == 0;
  gf2_bits_mm_kernel<<<static_cast<unsigned>((nb + kBitsR * 16 - 1) / (kBitsR * 16)),
                       kSplit * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(bits), nb, K, static_cast<const __nv_bfloat16*>(m),
      static_cast<int32_t*>(out), aligned);
  return static_cast<int>(cudaGetLastError());
}
