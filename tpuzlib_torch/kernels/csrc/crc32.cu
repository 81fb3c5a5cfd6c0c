// CRC-32 linear forms of 1 KiB blocks (tile 1) or 256 KiB spans (tile 256),
// and the whole CRC-32 finished on the card in the same launch.
//
// Replaces tpuzlib/kernels/crc32_pallas.py:_kernel_fn (per-block forms),
// :_fused_kernel_fn (the same plus an in-kernel combine of 256 blocks to one
// form per span) and, with a ticket, :crc32_device_jit (the span kernel, the
// tail combine and the seed finish in one program).  The form of a run of
// bytes is the raw CRC register after folding them from register 0, no pre-
// or post-XOR: r = T[(r ^ b) & 0xFF] ^ (r >> 8).  The TPU computes it as a
// bit-plane GF(2) matrix product on its matrix unit because it has no fast
// byte gather; the card has fast shared-memory lookups.
//
// Bound: the input is read once (256 MiB is a floor of about 80 us at
// 3.35 TB/s); a byte costs one table lookup and about three integer
// operations.  What the design does about it (probes/crc_breakdown.py
// times the variants):
//  - loads: each warp stages a contiguous chunk of 32 * kChains * kPiece
//    bytes at a time into its own shared buffers with cp.async, 512
//    contiguous bytes an instruction, the next chunk in flight while this
//    one folds (kStages buffers, __syncwarp only).  Loading each thread's
//    own block straight into registers, or staging 32-byte runs of every
//    block a round, was slower: the warp's loads then touch 16 to 32 lines
//    at a time.  The input may start at any byte: every 16 bytes of a piece
//    are funnel-shifted out of two aligned words; the shift is the same for
//    the whole grid, its word part a template argument.  Only the words at
//    the ends of the input, and in the virtual front pad, take a byte-wise
//    path that reads nothing outside [data, data + n).
//  - lookups: slice-by-4 (four 256-entry tables, 4 KiB), so the four
//    lookups of a word do not wait on each other; one copy of the tables is
//    faster than a copy a lane (no bank conflicts, but 32 KiB a table less
//    staging room).
//  - joins: a lane folds a kPiece-byte piece of a block from register 0;
//    the piece's form is shifted by A^(bytes after it in its block) (A: the
//    raw-register propagation through one zero byte; L(a | b) =
//    A^len(b) L(a) ^ L(b)), a matrix that depends only on the lane and is
//    kept in registers, and the kBlock / kPiece lanes of a block XOR their
//    shares with shuffles.
// Every matrix is a power A^(2^k) from one table of 64 (packed columns,
// k < 64) or a product of them: the pieces' shifts, the span tree
// (k = 10..17), the tail tree over the forms and the finish, which applies
// A^n by the bits of n.
//
// With a ticket (crc32_scalar), each CUDA block publishes its forms; the
// block that takes the last ticket combines all of them (a Horner fold a
// thread, then a tree over the CUDA block; front zeros are free,
// L(zeros | x) = L(x)), writes crc = L ^ A^n (seed ^ ~0) ^ ~0 and resets
// the ticket to 0 for the next call on its stream.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 1024;             // bytes per form
constexpr int kLogBlock = 10;
constexpr int kThreads = 256;            // threads a CUDA block
constexpr int kWarps = kThreads / 32;
constexpr int kLevels = 8;               // log2(blocks a span)
constexpr int kSpan = 256;               // 1 KiB blocks a span
constexpr int kPiece = 128;              // bytes a lane folds as one chain
constexpr int kChains = 1;               // chains a lane folds at once
constexpr int kStages = 2;               // chunks a warp holds: one folds, the rest load
// 1 KiB blocks a CUDA block folds: four spans where that still gives every
// SM a CUDA block, else one
constexpr int kMaxBlocksPerCta = 1024;
constexpr int kLanesPerBlock = kBlock / kPiece;
constexpr int kChunk = kChains * 32 * kPiece;        // bytes a warp stages a round
constexpr int kBlocksPerChunk = kChunk / kBlock;
constexpr int kPowers = 64;              // A^(2^k) for k < kPowers
// a staging buffer: the chunk's aligned 16-byte words and one more (the
// last piece's funnel shift reads it); kStages a warp
constexpr int kStageWords = kChunk / 16 + 1;
// dynamic shared memory: the slice-by-4 tables, the powers, the pieces' shift
// matrices, the forms of the CUDA block's blocks, the tree's warp forms,
// then the staging buffers
constexpr int kSmemWords =
    4 * 256 + kPowers * 32 + kLanesPerBlock * 32 + kMaxBlocksPerCta + kWarps;
constexpr int kSmemBytes = kSmemWords * 4 + kWarps * kStages * kStageWords * 16;

struct Args {
  const uint8_t* data;
  long long n, pad;           // data bytes; virtual zero bytes in front
  const uint32_t* table;      // the CRC table (256)
  const uint32_t* powers;     // A^(2^k), k < kPowers, 32 packed columns each
  uint32_t* out;              // forms: one a block (tile 1) or a span (tile 256)
  long long nb;               // 1 KiB blocks of zeros(pad) | data
  int tile;
  int per_cta;                // blocks a CUDA block folds: kSpan or kMaxBlocksPerCta
  unsigned* ticket;           // null: forms only
  unsigned long long* crc;    // the finished CRC, with a ticket
  uint32_t seed_raw;          // seed ^ 0xFFFFFFFF
};

// mat (32 packed columns) applied to v, in four independent sums
__device__ __forceinline__ uint32_t apply(const uint32_t* cols, uint32_t v) {
  uint32_t r[4] = {0, 0, 0, 0};
#pragma unroll
  for (int b = 0; b < 32; ++b) r[b & 3] ^= cols[b] & (0u - ((v >> b) & 1u));
  return (r[0] ^ r[1]) ^ (r[2] ^ r[3]);
}

// the 16 bytes at data[i, i + 16), data + i 16-byte aligned; bytes outside
// [0, n) read as 0 and are not loaded
__device__ __forceinline__ uint4 load16(const uint8_t* data, long long n, long long i) {
  if (i >= 0 && i + 16 <= n) return __ldg(reinterpret_cast<const uint4*>(data + i));
  uint32_t w[4] = {0, 0, 0, 0};
  if (i + 16 > 0 && i < n) {
#pragma unroll
    for (int b = 0; b < 16; ++b)
      if (i + b >= 0 && i + b < n)
        w[b >> 2] |= static_cast<uint32_t>(data[i + b]) << (8 * (b & 3));
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
// wait until at most kStages - 1 groups of this thread's copies are pending
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
}

// where word u of a chunk lies in its staging buffer: within each run of
// 8 words (128 bytes) the word's place is XORed with the run's index, so
// the lanes' reads of their pieces' k-th words fall in different banks
__device__ __forceinline__ int slot(int u) { return u ^ ((u >> 3) & 7); }

// the register after folding the four bytes of x = register ^ word, low
// byte first: slice-by-4, t[k * 256 + e] the form of byte e followed by k
// zero bytes, so the four lookups are independent
__device__ __forceinline__ uint32_t fold_word(const uint32_t* t, uint32_t x) {
  return t[768 + (x & 0xFFu)] ^ t[512 + ((x >> 8) & 0xFFu)] ^ t[256 + ((x >> 16) & 0xFFu)] ^
         t[x >> 24];
}

// word j (0..3) of the 16 bytes that start Q * 4 + sh / 8 bytes into the
// two aligned words (a, b)
template <int Q>
__device__ __forceinline__ uint32_t word_at(const uint4& a, const uint4& b, int j, int sh) {
  const uint32_t x[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  return __funnelshift_r(x[j + Q], x[j + Q + 1], sh);
}

// Stage the chunk whose aligned word 0 is at data[w0]: lane l copies words
// l, l + 32, ..., so a warp's copies read 512 contiguous bytes at a time.
template <bool kEdge>
__device__ __forceinline__ void stage(const Args& a, uint4* buf, long long w0, int lane) {
#pragma unroll
  for (int t = 0; t < (kStageWords + 31) / 32; ++t) {
    const int u = t * 32 + lane;
    const long long i = w0 + 16ll * u;
    if (u >= kStageWords) break;
    if (!kEdge || (i >= 0 && i + 16 <= a.n)) cp_async16(buf + slot(u), a.data + i);
    else buf[slot(u)] = load16(a.data, a.n, i);
  }
  cp_async_commit();
}

// The forms of the pieces j * 32 + lane (j < kChains) of a staged chunk
// whose first byte is Q * 4 + sh / 8 bytes into its word 0.
template <int Q>
__device__ __forceinline__ void fold_pieces(const uint4* buf, int sh, const uint32_t* t,
                                            int lane, uint32_t* crc) {
  constexpr int kWords = kPiece / 16;
  uint4 prev[kChains];
#pragma unroll
  for (int j = 0; j < kChains; ++j) {
    crc[j] = 0;
    prev[j] = buf[slot((j * 32 + lane) * kWords)];
  }
#pragma unroll
  for (int w = 1; w <= kWords; ++w) {
    uint4 cur[kChains];
#pragma unroll
    for (int j = 0; j < kChains; ++j) cur[j] = buf[slot((j * 32 + lane) * kWords + w)];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int j = 0; j < kChains; ++j)
        crc[j] = fold_word(t, crc[j] ^ word_at<Q>(prev[j], cur[j], k, sh));
    }
#pragma unroll
    for (int j = 0; j < kChains; ++j) prev[j] = cur[j];
  }
}

// The warp's chunks t = warp, warp + kWarps, ... of the CUDA block's
// blocks [b0, b0 + a.per_cta): each staged while the one before folds;
// each piece's form shifted by A^(bytes after it in its block) (`shift`,
// the lane's matrix), the kLanesPerBlock pieces of a block XORed together
// by shuffles.  Block forms go to forms[] (tile 256) or out[] (tile 1).
template <int Q, bool kEdge>
__device__ __forceinline__ void fold_chunks(const Args& a, long long b0, int s, uint4* bufs,
                                            const uint32_t* t, const uint32_t* shift,
                                            uint32_t* forms) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long w0 = b0 * kBlock - a.pad - s;  // aligned word 0 of the CUDA block's blocks
  // the chunks that hold blocks below nb; the warp takes every kWarps-th
  const long long chunks = (a.nb - b0 + kBlocksPerChunk - 1) / kBlocksPerChunk;
  const int rounds = static_cast<int>(
      chunks <= warp ? 0
                     : min(static_cast<long long>(a.per_cta / kBlocksPerChunk / kWarps),
                           (chunks - warp + kWarps - 1) / kWarps));
  if (rounds == 0) return;
  const auto chunk_at = [&](int r) {
    return w0 + (warp + static_cast<long long>(r) * kWarps) * kChunk;
  };
#pragma unroll
  for (int r = 0; r < kStages - 1; ++r) {
    if (r < rounds) stage<kEdge>(a, bufs + r * kStageWords, chunk_at(r), lane);
    else cp_async_commit();
  }
#pragma unroll 1
  for (int r = 0; r < rounds; ++r) {
    const long long chunk = warp + static_cast<long long>(r) * kWarps;
    const int ahead = r + kStages - 1;
    if (ahead < rounds)
      stage<kEdge>(a, bufs + ahead % kStages * kStageWords, chunk_at(ahead), lane);
    else
      cp_async_commit();
    cp_async_wait();
    __syncwarp();
    uint32_t crc[kChains];
    fold_pieces<Q>(bufs + r % kStages * kStageWords, 8 * (s & 3), t, lane, crc);
    __syncwarp();  // the buffer is read before it is refilled
#pragma unroll
    for (int j = 0; j < kChains; ++j) {
      uint32_t f = apply(shift, crc[j]);
#pragma unroll
      for (int m = 1; m < kLanesPerBlock; m <<= 1) f ^= __shfl_xor_sync(0xFFFFFFFFu, f, m);
      const long long blk = chunk * kBlocksPerChunk + (j * 32 + lane) / kLanesPerBlock;
      if (lane % kLanesPerBlock == 0) {
        if (a.tile == 1) {
          if (b0 + blk < a.nb) a.out[b0 + blk] = f;
        } else {
          forms[blk] = f;
        }
      }
    }
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
  uint32_t* t = smem;                        // the slice-by-4 tables
  uint32_t* pw = t + 4 * 256;                // A^(2^k)
  uint32_t* pos = pw + kPowers * 32;         // A^(bytes after a piece) by its place in its block
  uint32_t* forms = pos + kLanesPerBlock * 32;  // the CUDA block's block forms (tile 256)
  uint32_t* part = forms + kMaxBlocksPerCta;
  uint4* stages = reinterpret_cast<uint4*>(smem + kSmemWords);
  __shared__ bool last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < 256; i += kThreads) t[i] = a.table[i];
  for (int i = tid; i < kPowers * 32; i += kThreads) pw[i] = a.powers[i];
  __syncthreads();
  for (int i = tid; i < 256; i += kThreads) {
    for (int k = 1; k < 4; ++k) {
      const uint32_t v = t[(k - 1) * 256 + i];
      t[k * 256 + i] = t[v & 0xFFu] ^ (v >> 8);
    }
  }
  for (int i = tid; i < kLanesPerBlock * 32; i += kThreads) {
    const int after = kPiece * (kLanesPerBlock - 1 - i / 32);  // column i % 32 of place i / 32
    uint32_t v = 1u << (i % 32);
    for (int k = 0; k < kLogBlock; ++k)
      if ((after >> k) & 1) v = apply(pw + k * 32, v);
    pos[i] = v;
  }
  __syncthreads();

  // this lane's pieces' shift matrix, kept in registers
  uint32_t shift[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) shift[i] = pos[lane % kLanesPerBlock * 32 + i];

  const long long b0 = static_cast<long long>(blockIdx.x) * a.per_cta;
  {
    const long long at = b0 * kBlock - a.pad;  // data index of the first block's first byte
    const int s = static_cast<int>((reinterpret_cast<uintptr_t>(a.data) + at) & 15);
    uint4* bufs = stages + warp * kStages * kStageWords;
    if (at - s >= 0 && at - s + static_cast<long long>(a.per_cta) * kBlock + 16 <= a.n)
      fold_chunks<Q, false>(a, b0, s, bufs, t, shift, forms);
    else
      fold_chunks<Q, true>(a, b0, s, bufs, t, shift, forms);
  }
  if (a.tile != 1) {
    __syncthreads();
    const long long sp0 = static_cast<long long>(blockIdx.x) * (a.per_cta / kSpan);
    for (int sp = 0; sp < a.per_cta / kSpan; ++sp) {
      const uint32_t f = block_tree(forms[sp * kSpan + tid], pw, kLogBlock, part);
      if (tid == 0 && (sp0 + sp) * kSpan < a.nb) a.out[sp0 + sp] = f;
    }
  }
  if (a.ticket == nullptr) return;

  // the last CUDA block to finish combines every block's forms
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(a.ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const long long nf = a.tile == 1 ? a.nb : a.nb / kSpan;
  const int lg = kLogBlock + (a.tile == 1 ? 0 : kLevels);  // log2 bytes a form
  int lp = 0;  // each thread folds 2^lp forms of the front-padded kThreads << lp
  while ((static_cast<long long>(kThreads) << lp) < nf) ++lp;
  const long long front = (static_cast<long long>(kThreads) << lp) - nf;
  const long long lo = static_cast<long long>(tid) << lp, hi = lo + (1ll << lp);
  uint32_t v = 0;
  for (long long j = lo > front ? lo : front; j < hi; ++j)
    v = apply(pw + lg * 32, v) ^ __ldcg(a.out + (j - front));
  v = block_tree(v, pw, lg + lp, part);
  if (tid == 0) {
    *a.ticket = 0;  // ready for the next call on this stream
    uint32_t r = a.seed_raw;  // A^n (seed ^ ~0), by the bits of n
    for (int k = 0; k < kPowers; ++k)
      if ((a.n >> k) & 1) r = apply(pw + k * 32, r);
    *a.crc = (v ^ r ^ 0xFFFFFFFFu);
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

int launch(Args a, cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long nb = a.nb;
  const int per_cta =
      nb >= static_cast<long long>(kMaxBlocksPerCta) * sms ? kMaxBlocksPerCta : kSpan;
  a.per_cta = per_cta;
  const unsigned grid = static_cast<unsigned>((nb + per_cta - 1) / per_cta);
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
  if (tile != 1 && tile != kSpan) return static_cast<int>(cudaErrorInvalidValue);
  return launch(make_args(data, n, pad, table, powers, out, nb, tile),
                static_cast<cudaStream_t>(stream));
}

// forms: nb / tile words of scratch; ticket: one word, 0 before the call and
// left 0 after it, used by no other call at the same time (one a stream)
extern "C" int tz_crc32_scalar(const void* data, long long n, long long pad, const void* table,
                               const void* powers, void* forms, void* ticket, void* crc,
                               long long nb, int tile, unsigned seed_raw, void* stream) {
  if (tile != 1 && tile != kSpan) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a = make_args(data, n, pad, table, powers, forms, nb, tile);
  a.ticket = static_cast<unsigned*>(ticket);
  a.crc = static_cast<unsigned long long*>(crc);
  a.seed_raw = seed_raw;
  return launch(a, st);
}
