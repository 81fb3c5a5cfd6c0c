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
// The tools' product has K plane-major, K = i * B + j for bit i of byte j;
// there the "plane" and "cat" modes differ only in feeding Mosaic eight
// dots or one, and on the card they are one kernel a dtype.
//
// Bounds (H100 SXM): crc_rowsum and crc_unpack read each byte once (256 MiB
// is about 80 us at 3.35 TB/s); their arithmetic is a few integer steps a
// byte.  The forms take 8 bits x 32 columns x 2 = 512 operations a byte: in
// bf16 (989 T/s dense) that is above the byte bound, in int8 (1,979 T/s) at
// it.  gf2_bits_mm reads 16 bytes of bits a data byte and is held by them.
//
// Designs, simple first: the row kernels give a warp a row, read it in
// 16-byte loads from its first 16-byte boundary (bytes before and after it
// one at a time, so a row may start anywhere; 4 or 8 loads a lane in
// flight) and reduce with shuffles.  crc_unpack's modes are held by their
// instructions, not by the bytes, where each bit is converted (an I2F a
// bit in bf16) or summed a byte at a time (~6 steps a byte in i32): they
// build the bit planes as crc_forms_mm builds its A operands (a mask a
// plane of four bytes or of a byte pair) and sum a plane at a time, by
// __dp4a in i32 and by bf16x2 FMAs in bf16, whose sums become integers
// once every 32 words (RowAcc).
// gf2_bits_mm has its bits in memory already: a warp-specialised wgmma
// kernel with both operands streamed by TMA into shared memory, 128 rows a
// CUDA block and K split over a cluster (its note, below).
//
// crc_forms_mm is a warp-specialised wgmma kernel.  A CUDA block owns
// `tile` rows (the tools' tile: 256, 512 or 1024): two consumer warpgroups
// of tile / 128 64-row tiles each, and one producer warp.  K is walked in
// slices of 32 bytes of every row (8 x 32 K rows of M) through a ring of 4
// stages in shared memory; the producer's lane 0 keeps the slices in
// flight with TMA: the rows' bytes by a tensor map (a box of 256 rows x 32
// bytes, 32-byte swizzle, zeros past nb) and M's rows for the slice by one
// bulk copy, each stage's arrival counted on an mbarrier.  M does not fit
// in shared memory (8192 x 32 bf16 is 512 KiB at B = 1024), so every CUDA
// block streams all of it from L2 (clusters that multicast M's slices
// measured slower, PERF.md).  The consumers read their rows' words
// with ldmatrix (thread (g, t) of a warp gets word t of a 16-byte chunk of
// rows g and g + 8, the wgmma A fragment's rows) and build every bit
// plane's A fragment from them in registers: in bf16 a word is spread once
// (bytes 0 and 1 to the low bytes of two halves, __byte_perm) and plane i
// of the pair is (s & 0x10001 << i) * (0x3F80 >> i), bf16 1.0 where the bit
// is set, two integer steps a register; in int8 plane i is w & 0x01010101
// << i, the bit times 2^i, one step a register.  The bits never reach
// shared or device memory.  Then wgmma m64n32k16 (bf16, f32 sums) or
// m64n32k32 (int8, s32 sums) with A from registers and B, the slice of M,
// from shared memory in wgmma's 128-byte-swizzled K-major layout, in
// batches of 8 wgmmas: a warpgroup builds a batch's A, issues it and
// waits for it (ptxas serialises wgmmas whose A registers are written
// while any wgmma is in flight), and the other warpgroups of the SM (four
// at tile 256, two blocks an SM) keep the tensor cores busy meanwhile.
//
// So that each thread's A comes from whole words, K is permuted on the
// card by one fixed permutation, applied both to the bytes a fragment
// takes and to M's rows (a copy made on the host, crc32_probe.card_matrix):
// the sum of products, and its parity, do not change.  Slice s, wgmma q of
// the slice, element k of its K: bf16 q = 8c + i, bit i of byte 32s + 16c +
// 4(k % 8 / 2) + k % 2 + 2(k / 8); int8 q = i, bit i of byte 32s + k.  In
// int8 M's rows are also scaled, bit i's row by 2^(7 - i) (128 stored as
// -128): every product is 128 times bit x M mod 256, so bit 7 of the s32
// sum is the parity.  In bf16 the sums stay below 2^15, exact in f32, and
// the parity is bit 0 of the integer.  Each thread stores its parities
// straight from its accumulator registers, masked past nb.
//
// The rows go by TMA where they start on a 16-byte boundary (TMA's rule
// for a tensor map's base and row stride; B is a multiple of 16); else
// (rows at any byte offset) the consumers load their words from device
// memory themselves, two aligned words and a funnel shift each, and only M
// goes by TMA.  The wrapper chooses the route from the pointer before the
// launch.  Sums reach 8 * B = 32,768 at most.

#include <cstdint>
#include <cstring>
#include <mutex>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// ---- row sums: the read floor and the bit unpack ------------------------

constexpr int kRowWarps = 8;  // rows per CUDA block

enum RowMode { kSum = 0, kU8 = 1, kI32 = 2, kBf16 = 3 };

// The bit planes of bytes, shared by crc_forms_mm's A operands and
// crc_unpack: bytes 0, 1 (spread_lo) or 2, 3 (spread_hi) of a word spread
// to the low bytes of two 16-bit halves; plane i of the pair as two bf16
// 0.0 / 1.0 is (s & 0x10001 << i) * (0x3F80 >> i), two integer steps and
// no conversion (bf16_plane: the forms' A); shifted up by 7 first, plane
// i is a power of two as bf16 where the bit is set, 2^(2^i - 127), and
// 2^(127 - 2^i) times it is 1.0 (bf16_pow2_plane, bf16_pow2_scale: one
// step, the multiply left to crc_unpack's FMA); in int8 lanes plane i of
// four bytes is w & 0x01010101 << i, each bit at weight 2^i, one step.
__device__ __forceinline__ uint32_t spread_lo(uint32_t w) { return __byte_perm(w, 0, 0x4140); }
__device__ __forceinline__ uint32_t spread_hi(uint32_t w) { return __byte_perm(w, 0, 0x4342); }
__device__ __forceinline__ uint32_t bf16_plane(uint32_t spread, int i) {
  return (spread & (0x00010001u << i)) * (0x3F80u >> i);
}
__device__ __forceinline__ uint32_t bf16_pow2_plane(uint32_t spread7, int i) {
  return spread7 & (0x00800080u << i);
}
__device__ __forceinline__ uint32_t bf16_pow2_scale(int i) {  // 2^(127 - 2^i) in both halves
  return ((254u - (1u << i)) << 7) * 0x00010001u;
}
__device__ __forceinline__ uint32_t i8_plane(uint32_t w, int i) { return w & (0x01010101u << i); }

__device__ __forceinline__ __nv_bfloat162 as_bf162(uint32_t u) {
  __nv_bfloat162 v;
  memcpy(&v, &u, sizeof v);
  return v;
}

// A thread's running sum of a row's 32-bit words in the mode's type (a
// lone byte is a word whose other bytes are 0, which add 0 in every
// mode).  add(w) takes a word; flush() ends a group of at most 32 words
// (bf16's exact range); total() is the integer sum.  kLoads: the 16-byte
// loads a thread has in flight in the row loop, a group at most.
template <int Mode> struct RowAcc;

template <> struct RowAcc<kSum> {  // the bytes themselves: the read floor
  static constexpr int kLoads = 4;
  uint32_t s;
  __device__ __forceinline__ RowAcc() : s(0) {}
  __device__ __forceinline__ void add(uint32_t w) { s += __vsadu4(w, 0u); }
  __device__ __forceinline__ void flush() {}
  __device__ __forceinline__ uint32_t total() { return s; }
};

template <> struct RowAcc<kU8> {  // the planes added in four u8 lanes, each at most 8
  static constexpr int kLoads = 4;
  uint32_t s;
  __device__ __forceinline__ RowAcc() : s(0) {}
  __device__ __forceinline__ void add(uint32_t w) {
    uint32_t acc = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc += (w >> i) & 0x01010101u;
    s += __vsadu4(acc, 0u);
  }
  __device__ __forceinline__ void flush() {}
  __device__ __forceinline__ uint32_t total() { return s; }
};

// i32: each plane of four bytes summed into an int32 by __dp4a, one sum a
// plane (plane i's at weight 2^i), shifted back once at the end: two steps
// a plane and word where the byte-at-a-time sum took ~6 a byte
template <> struct RowAcc<kI32> {
  static constexpr int kLoads = 8;
  uint32_t p[8];
  __device__ __forceinline__ RowAcc() {
#pragma unroll
    for (int i = 0; i < 8; ++i) p[i] = 0;
  }
  __device__ __forceinline__ void add(uint32_t w) {
#pragma unroll
    for (int i = 0; i < 8; ++i) p[i] = __dp4a(i8_plane(w, i), 0x01010101u, p[i]);
  }
  __device__ __forceinline__ void flush() {}
  __device__ __forceinline__ uint32_t total() {
    uint32_t s = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) s += p[i] >> i;
    return s;
  }
};

// bf16: each plane of a byte pair added in bf16x2, bytes 0, 1 of the words
// in a, bytes 2, 3 in b: the plane as powers of two (bf16_pow2_plane), one
// __hfma2 by its scale adds each bit as 1.0.  That is a mask and an FMA a
// plane; the forms' 1.0 planes added by __hadd2 take a multiply more
// (probes/unpack_breakdown.py times both).  A half gains at most 8 a word and
// bf16 holds every integer up to 256 exactly, so the sums stay in bf16 for
// a group of 32 words and become integers once a group, not once a byte
template <> struct RowAcc<kBf16> {
  static constexpr int kLoads = 8;
  __nv_bfloat162 a, b;
  uint32_t s;
  __device__ __forceinline__ RowAcc() : a(as_bf162(0u)), b(as_bf162(0u)), s(0) {}
  __device__ __forceinline__ void add(uint32_t w) {
    const uint32_t lo = spread_lo(w) << 7, hi = spread_hi(w) << 7;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const __nv_bfloat162 scale = as_bf162(bf16_pow2_scale(i));
      a = __hfma2(as_bf162(bf16_pow2_plane(lo, i)), scale, a);
      b = __hfma2(as_bf162(bf16_pow2_plane(hi, i)), scale, b);
    }
  }
  __device__ __forceinline__ void flush() {
    s += static_cast<uint32_t>(__low2float(a)) + static_cast<uint32_t>(__high2float(a)) +
         static_cast<uint32_t>(__low2float(b)) + static_cast<uint32_t>(__high2float(b));
    a = b = as_bf162(0u);
  }
  __device__ __forceinline__ uint32_t total() {
    flush();
    return s;
  }
};

template <int Mode>
__device__ __forceinline__ void add4(RowAcc<Mode>& acc, const uint4& x) {
  acc.add(x.x);
  acc.add(x.y);
  acc.add(x.z);
  acc.add(x.w);
}

template <int Mode>
__global__ void __launch_bounds__(kRowWarps * 32)
crc_rowsum_kernel(const uint8_t* __restrict__ data, long long nb, int row,
                  int32_t* __restrict__ out) {
  constexpr int L = RowAcc<Mode>::kLoads;
  const int lane = threadIdx.x & 31;
  const long long r = static_cast<long long>(blockIdx.x) * kRowWarps + (threadIdx.x >> 5);
  if (r >= nb) return;  // whole warps leave together
  const uint8_t* p = data + r * row;
  int head = static_cast<int>((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15);
  head = head < row ? head : row;
  RowAcc<Mode> acc;
  if (lane < head) acc.add(p[lane]);
  acc.flush();
  const int nvec = (row - head) >> 4;
  const uint4* v = reinterpret_cast<const uint4*>(p + head);
  int k = lane;
  for (; k + 32 * (L - 1) < nvec; k += 32 * L) {  // L loads in flight, then a group
    uint4 x[L];
#pragma unroll
    for (int j = 0; j < L; ++j) x[j] = v[k + 32 * j];
#pragma unroll
    for (int j = 0; j < L; ++j) add4(acc, x[j]);
    acc.flush();
  }
  for (; k < nvec; k += 32) add4(acc, v[k]);  // fewer than L loads a lane
  acc.flush();
  // the bytes after the last whole 16, fewer than 16: at most one a lane
  for (int t = head + nvec * 16 + lane; t < row; t += 32) acc.add(p[t]);
  uint32_t s = acc.total();
#pragma unroll
  for (int off = 16; off; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  if (lane == 0) out[r] = static_cast<int32_t>(s);
}

// ---- the GF(2) products on the tensor cores ------------------------------

// crc_forms_mm's shape: two consumer warpgroups and a producer warp; K in
// slices of kSlice bytes a row (a stage) through a ring of kStages
constexpr int kConsumers = 2;
// the producer: one warp; at 8 tiles a warpgroup a whole warpgroup, whose
// registers (setmaxnreg) go to the consumers' 128 accumulators
template <int R>
__host__ __device__ constexpr int forms_threads() {
  return kConsumers * 128 + (R >= 8 ? 128 : 32);
}
constexpr int kStages = 4;
constexpr int kSlice = 32;
constexpr int kBoxRows = 256;  // rows of a TMA box of the rows' bytes
constexpr int kBox = 4096;     // bytes of a 128-byte-swizzled box of M (32 rows of 128 bytes)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n}" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// `bytes` from src to dst, counted on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// the box of the tensor map at (x, y) into this block's dst, counted on bar
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map, int x, int y,
                                        uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// a K-major operand's descriptor: rows of 128 bytes of K at shared address
// `addr`, 128-byte swizzle, 8-row groups 1024 bytes apart (crc_forms_mm's
// B, a 32-row box of M; gf2_bits_mm's A, 64 rows of bits)
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

// d = A (64 x 16 bf16, this thread's 4 registers) @ B (16 x 32 at desc) + d,
// or + 0 where !add
__device__ __forceinline__ void wgmma(float (&d)[16], const uint32_t (&a)[4], uint64_t desc,
                                      int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(add)
      : "memory");
}

// d = A (64 x 32 s8) @ B (32 x 32 s8 at desc) + d, or + 0 where !add
__device__ __forceinline__ void wgmma(int (&d)[16], const uint32_t (&a)[4], uint64_t desc,
                                      int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(add)
      : "memory");
}

// Registers the compiler must hold as they are at this point: the A
// fragments and B descriptors are complete before wgmma.fence, and built
// only after the last batch's wait (else ptxas serialises the wgmmas,
// C7513), the sums
// untouched while a wgmma may write them (CUTLASS's
// warpgroup_fence_operand)
__device__ __forceinline__ void pin(float (&d)[16]) {
#pragma unroll
  for (int e = 0; e < 16; ++e) asm volatile("" : "+f"(d[e])::"memory");
}
__device__ __forceinline__ void pin(int (&d)[16]) {
#pragma unroll
  for (int e = 0; e < 16; ++e) asm volatile("" : "+r"(d[e])::"memory");
}
__device__ __forceinline__ void pin(uint32_t (&w)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) asm volatile("" : "+r"(w[k])::"memory");
}
__device__ __forceinline__ void pin(uint64_t (&d)[4]) {
#pragma unroll
  for (int u = 0; u < 4; ++u) asm volatile("" : "+l"(d[u])::"memory");
}
__device__ __forceinline__ void pin(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
#pragma unroll
    for (int k = 0; k < 4; ++k) asm volatile("" : "+r"(a[u][k])::"memory");
  }
}

// What differs between the dtypes.  w: this thread's words of a slice for
// one 64-row tile (ldmatrix's order: rows g and g + 8 of 16-byte chunk 0,
// then of chunk 1).  Group h (of kGroups a tile and slice) is four wgmmas
// u = 0..3, whose B sits in box h of the slice's M at u * 32 bytes.
template <typename T> struct Forms;

template <> struct Forms<__nv_bfloat16> {
  using Acc = float;
  static constexpr int kGroups = 4;  // group h = 2c + p: chunk c, planes 4p..4p+3
  static constexpr uint32_t kMBytes = kSlice * 8 * 32 * 2;
  __device__ static __forceinline__ void build(uint32_t (&a)[4][4], const uint32_t (&w)[4],
                                               int h) {
    const int c = h >> 1, p = h & 1;
    // bytes 0, 1 (lo) and 2, 3 (hi) of rows g (w[2c]) and g + 8 (w[2c + 1])
    const uint32_t lo0 = spread_lo(w[2 * c]), lo1 = spread_lo(w[2 * c + 1]);
    const uint32_t hi0 = spread_hi(w[2 * c]), hi1 = spread_hi(w[2 * c + 1]);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      a[u][0] = bf16_plane(lo0, 4 * p + u);
      a[u][1] = bf16_plane(lo1, 4 * p + u);
      a[u][2] = bf16_plane(hi0, 4 * p + u);
      a[u][3] = bf16_plane(hi1, 4 * p + u);
    }
  }
  // the parity of an exact integer sum
  __device__ static __forceinline__ int parity(float s) { return static_cast<int>(s) & 1; }
};

template <> struct Forms<signed char> {
  using Acc = int;
  static constexpr int kGroups = 2;  // group h: planes 4h..4h+3 of the slice's 32 bytes
  static constexpr uint32_t kMBytes = kSlice * 8 * 32;
  __device__ static __forceinline__ void build(uint32_t (&a)[4][4], const uint32_t (&w)[4],
                                               int h) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int k = 0; k < 4; ++k) a[u][k] = i8_plane(w[k], 4 * h + u);
    }
  }
  // every product is 128 x bit x M mod 256 (M's rows scaled): bit 7
  __device__ static __forceinline__ int parity(int s) { return (s >> 7) & 1; }
};

// this thread's word of row `row` at byte `at`, from device memory at any
// byte offset: misalign (data's address mod 4) is the same for every word;
// the second aligned word holds the word's last byte, so no load leaves
// the rows' words
__device__ __forceinline__ uint32_t row_word(const uint8_t* data, long long row, int block,
                                             int at, int misalign) {
  const uint8_t* p = data + row * block + at;
  if (misalign == 0) return *reinterpret_cast<const uint32_t*>(p);
  const uint32_t* q = reinterpret_cast<const uint32_t*>(p - misalign);
  return __funnelshift_r(q[0], q[1], 8 * misalign);
}

template <typename T, int R, bool Tma>
__host__ __device__ constexpr int forms_stage_bytes() {
  return static_cast<int>(Forms<T>::kMBytes) + (Tma ? kConsumers * R * 64 * kSlice : 0);
}

template <typename T, int R, bool Tma>
__host__ __device__ constexpr int forms_smem() {
  return kStages * forms_stage_bytes<T, R, Tma>() + 2 * kStages * 8 + 1024;  // + alignment
}

// crc_forms_mm: out[row] = parity of bits(data[row]) @ M (8B x 32), with M's
// rows in the card's order (mimg: block / kSlice slices of kMBytes, each
// kMBytes / kBox swizzled boxes).  Tma: the rows' bytes by `rows` (a
// tensor map of data, (nb, block) bytes); else loaded by the consumers.
template <typename T, int R, bool Tma>
__global__ void __launch_bounds__(forms_threads<R>(), R <= 2 ? 2 : 1)
crc_forms_mm_kernel(const __grid_constant__ CUtensorMap rows, const uint8_t* __restrict__ data,
                    long long nb, int block, const uint8_t* __restrict__ mimg,
                    int32_t* __restrict__ out) {
  using F = Forms<T>;
  using Acc = typename F::Acc;
  constexpr int kTile = kConsumers * R * 64;
  constexpr int kStage = forms_stage_bytes<T, R, Tma>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStage);
  uint64_t* empty = full + kStages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slices = block / kSlice;
  const long long row0 = static_cast<long long>(blockIdx.x) * kTile;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);  // a consumer warp each
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (warp >= kConsumers * 4) {
    // the producer: slice s into stage s % kStages once every consumer
    // has released that stage's last slice
    if constexpr (R >= 8) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (warp == kConsumers * 4 && lane == 0) {
      for (int s = 0; s < slices; ++s) {
        const int st = s % kStages;
        mbar_wait(&empty[st], ((s / kStages) & 1) ^ 1);
        unsigned char* buf = smem + st * kStage;
        mbar_expect_tx(&full[st], kStage);
        bulk_copy(buf, mimg + static_cast<long long>(s) * F::kMBytes, F::kMBytes, &full[st]);
        if (Tma) {
#pragma unroll
          for (int b = 0; b < kTile / kBoxRows; ++b)
            tma_box(buf + F::kMBytes + b * kBoxRows * kSlice, &rows, s * kSlice,
                    static_cast<int>(row0) + b * kBoxRows, &full[st]);
        }
      }
    }
  } else {
    if constexpr (R >= 8) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, t = lane & 3;
    const int misalign = static_cast<int>(reinterpret_cast<uintptr_t>(data) & 3);
    Acc acc[R][16];  // zeroed by the first slice's first wgmma of each tile (add = 0)
    uint32_t a[2][4][4];  // a batch's A: 2 groups of 4 wgmmas
    for (int s = 0; s < slices; ++s) {
      const int st = s % kStages;
      mbar_wait(&full[st], (s / kStages) & 1);
      const uint32_t buf = smem_u32(smem + st * kStage);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int tile_row = 64 * (wg * R + r) + 16 * wq;
        uint32_t w[4];
        if (Tma) {
          // lane L addresses row L % 8 (+ 8 for odd L / 8) of chunk L / 16
          const int m = lane >> 3, row = tile_row + ((m & 1) << 3) + (lane & 7);
          const uint32_t at = buf + F::kMBytes + row * kSlice + (((m >> 1) ^ ((row >> 2) & 1)) << 4);
          asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
                       : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3])
                       : "r"(at)
                       : "memory");
        } else {
          const long long ra = row0 + tile_row + g, rb = ra + 8;
          const int at = s * kSlice + 4 * t;
          w[0] = ra < nb ? row_word(data, ra, block, at, misalign) : 0u;
          w[1] = rb < nb ? row_word(data, rb, block, at, misalign) : 0u;
          w[2] = ra < nb ? row_word(data, ra, block, at + 16, misalign) : 0u;
          w[3] = rb < nb ? row_word(data, rb, block, at + 16, misalign) : 0u;
        }
#pragma unroll
        for (int h = 0; h < F::kGroups; h += 2) {
          // a batch of two groups: 8 wgmmas, their A built beforehand and
          // all of them done before the next batch's A is built (ptxas
          // serialises wgmmas whose A registers are written while any
          // wgmma is in flight, C7513); the other warpgroups keep the
          // tensor cores busy meanwhile
          pin(w);  // the build stays after the last batch's wait
#pragma unroll
          for (int e = 0; e < 2; ++e) F::build(a[e], w, h + e);
          uint64_t desc[2][4];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
#pragma unroll
            for (int u = 0; u < 4; ++u) desc[e][u] = b_desc(buf + (h + e) * kBox + u * 32);
            pin(a[e]);
            pin(desc[e]);
          }
          pin(acc[r]);
          wgmma_fence();
#pragma unroll
          for (int e = 0; e < 2; ++e) {
#pragma unroll
            for (int u = 0; u < 4; ++u)
              wgmma(acc[r], a[e][u], desc[e][u], s > 0 || h + e > 0 || u > 0);
          }
          wgmma_commit();
          wgmma_wait<0>();
          pin(acc[r]);
        }
      }
      // every wgmma of the slice is done: its stage may be refilled
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long ra = row0 + 64 * (wg * R + r) + 16 * wq + g, rb = ra + 8;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // accumulator 4j + e: row g (e < 2) or g + 8, column 8j + 2t + e % 2
        if (ra < nb)
          *reinterpret_cast<int2*>(out + ra * 32 + 8 * j + 2 * t) =
              make_int2(F::parity(acc[r][4 * j]), F::parity(acc[r][4 * j + 1]));
        if (rb < nb)
          *reinterpret_cast<int2*>(out + rb * 32 + 8 * j + 2 * t) =
              make_int2(F::parity(acc[r][4 * j + 2]), F::parity(acc[r][4 * j + 3]));
      }
    }
  }
}

// gf2_bits_mm: out[row] = bits[row] (K bf16 0/1) @ M (K x 32 bf16 0/1) & 1.
// A warp-specialised wgmma kernel with both operands in shared memory.  A
// CUDA block owns kBitsRows rows: two consumer warpgroups of 64 rows each,
// and one producer warp whose lane 0 keeps kBitsStages stages in flight
// through an mbarrier ring, each stage kBitsK K elements: a TMA box of the
// block's rows (128 bytes of each, 128-byte swizzle, zeros past nb) and M's
// kBitsK x 32 slice by a second tensor map (64-byte rows, 64-byte swizzle).
// The consumers run wgmma m64n32k16 with A, their rows, K-major and B, M as
// the caller lays it out ((K, 32) row-major), N-major through the
// instruction's transpose flag, so M needs no image.  A block reads M once
// for 128 rows, a quarter of the bits' bytes from L2.  K is split over a
// cluster of kBitsCluster blocks, each a range of the stages, so that the
// tools' 8,192 rows (64 row blocks) still fill the card; the cluster's
// leader adds its peers' f32 sums from their shared memory and writes the
// parity.  Every partial sum is an integer below 2^24, exact in f32 in any
// order.  Bits off a 16-byte boundary (no tensor map takes them) are loaded
// by the consumers into the same swizzled layout, each warpgroup its own
// rows, as 4-byte words (two and a funnel shift where the bits lie 2 bytes
// off a 4-byte boundary); M still comes by TMA.
constexpr int kBitsK = 64;                    // K elements a stage: 128 bytes of a row
constexpr int kBitsRows = kConsumers * 64;    // rows of a CUDA block
constexpr int kBitsStages = 6;               // one CUDA block an SM (4 measured slower)
constexpr int kBitsCluster = 2;               // CUDA blocks sharing a row block, a K range each
constexpr int kBitsThreads = kConsumers * 128 + 32;
constexpr int kBitsA = kBitsRows * kBitsK * 2;  // bytes of bits a stage
constexpr int kBitsB = kBitsK * 32 * 2;         // bytes of M a stage
constexpr int kBitsStage = kBitsA + kBitsB;
constexpr int kBitsPart = kConsumers * 128 * 16 * 4;  // the consumers' f32 sums, for the leader
constexpr int kBitsSmem = kBitsStages * kBitsStage + kBitsPart + 2 * kBitsStages * 8 + 1024;

// M's descriptor: 16 K rows of 32 bf16 (64 bytes each) at shared address
// `addr`, N-major, 64-byte swizzle, 8-row groups 512 bytes apart.  N is one
// swizzle atom wide, so the offset between atoms along N is never used; it
// is set to the same 512 bytes.
__device__ __forceinline__ uint64_t m_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (32ull << 16) | (32ull << 32) |
         (2ull << 62);
}

// d = A (64 x 16 bf16 at adesc, K-major) @ B (16 x 32 bf16 at bdesc,
// N-major) + d
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t adesc, uint64_t bdesc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(adesc), "l"(bdesc), "r"(1)
      : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// every thread of every block of the cluster; what a block wrote to its
// shared memory before is then visible to the others
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;"
               ::: "memory");
}

// the 16 bytes at `p` in the shared memory of the cluster's block `rank`
__device__ __forceinline__ float4 ld_peer(const void* p, uint32_t rank) {
  uint32_t at;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(at) : "r"(smem_u32(p)), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(at)
               : "memory");
  return v;
}

// the "ldg" route: thread t of a warpgroup stores 16-byte chunk i % 8 of
// row i / 8 of its 64 rows (i = t + 128 j) of stage s into dst, in the
// layout TMA's 128-byte swizzle gives (chunk c of row r at c ^ r % 8); the
// rows past nb as zeros.  Every row starts `mis` (0 or 2) bytes past a
// 4-byte boundary, since its pitch, 2K bytes, is a multiple of 256.
__device__ __forceinline__ void load_bits(unsigned char* dst, const unsigned char* bits, long long nb,
                                          int K, long long row, int s, int t, int mis) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int i = t + 128 * j, r = i >> 3, c = i & 7;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row + r < nb) {
      const uint32_t* q = reinterpret_cast<const uint32_t*>(
          bits + (row + r) * 2LL * K + s * (2 * kBitsK) + c * 16 - mis);
      if (mis == 0) {
        v = make_uint4(__ldg(q), __ldg(q + 1), __ldg(q + 2), __ldg(q + 3));
      } else {
        const uint32_t w0 = __ldg(q), w1 = __ldg(q + 1), w2 = __ldg(q + 2), w3 = __ldg(q + 3),
                       w4 = __ldg(q + 4);
        v = make_uint4(__funnelshift_r(w0, w1, 16), __funnelshift_r(w1, w2, 16),
                       __funnelshift_r(w2, w3, 16), __funnelshift_r(w3, w4, 16));
      }
    }
    *reinterpret_cast<uint4*>(dst + r * 128 + ((c ^ (r & 7)) << 4)) = v;
  }
}

// Tma: the bits by `bmap` (a tensor map of bits, (nb, K) bf16); else loaded
// by the consumers.  mmap: a tensor map of M, (K, 32) bf16.
template <bool Tma>
__global__ void __cluster_dims__(kBitsCluster, 1, 1) __launch_bounds__(kBitsThreads)
gf2_bits_mm_kernel(const __grid_constant__ CUtensorMap bmap, const __grid_constant__ CUtensorMap mmap,
                   const unsigned char* __restrict__ bits, long long nb, int K,
                   int32_t* __restrict__ out) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float4* part = reinterpret_cast<float4*>(smem + kBitsStages * kBitsStage);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBitsStages * kBitsStage + kBitsPart);
  uint64_t* empty = full + kBitsStages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t rank = cluster_rank();
  const long long row0 = static_cast<long long>(blockIdx.x / kBitsCluster) * kBitsRows;
  // this block's stages [lo, hi) of K / kBitsK; a range may be empty
  const int stages = K / kBitsK;
  const int lo = static_cast<int>(static_cast<long long>(stages) * rank / kBitsCluster);
  const int hi = static_cast<int>(static_cast<long long>(stages) * (rank + 1) / kBitsCluster);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kBitsStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);  // a consumer warp each
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  float acc[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) acc[e] = 0.f;
  const bool consumer = warp < kConsumers * 4;
  if (!consumer) {
    // the producer: stage s into ring slot (s - lo) % kBitsStages once
    // every consumer warp has released that slot's last stage
    if (lane == 0) {
      for (int s = lo; s < hi; ++s) {
        const int i = s - lo, st = i % kBitsStages;
        mbar_wait(&empty[st], ((i / kBitsStages) & 1) ^ 1);
        unsigned char* buf = smem + st * kBitsStage;
        mbar_expect_tx(&full[st], Tma ? kBitsStage : kBitsB);
        tma_box(buf + kBitsA, &mmap, 0, s * kBitsK, &full[st]);
        if (Tma) tma_box(buf, &bmap, s * kBitsK, static_cast<int>(row0), &full[st]);
      }
    }
    __syncwarp();
  } else {
    const int wg = warp >> 2;
    const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(bits) & 3);
    for (int s = lo; s < hi; ++s) {
      const int i = s - lo, st = i % kBitsStages;
      mbar_wait(&full[st], (i / kBitsStages) & 1);
      unsigned char* buf = smem + st * kBitsStage;
      if (!Tma) {
        load_bits(buf + wg * 64 * 128, bits, nb, K, row0 + 64 * wg, s, threadIdx.x & 127, mis);
        // the generic stores made visible to wgmma's reads, then the warpgroup's barrier
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
      }
      const uint32_t a = smem_u32(buf) + wg * 64 * 128, b = smem_u32(buf + kBitsA);
      pin(acc);
      wgmma_fence();
#pragma unroll
      for (int q = 0; q < kBitsK / 16; ++q) wgmma_ss(acc, b_desc(a + 32 * q), m_desc(b + 1024 * q));
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's wgmmas are done: release its slot
      pin(acc);
      if (i > 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[(i - 1) % kBitsStages]);
      }
    }
    wgmma_wait<0>();
    pin(acc);
    if (kBitsCluster > 1 && rank != 0) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        part[q * kConsumers * 128 + threadIdx.x] =
            make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
    }
  }
  if (kBitsCluster > 1) cluster_sync();
  if (consumer && rank == 0) {
    for (uint32_t peer = 1; peer < kBitsCluster; ++peer) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 v = ld_peer(&part[q * kConsumers * 128 + threadIdx.x], peer);
        acc[4 * q] += v.x;
        acc[4 * q + 1] += v.y;
        acc[4 * q + 2] += v.z;
        acc[4 * q + 3] += v.w;
      }
    }
    const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, t = lane & 3;
    const long long ra = row0 + 64 * wg + 16 * wq + g, rb = ra + 8;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // accumulator 4j + e: row g (e < 2) or g + 8, column 8j + 2t + e % 2
      if (ra < nb)
        *reinterpret_cast<int2*>(out + ra * 32 + 8 * j + 2 * t) =
            make_int2(static_cast<int>(acc[4 * j]) & 1, static_cast<int>(acc[4 * j + 1]) & 1);
      if (rb < nb)
        *reinterpret_cast<int2*>(out + rb * 32 + 8 * j + 2 * t) =
            make_int2(static_cast<int>(acc[4 * j + 2]) & 1, static_cast<int>(acc[4 * j + 3]) & 1);
    }
  }
  if (kBitsCluster > 1) cluster_sync();  // no block leaves while its leader reads it
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, a driver-API function, found once through the runtime
cudaError_t encode_tiled(EncodeTiled* fn) {
  static EncodeTiled found = nullptr;
  static cudaError_t err = cudaSuccess;
  static std::once_flag once;
  std::call_once(once, [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                           &q);
#else
    err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && (q != cudaDriverEntryPointSuccess || p == nullptr))
      err = cudaErrorNotSupported;
    found = reinterpret_cast<EncodeTiled>(p);
  });
  *fn = found;
  return err;
}

template <typename T, int R, bool Tma>
int launch_forms(const void* data, long long nb, int block, const void* mimg, void* out,
                 cudaStream_t stream) {
  constexpr int kTile = kConsumers * R * 64;
  constexpr int kSmem = forms_smem<T, R, Tma>();
  CUtensorMap map{};  // the rows: (nb, block) bytes, a box 256 rows x 32 bytes, zeros past nb
  if (Tma) {
    EncodeTiled encode = nullptr;
    const cudaError_t err = encode_tiled(&encode);
    if (err != cudaSuccess) return static_cast<int>(err);
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(block), static_cast<cuuint64_t>(nb)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(block)};
    const cuuint32_t box[2] = {kSlice, kBoxRows}, steps[2] = {1, 1};
    if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(data), dims, strides, box,
               steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = crc_forms_mm_kernel<T, R, Tma>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((nb + kTile - 1) / kTile);
  kernel<<<blocks, forms_threads<R>(), kSmem, stream>>>(
      map, static_cast<const uint8_t*>(data), nb, block, static_cast<const uint8_t*>(mimg),
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool Tma>
int launch_forms_tile(const void* data, long long nb, int block, int tile, const void* mimg,
                      void* out, cudaStream_t stream) {
  switch (tile) {
    case 256: return launch_forms<T, 2, Tma>(data, nb, block, mimg, out, stream);
    case 512: return launch_forms<T, 4, Tma>(data, nb, block, mimg, out, stream);
    case 1024: return launch_forms<T, 8, Tma>(data, nb, block, mimg, out, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_forms_route(const void* data, long long nb, int block, int tile, int route,
                       const void* mimg, void* out, cudaStream_t stream) {
  if (route == 0) return launch_forms_tile<T, true>(data, nb, block, tile, mimg, out, stream);
  return launch_forms_tile<T, false>(data, nb, block, tile, mimg, out, stream);
}

// the two tensor maps of gf2_bits_mm: M (K, 32) in boxes of kBitsK rows,
// and where Tma the bits (nb, K) in boxes of kBitsRows rows x kBitsK
template <bool Tma>
int launch_bits(const void* bits, long long nb, int K, const void* m, void* out,
                cudaStream_t stream) {
  EncodeTiled encode = nullptr;
  const cudaError_t found = encode_tiled(&encode);
  if (found != cudaSuccess) return static_cast<int>(found);
  CUtensorMap bmap{}, mmap{};
  const cuuint32_t steps[2] = {1, 1};
  const cuuint64_t mdims[2] = {32, static_cast<cuuint64_t>(K)}, mstrides[1] = {64};
  const cuuint32_t mbox[2] = {32, kBitsK};
  if (encode(&mmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(m), mdims, mstrides,
             mbox, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  if (Tma) {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(nb)};
    const cuuint64_t strides[1] = {2 * static_cast<cuuint64_t>(K)};
    const cuuint32_t box[2] = {kBitsK, kBitsRows};
    if (encode(&bmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(bits), dims, strides,
               box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = gf2_bits_mm_kernel<Tma>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBitsSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks =
      static_cast<unsigned>((nb + kBitsRows - 1) / kBitsRows * kBitsCluster);
  kernel<<<blocks, kBitsThreads, kBitsSmem, stream>>>(
      bmap, mmap, static_cast<const unsigned char*>(bits), nb, K, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
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

// data: u8 (nb, block), 1 <= nb < 2^31 - 1024, block a positive multiple of
// 32; dtype: 0 bf16, 1 int8; tile: 256, 512 or 1024 rows a CUDA block;
// route: 0 the rows by TMA (data 16-byte aligned), 1 loaded by the
// consumers (any offset); mimg: M_B in the card's order and layout
// (crc32_probe.card_matrix), 16-byte aligned.  out: int32[nb, 32].
extern "C" int tz_crc_forms_mm(const void* data, long long nb, int block, int tile, int dtype,
                               int route, const void* mimg, void* out, void* stream) {
  if (block <= 0 || block % kSlice || nb <= 0 || nb >= (1LL << 31) - 1024 ||
      (route != 0 && route != 1) || reinterpret_cast<uintptr_t>(mimg) % 16 ||
      (route == 0 && reinterpret_cast<uintptr_t>(data) % 16))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_forms_route<__nv_bfloat16>(data, nb, block, tile, route, mimg, out, s);
  if (dtype == 1) return launch_forms_route<signed char>(data, nb, block, tile, route, mimg, out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// bits: bf16[nb, K], 1 <= nb < 2^31 - kBitsRows, K a positive multiple of
// 128; route: 0 the bits by TMA (16-byte aligned), 1 loaded by the
// consumers (any offset of a bf16); m: bf16[K, 32], 32-byte aligned.
// out: int32[nb, 32].
extern "C" int tz_gf2_bits_mm(const void* bits, long long nb, int K, int route, const void* m,
                              void* out, void* stream) {
  if (K <= 0 || K % (2 * kBitsK) || nb <= 0 || nb >= (1LL << 31) - kBitsRows ||
      (route != 0 && route != 1) || reinterpret_cast<uintptr_t>(m) % 32 ||
      reinterpret_cast<uintptr_t>(bits) % 2 || (route == 0 && reinterpret_cast<uintptr_t>(bits) % 16))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (route == 0) return launch_bits<true>(bits, nb, K, m, out, s);
  return launch_bits<false>(bits, nb, K, m, out, s);
}
