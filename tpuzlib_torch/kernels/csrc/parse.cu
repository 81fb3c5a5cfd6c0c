// Greedy-parse token starts of the batched device deflate encoder.
//
// Replaces tpuzlib/kernels/parse_pallas.py:_kernel_fn.  member[i] = 1 when
// i is reached from its segment's start by i -> i + step[i]; the encoder
// forces a token break every `seg` bytes, so segments are independent.
//
// The chain is serial: walked on one thread, a segment of literals takes
// `seg` dependent shared-memory reads, and the path's own tapes have
// segments of 1,024 steps.  So one warp takes one segment, and each lane
// owns a span of S = seg/32 positions (a power of two), in three passes
// of at most S, 32 and S dependent steps:
//
//   exits   each lane walks its span backwards once and records, for
//           every position, where the chain from there first leaves the
//           span: i + step[i] when that is past the span, else the exit
//           of i + step[i], which is already known;
//   entries the whole warp follows the chain from span to span, one
//           exit read a span visited (a step may jump over whole spans),
//           and each lane keeps the position where the chain enters its
//           own span;
//   marks   each lane walks its span from that entry and marks the
//           positions it meets; the warp writes the mask back coalesced.
//
// Bound by device memory at the path's shapes: four bytes in and one out
// a position.  A position's step (low 14 bits, clamped: a step past the
// segment's end only ends the chain), its mark (bit 15) and its exit
// (high 16 bits, 0xFFFF: the chain ends) share one word of shared
// memory.  Lane l's span starts at word l * P, P = S | 1: the lanes'
// walks, which run in step, then fall in 32 different banks.  The TPU
// kernel's lane-local pointer doubling and rank replay exist because the
// TPU has no cheap serial step; its row composition is the entries pass.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // segments a block, where shared memory allows
constexpr int kStepBits = 0x3FFF;
constexpr int kMark = 1 << 15;
constexpr int kEnd = 0xFFFF;  // exit: the chain leaves the segment

__global__ void segment_parse_kernel(const int* __restrict__ step, bool* __restrict__ member,
                                     int n, int n_valid, int seg, int log_s, int warps, bool vec) {
  extern __shared__ uint32_t smem[];
  const int S = 1 << log_s, P = S | 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long seg_id = static_cast<long long>(blockIdx.x) * warps + warp;
  const long long base = seg_id * seg;
  if (base >= n) return;  // whole warps only: no barrier follows
  const int len = static_cast<int>(min(static_cast<long long>(seg), n - base));
  uint32_t* w = smem + warp * 32 * P;
  auto at = [&](int i) -> uint32_t& { return w[(i >> log_s) * P + (i & (S - 1))]; };
  auto clamp_step = [](int s) { return static_cast<uint32_t>(min(max(s, 0), kStepBits)); };

  // stage the steps, clamped into 0..kStepBits, with coalesced loads: 16
  // bytes a lane where the tape is aligned to them (vec)
  const int nvec = vec ? len >> 2 : 0;
#pragma unroll 8
  for (int q = lane; q < nvec; q += 32) {
    const int4 v = reinterpret_cast<const int4*>(step + base)[q];
    at(4 * q) = clamp_step(v.x);
    at(4 * q + 1) = clamp_step(v.y);
    at(4 * q + 2) = clamp_step(v.z);
    at(4 * q + 3) = clamp_step(v.w);
  }
  for (int i = 4 * nvec + lane; i < len; i += 32) at(i) = clamp_step(step[base + i]);
  __syncwarp();

  // exits: backwards over the lane's own span, mine[k] holding position
  // lo + k; the next position's step is read before this one's exit is
  // stored, so only the exit read waits
  const int lo = lane * S, m = max(0, min(S, len - lo));
  uint32_t* mine = w + lane * P;
  uint32_t s = m ? mine[m - 1] : 0;
  for (int k = m - 1; k >= 0; --k) {
    const uint32_t s_next = k ? mine[k - 1] : 0;
    const int jk = k + static_cast<int>(s);
    const uint32_t exit = s == 0 || lo + jk >= len ? kEnd : jk >= m ? lo + jk : mine[jk] >> 16;
    mine[k] = s | exit << 16;
    s = s_next;
  }
  __syncwarp();

  // entries: the chain from the segment's start, span by span; every lane
  // reads the same word, so each read is one broadcast
  int entry = -1;
  for (int e = 0; e < len; e = static_cast<int>(at(e) >> 16)) {
    if (e >> log_s == lane) entry = e;
  }

  // marks: from the entry to the end of the span
  for (int k = entry - lo; entry >= 0 && k < m;) {
    const uint32_t v = mine[k];
    mine[k] = v | kMark;
    const int st = static_cast<int>(v & kStepBits);
    k = st == 0 ? m : k + st;
  }
  __syncwarp();
  // the mask, four bytes a lane where aligned
  auto marked = [&](int i) -> uint32_t { return (at(i) & kMark) && base + i < n_valid; };
#pragma unroll 8
  for (int q = lane; q < nvec; q += 32) {
    const int i = 4 * q;
    reinterpret_cast<uint32_t*>(member + base)[q] =
        marked(i) | marked(i + 1) << 8 | marked(i + 2) << 16 | marked(i + 3) << 24;
  }
  for (int i = 4 * nvec + lane; i < len; i += 32) member[base + i] = marked(i);
}

}  // namespace

extern "C" int tz_segment_parse(const void* step, void* member, int n, int n_valid, int seg,
                                void* stream) {
  int log_s = 0;
  while ((32 << log_s) < seg) ++log_s;
  const int words = 32 * ((1 << log_s) | 1);  // a warp's shared memory, in words
  const int warps = max(1, min(kWarps, (48 << 10) / (4 * words)));
  const long long segs = (static_cast<long long>(n) + seg - 1) / seg;
  const unsigned blocks = static_cast<unsigned>((segs + warps - 1) / warps);
  const size_t smem = sizeof(uint32_t) * words * warps;
  // 16-byte loads and 4-byte stores when every segment starts aligned to them
  const bool vec = seg % 4 == 0 && reinterpret_cast<uintptr_t>(step) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(member) % 4 == 0;
  segment_parse_kernel<<<blocks, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(step), static_cast<bool*>(member), n, n_valid, seg, log_s, warps,
      vec);
  return static_cast<int>(cudaGetLastError());
}
