// Load-chain latency on the card, and what stores from the same warp add
// to it.  Each thread follows its own chain of dependent loads through a
// 16 KiB table (a random cycle, so every load waits for the one before);
// clock64() around the chain gives cycles per hop.  Launched as 8,192
// threads in blocks of 32, as the decode kernel's cursors are, so each SM
// holds about two warps.  Modes:
//   0  __ldg (ld.global.nc)          1  plain ld.global
//   2  ld.shared                      3  __ldg, and a 16-byte store every
//   4  __ldg, and a 4-byte store           4 hops to the thread's own row
//      every hop to its own row       5  as 4, with st.global.cg
// Prints one JSON object per mode.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o latency probes/latency.cu && ./latency

#include <cstdint>
#include <cstdio>
#include <cuda_runtime.h>

constexpr int kN = 4096, kHops = 2000, kCap = 2048, kK = 8192, kThreads = 32;

template <int MODE>
__global__ void chase(const uint32_t* __restrict__ tab, int32_t* out, long long* cyc) {
  __shared__ uint32_t s[kN];
  if (MODE == 2) {
    for (int i = threadIdx.x; i < kN; i += blockDim.x) s[i] = tab[i];
    __syncthreads();
  }
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  int32_t* row = out + static_cast<long long>(k) * kCap;
  uint32_t x = (k * 97) % kN;
  const long long t0 = clock64();
  for (int h = 0; h < kHops; ++h) {
    if (MODE == 0) x = __ldg(tab + x);
    if (MODE == 1) x = tab[x];
    if (MODE == 2) x = s[x];
    if (MODE == 3) {
      x = __ldg(tab + x);
      if ((h & 3) == 3) reinterpret_cast<int4*>(row)[h >> 2] = make_int4(x, h, x, h);
    }
    if (MODE == 4) {
      x = __ldg(tab + x);
      row[h] = x;
    }
    if (MODE == 5) {
      x = __ldg(tab + x);
      __stcg(row + h, static_cast<int32_t>(x));
    }
  }
  cyc[k] = clock64() - t0;
  if (x == 0xffffffffu) out[0] = 1;  // keeps the chain live
}

template <int MODE>
void run(const char* name, const uint32_t* tab, int32_t* out, long long* cyc, long long* host) {
  for (int rep = 0; rep < 2; ++rep) {  // the second run is the warm one
    chase<MODE><<<kK / kThreads, kThreads>>>(tab, out, cyc);
    cudaDeviceSynchronize();
  }
  cudaMemcpy(host, cyc, kK * sizeof(long long), cudaMemcpyDeviceToHost);
  double sum = 0;
  for (int i = 0; i < kK; ++i) sum += host[i];
  printf("{\"mode\": %d, \"what\": \"%s\", \"cycles_per_hop\": %.1f}\n", MODE, name,
         sum / kK / kHops);
}

int main() {
  // one random cycle through the table
  uint32_t perm[kN], next[kN];
  for (int i = 0; i < kN; ++i) perm[i] = i;
  unsigned seed = 1;
  for (int i = kN - 1; i > 0; --i) {
    seed = seed * 1103515245u + 12345u;
    const int j = (seed >> 8) % (i + 1);
    const uint32_t t = perm[i];
    perm[i] = perm[j];
    perm[j] = t;
  }
  for (int i = 0; i < kN; ++i) next[perm[i]] = perm[(i + 1) % kN];
  uint32_t* tab;
  int32_t* out;
  long long* cyc;
  cudaMalloc(&tab, sizeof(next));
  cudaMemcpy(tab, next, sizeof(next), cudaMemcpyHostToDevice);
  cudaMalloc(&out, static_cast<size_t>(kK) * kCap * sizeof(int32_t));
  cudaMalloc(&cyc, kK * sizeof(long long));
  static long long host[kK];
  run<0>("ld.global.nc chain", tab, out, cyc, host);
  run<1>("ld.global chain", tab, out, cyc, host);
  run<2>("ld.shared chain", tab, out, cyc, host);
  run<3>("ld.global.nc chain + 16-byte store every 4 hops", tab, out, cyc, host);
  run<4>("ld.global.nc chain + 4-byte store every hop", tab, out, cyc, host);
  run<5>("ld.global.nc chain + 4-byte st.global.cg every hop", tab, out, cyc, host);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    fprintf(stderr, "%s\n", cudaGetErrorString(err));
    return 1;
  }
  return 0;
}
