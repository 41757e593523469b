// Bit-parallel reverse Glushkov step for Hopper (sm_90a).
//
// Replaces repro/kernels/nfa_step.py::nfa_step_pallas, the TPU kernel.
// Same function:  Y[n] = OR_{j : bit j of X[n], j < S} bwd[j]
// over packed uint32 words: X [N, W], bwd [S, W] -> Y [N, W], with
// S <= 32 * W.  Bits j >= S of X are ignored (the TPU kernel loops over
// j < S only), so a row's padding bits never select a table row.
//
// Design: one thread per task row.  The thread walks the set bits of its
// row with __ffs, so the work follows popcount(X[n]) and not S (the
// masked words D & B[p] are sparse), and ORs row bwd[j] into registers.
// Output words are produced in chunks of kChunk registers, so any W >= 1
// works; for W > kChunk the bit walk repeats once per chunk.  Table rows
// are read from global memory (cache-resident: every thread shares the
// table).  Staging the whole table in shared memory per block was
// measured slower on sparse rows and removed (PERF.md, PR 11).
//
// What bounds it: launch latency and bytes moved.  A call must move
// (2*N*W + R*W) * 4 bytes, R being the table rows that set bits select
// (at most S); at N = 1,000 and W = 22 that is under 0.2 MB, well under
// 0.1 microseconds of the H100's 3.35 TB/s.  So one launch (a few
// microseconds) and the host<->device copies of X and Y, which the
// caller makes around every launch, dominate.  The design does nothing
// about that yet: keeping the frontier on the device and batching
// supersteps is later work.
//
// Build (no PyTorch headers, plain C entry points bound with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libnfa_step.so nfa_step.cu

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // rows per block
constexpr int kChunk = 8;      // output words held in registers at a time

__global__ void __launch_bounds__(kThreads)
nfa_step_kernel(const uint32_t* __restrict__ X,
                const uint32_t* __restrict__ bwd,
                uint32_t* __restrict__ Y, int N, int S, int W) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;  // ragged last block
  const uint32_t* x_row = X + static_cast<size_t>(n) * W;
  uint32_t* y_row = Y + static_cast<size_t>(n) * W;
  const int in_words = (S + 31) >> 5;

  for (int c = 0; c < W; c += kChunk) {
    const int width = min(kChunk, W - c);
    uint32_t acc[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) acc[k] = 0u;
    for (int w = 0; w < in_words; ++w) {
      uint32_t bits = x_row[w];
      const int live = S - 32 * w;  // states held by this word
      if (live < 32) bits &= (1u << live) - 1u;
      while (bits) {
        const int b = __ffs(bits) - 1;
        bits &= bits - 1u;
        const uint32_t* row = bwd + static_cast<size_t>(32 * w + b) * W + c;
#pragma unroll
        for (int k = 0; k < kChunk; ++k)
          if (k < width) acc[k] |= row[k];
      }
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k)
      if (k < width) y_row[c + k] = acc[k];
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = queued).
// X, bwd and Y are device pointers to contiguous uint32 words.
int nfa_step_launch(const void* X, const void* bwd, void* Y, int N, int S,
                    int W, void* stream) {
  if (N <= 0) return 0;
  const auto* x = static_cast<const uint32_t*>(X);
  const auto* b = static_cast<const uint32_t*>(bwd);
  auto* y = static_cast<uint32_t*>(Y);
  auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + kThreads - 1) / kThreads);
  nfa_step_kernel<<<grid, kThreads, 0, st>>>(x, b, y, N, S, W);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
