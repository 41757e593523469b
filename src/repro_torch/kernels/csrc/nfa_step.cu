// Bit-parallel reverse Glushkov step for Hopper (sm_90a).
//
// Replaces repro/kernels/nfa_step.py::nfa_step_pallas, the TPU kernel.
// Same function:  Y[n] = OR_{j : bit j of X[n], j < S} bwd[j]
// over packed uint32 words: X [N, W], bwd [S, W] -> Y [N, W], with
// S <= 32 * W.  Bits j >= S of X are ignored (the TPU kernel loops over
// j < S only), so a row's padding bits never select a table row.
//
// Two layouts, chosen by the caller from W (kernels/nfa_step.py holds
// the rule and the times behind it):
//
// Narrow rows, one thread per row.  The thread walks the set bits of its
// row with __ffs, so the work follows popcount(X[n]) and not S (the
// masked words D & B[p] are sparse), and ORs row bwd[j] into registers,
// kChunk output words at a time; past kChunk the bit walk repeats per
// chunk.
//
// Wide rows, one warp per row.  The lanes load the row's input words
// together (32 a pass, coalesced); a ballot lists the non-zero ones, and
// each is broadcast to the warp (__shfl_sync) and its set bits walked by
// every lane at once.  For bit j, lane l ORs bwd[j][l + 32k] for
// k < kLaneWords, so each selected table row is read once, in whole
// 128-byte lines, and the bits are walked once for up to 32 * kLaneWords
// output words.  A thread a row would re-walk its bits for each of the
// 16 chunks of a W = 128 row, and put the ring batch's 305 rows on two of
// the 132 SMs; a warp a row puts 32 lanes on each.
//
// Table rows are read from global memory (cache-resident: every row
// shares the table).  Staging the whole table in shared memory per block
// was measured slower on sparse rows and removed (PERF.md).
//
// What bounds it: bytes and launch latency.  A call must move
// (2*N*W + R*W) * 4 bytes, R being the table rows that set bits select
// (at most S); at the ring batch's launch (N = 305, S = 4,096, W = 128)
// that is about 0.4 MB, 0.13 us at 3.35 TB/s, below the few microseconds
// any launch takes.  So a launch at that shape is launch-bound once each
// row's work spreads over a warp.  The packed BFS does not call this
// kernel: packed_superstep.cu fuses the transition into its edge pass.
//
// Build (no PyTorch headers, plain C entry points bound with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libnfa_step.so nfa_step.cu

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // threads per block, either layout
constexpr int kChunk = 8;       // output words a thread holds (thread rows)
constexpr int kLaneWords = 4;   // output words a lane holds (warp rows)
constexpr unsigned kFull = 0xFFFFFFFFu;

// Word w of row x, its bits at or above S cleared (w < ceil(S / 32)).
__device__ __forceinline__ uint32_t live_bits(const uint32_t* x, int w,
                                              int S) {
  const uint32_t bits = x[w];
  const int live = S - 32 * w;  // states held by this word
  return live < 32 ? bits & ((1u << live) - 1u) : bits;
}

__global__ void __launch_bounds__(kThreads)
nfa_step_thread_rows(const uint32_t* __restrict__ X,
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
      uint32_t bits = live_bits(x_row, w, S);
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

__global__ void __launch_bounds__(kThreads)
nfa_step_warp_rows(const uint32_t* __restrict__ X,
                   const uint32_t* __restrict__ bwd,
                   uint32_t* __restrict__ Y, int N, int S, int W) {
  const int lane = threadIdx.x & 31;
  const int64_t n =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (n >= N) return;  // whole warps: blockDim is a multiple of 32
  const uint32_t* x_row = X + n * W;
  uint32_t* y_row = Y + n * W;
  const int in_words = (S + 31) >> 5;
  constexpr int kSpan = 32 * kLaneWords;  // output words a pass

  for (int c = 0; c < W; c += kSpan) {
    uint32_t acc[kLaneWords];
#pragma unroll
    for (int k = 0; k < kLaneWords; ++k) acc[k] = 0u;
    for (int w0 = 0; w0 < in_words; w0 += 32) {
      const int w = w0 + lane;
      const uint32_t mine = w < in_words ? live_bits(x_row, w, S) : 0u;
      unsigned todo = __ballot_sync(kFull, mine != 0u);
      while (todo) {  // the same on every lane
        const int src = __ffs(todo) - 1;
        todo &= todo - 1u;
        uint32_t bits = __shfl_sync(kFull, mine, src);
        const int base = 32 * (w0 + src);
        while (bits) {
          const int j = base + __ffs(bits) - 1;
          bits &= bits - 1u;
          const uint32_t* row = bwd + static_cast<size_t>(j) * W + c + lane;
#pragma unroll
          for (int k = 0; k < kLaneWords; ++k)
            if (c + lane + 32 * k < W) acc[k] |= row[32 * k];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kLaneWords; ++k)
      if (c + lane + 32 * k < W) y_row[c + lane + 32 * k] = acc[k];
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = queued).
// X, bwd and Y are device pointers to contiguous uint32 words; warp_rows
// picks the layout (non-zero: a warp per row).
int nfa_step_launch(const void* X, const void* bwd, void* Y, int N, int S,
                    int W, int warp_rows, void* stream) {
  if (N <= 0) return 0;
  const auto* x = static_cast<const uint32_t*>(X);
  const auto* b = static_cast<const uint32_t*>(bwd);
  auto* y = static_cast<uint32_t*>(Y);
  auto st = static_cast<cudaStream_t>(stream);
  if (warp_rows) {
    const int64_t threads = static_cast<int64_t>(N) * 32;
    const dim3 grid(static_cast<unsigned>((threads + kThreads - 1) /
                                          kThreads));
    nfa_step_warp_rows<<<grid, kThreads, 0, st>>>(x, b, y, N, S, W);
  } else {
    const dim3 grid((N + kThreads - 1) / kThreads);
    nfa_step_thread_rows<<<grid, kThreads, 0, st>>>(x, b, y, N, S, W);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
