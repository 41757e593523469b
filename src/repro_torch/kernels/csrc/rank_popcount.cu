// Bitvector rank over packed uint32 words, for Hopper (sm_90a).
//
// Replaces the two TPU kernels of repro/kernels/rank_popcount.py:
//
// superblock_popcounts_launch, for superblock_popcounts_pallas: the set
// bits of each 512-bit superblock (16 words) of words [NW] -> [NW/16]
// int32.  The rank directory is a leading 0 and the prefix sum of these,
// taken outside.  One thread per word: __popc, then a sum over the 16
// lanes of the superblock with __shfl_xor_sync, so a warp reads 128
// contiguous bytes.
//
// rank1_launch, for rank_window together with the window gather and masks
// that repro/kernels/ops.py::rank1 builds around it in XLA:
//   rank1(i) = dir[i >> 9] + popcount of the bits below i in the 16-word
//   window of superblock i >> 9.
// One thread per query.  It reads its window from `words` and builds each
// word's mask in uint32 registers: all ones below the query's word, the
// low (i & 31) bits in it, nothing above.  When i & 31 == 0 the partial
// mask is 0 (the JAX package computes 0xFFFFFFFF >> 32 there and discards
// it).  Word and directory indices are clamped into their arrays, as the
// JAX package's gathers clamp.
//
// What bounds them: bytes.  The popcounts read 4*NW bytes and write NW/4;
// a query reads its offset, one directory entry and at most 16 words (64
// bytes, one or two cache lines) and writes 4 bytes.  Random queries over
// a bitvector larger than L2 pay a cache line or two from HBM each.
//
// Build (no PyTorch headers, plain C entry points bound with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o librank_popcount.so rank_popcount.cu

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSbWords = 16;  // 16 x 32-bit words = 512-bit superblocks

__global__ void __launch_bounds__(kThreads)
superblock_popcounts_kernel(const uint32_t* __restrict__ words,
                            int32_t* __restrict__ out, int64_t NW) {
  const int64_t idx =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  // NW % 16 == 0 and blocks are whole warps, so a superblock's 16 lanes
  // are all in range or all out: the shuffles below see whole groups
  int pc = idx < NW ? __popc(words[idx]) : 0;
#pragma unroll
  for (int d = kSbWords / 2; d > 0; d >>= 1)
    pc += __shfl_xor_sync(0xFFFFFFFFu, pc, d);
  if (idx < NW && (threadIdx.x & (kSbWords - 1)) == 0)
    out[idx / kSbWords] = pc;
}

__global__ void __launch_bounds__(kThreads)
rank1_kernel(const uint32_t* __restrict__ words,
             const int32_t* __restrict__ dir, const int32_t* __restrict__ q,
             int32_t* __restrict__ out, int64_t NW, int64_t ndir,
             int64_t Q) {
  const int64_t t =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= Q) return;
  const int32_t i = q[t];
  const int64_t sb = i >> 9;
  const int64_t wq = i >> 5;
  const uint32_t inword = static_cast<uint32_t>(i & 31);
  const uint32_t partial = inword == 0u ? 0u : (0xFFFFFFFFu >> (32u - inword));
  const int64_t d = sb < 0 ? 0 : (sb >= ndir ? ndir - 1 : sb);
  int32_t acc = dir[d];
  const int64_t w0 = sb * kSbWords;
#pragma unroll
  for (int k = 0; k < kSbWords; ++k) {
    const int64_t w = w0 + k;
    const int64_t rel = wq - w;
    const uint32_t mask = rel > 0 ? 0xFFFFFFFFu : (rel == 0 ? partial : 0u);
    if (mask) {
      const int64_t wc = w < 0 ? 0 : (w >= NW ? NW - 1 : w);
      acc += __popc(words[wc] & mask);
    }
  }
  out[t] = acc;
}

dim3 grid_for(int64_t total) {
  return dim3(static_cast<unsigned>((total + kThreads - 1) / kThreads));
}

}  // namespace

extern "C" {

// Launch on `stream`; each returns the cudaError_t of the launch (0 =
// queued).  All pointers are device pointers to contiguous data.

// words [NW] uint32, NW % 16 == 0 -> out [NW/16] int32.
int superblock_popcounts_launch(const void* words, void* out, long long NW,
                                void* stream) {
  if (NW <= 0) return 0;
  if (NW % kSbWords) return static_cast<int>(cudaErrorInvalidValue);
  superblock_popcounts_kernel<<<grid_for(NW), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<int32_t*>(out), NW);
  return static_cast<int>(cudaGetLastError());
}

// words [NW] uint32, dir [ndir] int32, q [Q] int32 -> out [Q] int32.
int rank1_launch(const void* words, const void* dir, const void* q,
                 void* out, long long NW, long long ndir, long long Q,
                 void* stream) {
  if (Q <= 0) return 0;
  if (NW <= 0 || ndir <= 0) return static_cast<int>(cudaErrorInvalidValue);
  rank1_kernel<<<grid_for(Q), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const int32_t*>(dir),
      static_cast<const int32_t*>(q), static_cast<int32_t*>(out), NW, ndir,
      Q);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
