// Bitvector rank over packed uint32 words, for Hopper (sm_90a).
//
// Replaces the two TPU kernels of repro/kernels/rank_popcount.py:
//
// superblock_popcounts_launch, for superblock_popcounts_pallas: the set
// bits of each 512-bit superblock (16 words) of words [NW] -> [NW/16]
// int32.  rank_directory_launch: the rank directory itself, a leading 0
// and the inclusive prefix sum of those counts, [NW/16 + 1] int32, in
// the same kernel and launch (the JAX package takes the prefix sum
// outside, in XLA).
//
// rank1_launch, for rank_window together with the window gather and masks
// that repro/kernels/ops.py::rank1 builds around it in XLA:
//   rank1(i) = dir[i >> 9] + popcount of the bits below i in the 16-word
//   window of superblock i >> 9.
// Each word's mask is all ones below the query's word, the low (i & 31)
// bits in it, nothing above.  When i & 31 == 0 the partial mask is 0 (the
// JAX package computes 0xFFFFFFFF >> 32 there and discards it).  Word and
// directory indices are clamped into their arrays, as the JAX package's
// gathers clamp, while the masks use the unclamped positions.
//
// What bounds them, and the design.  Both read little and are bound by
// bytes.  A query's window starts 64-byte aligned (word 16 * sb), so
// rank1 reads it as 16-byte vectors through the read-only path, one
// thread a query, only the quarters that hold a word at or below the
// query's word: every 32-byte sector it touches is used whole, at most
// two a query, where a load a word touched a sector per word.  At
// random offsets over a level of the ring the L2 sectors (its directory
// entry's and its words') set the pace, not HBM; sorted offsets share
// them.  Four lanes a query, one quarter each, was timed beside this on
// the card and lost: four times the threads made it bound by instruction
// throughput; two or four queries a thread moved it by under 5%.
// Indices are 32-bit (offsets are int32).  A window that reaches past
// the words, or words whose address is not 16-byte aligned (a view at
// an offset), take the per-word clamped path of the same kernel.  The
// directory's entry is loaded before the words, so the loads overlap.
// The popcounts read each superblock as four 16-byte vectors, one a lane,
// a warp 512 bytes at a time.  The directory mode scans in the same pass:
// blocks take tiles in the order of an atomic ticket, scan their tile
// with warp shuffles, and chain the tiles by decoupled look-back through
// a scratch of one 64-bit word a tile (the aggregate or the inclusive
// prefix, with the launch's sequence number in the high half, so no
// launch has to clear it; the last ticket resets the ticket counter).
// Both are a few microseconds above their launch floor.
//
// Build (no PyTorch headers, plain C entry points bound with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o librank_popcount.so rank_popcount.cu

#include <climits>
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSbWords = 16;     // 16 x 32-bit words = 512-bit superblocks
constexpr int kGroup = 4;        // lanes a superblock: a uint4 each
constexpr int kTileSb = kThreads / kGroup;   // 64 superblocks a block
constexpr unsigned kFull = 0xFFFFFFFFu;
// a tile's scratch word: (seq << 33) | (inclusive << 32) | value
constexpr unsigned long long kInclusive = 1ull << 32;

__device__ __forceinline__ int popc4(uint4 v) {
  return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
}

// the popcount of word k of a query's window: all of it below the query's
// word kq, the partial mask in it, nothing above
__device__ __forceinline__ int masked(uint32_t w, int k, int kq,
                                      uint32_t partial) {
  return __popc(w & (k < kq ? kFull : (k == kq ? partial : 0u)));
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
  return v;
}

__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int n = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += n;
  }
  return v;
}

// One superblock a lane group (4 lanes), kTileSb superblocks a block:
// lane `part` reads quarter `part` of superblock tile * kTileSb + g, and
// two shuffles give all four lanes its count.
template <bool kDirectory>
__global__ void __launch_bounds__(kThreads)
superblock_kernel(const uint32_t* __restrict__ words,
                  int32_t* __restrict__ out, int nsb, int vec,
                  unsigned long long* __restrict__ flags,
                  unsigned* __restrict__ ticket, int ntiles, unsigned seq) {
  __shared__ int s_tile;
  __shared__ int s_warp[kWarps];
  __shared__ int s_excl;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int part = threadIdx.x & (kGroup - 1);
  int tile = blockIdx.x;
  if (kDirectory) {
    // tiles in ticket order: every tile below this one belongs to a
    // block that is already running, so the look-back below ends
    if (threadIdx.x == 0) {
      s_tile = static_cast<int>(atomicAdd(ticket, 1u));
      if (s_tile == ntiles - 1) atomicExch(ticket, 0u);  // the last ticket
    }
    __syncthreads();
    tile = s_tile;
  }
  const int sb = tile * kTileSb + threadIdx.x / kGroup;
  int pc = 0;
  if (sb < nsb) {
    if (vec) {
      pc = popc4(__ldg(reinterpret_cast<const uint4*>(words) +
                       (sb * kGroup + part)));
    } else {
      const uint32_t* w = words + sb * kSbWords + part * 4;
      pc = __popc(w[0]) + __popc(w[1]) + __popc(w[2]) + __popc(w[3]);
    }
  }
  pc += __shfl_xor_sync(kFull, pc, 1);
  pc += __shfl_xor_sync(kFull, pc, 2);
  if (!kDirectory) {
    if (part == 0 && sb < nsb) out[sb] = pc;
    return;
  }
  // the counts scanned in tile order: within the warp (its 8 groups),
  // then over the warps, then over the tiles before this one
  const int wincl = warp_inclusive_scan(part == 0 ? pc : 0, lane);
  if (lane == 31) s_warp[warp] = wincl;
  __syncthreads();
  if (warp == 0) {
    const int t = warp_inclusive_scan(lane < kWarps ? s_warp[lane] : 0,
                                      lane);
    const int agg = __shfl_sync(kFull, t, kWarps - 1);
    if (lane < kWarps) s_warp[lane] = t;
    volatile unsigned long long* vf = flags;
    const unsigned long long stamp =
        static_cast<unsigned long long>(seq) << 33;
    int excl = 0;
    if (tile == 0) {
      if (lane == 0)
        vf[0] = stamp | kInclusive | static_cast<unsigned>(agg);
    } else {
      if (lane == 0) vf[tile] = stamp | static_cast<unsigned>(agg);
      for (int top = tile - 1;; top -= 32) {
        const int j = top - lane;
        unsigned long long f = stamp | kInclusive;  // before tile 0: 0
        if (j >= 0) {
          do {
            f = vf[j];
          } while ((f >> 33) != seq);
        }
        const int val = static_cast<int>(static_cast<unsigned>(f));
        const unsigned done = __ballot_sync(kFull, (f & kInclusive) != 0);
        if (done) {   // the nearest tile with its inclusive prefix
          excl += warp_sum(lane <= __ffs(done) - 1 ? val : 0);
          break;
        }
        excl += warp_sum(val);
      }
      if (lane == 0)
        vf[tile] = stamp | kInclusive | static_cast<unsigned>(excl + agg);
    }
    if (lane == 0) s_excl = excl;
  }
  __syncthreads();
  if (part == 0 && sb < nsb)
    out[1 + sb] = s_excl + (warp ? s_warp[warp - 1] : 0) + wincl;
  if (tile == 0 && threadIdx.x == 0) out[0] = 0;
}

// The set bits below offset i in its superblock's window: up to four
// 16-byte loads, the quarters of the window that hold a word at or below
// the query's word, or the per-word clamped path.
__device__ __forceinline__ int window_rank(const uint32_t* __restrict__ words,
                                           int i, int NW, int vec) {
  const int sb = i >> 9;
  const int kq = (i >> 5) & (kSbWords - 1);           // the query's word
  const unsigned inword = static_cast<unsigned>(i) & 31u;
  const uint32_t partial = inword ? kFull >> (32u - inword) : 0u;
  int acc = 0;
  if (vec && sb >= 0 && sb < (NW >> 4)) {
    const uint4* win = reinterpret_cast<const uint4*>(words) + sb * 4;
#pragma unroll
    for (int k0 = 0; k0 < kSbWords; k0 += 4) {
      if (k0 < kq || (k0 == kq && partial)) {
        const uint4 v = __ldg(win + k0 / 4);
        acc += masked(v.x, k0, kq, partial) + masked(v.y, k0 + 1, kq, partial)
             + masked(v.z, k0 + 2, kq, partial)
             + masked(v.w, k0 + 3, kq, partial);
      }
    }
  } else {   // the window reaches past the words, or they are unaligned
#pragma unroll
    for (int k = 0; k < kSbWords; ++k) {
      if (k < kq || (k == kq && partial)) {
        const int w = sb * kSbWords + k;
        acc += masked(words[min(max(w, 0), NW - 1)], k, kq, partial);
      }
    }
  }
  return acc;
}

// One thread a query.
__global__ void __launch_bounds__(kThreads)
rank1_kernel(const uint32_t* __restrict__ words,
             const int32_t* __restrict__ dir, const int32_t* __restrict__ q,
             int32_t* __restrict__ out, int NW, int ndir, int Q, int vec) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= Q) return;
  const int i = __ldg(q + t);
  const int d = __ldg(dir + min(max(i >> 9, 0), ndir - 1));  // ahead
  out[t] = d + window_rank(words, i, NW, vec);
}

int tiles_for(long long nsb) {
  return static_cast<int>((nsb + kTileSb - 1) / kTileSb);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" {

// Launch on `stream`; each returns the cudaError_t of the launch (0 =
// queued).  All pointers are device pointers to contiguous data.

// words [NW] uint32, NW % 16 == 0 -> out [NW/16] int32.
int superblock_popcounts_launch(const void* words, void* out, long long NW,
                                void* stream) {
  if (NW <= 0) return 0;
  if (NW % kSbWords || NW > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nsb = NW / kSbWords;
  superblock_kernel<false><<<tiles_for(nsb), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<int32_t*>(out),
      static_cast<int>(nsb), aligned16(words), nullptr, nullptr, 0, 0u);
  return static_cast<int>(cudaGetLastError());
}

// The scratch words the directory of NW words needs: one for the ticket
// counter, one for each tile's flag.
long long rank_directory_scratch_words(long long NW) {
  return 1 + tiles_for(NW / kSbWords);
}

// words [NW] uint32, NW > 0, NW % 16 == 0 -> out [NW/16 + 1] int32, in
// one launch.
// scratch: rank_directory_scratch_words(NW) uint64 words, zero when first
// used and then only by these launches, in stream order; seq in
// [1, 2^31), a different one for each launch on the scratch.
int rank_directory_launch(const void* words, void* out, void* scratch,
                          long long NW, unsigned seq, void* stream) {
  if (NW % kSbWords || NW <= 0 || NW > INT_MAX || seq == 0 ||
      seq >= (1u << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nsb = NW / kSbWords;
  auto* s = static_cast<unsigned long long*>(scratch);
  superblock_kernel<true><<<tiles_for(nsb), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<int32_t*>(out),
      static_cast<int>(nsb), aligned16(words), s + 1,
      reinterpret_cast<unsigned*>(s), tiles_for(nsb), seq);
  return static_cast<int>(cudaGetLastError());
}

// words [NW] uint32, dir [ndir] int32, q [Q] int32 -> out [Q] int32.
int rank1_launch(const void* words, const void* dir, const void* q,
                 void* out, long long NW, long long ndir, long long Q,
                 void* stream) {
  if (Q <= 0) return 0;
  if (NW <= 0 || ndir <= 0 || NW > INT_MAX || ndir > INT_MAX ||
      Q > INT_MAX - kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  rank1_kernel<<<static_cast<unsigned>((Q + kThreads - 1) / kThreads),
                 kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const int32_t*>(dir),
      static_cast<const int32_t*>(q), static_cast<int32_t*>(out),
      static_cast<int>(NW), static_cast<int>(ndir), static_cast<int>(Q),
      aligned16(words));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
