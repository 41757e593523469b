// One superstep of R packed BFS runs as one edge pass, for Hopper (sm_90a).
//
// Replaces, on the packed path, repro/kernels/nfa_step.py:54
// nfa_step_pallas and repro/kernels/segment_or.py:43 segmented_or_scan
// with the stitch and pick of repro/kernels/ops.py:87 segment_or, and the
// gathers and masks around them in the body of repro/core/packed.py's
// while_loop; on the dense engine's path, the XLA superstep of
// repro/core/dense.py:136 _edge_scatter / _step_core, vmapped over rows
// as in _bfs_hetero (one automaton a row); on a mesh, one shard's
// superstep, repro/core/distributed.py:159 _local_bfs_step.  For each row
// r, frontier f_r and visited v_r ([V, W] uint32 words), the frontier g_r
// that obj indexes ([Vg, W]: f_r itself, or on a mesh the frontier
// gathered over every shard, of which f_r is the shard's own rows),
// tables Bp_r [L, W] and bwd_r [S, W], and edges subj, pred, obj ([E]
// int32, subj local) shared by every row, one launch computes
//
//   v_r |= f_r                                  (the frontier is visited)
//   nxt_r[s] |= OR_{e : subj[e] == s} T'_r[g_r[obj[e]] & Bp_r[pred[e]]]
//               & ~v_r[s]
//   spare_r = 0                                 (the next superstep's nxt)
//   *flag = stamp, if some word ORed into some nxt_r is non-zero
//
// with T'_r[X] = OR_{j < S, bit j of X} bwd_r[j].  nxt is zero on entry.
// So v trails the frontier by one superstep, and the caller rotates three
// frontier buffers (f, nxt, spare): that is what lets one launch do the
// whole superstep.  The JAX package's state (f, v | f) is this one's
// (f, v) plus the OR of f into v, which the caller does once at the end.
// The flag holds the stamp of the last superstep that found a word, so a
// caller may queue several supersteps before it reads the flag: a launch
// whose flag is below stamp - 1 follows a superstep that found nothing,
// so its frontier is empty and it returns at once, writing nothing.  The
// shards of a mesh that sit on one device share one flag, so a launch
// stops only when no shard found a word (the gathered frontier is empty).
// Ids out of range contribute nothing; bits j >= S of X select nothing.
// A label row of zeros (the dense engine's inert label) selects nothing.
//
// Race-free: threads OR f into v while others read v[s] | f[s] for the
// mask, and they read the same value whether or not f is in v yet.  OR
// does not depend on order, so the atomics make nxt exact for subjects in
// any order.  Nothing reads spare or writes f or g.  Every thread of a launch
// reads the flag before any writes it, or reads the launch's own stamp.
//
// What bounds it: bytes.  Every edge's obj must be read (4*E) and every
// frontier word (4*R*V*W); a (row, edge) whose frontier word is non-zero
// also needs its pred, one whose T' is non-zero its subj (4 each); each
// word ORed into nxt needs v and nxt there (8), each non-zero frontier
// word v's read and write (8), spare is written (4*R*V*W), and the tables
// are read once.  At the packed path's heaviest superstep (R = 1,
// E = 3,954,840, V = 200,000, W = 1; 54% of rows with a non-zero frontier
// word, 8.5% with a non-zero transition) that is 28.5 MB, 8.5 us at
// 3.35 TB/s; obj is 55% of it.
//
// What the design does about it: one thread per edge, in a grid-stride
// loop of as many blocks as fit on the card at once.  A thread reads its
// obj once (coalesced) and walks the R rows: the frontier word there (800
// KB a row at V = 200,000, held in the 50 MB L2), and it stops for that
// row if that is zero: its pred, Bp row, table rows and subj are never
// read.  With an empty frontier the pass runs at the speed of a bare
// gather of f[obj] a row; the live edges' work takes it to about 10x its
// bound at the packed path's heaviest superstep.  Taking four edges a
// thread, their loads issued together, was measured no faster and
// removed (PERF.md).  The tables are read through the L1: staging them in
// shared memory once per block was timed within 1.5% of it either way and
// removed (PERF.md).  Lanes of a warp whose rows share a subject (edges
// sorted by subject put a hub's rows side by side) OR together first
// (__match_any_sync + __reduce_or_sync, as in segment_or.cu), skipped
// when one lane of the warp has a non-zero word; the lane that issues the
// atomic applies the mask.  So no [E, W] row of X or Y is written, nxt
// needs no memset (the spare buffer is cleared in passing) and the stop
// test is the flag: one launch a superstep of every row.  Output words
// are built kChunk at a time, so any W >= 1 works; past kChunk the bit
// walk repeats a chunk.
//
// Build (no PyTorch headers, plain C entry points bound with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libpacked_superstep.so packed_superstep.cu

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 8;                 // output words in registers
constexpr unsigned kFull = 0xFFFFFFFFu;

// Word w of X = f_row & b_row, its bits at or above S cleared.
__device__ __forceinline__ uint32_t x_word(const uint32_t* f_row,
                                           const uint32_t* b_row, int w,
                                           int S) {
  uint32_t x = f_row[w] & b_row[w];
  const int live = S - 32 * w;  // > 0: w < in_words
  return live < 32 ? x & ((1u << live) - 1u) : x;
}

// One edge slot of a warp, in one row: edge e (object o, live when the
// row's frontier words below S are not all zero) ORs T'[g[o] &
// Bp[pred[e]]] into nxt[subj[e]], masked by ~(v | f) there.  g, f, v,
// nxt, Bp and bwd point at the row's own arrays.  Every lane of the warp calls
// it together.  Sets `hit` when it ORs a non-zero word in.
__device__ __forceinline__ void edge_slot(
    int64_t e, int o, bool live, const uint32_t* __restrict__ g,
    const uint32_t* __restrict__ f, const uint32_t* v, uint32_t* __restrict__ nxt,
    const uint32_t* __restrict__ Bp, const uint32_t* __restrict__ bwd,
    const int32_t* __restrict__ subj, const int32_t* __restrict__ pred,
    int V, int L, int S, int W, int in_words, int lane, bool& hit) {
  const uint32_t* f_row = g + static_cast<int64_t>(live ? o : 0) * W;
  const uint32_t* b_row = Bp;
  if (live) {
    const int p = pred[e];
    if (p >= 0 && p < L) b_row = Bp + static_cast<int64_t>(p) * W;
    else live = false;
  }
  int s = -1;  // subject, read once T' is non-zero
  for (int c = 0; c < W; c += kChunk) {
    const int width = min(kChunk, W - c);
    uint32_t y[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) y[k] = 0u;
    if (live) {
      for (int w = 0; w < in_words; ++w) {
        uint32_t bits = x_word(f_row, b_row, w, S);
        while (bits) {
          const int j = 32 * w + __ffs(bits) - 1;
          bits &= bits - 1u;
          const uint32_t* row = bwd + static_cast<int64_t>(j) * W + c;
#pragma unroll
          for (int k = 0; k < kChunk; ++k)
            if (k < width) y[k] |= row[k];
        }
      }
    }
    bool any = false;
#pragma unroll
    for (int k = 0; k < kChunk; ++k) any |= y[k] != 0u;
    if (any && s < 0) {
      s = subj[e];
      if (s >= V) s = -2;  // out of range: contributes nothing
    }
    const bool mine = any && s >= 0;
    const unsigned writers = __ballot_sync(kFull, mine);
    if (writers == 0u) continue;
    bool lead = mine;
    if (__popc(writers) > 1) {  // the same for every lane of the warp
      const unsigned peers = __match_any_sync(kFull, mine ? s : -1);
#pragma unroll
      for (int k = 0; k < kChunk; ++k)
        y[k] = __reduce_or_sync(peers, mine ? y[k] : 0u);
      lead = mine && lane == __ffs(peers) - 1;
    }
    if (lead) {
      const int64_t base = static_cast<int64_t>(s) * W + c;
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        if (k >= width) continue;
        const uint32_t m = y[k] & ~(v[base + k] | f[base + k]);
        if (m) {
          atomicOr(nxt + base + k, m);
          hit = true;
        }
      }
    }
  }
}

// kOneRow: R == 1, compiled apart so the one-row pass (the packed BFS,
// and the dense engine's one-request dispatches) keeps the registers,
// and so the occupancy, it had before the row loop.
template <bool kOneRow>
__global__ void __launch_bounds__(kThreads)
packed_superstep_kernel(const uint32_t* __restrict__ g,
                        const uint32_t* __restrict__ f, uint32_t* v,
                        uint32_t* __restrict__ nxt,
                        uint32_t* __restrict__ spare, int32_t* flag,
                        int stamp, const uint32_t* __restrict__ Bp,
                        const uint32_t* __restrict__ bwd,
                        const int32_t* __restrict__ subj,
                        const int32_t* __restrict__ pred,
                        const int32_t* __restrict__ obj, int64_t E, int R,
                        int V, int Vg, int L, int S, int W) {
  // the superstep before found nothing: every frontier is empty
  if (*flag < stamp - 1) return;
  const int lane = threadIdx.x & 31;
  const int in_words = (S + 31) >> 5;
  const int64_t row_words = static_cast<int64_t>(V) * W;
  const int64_t g_words = static_cast<int64_t>(Vg) * W;
  bool hit = false;  // this thread ORed a non-zero word into nxt

  // edges: the loop test is the warp's first lane's, so a warp stays whole
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (int64_t e = first; e - lane < E; e += stride) {
    int o = -1;
    if (e < E) {
      o = obj[e];
      if (o < 0 || o >= Vg) o = -1;
    }
    if (!__any_sync(kFull, o >= 0)) continue;
    for (int r = 0; r < (kOneRow ? 1 : R); ++r) {
      const int64_t at = r * row_words;
      const int64_t at_g = r * g_words;
      bool live = false;
      if (o >= 0)
        for (int w = 0; w < in_words && !live; ++w)
          live = g[at_g + static_cast<int64_t>(o) * W + w] != 0u;
      if (!__any_sync(kFull, live)) continue;
      edge_slot(e, o, live, g + at_g, f + at, v + at, nxt + at,
                Bp + static_cast<int64_t>(r) * L * W,
                bwd + static_cast<int64_t>(r) * S * W, subj, pred, V, L, S,
                W, in_words, lane, hit);
    }
  }

  // words: visit the frontier, clear the spare buffer
  const int64_t words = (kOneRow ? 1 : R) * row_words;
  for (int64_t i = first; i < words; i += stride) {
    const uint32_t fw = f[i];
    if (fw) v[i] |= fw;
    spare[i] = 0u;
  }
  if (__any_sync(kFull, hit) && lane == 0) *flag = stamp;
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = queued).
// All pointers are device pointers to contiguous data: g [R, Vg, W]
// uint32 (f itself, or a buffer no launch writes), f, v, nxt, spare
// [R, V, W] uint32 (nxt zero on entry, four distinct buffers), flag one
// int32, Bp [R, L, W] and bwd [R, S, W] uint32, subj, pred, obj [E]
// int32.
int packed_superstep_launch(const void* g, const void* f, void* v,
                            void* nxt, void* spare,
                            void* flag, int stamp, const void* Bp,
                            const void* bwd, const void* subj,
                            const void* pred, const void* obj, long long E,
                            int R, int V, int Vg, int L, int S, int W,
                            void* stream) {
  const int64_t words = static_cast<int64_t>(R) * V * W;
  const int64_t work = E > words ? E : words;
  if (work <= 0 || W <= 0 || R <= 0) return 0;
  const auto kernel = R == 1 ? packed_superstep_kernel<true>
                             : packed_superstep_kernel<false>;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t needed = (work + kThreads - 1) / kThreads;
  const int64_t resident = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm
                                                                   : 1);
  const int blocks = static_cast<int>(needed < resident ? needed : resident);
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(g), static_cast<const uint32_t*>(f),
      static_cast<uint32_t*>(v),
      static_cast<uint32_t*>(nxt), static_cast<uint32_t*>(spare),
      static_cast<int32_t*>(flag), stamp,
      static_cast<const uint32_t*>(Bp), static_cast<const uint32_t*>(bwd),
      static_cast<const int32_t*>(subj), static_cast<const int32_t*>(pred),
      static_cast<const int32_t*>(obj), E, R, V, Vg, L, S, W);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
