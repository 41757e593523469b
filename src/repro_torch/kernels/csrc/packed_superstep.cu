// One superstep of R packed BFS runs, driven by the live frontier, for
// Hopper (sm_90a).
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
// that an edge's object indexes ([Vg, W]: f_r itself, or on a mesh the
// frontier gathered over every shard, of which f_r is the shard's own
// rows), tables Bp_r [L, W] and bwd_r [S, W], and edges (s, p, o) shared
// by every row, one superstep computes
//
//   v_r |= f_r                                  (the frontier is visited)
//   nxt_r[s] |= OR_{edges (s, p, o)} T'_r[g_r[o] & Bp_r[p]] & ~v_r[s]
//   spare_r = 0                                 (the next superstep's nxt)
//   *flag = stamp, if some word ORed into some nxt_r is non-zero
//
// with T'_r[X] = OR_{j < S, bit j of X} bwd_r[j].  nxt is zero on entry.
// So v trails the frontier by one superstep, and the caller rotates three
// frontier buffers (f, nxt, spare).  The JAX package's state (f, v | f)
// is this one's (f, v) plus the OR of f into v, which the caller does
// once at the end.  The flag holds the stamp of the last superstep that
// found a word, so a caller may queue several supersteps before it reads
// the flag: a superstep whose flag is below stamp - 1 follows one that
// found nothing, so its frontier is empty and both its launches return at
// once, writing nothing.  The shards of a mesh that sit on one device
// share one flag, so a superstep stops only when no shard found a word.
// Ids out of range contribute nothing; bits j >= S of X select nothing.
//
// The edges come grouped by object (kernels/packed_superstep.py
// group_by_object): offsets [Vg + 1], and subj, pred [E'] in object
// order with the subject as the secondary key, inert-label edges (the
// dense engine's tombstones and padding) dropped.  A superstep is two
// launches on the caller's stream:
//
//   A, scan_frontier: reads g once, coalesced.  Each (row, object) with a
//   frontier bit below S and edges appends ceil(degree / tile) worklist
//   entries {first edge, row * Vg + object} of at most `tile` edges each
//   (32: kernels/packed_superstep.py TILE).  A block takes a prefix sum
//   of its threads' entry counts and issues one atomicAdd on the global
//   counter; a warp writes a hub's entries together.  The same launch ORs
//   f into v and clears spare over the state's own [R, V, W] words.
//   B, expand_tiles: each warp takes a run of kRun entries, a prefix sum
//   of their edge counts by shuffles, and its lanes take one edge each by
//   a binary search over those sums (a load-balanced search, as in
//   Merrill, Garland and Grimshaw, "Scalable GPU Graph Traversal", PPoPP
//   2012), so a run is at most kRun warp-wide steps and a hub's edges
//   spread over many warps.  An edge reads its pred and the row's Bp row,
//   walks T' over the bits of X, and ORs the word, masked by ~v[s], into
//   nxt[s].
//
// Three counters rotate with the stamp, as the caller rotates the
// frontier buffers: launch A of stamp n appends to counter n % 3 and
// zeroes counter (n + 1) % 3, the one superstep n + 1 appends to (last
// used by superstep n - 2); B of stamp n reads counter n % 3.  They are
// zero when a BFS starts.  The worklist holds R * tiles entries, which no
// superstep can exceed.  The caller allocates both once per BFS.
//
// Race-free: A writes v and spare and reads g and f; B reads v (which
// holds f once A is done), g and the tables, and ORs into nxt.  OR does
// not depend on order, so the atomics make nxt exact for edges in any
// order.  Before an atomic a thread reads the word from L2; the word only
// gains bits during B, so when it holds the thread's bits already another
// thread put them there (and set the flag), and the atomic is skipped: a
// hub subject's word fills after its first few edges.
//
// What bounds it: bytes.  The work follows the live (row, object) pairs:
// g is read once (4*R*Vg*W), state words cleared and visited (8*R*V*W
// plus the live frontier words), and only the live objects' edges read
// (8 bytes an edge: pred and, where T' is non-zero, subj), with v and nxt
// at each word a transition reaches.  An edge-driven pass gathers
// g[obj] for every edge in every row, R * E random 32-byte L2 sectors
// whether the frontier is live there or not, and padding and tombstoned
// edges (obj = 0) read a hub's words in every row.  OR-ing the words of
// lanes that share a subject before the atomic (__match_any_sync +
// __reduce_or_sync) pays when edges are sorted by subject; here a warp's
// lanes hold edges of a few objects, whose subjects differ, and the
// match measured up to four times the rest of the pass (PERF.md), so
// each thread ORs alone.  Output words are built kChunk at a time, so
// any W >= 1 works; past kChunk the bit walk repeats a chunk.  Measured
// times: PERF.md, the kernel table.
//
// Build (no PyTorch headers, plain C entry points bound with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libpacked_superstep.so packed_superstep.cu

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 8;                 // output words in registers
constexpr int kRun = 8;                   // worklist entries a warp takes
constexpr int kOwnEntries = 4;            // more: the warp writes them
constexpr int kPairs = 4;                 // pairs a thread scans at once
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxDevices = 64;

// Word w of the row, its bits at or above S cleared (w < in_words).
__device__ __forceinline__ uint32_t below_s(uint32_t x, int w, int S) {
  const int live = S - 32 * w;
  return live < 32 ? x & ((1u << live) - 1u) : x;
}

// Exclusive prefix sum of x over the block; the block's sum in `total`.
// `sums` is kWarps + 1 ints of shared memory; the caller syncs before the
// next call reuses it.
__device__ __forceinline__ int block_exclusive_sum(int x, int* sums,
                                                   int& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int inc = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int s = lane < kWarps ? sums[lane] : 0;
    int si = s;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, si, d);
      if (lane >= d) si += y;
    }
    if (lane < kWarps) sums[lane] = si - s;
    if (lane == kWarps - 1) sums[kWarps] = si;
  }
  __syncthreads();
  total = sums[kWarps];
  return sums[warp] + inc - x;
}

// Launch A: the frontier scan, the visit and the spare buffer.  A thread
// takes kPairs (row, object) pairs a kThreads apart each time round, its
// loads issued together; a block whose pairs are all dead skips the
// prefix sum.
__global__ void __launch_bounds__(kThreads)
scan_frontier(const uint32_t* __restrict__ g, const uint32_t* __restrict__ f,
              uint32_t* __restrict__ v, uint32_t* __restrict__ spare,
              const int32_t* __restrict__ flag, int stamp,
              const int32_t* __restrict__ offsets, int2* __restrict__ work,
              int32_t* __restrict__ counters, int64_t capacity, int R, int V,
              int Vg, int S, int W, int tile) {
  // the superstep before found nothing: every frontier is empty
  if (*flag < stamp - 1) return;
  const int slot = stamp % 3;
  if (blockIdx.x == 0 && threadIdx.x == 0) counters[(slot + 1) % 3] = 0;
  __shared__ int sums[kWarps + 1];
  __shared__ int base;
  const int lane = threadIdx.x & 31;
  const int in_words = (S + 31) >> 5;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;

  // (row, object) pairs: i = row * Vg + object, the entry's own id
  const int64_t pairs = static_cast<int64_t>(R) * Vg;
  for (int64_t i0 = static_cast<int64_t>(blockIdx.x) * kThreads * kPairs;
       i0 < pairs; i0 += stride * kPairs) {
    int64_t i[kPairs];
    uint32_t x[kPairs];
#pragma unroll
    for (int q = 0; q < kPairs; ++q) {
      i[q] = i0 + q * kThreads + threadIdx.x;
      x[q] = i[q] < pairs ? below_s(g[i[q] * W], 0, S) : 0u;
    }
    int n[kPairs], lo[kPairs], mine = 0;
#pragma unroll
    for (int q = 0; q < kPairs; ++q) {
      for (int w = 1; w < in_words && !x[q] && i[q] < pairs; ++w)
        x[q] = below_s(g[i[q] * W + w], w, S);
      n[q] = lo[q] = 0;
      if (x[q]) {
        const int o = static_cast<int>(i[q] % Vg);
        lo[q] = offsets[o];
        n[q] = (offsets[o + 1] - lo[q] + tile - 1) / tile;
      }
      mine += n[q];
    }
    if (!__syncthreads_or(mine)) continue;  // the same for the block
    int total = 0;
    int at = block_exclusive_sum(mine, sums, total);
    if (threadIdx.x == 0) base = atomicAdd(counters + slot, total);
    __syncthreads();
    // a BFS never queues past R * tiles; a superstep rerun on its own
    // stamp (a timing loop) may, and drops the excess
#pragma unroll
    for (int q = 0; q < kPairs; ++q) {
      const int64_t room = capacity - base - at;
      const int ro = static_cast<int>(i[q]);
      const bool many = n[q] > kOwnEntries;
      if (!many)
        for (int t = 0; t < n[q] && t < room; ++t)
          work[base + at + t] = make_int2(lo[q] + t * tile, ro);
      // a hub's entries: its warp writes them together
      for (unsigned hubs = __ballot_sync(kFull, many); hubs;
           hubs &= hubs - 1u) {
        const int l = __ffs(hubs) - 1;
        const int nl = __shfl_sync(kFull, n[q], l);
        const int64_t rl = __shfl_sync(kFull, room, l);
        const int64_t to = base + __shfl_sync(kFull, at, l);
        const int lol = __shfl_sync(kFull, lo[q], l);
        const int rol = __shfl_sync(kFull, ro, l);
        for (int t = lane; t < nl && t < rl; t += 32)
          work[to + t] = make_int2(lol + t * tile, rol);
      }
      at += n[q];
    }
    __syncthreads();  // base is rewritten next time round
  }

  // state words: visit the frontier, clear the spare buffer, four words
  // a thread where all three buffers are 16-byte aligned
  const int64_t words = static_cast<int64_t>(R) * V * W;
  const bool aligned = ((reinterpret_cast<uintptr_t>(f) |
                         reinterpret_cast<uintptr_t>(v) |
                         reinterpret_cast<uintptr_t>(spare)) & 15u) == 0;
  int64_t k = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (aligned) {
    const uint4* f4 = reinterpret_cast<const uint4*>(f);
    uint4* v4 = reinterpret_cast<uint4*>(v);
    uint4* spare4 = reinterpret_cast<uint4*>(spare);
    for (; k < words / 4; k += stride) {
      const uint4 fw = f4[k];
      if (fw.x | fw.y | fw.z | fw.w) {
        uint4 vw = v4[k];
        vw.x |= fw.x;
        vw.y |= fw.y;
        vw.z |= fw.z;
        vw.w |= fw.w;
        v4[k] = vw;
      }
      spare4[k] = make_uint4(0u, 0u, 0u, 0u);
    }
    k = words / 4 * 4 + static_cast<int64_t>(blockIdx.x) * kThreads +
        threadIdx.x;
  }
  for (; k < words; k += stride) {
    const uint32_t fw = f[k];
    if (fw) v[k] |= fw;
    spare[k] = 0u;
  }
}

// One edge of (row, object) `ro`: edge e ORs T'[g[ro] & Bp[r][pred[e]]]
// into nxt[r][subj[e]], masked by ~v there.  Sets `hit` when it ORs a
// non-zero word in.
__device__ __forceinline__ void expand_edge(
    int64_t e, int ro, const uint32_t* __restrict__ g, const uint32_t* v,
    uint32_t* nxt, const uint32_t* __restrict__ Bp,
    const uint32_t* __restrict__ bwd, const int32_t* __restrict__ subj,
    const int32_t* __restrict__ pred, int V, int Vg, int L, int S, int W,
    int in_words, bool& hit) {
  const int r = ro / Vg;
  const int p = pred[e];
  if (p < 0 || p >= L) return;  // out of range: selects nothing
  const uint32_t* f_row = g + static_cast<int64_t>(ro) * W;
  const uint32_t* b_row = Bp + (static_cast<int64_t>(r) * L + p) * W;
  const uint32_t* t_rows = bwd + static_cast<int64_t>(r) * S * W;
  int s = -1;  // subject, read once T' is non-zero
  for (int c = 0; c < W; c += kChunk) {
    const int width = min(kChunk, W - c);
    uint32_t y[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) y[k] = 0u;
    for (int w = 0; w < in_words; ++w) {
      uint32_t bits = below_s(f_row[w] & b_row[w], w, S);
      while (bits) {
        const int j = 32 * w + __ffs(bits) - 1;
        bits &= bits - 1u;
        const uint32_t* row = t_rows + static_cast<int64_t>(j) * W + c;
#pragma unroll
        for (int k = 0; k < kChunk; ++k)
          if (k < width) y[k] |= row[k];
      }
    }
    bool any = false;
#pragma unroll
    for (int k = 0; k < kChunk; ++k) any |= y[k] != 0u;
    if (!any) continue;
    if (s == -1) {
      s = subj[e];
      if (s < 0 || s >= V) return;  // out of range: contributes nothing
    }
    const int64_t at = (static_cast<int64_t>(r) * V + s) * W + c;
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      if (k >= width) continue;
      const uint32_t m = y[k] & ~v[at + k];
      if (m & ~__ldcg(nxt + at + k)) {
        atomicOr(nxt + at + k, m);
        hit = true;
      }
    }
  }
}

// Launch B: the worklist's edges, load-balanced within each warp.  A
// warp takes a run of kRun entries (a lane each), an inclusive sum of
// their edge counts by shuffles, and then its lanes take one edge each:
// lane slot j belongs to the last entry whose first slot is at or before
// j, found by a binary search over the lanes' sums (shuffles again).
// Every warp works on its own runs.
__global__ void __launch_bounds__(kThreads)
expand_tiles(const uint32_t* __restrict__ g, const uint32_t* v, uint32_t* nxt,
             int32_t* flag, int stamp, const uint32_t* __restrict__ Bp,
             const uint32_t* __restrict__ bwd,
             const int32_t* __restrict__ offsets,
             const int32_t* __restrict__ subj,
             const int32_t* __restrict__ pred,
             const int2* __restrict__ work,
             const int32_t* __restrict__ counters, int64_t capacity, int V,
             int Vg, int L, int S, int W, int tile) {
  if (*flag < stamp - 1) return;
  const int64_t queued = counters[stamp % 3];
  const int64_t n = queued < capacity ? queued : capacity;
  const int lane = threadIdx.x & 31;
  const int in_words = (S + 31) >> 5;
  bool hit = false;  // this thread ORed a non-zero word into nxt
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t run = (static_cast<int64_t>(blockIdx.x) * kWarps +
                      (threadIdx.x >> 5)) * kRun;
       run < n; run += warps * kRun) {
    const int64_t k = run + lane;
    int count = 0, first = 0, ro = 0;
    if (lane < kRun && k < n) {
      const int2 entry = work[k];
      first = entry.x;
      ro = entry.y;
      count = min(tile, offsets[entry.y % Vg + 1] - first);
    }
    int end = count;  // inclusive sum: the run's slots up to this entry
#pragma unroll
    for (int d = 1; d < kRun; d <<= 1) {
      const int y = __shfl_up_sync(kFull, end, d);
      if (lane >= d) end += y;
    }
    const int start = end - count;
    const int total = __shfl_sync(kFull, end, kRun - 1);
    for (int j0 = 0; j0 < total; j0 += 32) {
      const int j = j0 + lane;
      int at = 0;  // the last entry whose first slot is at or before j
#pragma unroll
      for (int step = kRun / 2; step > 0; step >>= 1) {
        const int cand = at + step;
        if (__shfl_sync(kFull, start, cand) <= j) at = cand;
      }
      const int e = __shfl_sync(kFull, first, at) +
                    (j - __shfl_sync(kFull, start, at));
      const int entry_ro = __shfl_sync(kFull, ro, at);
      if (j < total)
        expand_edge(e, entry_ro, g, v, nxt, Bp, bwd, subj, pred, V, Vg, L,
                    S, W, in_words, hit);
    }
  }
  if (__any_sync(kFull, hit) && lane == 0) *flag = stamp;
}

// Blocks of `kernel` resident on the current device at once, looked up
// once per device and kernel.
int resident_blocks(const void* kernel, int which, int* out) {
  static int cache[kMaxDevices][2];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < kMaxDevices && cache[device][which] > 0) {
    *out = cache[device][which];
    return 0;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  *out = sms * (per_sm > 0 ? per_sm : 1);
  if (device < kMaxDevices) cache[device][which] = *out;
  return 0;
}

int grid(int64_t work, int resident) {
  const int64_t needed = (work + kThreads - 1) / kThreads;
  return static_cast<int>(needed < resident ? needed : resident);
}

}  // namespace

extern "C" {

// Launch A then B on `stream`; returns the first cudaError_t (0 = both
// queued).  All pointers are device pointers to contiguous data: g
// [R, Vg, W] uint32 (f itself, or a buffer no launch writes), f, v, nxt,
// spare [R, V, W] uint32 (nxt zero on entry, four distinct buffers), flag
// one int32, Bp [R, L, W] and bwd [R, S, W] uint32, offsets [Vg + 1] and
// subj, pred [offsets[Vg]] int32 (the grouped edges), work [capacity, 2]
// and counters [3] int32 (the scratch, capacity >= R * tiles).
int packed_superstep_launch(const void* g, const void* f, void* v,
                            void* nxt, void* spare, void* flag, int stamp,
                            const void* Bp, const void* bwd,
                            const void* offsets, const void* subj,
                            const void* pred, void* work, void* counters,
                            long long capacity, int R, int V, int Vg, int L,
                            int S, int W, int tile, void* stream) {
  if (R <= 0 || W <= 0 || tile <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const int64_t pairs = static_cast<int64_t>(R) * Vg;
  const int64_t words = static_cast<int64_t>(R) * V * W;
  const int64_t scan = pairs > words ? pairs : words;
  int resident = 0;
  int err = 0;
  if (scan > 0) {
    err = resident_blocks(reinterpret_cast<const void*>(scan_frontier), 0,
                          &resident);
    if (err) return err;
    scan_frontier<<<grid(scan, resident), kThreads, 0, s>>>(
        static_cast<const uint32_t*>(g), static_cast<const uint32_t*>(f),
        static_cast<uint32_t*>(v), static_cast<uint32_t*>(spare),
        static_cast<const int32_t*>(flag), stamp,
        static_cast<const int32_t*>(offsets), static_cast<int2*>(work),
        static_cast<int32_t*>(counters), capacity, R, V, Vg, S, W, tile);
    err = static_cast<int>(cudaGetLastError());
    if (err) return err;
  }
  if (capacity > 0) {
    err = resident_blocks(reinterpret_cast<const void*>(expand_tiles), 1,
                          &resident);
    if (err) return err;
    expand_tiles<<<grid(capacity, resident), kThreads, 0, s>>>(
        static_cast<const uint32_t*>(g), static_cast<const uint32_t*>(v),
        static_cast<uint32_t*>(nxt), static_cast<int32_t*>(flag), stamp,
        static_cast<const uint32_t*>(Bp), static_cast<const uint32_t*>(bwd),
        static_cast<const int32_t*>(offsets),
        static_cast<const int32_t*>(subj), static_cast<const int32_t*>(pred),
        static_cast<const int2*>(work),
        static_cast<const int32_t*>(counters), capacity, V, Vg, L, S, W,
        tile);
    err = static_cast<int>(cudaGetLastError());
  }
  return err;
}

}  // extern "C"
