// Segment OR of packed rows, and the segmented OR-scan, for Hopper
// (sm_90a).
//
// Replaces repro/kernels/segment_or.py::segmented_or_scan, the TPU kernel,
// together with the carry stitch and last-row pick around it in
// repro/kernels/ops.py::segment_or.  Two entry points:
//
// segment_or_launch: out[v] = OR of vals[e] with seg[e] == v, over uint32
// words vals [E, W] -> out [V, W].  The TPU has no atomic scatter, so the
// JAX package computes this as a segmented scan over edges sorted by
// segment, then picks each segment's last row.  Here it is a scatter: one
// thread per word, atomicOr into the output, which the caller zeroes.  OR
// does not depend on order, so the result is exact and any order of seg
// works (sorted ids only make the warp-level OR below pay).  A zero word
// ORs nothing in and is skipped, and its segment id is never read: on the
// packed BFS path (Y = T'[f[obj] & B[pred]]) almost every word is zero.
// Ids outside [0, V) contribute nothing.
//
// segmented_or_scan_launch: the inclusive segmented OR-scan over the whole
// array, off the BFS path (the JAX package's tests hold its first tile).
// Row e of column w is the OR of rows s..e, s being the last row at or
// before e whose flag is nonzero.  Three passes: (1) each block scans one
// tile of kTile rows per column (warp shuffles, then the warps' totals),
// and records the tile's last value and its first flagged row; (2) one
// block scans those tile summaries in order, giving each tile the value
// carried into it; (3) rows before the first flag of their tile OR in
// their tile's carry.
//
// What bounds them: bytes.  segment_or must read the values (4*E*W bytes)
// and the id of each row with a non-zero word (at most 4*E) and write the
// output (4*V*W); at E = 3,954,840, V = 200,000 and W = 1 that is about
// 17 MB with 5% of the words non-zero, as on the packed BFS path (5 us at
// 3.35 TB/s), and about 32 MB with every word non-zero (10 us).  Many atomics on one word (a hub subject of
// a scale-free graph) serialise in L2: one atomic per non-zero word ran
// 52x over the bound on dense values with hub-law ids (PERF.md),
// so lanes that share an output word OR together before the atomic.
// The scan moves 2*4*E*W + 4*E bytes plus its small tile summaries.
//
// Build (no PyTorch headers, plain C entry points bound with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libsegment_or.so segment_or.cu

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kScatterThreads = 256;
constexpr int kTile = 1024;  // rows per scan block, one per thread
constexpr int kWarps = kTile / 32;
constexpr unsigned kFull = 0xFFFFFFFFu;

// One thread per word.  The lanes of a warp that hold non-zero words for
// the same output word OR them together first (__match_any_sync groups
// them, __reduce_or_sync combines), and one lane of each group issues
// the atomic: rows sorted by segment put a hub's rows side by side, so a
// warp sends one or two atomics to a hub word instead of 32.  A warp with
// one non-zero word, the common case on sparse values, skips the match.
__global__ void __launch_bounds__(kScatterThreads)
segment_or_kernel(const uint32_t* __restrict__ vals,
                  const int32_t* __restrict__ seg, uint32_t* __restrict__ out,
                  int64_t total, int W, int V) {
  const int64_t idx =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const uint32_t v = idx < total ? vals[idx] : 0u;
  const unsigned nonzero = __ballot_sync(kFull, v != 0u);
  if (nonzero == 0u) return;  // the whole warp
  long long target = -1;  // output word, or -1: nothing to OR in
  if (v != 0u) {
    const int64_t e = idx / W;
    const int s = seg[e];
    if (s >= 0 && s < V) target = static_cast<int64_t>(s) * W + (idx - e * W);
  }
  if (__popc(nonzero) == 1) {  // the same for every lane of the warp
    if (target >= 0) atomicOr(out + target, v);
    return;
  }
  const unsigned peers = __match_any_sync(kFull, target);
  const uint32_t r = __reduce_or_sync(peers, target >= 0 ? v : 0u);
  if (target >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1)
    atomicOr(out + target, r);
}

// Inclusive segmented OR-scan of (flag, value) over the kTile threads of
// a block; row order = thread order.  The operator, left a, right b:
// (a.f | b.f, b.f ? b.v : a.v | b.v).  Returns the scanned pair in
// place.  `wf`/`wv` are kWarps-entry shared arrays.
__device__ void block_seg_scan(int& f, uint32_t& v, int* wf, uint32_t* wv) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t pv = __shfl_up_sync(kFull, v, d);
    const int pf = __shfl_up_sync(kFull, f, d);
    if (lane >= d) {
      if (!f) v |= pv;
      f |= pf;
    }
  }
  if (lane == 31) {
    wf[warp] = f;
    wv[warp] = v;
  }
  __syncthreads();
  if (warp == 0) {  // scan the warps' totals
    int tf = wf[lane];
    uint32_t tv = wv[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t pv = __shfl_up_sync(kFull, tv, d);
      const int pf = __shfl_up_sync(kFull, tf, d);
      if (lane >= d) {
        if (!tf) tv |= pv;
        tf |= pf;
      }
    }
    wf[lane] = tf;
    wv[lane] = tv;
  }
  __syncthreads();
  if (warp > 0) {  // the prefix of the warps before this one, on the left
    if (!f) v |= wv[warp - 1];
    f |= wf[warp - 1];
  }
  __syncthreads();  // wf/wv are reused by the next call
}

// Pass 1: tile-local scan.  Block b scans rows [b*kTile, b*kTile + n) of
// every column, writes them to out, the last row's value to
// last[b*W + w] and the tile's first flagged row (kTile if none) to
// first[b].
__global__ void __launch_bounds__(kTile)
scan_tiles_kernel(const uint32_t* __restrict__ vals,
                  const int32_t* __restrict__ flags,
                  uint32_t* __restrict__ out, uint32_t* __restrict__ last,
                  int32_t* __restrict__ first, int64_t E, int W) {
  __shared__ int wf[kWarps];
  __shared__ uint32_t wv[kWarps];
  __shared__ int first_flag;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t rest = E - row0;
  const int n = rest < kTile ? static_cast<int>(rest) : kTile;
  const int t = threadIdx.x;
  const bool live = t < n;
  // padding rows start segments of their own, so nothing flows past them
  const int flag = live ? (flags[row0 + t] != 0) : 1;
  if (t == 0) first_flag = kTile;
  __syncthreads();
  if (live && flag) atomicMin(&first_flag, t);
  for (int w = 0; w < W; ++w) {
    int f = flag;
    uint32_t v = live ? vals[(row0 + t) * W + w] : 0u;
    block_seg_scan(f, v, wf, wv);
    if (live) out[(row0 + t) * W + w] = v;
    if (t == n - 1) last[static_cast<int64_t>(blockIdx.x) * W + w] = v;
  }
  if (t == 0) first[blockIdx.x] = first_flag;
}

// Pass 2, one block: carry[b*W + w] = the scan's value entering tile b.
// Tile b's summary is (first[b] < kTile, last[b*W + w]); the
// tiles are scanned in chunks of kTile, in order, with a running carry.
__global__ void __launch_bounds__(kTile)
scan_carries_kernel(const uint32_t* __restrict__ last,
                    const int32_t* __restrict__ first,
                    uint32_t* __restrict__ carry, int tiles, int W) {
  __shared__ int wf[kWarps];
  __shared__ uint32_t wv[kWarps];
  __shared__ int sf[kTile];
  __shared__ uint32_t sv[kTile];
  const int t = threadIdx.x;
  for (int w = 0; w < W; ++w) {
    uint32_t running = 0u;
    for (int c = 0; c < tiles; c += kTile) {
      const int b = c + t;
      int f = 1;
      uint32_t v = 0u;
      if (b < tiles) {
        f = first[b] < kTile;  // counts live rows only
        v = last[static_cast<int64_t>(b) * W + w];
      }
      block_seg_scan(f, v, wf, wv);
      sf[t] = f;
      sv[t] = v;
      __syncthreads();
      if (b < tiles) {
        uint32_t in = running;  // value entering tile b
        if (t > 0) in = sf[t - 1] ? sv[t - 1] : (running | sv[t - 1]);
        carry[static_cast<int64_t>(b) * W + w] = in;
      }
      const int end = min(kTile, tiles - c) - 1;
      running = sf[end] ? sv[end] : (running | sv[end]);
      __syncthreads();
    }
  }
}

// Pass 3: rows before their tile's first flag OR in the tile's carry.
__global__ void __launch_bounds__(kScatterThreads)
scan_fixup_kernel(uint32_t* __restrict__ out,
                  const uint32_t* __restrict__ carry,
                  const int32_t* __restrict__ first, int64_t total, int W) {
  const int64_t idx =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int64_t e = idx / W;
  const int64_t b = e / kTile;
  if (b == 0 || e - b * kTile >= first[b]) return;
  out[idx] |= carry[b * W + (idx - e * W)];
}

dim3 grid_for(int64_t total, int threads) {
  return dim3(static_cast<unsigned>((total + threads - 1) / threads));
}

}  // namespace

extern "C" {

// Launch on `stream`; each returns the cudaError_t of its launches
// (0 = queued).  All pointers are device pointers to contiguous data.

// vals [E, W] uint32, seg [E] int32, out [V, W] uint32 zeroed by the
// caller.
int segment_or_launch(const void* vals, const void* seg, void* out,
                      long long E, int W, int V, void* stream) {
  const int64_t total = static_cast<int64_t>(E) * W;
  if (total <= 0 || V <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  segment_or_kernel<<<grid_for(total, kScatterThreads), kScatterThreads, 0,
                      st>>>(static_cast<const uint32_t*>(vals),
                            static_cast<const int32_t*>(seg),
                            static_cast<uint32_t*>(out), total, W, V);
  return static_cast<int>(cudaGetLastError());
}

// Rows per tile of the scan, for the caller's scratch: `last` and `carry`
// hold tiles*W words each and `first` tiles ints, tiles = ceil(E / this).
int segmented_or_scan_tile_rows() { return kTile; }

// vals [E, W] uint32, flags [E] int32 -> out [E, W] uint32.
int segmented_or_scan_launch(const void* vals, const void* flags, void* out,
                             void* last, void* first, void* carry,
                             long long E, int W, void* stream) {
  if (E <= 0 || W <= 0) return 0;
  const int64_t tiles64 = (E + kTile - 1) / kTile;
  if (tiles64 > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = static_cast<int>(tiles64);
  auto st = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<uint32_t*>(out);
  auto* l = static_cast<uint32_t*>(last);
  auto* f = static_cast<int32_t*>(first);
  auto* c = static_cast<uint32_t*>(carry);
  scan_tiles_kernel<<<tiles, kTile, 0, st>>>(
      static_cast<const uint32_t*>(vals), static_cast<const int32_t*>(flags),
      o, l, f, E, W);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || tiles == 1) return static_cast<int>(err);
  scan_carries_kernel<<<1, kTile, 0, st>>>(l, f, c, tiles, W);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t total = static_cast<int64_t>(E) * W;
  scan_fixup_kernel<<<grid_for(total, kScatterThreads), kScatterThreads, 0,
                      st>>>(o, c, f, total, W);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
