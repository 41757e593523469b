// Segment OR of packed rows, and the segmented OR-scan, for Hopper
// (sm_90a).
//
// Replaces repro/kernels/segment_or.py::segmented_or_scan, the TPU kernel,
// together with the carry stitch and last-row pick around it in
// repro/kernels/ops.py::segment_or.  Two entry points, one layout: a tile
// is kTileRows = 4,096 rows, a thread's part of it kRows = 16 consecutive
// rows, and the W columns are walked one after another, each (tile,
// column) an item.  The blocks stay resident (as many as the SMs hold)
// and each stages its next item into shared memory with asynchronous
// copies while it works on the current one, so no register holds bytes in
// flight and the loads of one item run under the work on another.  At
// W = 1 the copies are 16-byte chunks, each thread's beside the last
// one's; a ragged last tile, a base address that is not 16-byte aligned,
// or W > 1 (a column's words are W apart) copies a word a thread, 32
// consecutive rows a warp, in the same kernel.  In shared memory a
// tile's 16-byte chunks are swizzled, so that a thread reading its four
// chunks meets no bank twice in a quarter warp.
//
// segment_or_launch: out[v] = OR of vals[e] with seg[e] == v, over uint32
// words vals [E, W] -> out [V, W], which the caller zeroes.  The TPU has
// no atomic scatter, so the JAX package computes this as a segmented scan
// over edges sorted by segment, then picks each segment's last row.  Here
// it is an atomicOr scatter that sends one atomic per run of equal
// (id, column) keys in a tile: a thread ORs its own rows' runs in
// registers, reading the id of a row only where its word is non-zero (a
// zero word ORs nothing in; ids outside [0, V) contribute nothing); a
// segmented shuffle scan over the warp joins the runs that cross thread
// boundaries, and the runs that cross warp boundaries meet in shared
// memory, where warp 0 joins them the same way.  A run that ends inside
// the tile is sent by the lane where it ends.  OR does not depend on
// order, so any order of ids is exact: unsorted ids only make runs
// shorter, at most one atomic per non-zero word.  Sorted ids (the JAX
// package's contract, and Edges.subj on the packed path) put a hub's rows
// side by side, and the hub's word then takes one atomic per tile it
// touches, not one per warp.  Blocks take tiles blockIdx.x, + gridDim.x,
// ... (no block waits on another).
//
// segmented_or_scan_launch: the inclusive segmented OR-scan over the whole
// array, off the BFS path (the JAX package's tests hold its first tile).
// Row e of column w is the OR of rows s..e, s being the last row at or
// before e whose flag is nonzero (row 0 starts a segment whatever its
// flag).  One launch, one pass, by decoupled look-back.  Blocks take tiles
// in the order of an atomic ticket, so every earlier tile belongs to a
// block that is already running.  As soon as an item's rows are staged, a
// thread ORs its rows' runs in registers, a warp-shuffle scan of the
// threads' (flag, value) pairs and one combine over the block's warps
// give the tile's aggregate, and the block publishes it in the item's
// descriptor, one 64-bit word: (seq << 33) | (inclusive << 32) | value.
// A tile that holds a flag knows its inclusive value from its own rows and
// publishes it as inclusive at once, so look-backs walk back only across
// tiles without a flag.  Then the block starts staging its next item
// (taking the next ticket first) and only then looks back: one warp reads
// its predecessors' words, 32 at a time, waits only for those up to the
// nearest inclusive one, ORs them and publishes the tile's inclusive
// value (it skips all this when the tile's first row is flagged).  The
// rows are written back from shared memory as they were staged.  The
// sequence number in each word spares every launch a clear of the
// descriptors; the last ticket of a launch resets the ticket counter.
// Every word is read once and written once.
//
// What bounds them: bytes.  segment_or must read the values (4*E*W bytes)
// and the id of each row with a non-zero word (at most 4*E) and write the
// output (4*V*W); at E = 3,954,840, V = 200,000 and W = 1 that is about
// 18 MB with 8.5% of the words non-zero, as on the packed BFS path's
// heaviest superstep (5.4 us at 3.35 TB/s), though the ids come in whole
// 32-byte sectors, about half of them there.  Many atomics on one word (a
// hub subject of a scale-free graph) serialise in L2, hence one atomic a
// run.  The scan moves 2*4*E*W + 4*E bytes; its descriptors add 8 bytes a
// tile and column.  Both pay a launch floor of a few microseconds (the
// persistent grid, the tickets, the staging barrier).
//
// Build (no PyTorch headers, plain C entry points bound with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libsegment_or.so segment_or.cu

#include <cstddef>
#include <cstdint>

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;                      // consecutive rows a thread
constexpr int kTileRows = kThreads * kRows;    // 4,096 rows a block
constexpr unsigned kFull = 0xFFFFFFFFu;
// a descriptor word: (seq << 33) | (inclusive << 32) | value
constexpr unsigned long long kInclusive = 1ull << 32;

// A thread's or a warp's runs of equal keys (output word indices), in row
// order: n = 0 none, 1 one run (head = tail), 2 a head run and a tail run
// that differ; the runs between them are already sent.
struct Runs {
  long long hk, tk;
  uint32_t hv, tv;
  int n;
};

__device__ __forceinline__ void add_word(Runs& r, long long key, uint32_t w,
                                         uint32_t* __restrict__ out) {
  if (r.n && key == r.tk) {
    r.tv |= w;
    return;
  }
  if (r.n == 1) {           // the first run becomes the head
    r.hk = r.tk;
    r.hv = r.tv;
  } else if (r.n == 2) {    // a run between head and tail: complete
    atomicOr(out + r.tk, r.tv);
  }
  r.tk = key;
  r.tv = w;
  r.n = r.n ? 2 : 1;
}

// The 32 lanes' Runs, in lane order, joined where a lane's head continues
// the tail of the nearest lane before it that has runs.  Each run that
// ends here is sent with one atomicOr by the lane where it ends; with
// `ends`, the run that holds the warp's first head and the one that holds
// its last tail are written there instead (as the warp's own Runs) for the
// block to join.  A segmented scan over the lanes: a pair is (start, value)
// with a third bit, set where the run holds the warp's first head.
__device__ void join_runs(const Runs& r, uint32_t* __restrict__ out,
                          Runs* ends) {
  const int lane = threadIdx.x & 31;
  const unsigned live = __ballot_sync(kFull, r.n > 0);
  if (live == 0) {
    if (ends != nullptr && lane == 0) ends->n = 0;
    return;
  }
  const unsigned below = live & ((1u << lane) - 1u);
  const unsigned above = live & ~((2u << lane) - 1u);
  const int prev = below ? 31 - __clz(below) : lane;
  const int next = above ? __ffs(above) - 1 : lane;
  const long long prev_tk = __shfl_sync(kFull, r.tk, prev);
  const long long next_hk = __shfl_sync(kFull, r.hk, next);
  const bool first = r.n > 0 && below == 0u;
  const bool cont = r.n > 0 && below != 0u && r.hk == prev_tk;
  // the lane's tail run, joined to the runs before it
  int f = r.n > 0 && !(r.n == 1 && cont);
  uint32_t v = r.n > 0 ? r.tv : 0u;
  int h = r.n == 1 && first;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t pv = __shfl_up_sync(kFull, v, d);
    const int pf = __shfl_up_sync(kFull, f, d);
    const int ph = __shfl_up_sync(kFull, h, d);
    if (lane >= d) {
      if (!f) {
        v |= pv;
        h |= ph;
      }
      f |= pf;
    }
  }
  const uint32_t ev = __shfl_sync(kFull, v, prev);
  const int eh = __shfl_sync(kFull, h, prev);
  if (r.n == 2) {           // the head run ends at this lane
    const uint32_t hv = r.hv | (cont ? ev : 0u);
    if (ends != nullptr && (cont ? eh : first)) {
      ends->hk = r.hk;
      ends->hv = hv;
    } else {
      atomicOr(out + r.hk, hv);
    }
  }
  if (r.n > 0 && !(above != 0u && next_hk == r.tk)) {  // the tail run ends
    if (ends != nullptr && above == 0u) {
      ends->tk = r.tk;
      ends->tv = v;
      ends->n = h ? 1 : 2;
      if (h) {
        ends->hk = r.tk;
        ends->hv = v;
      }
    } else if (ends != nullptr && h) {
      ends->hk = r.tk;
      ends->hv = v;
    } else {
      atomicOr(out + r.tk, v);
    }
  }
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Where row r of a tile lies in shared memory: its 16-byte chunk r / 4
// with the chunk's bits 2-4 XORed into bits 0-2, so that the four chunks
// of a thread's kRows rows, read as 16-byte vectors, meet no bank twice
// in a quarter warp (and 32 rows written by a warp stay in one 128-byte
// line).
__device__ __forceinline__ int slot(int r) {
  const int c = r >> 2;
  return ((c ^ ((c >> 2) & 7)) << 2) | (r & 3);
}

// Start copying column c of the tile's kTileRows rows from row t0 into
// shared memory s (rows at or past E read 0), asynchronously: no register
// holds the bytes in flight, and the block works on its current tile
// meanwhile.  `vec`: W == 1, the whole tile inside the array and vals
// 16-byte aligned; the block's threads copy 16-byte chunks, each a
// neighbour of the last.  Otherwise a word a thread at a time, 32
// consecutive rows a warp.
__device__ __forceinline__ void stage_column(uint32_t* s,
                                             const uint32_t* __restrict__ vals,
                                             int64_t t0, int64_t E, int W,
                                             int c, bool vec) {
  if (vec) {
#pragma unroll
    for (int i = 0; i < kRows / 4; ++i) {
      const int r = 4 * (i * kThreads + static_cast<int>(threadIdx.x));
      __pipeline_memcpy_async(s + slot(r), vals + t0 + r, 16);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = i * kThreads + static_cast<int>(threadIdx.x);
      const bool in = t0 + r < E;   // else 4 bytes of zeros, nothing read
      __pipeline_memcpy_async(s + slot(r),
                              in ? vals + (t0 + r) * W + c : vals, 4,
                              in ? 0 : 4);
    }
  }
}

// Rows 4q..4q+3 of this thread's kRows rows, from a staged column.
__device__ __forceinline__ uint4 staged_rows(const uint32_t* s, int q) {
  return *reinterpret_cast<const uint4*>(
      s + slot(static_cast<int>(threadIdx.x) * kRows + 4 * q));
}

__device__ __forceinline__ uint32_t part(const uint4& x, int k) {
  return k == 0 ? x.x : k == 1 ? x.y : k == 2 ? x.z : x.w;
}

// The blocks stay resident and walk over the (tile, column) items, tile =
// blockIdx.x, then + gridDim.x, ...; each stages its next item while it
// scatters the current one.
__global__ void __launch_bounds__(kThreads)
segment_or_kernel(const uint32_t* __restrict__ vals,
                  const int32_t* __restrict__ seg, uint32_t* __restrict__ out,
                  int64_t E, int W, int V) {
  __shared__ __align__(16) uint32_t s_col[2][kTileRows];
  __shared__ Runs s_warp[kWarps];
  const int warp = threadIdx.x >> 5;
  const int64_t ntiles = (E + kTileRows - 1) / kTileRows;
  const bool aligned = aligned16(vals) && aligned16(seg);
  int64_t tile = blockIdx.x;
  int c = 0, buf = 0;
  if (tile >= ntiles) return;
  stage_column(s_col[0], vals, tile * kTileRows, E, W, 0,
               W == 1 && (tile + 1) * kTileRows <= E && aligned);
  __pipeline_commit();
  for (;;) {
    const int64_t t0 = tile * kTileRows;
    const bool vec = W == 1 && t0 + kTileRows <= E && aligned;
    const int64_t ntile = c + 1 < W ? tile : tile + gridDim.x;
    const int nc = c + 1 < W ? c + 1 : 0;
    const bool more = ntile < ntiles;
    if (more) {
      stage_column(s_col[buf ^ 1], vals, ntile * kTileRows, E, W, nc,
                   W == 1 && (ntile + 1) * kTileRows <= E && aligned);
      __pipeline_commit();
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    const int64_t r0 = t0 + static_cast<int64_t>(threadIdx.x) * kRows;
    Runs r{-1, -1, 0u, 0u, 0};
#pragma unroll
    for (int q = 0; q < kRows / 4; ++q) {
      const uint4 x = staged_rows(s_col[buf], q);
      if ((x.x | x.y | x.z | x.w) == 0u) continue;
      int id[4];
      if (vec) {
        const int4 g = __ldg(reinterpret_cast<const int4*>(seg + r0) + q);
        id[0] = g.x;
        id[1] = g.y;
        id[2] = g.z;
        id[3] = g.w;
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          id[k] = part(x, k) != 0u ? seg[r0 + 4 * q + k] : -1;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t w = part(x, k);
        if (w != 0u && id[k] >= 0 && id[k] < V)
          add_word(r, static_cast<long long>(id[k]) * W + c, w, out);
      }
    }
    if (r.n == 1) {
      r.hk = r.tk;
      r.hv = r.tv;
    }
    join_runs(r, out, &s_warp[warp]);
    __syncthreads();
    if (warp == 0) {
      Runs b{-1, -1, 0u, 0u, 0};
      if (threadIdx.x < kWarps) b = s_warp[threadIdx.x];
      join_runs(b, out, nullptr);
    }
    __syncthreads();        // s_col[buf] and s_warp are free again
    if (!more) break;
    tile = ntile;
    c = nc;
    buf ^= 1;
  }
}

// The segmented OR of (left, right) pairs, in place in (f, v): the right
// operand's value if it starts a segment, else the OR of both.
__device__ __forceinline__ void seg_or(int& f, uint32_t& v, int lf,
                                       uint32_t lv) {
  if (!f) v |= lv;
  f |= lf;
}

__device__ __forceinline__ void warp_seg_scan(int& f, uint32_t& v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t pv = __shfl_up_sync(kFull, v, d);
    const int pf = __shfl_up_sync(kFull, f, d);
    if (lane >= d) seg_or(f, v, pf, pv);
  }
}

// A ticket: the next tile in scan order, or ntiles when none is left.
// Every block takes tickets until it gets one past the last tile, so a
// launch takes ntiles + gridDim.x of them; the one that takes the last
// resets the counter for the next launch.
__device__ __forceinline__ int take_ticket(unsigned* ticket, int ntiles) {
  const unsigned t = atomicAdd(ticket, 1u);
  if (t == static_cast<unsigned>(ntiles) + gridDim.x - 1u)
    atomicExch(ticket, 0u);
  return t < static_cast<unsigned>(ntiles) ? static_cast<int>(t) : ntiles;
}

// Shared memory of the scan: two buffers of a column's values and one of
// the flags (a tile's flags are read into registers before the next
// tile's are staged), kTileRows words each.
constexpr int kScanSmem = 3 * kTileRows * 4;

// What a block keeps of a scanned (tile, column) item between publishing
// its aggregate and writing its rows: in registers, a thread's flags and
// the (flag, value) of the rows before its own in its warp; in shared
// memory (one set a buffer), the warps' and the tile's.
struct ScanItem {
  int tile, c;
  unsigned fm;       // bit k: row k of the thread's rows starts a segment
  bool look_back;    // the tile's rows before its first flag need the
                     // value of the tiles before it
  int ef;
  uint32_t ea;
};

struct ScanShared {
  int wf[kWarps];        // the (flag, value) of the warps before each warp
  uint32_t wv[kWarps];
  int agg_f;             // the tile's own aggregate
  uint32_t agg;
  uint32_t prefix;       // the value of the tiles before it
};

// The blocks stay resident.  Each takes a tile by ticket, stages it, and
// publishes its aggregate as soon as its rows are in shared memory; then
// it takes and starts staging the next item before it looks back and
// writes the rows of the current one, so that the loads of one tile run
// under the look-back and the stores of another, and no tile waits
// unpublished behind another's look-back.  Four blocks an SM (their
// shared memory allows no more).
__global__ void __launch_bounds__(kThreads, 4)
segmented_or_scan_kernel(const uint32_t* __restrict__ vals,
                         const int32_t* __restrict__ flags,
                         uint32_t* __restrict__ out, int64_t E, int W,
                         unsigned long long* __restrict__ desc,
                         unsigned* __restrict__ ticket, int ntiles,
                         unsigned seq) {
  extern __shared__ __align__(16) uint32_t s_mem[];
  __shared__ int s_next;
  __shared__ ScanShared s_sh[2];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool aligned = aligned16(vals) && aligned16(out);
  const bool flags_aligned = aligned16(flags);
  volatile unsigned long long* vd = desc;
  const unsigned long long stamp = static_cast<unsigned long long>(seq) << 33;
  auto val_buf = [&](int b) { return s_mem + b * kTileRows; };
  uint32_t* const s_flags = s_mem + 2 * kTileRows;
  auto whole = [&](int t) {
    return static_cast<int64_t>(t + 1) * kTileRows <= E;
  };
  auto stage = [&](int t, int col, int b) {
    const int64_t t0 = static_cast<int64_t>(t) * kTileRows;
    stage_column(val_buf(b), vals, t0, E, W, col,
                 W == 1 && whole(t) && aligned);
    if (col == 0)
      stage_column(s_flags, reinterpret_cast<const uint32_t*>(flags), t0, E,
                   1, 0, whole(t) && flags_aligned);
    __pipeline_commit();
  };
  // The item's aggregate from its staged rows, published at once; thread
  // 0 also takes the ticket of the tile after it when the next item
  // starts a new tile (asked for first, so that the atomic's round trip
  // runs under the scan).  Ends with a barrier.
  auto aggregate = [&](ScanItem& it, int b) {
    const int next = threadIdx.x == 0 && it.c + 1 == W
                         ? take_ticket(ticket, ntiles) : -1;
    const int64_t r0 = static_cast<int64_t>(it.tile) * kTileRows +
                       static_cast<int64_t>(threadIdx.x) * kRows;
    if (it.c == 0) {
      it.fm = 0u;
#pragma unroll
      for (int q = 0; q < kRows / 4; ++q) {
        const uint4 x = staged_rows(s_flags, q);
        it.fm |= ((x.x != 0u) | (x.y != 0u) << 1 | (x.z != 0u) << 2 |
                  (x.w != 0u) << 3) << (4 * q);
      }
      if (r0 == 0) it.fm |= 1u;
      it.look_back = it.tile > 0 && s_flags[slot(0)] == 0u;
    }
    int f = it.fm != 0u;
    uint32_t a = 0u;
#pragma unroll
    for (int q = 0; q < kRows / 4; ++q) {
      const uint4 x = staged_rows(val_buf(b), q);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        a = (it.fm >> (4 * q + k) & 1u) ? part(x, k) : a | part(x, k);
    }
    warp_seg_scan(f, a, lane);
    it.ef = __shfl_up_sync(kFull, f, 1);          // the lanes before
    it.ea = __shfl_up_sync(kFull, a, 1);
    if (lane == 0) {
      it.ef = 0;
      it.ea = 0u;
    }
    ScanShared& sh = s_sh[b];
    if (lane == 31) {
      sh.wf[warp] = f;
      sh.wv[warp] = a;
    }
    __syncthreads();
    if (warp == 0) {
      int tf = lane < kWarps ? sh.wf[lane] : 0;
      uint32_t tv = lane < kWarps ? sh.wv[lane] : 0u;
      warp_seg_scan(tf, tv, lane);
      const int xf = __shfl_up_sync(kFull, tf, 1);   // the warps before
      const uint32_t xv = __shfl_up_sync(kFull, tv, 1);
      if (lane < kWarps) {
        sh.wf[lane] = lane ? xf : 0;
        sh.wv[lane] = lane ? xv : 0u;
      }
      if (lane == kWarps - 1) {
        sh.agg_f = tf;
        sh.agg = tv;
        vd[static_cast<int64_t>(it.tile) * W + it.c] =
            stamp | (tf ? kInclusive : 0ull) | tv;
      }
      if (next >= 0) s_next = next;
    }
    __syncthreads();
  };
  // The look-back for the item, then its rows written.  Warp 0 walks back
  // over the descriptors of this column, 32 tiles at a time, to the
  // nearest one with its inclusive value, ORs what it passed and
  // publishes this tile's inclusive value.
  auto finish = [&](const ScanItem& it, int b) {
    ScanShared& sh = s_sh[b];
    if (warp == 0) {
      uint32_t pre = 0u;
      if (it.look_back) {
        for (int top = it.tile - 1;; top -= 32) {
          const int j = top - lane;
          unsigned long long d;
          unsigned incl;
          for (;;) {   // until the tiles up to the nearest inclusive one
            d = j >= 0 ? vd[static_cast<int64_t>(j) * W + it.c]
                       : stamp | kInclusive;       // before tile 0: 0
            const bool now = (d >> 33) == seq;
            const unsigned ready = __ballot_sync(kFull, now);
            incl = __ballot_sync(kFull, now && (d & kInclusive) != 0);
            const unsigned need = incl ? (2u << (__ffs(incl) - 1)) - 1u
                                       : kFull;
            if ((ready & need) == need) break;
          }
          const int stop = incl ? __ffs(incl) - 1 : 31;
          pre |= __reduce_or_sync(
              kFull, lane <= stop ? static_cast<uint32_t>(d) : 0u);
          if (incl) break;
        }
      }
      if (lane == 0) {
        if (!sh.agg_f)
          vd[static_cast<int64_t>(it.tile) * W + it.c] =
              stamp | kInclusive | (pre | sh.agg);
        sh.prefix = pre;
      }
    }
    __syncthreads();
    const int64_t r0 = static_cast<int64_t>(it.tile) * kTileRows +
                       static_cast<int64_t>(threadIdx.x) * kRows;
    // the value carried into this thread's first row
    uint32_t acc = it.ef ? it.ea
                         : (sh.wf[warp] ? sh.wv[warp] | it.ea
                                        : sh.prefix | sh.wv[warp] | it.ea);
    uint32_t* rows = val_buf(b);
#pragma unroll
    for (int q = 0; q < kRows / 4; ++q) {   // the rows, in place
      const uint4 x = staged_rows(rows, q);
      uint32_t o[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        acc = (it.fm >> (4 * q + k) & 1u) ? part(x, k) : acc | part(x, k);
        o[k] = acc;
      }
      *reinterpret_cast<uint4*>(
          rows + slot(static_cast<int>(threadIdx.x) * kRows + 4 * q)) =
          make_uint4(o[0], o[1], o[2], o[3]);
    }
    __syncthreads();
    // written back as they were staged: each thread's chunk beside the
    // last one's
    const int64_t t0 = static_cast<int64_t>(it.tile) * kTileRows;
    if (W == 1 && whole(it.tile) && aligned) {
#pragma unroll
      for (int i = 0; i < kRows / 4; ++i) {
        const int r = 4 * (i * kThreads + static_cast<int>(threadIdx.x));
        *reinterpret_cast<uint4*>(out + t0 + r) =
            *reinterpret_cast<const uint4*>(rows + slot(r));
      }
    } else {
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = i * kThreads + static_cast<int>(threadIdx.x);
        if (t0 + r < E) out[(t0 + r) * W + it.c] = rows[slot(r)];
      }
    }
  };

  if (threadIdx.x == 0) s_next = take_ticket(ticket, ntiles);
  __syncthreads();
  ScanItem cur{s_next, 0, 0u, false, 0, 0u};
  if (cur.tile >= ntiles) return;
  int buf = 0;
  stage(cur.tile, 0, 0);
  __pipeline_wait_prior(0);
  __syncthreads();
  aggregate(cur, 0);
  for (;;) {
    ScanItem nxt = cur;
    if (cur.c + 1 < W) {
      nxt.c = cur.c + 1;
    } else {
      nxt.tile = s_next;
      nxt.c = 0;
    }
    const bool more = nxt.tile < ntiles;
    if (more) stage(nxt.tile, nxt.c, buf ^ 1);
    finish(cur, buf);
    if (!more) break;
    __pipeline_wait_prior(0);
    __syncthreads();
    buf ^= 1;
    cur = nxt;
    aggregate(cur, buf);
  }
}

int64_t tiles_for(long long E) { return (E + kTileRows - 1) / kTileRows; }

// The grid of a kernel whose blocks stay resident: the blocks one SM holds
// at once (with `smem` bytes of dynamic shared memory each, which the
// kernel is first allowed), times the SMs; found once a device.  `which`
// names the kernel's cache entry.  0 if a query failed.
int resident_blocks(int which, const void* kernel, int smem) {
  static int cache[2][64];
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < 64 && cache[which][dev] > 0) return cache[which][dev];
  if ((smem > 0 &&
       cudaFuncSetAttribute(kernel,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            smem) != cudaSuccess) ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                    smem) != cudaSuccess)
    return 0;
  if (dev < 64) cache[which][dev] = sms * per_sm;
  return sms * per_sm;
}

}  // namespace

extern "C" {

// Launch on `stream`; each returns the cudaError_t of its launch (0 =
// queued).  All pointers are device pointers to contiguous data.

// vals [E, W] uint32, seg [E] int32, out [V, W] uint32 zeroed by the
// caller.
int segment_or_launch(const void* vals, const void* seg, void* out,
                      long long E, int W, int V, void* stream) {
  if (E <= 0 || W <= 0 || V <= 0) return 0;
  const int blocks = resident_blocks(
      0, reinterpret_cast<const void*>(segment_or_kernel), 0);
  if (blocks <= 0) return static_cast<int>(cudaGetLastError());
  const int64_t grid = tiles_for(E) < blocks ? tiles_for(E) : blocks;
  segment_or_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(vals), static_cast<const int32_t*>(seg),
      static_cast<uint32_t*>(out), E, W, V);
  return static_cast<int>(cudaGetLastError());
}

// The scratch words (uint64) the scan of E rows of W words needs: one for
// the ticket counter, one for each tile and column's descriptor.
long long segmented_or_scan_scratch_words(long long E, int W) {
  return 1 + tiles_for(E) * W;
}

// vals [E, W] uint32, flags [E] int32 -> out [E, W] uint32, in one launch.
// scratch: segmented_or_scan_scratch_words(E, W) uint64 words, zero when
// first used and then only by these launches, in stream order; seq in
// [1, 2^31), a different one for each launch on the scratch.
int segmented_or_scan_launch(const void* vals, const void* flags, void* out,
                             void* scratch, long long E, int W,
                             unsigned seq, void* stream) {
  if (E <= 0 || W <= 0) return 0;
  if (tiles_for(E) > 0x7FFFFFFF || seq == 0 || seq >= (1u << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = resident_blocks(
      1, reinterpret_cast<const void*>(segmented_or_scan_kernel), kScanSmem);
  if (blocks <= 0) return static_cast<int>(cudaGetLastError());
  const int tiles = static_cast<int>(tiles_for(E));
  auto* s = static_cast<unsigned long long*>(scratch);
  segmented_or_scan_kernel<<<tiles < blocks ? tiles : blocks, kThreads,
                             kScanSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(vals), static_cast<const int32_t*>(flags),
      static_cast<uint32_t*>(out), E, W, s + 1,
      reinterpret_cast<unsigned*>(s), tiles, seq);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
