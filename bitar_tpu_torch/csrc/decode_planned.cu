// Dense-plan block decode for Hopper (sm_90a): kernel B7.
//
// Replaces the TPU kernel bitar_tpu/ops/pallas/lz4_decode_planned.py
// `_planned_kernel` (called through `decode_blocks_planned`).  Per block i,
// over the stacked plane S = [comp rows | out rows | zeros] of w_rows rows:
// each pass k < min(p_used[i], passes), in order, reads S as it stood before
// the pass.  In out row r, lane l is active when start <= l < end (start =
// se >>> 8, end = se & 0xFF); it takes q = r*128 + l + shift (int32,
// wrapping), qrow = q >>> 7, and with row_a = min(min over the row's active
// lanes of qrow, w_rows - 2) the byte S[qrow == row_a ? row_a : row_a + 1]
// [q & 127].  Only active lanes are written.
//
// Bound.  Device traffic: the comp planes and the plan cells (8 bytes per
// pass and row) read once, the planes written once.  What held the first
// design (every pass: each warp's 32 rows in turn, two L2 loads of the
// row's cell and a gather each, then two CTA barriers) far from it was
// latency and issue: a pass took ~13 us, ~59 passes a deep block, and one
// CTA per SM ran its blocks in index order, so each wave lasted as long as
// its deepest block.
//
// Design.  Persistent CTAs of 1024 threads (one per SM: the out plane, 1024
// rows padded to 132 bytes, lives in shared memory) take blocks from a
// queue by descending p_used (a counting sort by one CTA launched first),
// so the deepest blocks start first and no SM idles behind them.  A block's passes are of
// two classes, found by a prologue over its cells (thread r takes row r of
// every pass; a cell's source rows follow in closed form from its first
// and last active lane):
//   * comp-only passes read no out row (on planner plans, the first p0
//     passes).  A row's bytes then depend only on that row's cells and the
//     comp plane, so thread r applies a whole run of such passes to row r,
//     in order, with no barrier: per pass one coalesced load of its cell
//     (the next one in flight meanwhile) and its active span copied 16 bytes
//     at a time from aligned comp words (byte by byte, a thread waited on a
//     load every four bytes and deep blocks took ~270 us).  The padding puts
//     the rows of a warp in 32 different banks.
//   * plane-reading passes: the pass's cells are staged in shared memory,
//     then each warp takes its rows (a row with no active lane is skipped
//     warp-uniformly), a lane its row's 4-byte word, the row anchor by
//     __reduce_min_sync; every word is gathered into registers, a barrier,
//     then written.
// The finished plane leaves in 16-byte stores.  The TPU kernel's one-hot
// MXU row fetch and its bf16 plane are not carried over.
//
// Planes taller than 1024 rows (blocks of 256 KiB to 1 MiB: up to 8192
// rows) take the tall route, after B1's (csrc/decode_flat.cu).  What held
// its first version (one CTA a block with the plane in device memory: 32
// blocks of 1 MiB on 32 of 132 SMs, and every plane-reading pass moving
// its words through a scratch row and L2 three times) at 30x its bound was
// the SMs it left idle and those trips.  The plane is cut into 1024-row
// slices, each in the shared route's padded layout, and the route is two
// kernels on the launch's stream behind the block order:
//   * the slice kernel: persistent CTAs on every SM take (block, slice)
//     units by descending p_used.  A pass's class belongs to the whole
//     block (another slice's plane-reading pass k reads this slice as it
//     stood before k), so a slice cannot tell alone how far its row-local
//     run may go.  It reads each of its rows' cells once, kCellBatch passes
//     at a time (the next batch in flight): it classes them (the slice's
//     classes, one bit a pass, OR-ed by atomics in shared memory), and
//     applies them, thread r to row r as above, up to its stop, the first
//     pass at which one of its rows reads an out row.  It stores the slice
//     as it stood at its stop, the stop and its classes.  A block whose
//     slices all stop at its last pass (the bench corpus's RAW and
//     single-pass blocks) is then done, with its cells read once.
//   * the cluster kernel: a thread-block cluster of C = ceil(out_rows /
//     1024) CTAs (2 at 256 KiB, 8 at 1 MiB) takes each block that has a
//     plane-reading pass, in the same order; CTA r holds rows [1024 r,
//     1024 (r + 1)).  The block's first plane-reading pass is the least
//     stop of its slices, its classes the OR of theirs.  A CTA whose stop
//     is that pass loads its slice back; any other applies the block's
//     leading comp-only run again from its cells (on planner plans the
//     slices whose rows have no match at the first out pass).  Then per
//     plane-reading pass: the pass's cells of the CTA's rows staged,
//     cluster barrier, each warp gathers its rows' words, cluster barrier,
//     the words written (and the next pass's cells, loaded during the
//     gather, staged).  Every read sees the plane as it stood before the
//     pass.  A row's two candidate source rows are resolved once to byte
//     pointers: a comp row, a row of the CTA that holds it (distributed
//     shared memory) or a row of zeros in shared memory; a lane reads its
//     word from one row as two aligned words and a funnel shift, else byte
//     by byte.  (Resolving each byte's row and rank on its own made the
//     gather, which is bound by what it issues a row, the slowest of the
//     variants timed; batching several rows' loads, or freeing registers by
//     staging half the gathered words in shared memory, bought nothing.)
//     Comp-only runs between them stay row-local, behind a CTA barrier,
//     kCellBatch cells at a time.  Each slice leaves in 16-byte stores.  A
//     cluster's next block is taken by its rank-0 CTA and written into
//     every CTA's slot through distributed shared memory before a cluster
//     barrier; the grid is as many clusters as can be resident at once
//     (cudaOccupancyMaxActiveClusters), and it exits at once when no block
//     has a plane-reading pass.
// Quiet blocks never take a cluster: an H100 holds only 15 clusters of 8
// such CTAs (120 of its 132 SMs).  What bounds the route now: in the
// cluster kernel the chain of a block's plane-reading passes, each two
// cluster barriers and a gather of every active row; at 1 MiB, 32 blocks
// take 3 rounds of 15 clusters.  A cluster launch the card refuses returns
// its error.

#include <cooperative_groups.h>

#include <cstdint>

#include "cuda_util.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 1024;                    // the shared route's plane, a tall route's slice
constexpr int kMaxCluster = 8;                    // the portable cluster size
constexpr int kMaxTallRows = kMaxRows * kMaxCluster;   // the tall route's plane: 1 MiB
constexpr int kRowsPerWarp = kMaxRows / kWarps;   // 32
constexpr int kRowWords = 33;                     // a plane row: 32 words and one of padding
constexpr int kMaxClassed = 4096;                 // passes classed; later ones read the plane
constexpr int kClassWords = kMaxClassed / 32;
constexpr int kOrderBuckets = 4096;               // pass counts the block order tells apart
constexpr int kCellBatch = 4;                     // passes whose cells a tall thread loads at once
constexpr unsigned kFull = 0xffffffffu;
static_assert(32 % kCellBatch == 0, "a batch's classes lie in one word");

struct Args {
  const uint8_t* comp;          // [n, comp_rows, 128]
  int comp_rows;
  const int32_t* p_used;        // [n]
  const int32_t* se;            // [n, passes, out_rows]
  const int32_t* shift;         // [n, passes, out_rows]
  int passes;
  const int32_t* order;         // [n]: the blocks in the order to take them
  uint8_t* out;                 // [n, out_rows, 128]
  int out_rows, w_rows, n;
  // Shared route: [next block, CTAs done].  Tall route: [next unit, CTAs
  // (then clusters) done, next block of the cluster kernel, whether a block
  // has a plane-reading pass].  0 at launch.
  int* queue;
  int slices;                   // tall route: C, a plane's 1024-row slices
  int class_words;              // tall route: words of a slice's classes
  int* stops;                   // tall route: [n, slices]
  uint32_t* classes;            // tall route: [n, slices, class_words]
};

// Shared memory: the padded plane (a tall route's slice), one pass's cells,
// the pass classes, the next block.
struct Smem {
  uint32_t* plane;              // [rows][kRowWords]
  int32_t* se;                  // [rows]
  int32_t* shift;               // [rows]
  uint32_t* reads;              // [kClassWords]: bit k set when pass k reads the plane
  int* next;                    // [2]
  uint32_t* zeros;              // tall route: [32], a row of zeros
};

__device__ __forceinline__ Smem smem_at(uint32_t* smem, int rows) {
  Smem s;
  s.plane = smem;
  s.se = reinterpret_cast<int32_t*>(smem + rows * kRowWords);
  s.shift = s.se + rows;
  s.reads = reinterpret_cast<uint32_t*>(s.shift + rows);
  s.next = reinterpret_cast<int*>(s.reads + kClassWords);
  s.zeros = reinterpret_cast<uint32_t*>(s.next + 4);
  return s;
}

// One cell of row r: its active lanes [lo, hi) and their first and last q.
struct Cell {
  uint32_t lo, hi, q0, q1;
};

__device__ __forceinline__ Cell cell_of(uint32_t se, uint32_t sh, int r) {
  Cell c;
  c.lo = se >> 8;
  c.hi = min(se & 0xFFu, 128u);
  c.q0 = static_cast<uint32_t>(r) * 128u + c.lo + sh;
  c.q1 = static_cast<uint32_t>(r) * 128u + (c.hi - 1u) + sh;
  return c;
}

// The anchor row: the least qrow of the active lanes (0 when q wraps past
// 2^32 inside the row), capped at w_rows - 2.
__device__ __forceinline__ uint32_t anchor(const Cell& c, uint32_t cap) {
  return min(c.q1 < c.q0 ? 0u : c.q0 >> 7, cap);
}

// Whether an active cell (lo < hi) reads an out row.
__device__ __forceinline__ bool reads_plane(const Cell& c, const Args& a) {
  const uint32_t cap = static_cast<uint32_t>(a.w_rows - 2);
  const uint32_t ra = anchor(c, cap);
  // Some lane reads row_a when some lane's qrow is row_a; some reads
  // row_a + 1 when some lane's qrow is not.
  const bool wrap = c.q1 < c.q0;
  const bool has_a = wrap || (c.q0 >> 7) <= cap;
  const bool has_b = wrap || (c.q1 >> 7) != ra || (c.q0 >> 7) != ra;
  const uint32_t lo = static_cast<uint32_t>(a.comp_rows);
  const uint32_t hi = lo + static_cast<uint32_t>(a.out_rows);
  return (has_a && ra >= lo && ra < hi) || (has_b && ra + 1 >= lo && ra + 1 < hi);
}

// Out rows as the passes read them: the shared plane; none in a comp-only
// pass (which reads no out row); a slice of the cluster's plane.
struct SharedPlane {
  const uint32_t* p;
  __device__ __forceinline__ uint32_t byte(uint32_t row, uint32_t lane) const {
    return reinterpret_cast<const uint8_t*>(p)[row * (4 * kRowWords) + lane];
  }
};

struct NoPlane {
  __device__ __forceinline__ uint32_t byte(uint32_t, uint32_t) const { return 0; }
};

// S[row][lane] of block comp.  The plane is read with plain loads: it is
// written during the kernel.
template <typename Plane>
__device__ __forceinline__ uint32_t s_byte(const uint8_t* comp, const Plane& plane,
                                           const Args& a, uint32_t row, uint32_t lane) {
  if (row < static_cast<uint32_t>(a.comp_rows)) return __ldg(comp + row * 128u + lane);
  row -= a.comp_rows;
  if (row < static_cast<uint32_t>(a.out_rows)) return plane.byte(row, lane);
  return 0;
}

__device__ __forceinline__ bool is_plane_pass(const uint32_t* reads, int k) {
  return k >= kMaxClassed || ((reads[k >> 5] >> (k & 31)) & 1u);
}

// One comp-only pass on row r.  In the usual cell (q does not wrap, the
// anchor is not capped) every active lane reads S at q itself, so the row
// takes S[q0 .. q0 + n) in one piece: comp bytes, or zeros above the out
// region (a comp-only pass reads no out row).  It is copied 16 bytes at a
// time from at most five aligned comp words, all loaded before any is used;
// any other cell goes byte by byte.
template <typename Plane>
__device__ __forceinline__ void comp_pass_row(const uint8_t* comp, uint8_t* row, const Cell& c,
                                              const Plane& plane, const Args& a) {
  const uint32_t cap = static_cast<uint32_t>(a.w_rows - 2);
  const uint32_t comp_len = static_cast<uint32_t>(a.comp_rows) * 128u;
  const uint32_t n = c.hi - c.lo;
  const bool linear = c.q1 >= c.q0 && (c.q0 >> 7) <= cap;
  if (linear && c.q1 < comp_len) {
    const uint32_t* cw = reinterpret_cast<const uint32_t*>(comp);
    const uint32_t last = c.q1 >> 2;
    for (uint32_t o = 0; o < n; o += 16) {
      const uint32_t at = c.q0 + o;
      const uint32_t w0 = at >> 2, sh = 8u * (at & 3u);
      uint32_t w[5];
#pragma unroll
      for (int k = 0; k < 5; ++k) w[k] = w0 + k <= last ? __ldg(cw + w0 + k) : 0u;
      uint32_t al[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) al[k] = __funnelshift_r(w[k], w[k + 1], sh);
#pragma unroll
      for (int j = 0; j < 16; ++j)
        if (o + j < n) row[c.lo + o + j] = static_cast<uint8_t>(al[j >> 2] >> (8 * (j & 3)));
    }
    return;
  }
  if (linear && c.q0 >= comp_len + static_cast<uint32_t>(a.out_rows) * 128u) {
    for (uint32_t j = 0; j < n; ++j) row[c.lo + j] = 0;
    return;
  }
  const uint32_t ra = anchor(c, cap);
  for (uint32_t l0 = c.lo; l0 < c.hi; l0 += 4) {
    uint32_t v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t q = c.q0 + (l0 - c.lo) + j;
      const uint32_t src = (q >> 7) == ra ? ra : ra + 1;
      v[j] = l0 + j < c.hi ? s_byte(comp, plane, a, src, q & 127u) : 0u;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (l0 + j < c.hi) row[l0 + j] = static_cast<uint8_t>(v[j]);
  }
}

// Passes [k0, k_end), all comp-only, applied in order by thread r to row r
// of the shared route's plane, held at `row`.  se_b and sh_b are the
// block's cells.
__device__ void comp_passes(const uint8_t* comp, const int32_t* se_b, const int32_t* sh_b,
                            int k0, int k_end, uint8_t* row, int r, const SharedPlane& plane,
                            const Args& a) {
  uint32_t n_se = 0, n_sh = 0;
  if (k0 < k_end) {
    n_se = __ldg(se_b + static_cast<long long>(k0) * a.out_rows + r);
    n_sh = __ldg(sh_b + static_cast<long long>(k0) * a.out_rows + r);
  }
  for (int k = k0; k < k_end; ++k) {
    const uint32_t se = n_se, sh = n_sh;
    if (k + 1 < k_end) {        // the next pass's cell, in flight during this one
      n_se = __ldg(se_b + static_cast<long long>(k + 1) * a.out_rows + r);
      n_sh = __ldg(sh_b + static_cast<long long>(k + 1) * a.out_rows + r);
    }
    const Cell c = cell_of(se, sh, r);
    if (c.lo < c.hi) comp_pass_row(comp, row, c, plane, a);
  }
}

// A row's cells of passes [k0, k0 + kCellBatch) below `lim` (0 past it):
// se_r and sh_r are the row's cells of pass 0.
__device__ __forceinline__ void load_cells(const int32_t* se_r, const int32_t* sh_r, int k0,
                                           int lim, uint32_t* se, uint32_t* sh, const Args& a) {
#pragma unroll
  for (int j = 0; j < kCellBatch; ++j) {
    const bool on = k0 + j < lim;
    se[j] = on ? __ldg(se_r + static_cast<long long>(k0 + j) * a.out_rows) : 0u;
    sh[j] = on ? __ldg(sh_r + static_cast<long long>(k0 + j) * a.out_rows) : 0u;
  }
}

// Passes [k0, k_end), all comp-only, applied in order to out row r at `row`
// on the tall route, kCellBatch passes' cells loaded at once and the next
// kCellBatch in flight meanwhile.
__device__ void comp_run(const uint8_t* comp, const int32_t* se_r, const int32_t* sh_r, int k0,
                         int k_end, uint8_t* row, int r, const Args& a) {
  uint32_t se[kCellBatch], sh[kCellBatch];
  load_cells(se_r, sh_r, k0, k_end, se, sh, a);
  for (int k = k0; k < k_end; k += kCellBatch) {
    uint32_t n_se[kCellBatch], n_sh[kCellBatch];
    load_cells(se_r, sh_r, k + kCellBatch, k_end, n_se, n_sh, a);
#pragma unroll
    for (int j = 0; j < kCellBatch; ++j) {
      const Cell c = cell_of(se[j], sh[j], r);
      if (c.lo < c.hi) comp_pass_row(comp, row, c, NoPlane{}, a);
      se[j] = n_se[j], sh[j] = n_sh[j];
    }
  }
}

// Plane-reading pass k: stage its cells, gather every active word, barrier,
// write them.  The caller ends the previous step with the plane complete
// for this thread's rows only; the barrier after staging orders the rest.
__device__ void plane_pass(const uint8_t* comp, const int32_t* se_b, const int32_t* sh_b, int k,
                           const Smem& s, const Args& a) {
  const int r0 = threadIdx.x;
  if (r0 < a.out_rows) {
    s.se[r0] = __ldg(se_b + static_cast<long long>(k) * a.out_rows + r0);
    s.shift[r0] = __ldg(sh_b + static_cast<long long>(k) * a.out_rows + r0);
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t cap = static_cast<uint32_t>(a.w_rows - 2);
  const SharedPlane plane{s.plane};
  uint32_t vals[kRowsPerWarp];
  uint32_t act = 0;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp + kWarps * i;
    if (r >= a.out_rows) break;                    // warp-uniform
    const uint32_t se = static_cast<uint32_t>(s.se[r]);
    const uint32_t start = se >> 8, end = se & 0xFFu;
    if (start >= end || start >= 128u) continue;   // no active lane: warp-uniform
    const uint32_t sh = static_cast<uint32_t>(s.shift[r]);
    uint32_t q[4];
    uint32_t low = 1u << 29;
    unsigned active = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t l = 4u * lane + j;
      q[j] = static_cast<uint32_t>(r) * 128u + l + sh;
      if (l >= start && l < end) {
        active |= 1u << j;
        low = min(low, q[j] >> 7);
      }
    }
    const uint32_t row_a = min(__reduce_min_sync(kFull, low), cap);
    uint32_t v = s.plane[r * kRowWords + lane];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (active & (1u << j)) {
        const uint32_t src = (q[j] >> 7) == row_a ? row_a : row_a + 1;
        const uint32_t byte = s_byte(comp, plane, a, src, q[j] & 127u);
        v = (v & ~(0xFFu << (8 * j))) | (byte << (8 * j));
      }
    }
    vals[i] = v;
    act |= 1u << i;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
    if (act & (1u << i)) s.plane[(warp + kWarps * i) * kRowWords + lane] = vals[i];
}

// Rows [0, rows) of the padded plane out to dst (rows of 128 bytes), 16
// bytes a thread: row i / 8, words 4 (i % 8) ... + 3.
__device__ __forceinline__ void store_plane(const uint32_t* plane, uint4* dst, int rows) {
  for (int i = threadIdx.x; i < rows * 8; i += kThreads) {
    const uint32_t* w = plane + (i >> 3) * kRowWords + 4 * (i & 7);
    dst[i] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

__device__ void decode_block(int b, Smem s, const Args& a) {
  const uint8_t* comp = a.comp + static_cast<long long>(b) * a.comp_rows * 128;
  const long long cells = static_cast<long long>(a.passes) * a.out_rows;
  const int32_t* se_b = a.se + b * cells;
  const int32_t* sh_b = a.shift + b * cells;
  const int np = max(0, min(__ldg(a.p_used + b), a.passes));
  uint4* dst = reinterpret_cast<uint4*>(a.out + static_cast<long long>(b) * a.out_rows * 128);
  if (threadIdx.x < a.out_rows) {                  // each thread zeroes its own row
    for (int w = 0; w < kRowWords; ++w) s.plane[threadIdx.x * kRowWords + w] = 0;
  }
  for (int w = threadIdx.x; w < kClassWords; w += kThreads) s.reads[w] = 0;
  __syncthreads();
  // Prologue: the class of every pass (up to kMaxClassed).  Whole warps take
  // each row: out_rows is a multiple of 128.
  for (int r = threadIdx.x; r < a.out_rows; r += kThreads) {
    // kBatch passes' cells loaded before any is used.
    constexpr int kBatch = 8;
    const int nk = min(np, kMaxClassed);
    for (int k0 = 0; k0 < nk; k0 += kBatch) {
      uint32_t se[kBatch], sh[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const long long cell = static_cast<long long>(k0 + j) * a.out_rows + r;
        se[j] = k0 + j < nk ? __ldg(se_b + cell) : 0u;
        sh[j] = k0 + j < nk ? __ldg(sh_b + cell) : 0u;
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const Cell c = cell_of(se[j], sh[j], r);
        if (__any_sync(kFull, c.lo < c.hi && reads_plane(c, a)) && (r & 31) == 0)
          atomicOr(s.reads + ((k0 + j) >> 5), 1u << ((k0 + j) & 31));
      }
    }
  }
  __syncthreads();
  bool synced = true;             // every thread's plane writes are visible to all
  uint8_t* row = reinterpret_cast<uint8_t*>(s.plane + threadIdx.x * kRowWords);
  for (int k = 0; k < np;) {
    if (is_plane_pass(s.reads, k)) {
      plane_pass(comp, se_b, sh_b, k, s, a);       // its staging barrier orders earlier writes
      synced = false;
      ++k;
    } else {
      int k_end = k + 1;
      while (k_end < np && !is_plane_pass(s.reads, k_end)) ++k_end;
      if (!synced) __syncthreads();                // the plane pass's writes, other rows
      if (threadIdx.x < a.out_rows)
        comp_passes(comp, se_b, sh_b, k, k_end, row, threadIdx.x, SharedPlane{s.plane}, a);
      synced = false;
      k = k_end;
    }
  }
  __syncthreads();
  store_plane(s.plane, dst, a.out_rows);
}

// The blocks by descending pass count (p_used clamped to [0, passes] and to
// kOrderBuckets - 1): a counting sort in one CTA, run before the decode on
// the same stream.  Blocks of one count come in the order the atomics give.
__global__ void __launch_bounds__(kThreads) decode_planned_order_kernel(const int32_t* p_used,
                                                                        int passes, int n,
                                                                        int32_t* order) {
  __shared__ int start[kOrderBuckets];
  __shared__ int warp_base[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int top = min(passes, kOrderBuckets - 1);
  auto key = [&](int b) { return min(max(__ldg(p_used + b), 0), top); };
  for (int k = tid; k <= top; k += kThreads) start[k] = 0;
  __syncthreads();
  for (int b = tid; b < n; b += kThreads) atomicAdd(start + key(b), 1);
  __syncthreads();
  // Each bucket's first place, counting from the top bucket down: thread t
  // owns buckets top - kPer * t ... top - kPer * t - kPer + 1.
  constexpr int kPer = kOrderBuckets / kThreads;
  int cnt[kPer], sum = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int k = top - (kPer * tid + j);
    cnt[j] = k >= 0 ? start[k] : 0;
    sum += cnt[j];
  }
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_base[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int total = warp_base[lane];
    int x = total;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, x, d);
      if (lane >= d) x += v;
    }
    warp_base[lane] = x - total;
  }
  __syncthreads();
  int run = warp_base[warp] + incl - sum;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int k = top - (kPer * tid + j);
    if (k >= 0) start[k] = run;
    run += cnt[j];
  }
  __syncthreads();
  for (int b = tid; b < n; b += kThreads) order[atomicAdd(start + key(b), 1)] = b;
}

// The last CTA (cluster) of a launch to finish sets `count` queue slots from
// `first` back to 0 for the stream's next launch: every other one has taken
// its last work by then.  `done` counts them; `of` is how many there are.
__device__ __forceinline__ void reset_queue(int* queue, int done, int first, int count, int of) {
  __threadfence();
  if (atomicAdd(queue + done, 1) == of - 1)
    for (int i = first; i < first + count; ++i) queue[i] = 0;
}

// The shared route (planes of up to 1024 rows): one CTA a block.
__global__ void __launch_bounds__(kThreads, 1) decode_planned_kernel(Args a) {
  extern __shared__ __align__(16) uint32_t smem[];
  const Smem s = smem_at(smem, a.out_rows);
  // The first block is the CTA's own index in the order; each later one is
  // taken from the queue once the block before it ends.
  int i = blockIdx.x;
  for (int it = 0; i < a.n; ++it) {
    decode_block(__ldg(a.order + i), s, a);
    if (threadIdx.x == 0) s.next[it & 1] = static_cast<int>(gridDim.x) + atomicAdd(a.queue, 1);
    __syncthreads();
    i = s.next[it & 1];
  }
  if (threadIdx.x == 0) reset_queue(a.queue, 1, 0, 2, static_cast<int>(gridDim.x));
}

// ---------------------------------------------------------------------------
// The tall route (planes of 1025 to 8192 rows)

// Block b's cells of out row r: pass k's at [k * out_rows].
__device__ __forceinline__ const int32_t* block_cells(const int32_t* cells, int b, int r,
                                                      const Args& a) {
  return cells + static_cast<long long>(b) * a.passes * a.out_rows + r;
}

// The slice kernel's unit: slice `sl` of block b (rows [1024 sl, ...)),
// thread t taking out row 1024 sl + t.
__device__ void slice_unit(int b, int sl, const Smem& s, const Args& a) {
  const int row0 = sl * kMaxRows, rows = min(kMaxRows, a.out_rows - row0);
  const int r = row0 + static_cast<int>(threadIdx.x);
  const bool mine = static_cast<int>(threadIdx.x) < rows;     // warp-uniform: rows % 128 == 0
  const uint8_t* comp = a.comp + static_cast<long long>(b) * a.comp_rows * 128;
  const int32_t* se_r = block_cells(a.se, b, r, a);
  const int32_t* sh_r = block_cells(a.shift, b, r, a);
  const int np = max(0, min(__ldg(a.p_used + b), a.passes));
  const int nk = min(np, kMaxClassed);
  uint8_t* row = reinterpret_cast<uint8_t*>(s.plane + threadIdx.x * kRowWords);
  if (mine)
    for (int w = 0; w < kRowWords; ++w) s.plane[threadIdx.x * kRowWords + w] = 0;
  for (int w = threadIdx.x; w < a.class_words; w += kThreads) s.reads[w] = 0;
  __syncthreads();
  const int lim = mine ? nk : 0;
  int stop = nk;                  // the first pass at which a row of the slice reads an out row
  uint32_t se[kCellBatch], sh[kCellBatch];
  load_cells(se_r, sh_r, 0, lim, se, sh, a);
  for (int k0 = 0; k0 < nk; k0 += kCellBatch) {
#pragma unroll
    for (int j = 0; j < kCellBatch; ++j) {
      const Cell c = cell_of(se[j], sh[j], r);
      if (__any_sync(kFull, c.lo < c.hi && reads_plane(c, a)) && (threadIdx.x & 31) == 0)
        atomicOr(s.reads + ((k0 + j) >> 5), 1u << ((k0 + j) & 31));
    }
    uint32_t n_se[kCellBatch], n_sh[kCellBatch];          // the next batch, in flight meanwhile
    load_cells(se_r, sh_r, k0 + kCellBatch, lim, n_se, n_sh, a);
    __syncthreads();                               // the batch's classes are known
    if (k0 < stop) {
      const uint32_t w = (s.reads[k0 >> 5] >> (k0 & 31)) & ((1u << kCellBatch) - 1u);
      if (w) stop = k0 + __ffs(static_cast<int>(w)) - 1;
      if (mine) {
#pragma unroll
        for (int j = 0; j < kCellBatch; ++j) {
          const Cell c = cell_of(se[j], sh[j], r);
          if (k0 + j < stop && c.lo < c.hi) comp_pass_row(comp, row, c, NoPlane{}, a);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kCellBatch; ++j) se[j] = n_se[j], sh[j] = n_sh[j];
  }
  __syncthreads();
  uint4* dst = reinterpret_cast<uint4*>(a.out + (static_cast<long long>(b) * a.out_rows + row0) *
                                        128);
  store_plane(s.plane, dst, rows);
  const long long u = static_cast<long long>(b) * a.slices + sl;
  for (int w = threadIdx.x; w < a.class_words; w += kThreads)
    a.classes[u * a.class_words + w] = s.reads[w];
  if (threadIdx.x == 0) {
    a.stops[u] = stop;
    if (stop < np) atomicOr(a.queue + 3, 1);
  }
}

// The tall route's first kernel: the n * slices units, block by block in
// the order, taken by persistent CTAs on every SM.
__global__ void __launch_bounds__(kThreads, 1) decode_planned_kernel_slices(Args a) {
  extern __shared__ __align__(16) uint32_t smem[];
  const Smem s = smem_at(smem, kMaxRows);
  const int units = a.n * a.slices;
  int u = blockIdx.x;
  for (int it = 0; u < units; ++it) {
    slice_unit(__ldg(a.order + u / a.slices), u % a.slices, s, a);
    if (threadIdx.x == 0) s.next[it & 1] = static_cast<int>(gridDim.x) + atomicAdd(a.queue, 1);
    __syncthreads();
    u = s.next[it & 1];
  }
  if (threadIdx.x == 0) reset_queue(a.queue, 1, 0, 2, static_cast<int>(gridDim.x));
}

// Whether block b has a plane-reading pass: one of its slices stopped short.
__device__ __forceinline__ bool needs_cluster(int b, const Args& a) {
  const int np = max(0, min(__ldg(a.p_used + b), a.passes));
  for (int sl = 0; sl < a.slices; ++sl)
    if (__ldg(a.stops + static_cast<long long>(b) * a.slices + sl) < np) return true;
  return false;
}

// Row `row` of S as 128 bytes: a comp row, a row of the cluster's plane (in
// the shared memory of the CTA that holds its slice, row / 1024), or the
// CTA's row of zeros.
__device__ __forceinline__ const uint8_t* s_row(const uint8_t* comp, const Smem& s,
                                                const Args& a, uint32_t row) {
  if (row < static_cast<uint32_t>(a.comp_rows)) return comp + row * 128u;
  row -= a.comp_rows;
  if (row >= static_cast<uint32_t>(a.out_rows)) return reinterpret_cast<const uint8_t*>(s.zeros);
  return reinterpret_cast<const uint8_t*>(cg::cluster_group::map_shared_rank(
      s.plane + (row % kMaxRows) * kRowWords, row / kMaxRows));
}

// Block b's slice on this CTA (rows [row0, row0 + rows)): its leading
// comp-only run (loaded back or applied again), then its passes.
__device__ void cluster_block(int b, const Smem& s, int rank, const Args& a) {
  const int row0 = rank * kMaxRows, rows = min(kMaxRows, a.out_rows - row0);
  const bool mine = static_cast<int>(threadIdx.x) < rows;
  const int r = row0 + static_cast<int>(threadIdx.x);
  const uint8_t* comp = a.comp + static_cast<long long>(b) * a.comp_rows * 128;
  const int32_t* se_b = block_cells(a.se, b, 0, a);
  const int32_t* sh_b = block_cells(a.shift, b, 0, a);
  const int np = max(0, min(__ldg(a.p_used + b), a.passes));
  const long long u0 = static_cast<long long>(b) * a.slices;
  // The block's first plane-reading pass and classes, from its slices'.
  int first = np;
  for (int sl = 0; sl < a.slices; ++sl) first = min(first, __ldg(a.stops + u0 + sl));
  for (int w = threadIdx.x; w < a.class_words; w += kThreads) {
    uint32_t x = 0;
    for (int sl = 0; sl < a.slices; ++sl) x |= __ldg(a.classes + (u0 + sl) * a.class_words + w);
    s.reads[w] = x;
  }
  uint4* dst = reinterpret_cast<uint4*>(a.out + (static_cast<long long>(b) * a.out_rows + row0) *
                                        128);
  uint8_t* row = reinterpret_cast<uint8_t*>(s.plane + threadIdx.x * kRowWords);
  if (__ldg(a.stops + u0 + rank) == first) {       // the slice kernel stored it at `first`
    for (int i = threadIdx.x; i < rows * 8; i += kThreads) {
      const uint4 v = dst[i];
      uint32_t* w = s.plane + (i >> 3) * kRowWords + 4 * (i & 7);
      w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
    }
  } else if (mine) {              // it ran past `first`: the leading run again
    for (int w = 0; w < kRowWords; ++w) s.plane[threadIdx.x * kRowWords + w] = 0;
    comp_run(comp, se_b + r, sh_b + r, 0, first, row, r, a);
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t cap = static_cast<uint32_t>(a.w_rows - 2);
  bool staged = false;            // the next pass's cells are in s.se / s.shift
  for (int k = first; k < np;) {
    if (!is_plane_pass(s.reads, k)) {
      int k_end = k + 1;
      while (k_end < np && !is_plane_pass(s.reads, k_end)) ++k_end;
      __syncthreads();                             // the plane pass's writes, other rows
      if (mine) comp_run(comp, se_b + r, sh_b + r, k, k_end, row, r, a);
      k = k_end;
      continue;
    }
    if (!staged && mine) {
      s.se[threadIdx.x] = __ldg(se_b + static_cast<long long>(k) * a.out_rows + r);
      s.shift[threadIdx.x] = __ldg(sh_b + static_cast<long long>(k) * a.out_rows + r);
    }
    // Every CTA's writes before the pass (and the cells) visible to all.
    cg::cluster_group::sync();
    const bool next = k + 1 < np && is_plane_pass(s.reads, k + 1);
    int32_t n_se = 0, n_sh = 0;                    // its cells, in flight during the gather
    if (next && mine) {
      n_se = __ldg(se_b + static_cast<long long>(k + 1) * a.out_rows + r);
      n_sh = __ldg(sh_b + static_cast<long long>(k + 1) * a.out_rows + r);
    }
    uint32_t vals[kRowsPerWarp];
    uint32_t act = 0;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int lr = warp + kWarps * i;
      if (lr >= rows) break;                       // warp-uniform
      const uint32_t se = static_cast<uint32_t>(s.se[lr]);
      const uint32_t start = se >> 8, end = se & 0xFFu;
      if (start >= end || start >= 128u) continue;  // no active lane: warp-uniform
      const uint32_t q0 = static_cast<uint32_t>(row0 + lr) * 128u + 4u * lane +
                          static_cast<uint32_t>(s.shift[lr]);
      uint32_t low = 1u << 29;
      unsigned active = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t l = 4u * lane + j;
        if (l >= start && l < end) {
          active |= 1u << j;
          low = min(low, (q0 + j) >> 7);
        }
      }
      // The row's two source rows, resolved once (warp-uniform).
      const uint32_t row_a = min(__reduce_min_sync(kFull, low), cap);
      const uint8_t* pa = s_row(comp, s, a, row_a);
      const uint8_t* pb = s_row(comp, s, a, row_a + 1);
      uint32_t v = s.plane[lr * kRowWords + lane];
      if (active == 0xFu && (q0 & 127u) <= 124u) {  // four bytes of one source row
        const uint32_t* w = reinterpret_cast<const uint32_t*>(
            ((q0 >> 7) == row_a ? pa : pb) + (q0 & 124u));
        const uint32_t sh = 8u * (q0 & 3u);
        v = sh ? __funnelshift_r(w[0], w[1], sh) : w[0];
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (active & (1u << j)) {
            const uint32_t q = q0 + j;
            const uint32_t byte = ((q >> 7) == row_a ? pa : pb)[q & 127u];
            v = (v & ~(0xFFu << (8 * j))) | (byte << (8 * j));
          }
        }
      }
      vals[i] = v;
      act |= 1u << i;
    }
    cg::cluster_group::sync();                     // every CTA has read the plane
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i)
      if (act & (1u << i)) s.plane[(warp + kWarps * i) * kRowWords + lane] = vals[i];
    if (next && mine) {
      s.se[threadIdx.x] = n_se;
      s.shift[threadIdx.x] = n_sh;
    }
    staged = next;
    ++k;
  }
  __syncthreads();
  store_plane(s.plane, dst, rows);
}

// The tall route's second kernel: the blocks with a plane-reading pass, one
// cluster a block, in the order.  A cluster's next block is found by its
// rank-0 CTA and written into every CTA's slot before the barrier.
__global__ void __launch_bounds__(kThreads, 1) decode_planned_kernel_cluster(Args a) {
  extern __shared__ __align__(16) uint32_t smem[];
  const Smem s = smem_at(smem, kMaxRows);
  const int rank = static_cast<int>(cg::cluster_group::block_rank());
  const int ctas = static_cast<int>(cg::cluster_group::num_blocks());
  if (*reinterpret_cast<volatile int*>(a.queue + 3) == 0) return;   // every block is done
  if (threadIdx.x < 32) s.zeros[threadIdx.x] = 0;   // before the first cluster barrier
  for (int it = 0;; ++it) {
    if (rank == 0 && threadIdx.x == 0) {
      int b = -1;
      for (int j; b < 0 && (j = atomicAdd(a.queue + 2, 1)) < a.n;) {
        const int c = __ldg(a.order + j);
        if (needs_cluster(c, a)) b = c;
      }
      for (int r = 0; r < ctas; ++r) *cg::cluster_group::map_shared_rank(s.next + (it & 1), r) = b;
    }
    cg::cluster_group::sync();    // also: no CTA reads another's slice past here
    const int b = s.next[it & 1];
    if (b < 0) break;
    cluster_block(b, s, rank, a);
  }
  if (rank == 0 && threadIdx.x == 0)
    reset_queue(a.queue, 1, 1, 3, static_cast<int>(gridDim.x) / ctas);
}

}  // namespace

// Rows of the largest plane the shared-memory route holds; taller planes
// (up to bt_decode_planned_max_rows()) take the tall route.
extern "C" int bt_decode_planned_shared_rows() { return kMaxRows; }
extern "C" int bt_decode_planned_max_rows() { return kMaxTallRows; }

// CTAs that decode one block of an `out_rows`-row plane: 1 on the shared
// route (up to 1024 rows), else the tall route's slices and cluster size,
// ceil(out_rows / 1024); 0 past 8192 rows.
extern "C" int bt_decode_planned_cluster_ctas(int out_rows) {
  if (out_rows <= 0 || out_rows > kMaxTallRows) return 0;
  return (out_rows + kMaxRows - 1) / kMaxRows;
}

namespace {

// The launch's kernels on `stream` after the block order: the shared
// route's persistent CTAs (as many as fit, at most n), or for taller planes
// the slice kernel on every SM and the cluster kernel (as many clusters as
// can be resident, at most n).
cudaError_t launch_routes(const Args& a, int32_t* order, int device, cudaStream_t st) {
  // Shared memory: the plane (a slice), one pass's cells, the pass classes,
  // the queue slots.  Each kernel opts in to its largest, so launches of
  // other block sizes from other threads never meet a smaller limit.
  const int tail = kClassWords * 4 + 16;
  const int most = kMaxRows * (kRowWords * 4 + 8) + tail;
  int sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  decode_planned_order_kernel<<<1, kThreads, 0, st>>>(a.p_used, a.passes, a.n, order);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (a.slices == 1) {
    const int smem = a.out_rows * (kRowWords * 4 + 8) + tail;
    if ((err = bt::smem_opt_in(decode_planned_kernel, most)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, decode_planned_kernel,
                                                             kThreads, smem)) != cudaSuccess)
      return err;
    const int grid = per_sm < 1 ? 1 : (a.n < per_sm * sms ? a.n : per_sm * sms);
    decode_planned_kernel<<<grid, kThreads, smem, st>>>(a);
    return cudaGetLastError();
  }
  if ((err = bt::smem_opt_in(decode_planned_kernel_slices, most)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, decode_planned_kernel_slices, kThreads, most)) != cudaSuccess)
    return err;
  const long long units = static_cast<long long>(a.n) * a.slices;
  const long long fit = per_sm < 1 ? 1 : static_cast<long long>(per_sm) * sms;
  decode_planned_kernel_slices<<<static_cast<int>(units < fit ? units : fit), kThreads, most,
                                st>>>(a);
  const int cluster_smem = most + 128;            // and the row of zeros
  if ((err = cudaGetLastError()) != cudaSuccess ||
      (err = bt::smem_opt_in(decode_planned_kernel_cluster, cluster_smem)) != cudaSuccess)
    return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = a.slices;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.gridDim = dim3(a.slices);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = cluster_smem;
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  if ((err = cudaOccupancyMaxActiveClusters(&clusters, decode_planned_kernel_cluster, &cfg)) !=
      cudaSuccess)
    return err;
  if (clusters < 1) return cudaErrorLaunchOutOfResources;
  cfg.gridDim = dim3(a.slices * (a.n < clusters ? a.n : clusters));
  if ((err = cudaLaunchKernelEx(&cfg, decode_planned_kernel_cluster, a)) != cudaSuccess)
    return err;
  return cudaGetLastError();
}

}  // namespace

// Launches the block order (one CTA, into `order`, n ints) and then the
// route's kernels on `stream` of `device` (see launch_routes); returns the
// CUDA error code (0 on success), also when the card refuses the cluster
// launch.  Pointers are device pointers; the caller allocates `out`
// (16-byte aligned), `order`, the four ints of `queue`, which must be 0 and
// are 0 again when the launch ends (so launches that share a queue must run
// in turn, as on one stream), and on the tall route `stops` (n * C ints, C =
// bt_decode_planned_cluster_ctas(out_rows)) and `classes` (n * C *
// max(1, ceil(min(passes, 4096) / 32)) words).
extern "C" int bt_decode_planned_launch(const void* comp, int comp_rows, const void* p_used,
                                        const void* se, const void* shift, int passes,
                                        void* order, void* out, int n, int out_rows,
                                        void* queue, void* stops, void* classes, int device,
                                        void* stream) {
  const int ctas = bt_decode_planned_cluster_ctas(out_rows);
  if (n < 0 || comp_rows < 0 || passes < 0 || ctas == 0 || out_rows % 128 || device < 0 ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0 ||
      (ctas > 1 && (stops == nullptr || classes == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  int current = 0;
  cudaError_t err = bt::enter_device(device, &current);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a;
  a.comp = static_cast<const uint8_t*>(comp);
  a.comp_rows = comp_rows;
  a.p_used = static_cast<const int32_t*>(p_used);
  a.se = static_cast<const int32_t*>(se);
  a.shift = static_cast<const int32_t*>(shift);
  a.passes = passes;
  a.order = static_cast<const int32_t*>(order);
  a.out = static_cast<uint8_t*>(out);
  a.out_rows = out_rows;
  a.w_rows = (comp_rows + out_rows + 1023) / 1024 * 1024;
  a.n = n;
  a.queue = static_cast<int*>(queue);
  a.slices = ctas;
  a.class_words = passes < 32 ? 1 : ((passes < kMaxClassed ? passes : kMaxClassed) + 31) / 32;
  a.stops = static_cast<int*>(stops);
  a.classes = static_cast<uint32_t*>(classes);
  err = launch_routes(a, static_cast<int32_t*>(order), device, static_cast<cudaStream_t>(stream));
  if (current != device) cudaSetDevice(current);
  return static_cast<int>(err);
}
