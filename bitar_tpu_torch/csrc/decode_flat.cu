// Flat-plan block decode for Hopper (sm_90a): LZ4, Snappy and RAW blocks.
//
// Replaces the TPU kernel bitar_tpu/ops/pallas/lz4_decode_flat.py
// `_flat_kernel` (called through `decode_blocks_flat`).  It computes what
// that module's numpy oracle `decode_flat_numpy` computes, per block:
//   1. RAW block (dense < 0): output = comp plane, zero past it.
//   2. otherwise the plane starts at zero; dense passes write every byte
//      whose dq pass id pid is in [1, dense]: comp[(row_a + drow)*128 + qlane];
//   3. comp passes k < p0: lanes [start, end) of row r take comp[p + shift];
//   4. out passes p0 <= k < p_used, in order, gather from the output plane
//      as it stood before the pass: out[p + shift].
// Every source index clips to its plane; comp bytes past the row width are 0.
//
// Bound.  The device traffic is the stored comp bytes, the plan wire and the
// output plane.  What held a one-CTA-per-block design far from it was
// latency: each thread swept its 32 words one after another, every word a
// chain of dependent loads (dq, then the anchor, then the comp byte) through
// L2, and a RAW block held an SM's whole shared-memory plane while copying
// byte by byte.
//
// Design.  Persistent CTAs of 1024 threads, as many as fit on the card
// (one per SM at 128 KiB planes), take blocks from a queue (one atomic per
// block), so no SM idles in a tail wave while another still holds several
// blocks.  Thread t owns the 32-bit
// words w = t + i * 1024 of a plane, so the 32 lanes of a warp cover one
// 128-byte row per step and read that row's se/shift cell as a broadcast.
// By class:
//   * RAW: a straight copy, 16 bytes a thread where the comp row is 16-byte
//     aligned, else 4 or 1; no shared memory.
//   * No out pass: dense and comp passes read only the comp plane, so each
//     thread folds every pass into its own words (in plan order per byte,
//     the oracle's order) and stores them straight to device memory.  The
//     words are swept four at a time, so their loads are in flight together.
//     A dense pass's byte is an index sum and a gather, so what the sweep
//     issues per byte is what it costs: a lane loads its row's anchors of
//     one dense pass (those of the 8 tiles are one 32-byte sector of row_a,
//     so the sweep takes the words of one row offset in every tile
//     together), each byte takes its pass's anchor by a shuffle, and
//     indices are clipped in 32-bit arithmetic (~15 instructions a byte,
//     where an anchor load per byte and 64-bit clipping took ~35).  Staging
//     the dq plane in shared memory by TMA bulk copies instead made it
//     slower: the sweep does not wait on its dq bytes.
//   * Out passes: the same sweep into the out plane in dynamic shared
//     memory; then each out pass gathers the new value of all its words into
//     registers, __syncthreads(), writes them, __syncthreads(), so every
//     read sees the plane as it was before the pass.  A pass's se/shift
//     cells are staged in shared memory (one coalesced load per row, during
//     the previous pass's write phase), so its 32 words per thread do not
//     each wait on an L2 load of their cell.  The finished plane
//     leaves by one TMA bulk store (cp.async.bulk) that runs while the CTA
//     goes on to its next block; only a next block that needs the plane
//     waits for the store to have read it (cp.async.bulk.wait_group.read).
// The comp plane is read through L1/L2 (not staged): the kernel knows only
// the unit's widest plane, so staging would copy comp_rows * 128 bytes a
// block where the bench's decoded blocks store ~550 (they stay in L1).
// A launch may name each block's comp row through a table (src_row), so
// blocks resident in the engine's slot arena decode where they lie: the
// scan then copies no slot, and a block still reads one contiguous row.
//
// Planes taller than 1024 rows (blocks of 256 KiB to 1 MiB: up to 8192
// rows) take the tall route.  What held its first version (one CTA a block,
// each out pass walking the whole plane twice through L2 and a scratch row)
// far from the bound was that a pass moved ~3x the bytes it wrote through L2
// on one SM a block, and that a burst of 32 blocks kept 32 of 132 SMs busy.
// The route is two kernels on the launch's stream:
//   * the slice kernel: persistent CTAs on every SM share out the blocks
//     in block order, whole blocks when there are at least as many as CTAs,
//     else each in parts of its 1024-row slices, as many parts as keep every
//     CTA busy; RAW and no-out-pass slices are copied or swept straight to
//     device memory (a CTA pays a block's plan and first loads once for its
//     run of slices), and a block with out passes is listed for the second
//     kernel.  (A single cluster kernel for every class ran the bench's
//     128 blocks of 1 MiB, none with out passes, at 1.9x the first
//     version's time: an H100 holds only 15 clusters of 8 such CTAs at once,
//     120 of its 132 SMs, so the blocks took two rounds.)
//   * the cluster kernel: a thread-block cluster of C = ceil(out_rows /
//     1024) CTAs (2 at 256 KiB, 8 at 1 MiB: the portable maximum) decodes
//     each listed block, CTA r holding rows [1024 r, 1024 (r + 1)) of its
//     plane in its own shared memory (the shared route's 128 KiB slice).
//     Each CTA sweeps its rows into its slice, then per out pass gathers the
//     new value of each of its words from the CTA that holds the source
//     bytes (distributed shared memory: a whole word as two aligned words
//     and a funnel shift, else byte by byte), cluster barrier, writes the
//     words it gathered, cluster barrier: every read sees the plane as it
//     stood before the pass.  A pass's se/shift cells of the CTA's rows are
//     staged as on the shared route (shift only for live rows); a CTA skips
//     the words of rows whose cell is empty, and a pass with no live row
//     among its rows costs it the two barriers and nothing else.  Each slice
//     leaves by its own TMA bulk store.  A cluster's next block is one
//     atomic, taken by its rank-0 CTA and written into every CTA's slot
//     through distributed shared memory before a cluster barrier; the grid
//     is as many clusters as can be resident at once
//     (cudaOccupancyMaxActiveClusters); with no block listed it exits at
//     once.
// What bounds the route now: in the slice kernel the device-memory bytes
// (the dq plane's 2 bytes a plane byte, the plane, the comp rows); in the
// cluster kernel the chain of a block's out passes, two cluster barriers
// and a gather through distributed shared memory a pass.  A cluster launch
// the card refuses returns its error.

#include <cooperative_groups.h>

#include <algorithm>
#include <atomic>
#include <cstdint>

#include "cuda_util.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxWords = 32;     // words per thread of the shared route: 1024 rows * 32 / 1024
constexpr int kGroup = 4;         // tiles whose words a thread sweeps at once
constexpr int kRawBatch = 4;      // 16-byte chunks a thread loads at once in a RAW copy
constexpr int kLanes = 128;
constexpr int kSliceRows = kThreads * kMaxWords / (kLanes / 4);   // rows a CTA holds: 1024
constexpr int kSliceShift = 17;   // log2 of a slice's bytes
constexpr int kMaxCluster = 8;    // the portable cluster size: planes of up to 8192 rows
static_assert(kSliceRows * kLanes == 1 << kSliceShift, "a slice is 2^17 bytes");

struct Args {
  const uint8_t* comp;            // rows of comp_stride bytes: block b's is row b, or src_row[b]
  long long comp_stride;
  const int32_t* src_row;         // [n] or null: block b reads comp row src_row[b]
  int comp_n;                     // rows of comp: src_row entries clip to [0, comp_n)
  int comp_width;                 // bytes per row that hold data
  int comp_len;                   // comp plane length: comp_rows * 128
  const int32_t* p_used;
  const int32_t* p_off;
  const int32_t* p0;
  const int32_t* dense;
  const int32_t* dq_idx;
  const int16_t* se;              // [s_rows, out_rows]
  const int32_t* shift;           // [s_rows, out_rows]
  long long s_rows;
  const int16_t* dq;              // [dq_rows, out_rows * 128], 8-byte aligned
  int dq_rows;
  const int32_t* row_a;           // [dq_rows, dcap, 128, tiles]
  int dcap;
  uint8_t* out;                   // [n, out_rows * 128]
  int out_rows;
  int n;
  int* queue;                     // [next block, CTAs (clusters) done, listed blocks]: 0 at launch
  int* list;                      // tall route: [n] the blocks with out passes
  int parts;                      // tall route: parts a block's slices are shared out in
};

// One block's plan, the same in every thread.
struct Block {
  const uint8_t* cp;
  long long base;                 // first wire row of its passes
  int npass, ncomp, dn, di;
  bool dense_on;
};

__device__ __forceinline__ uint32_t comp_byte(const uint8_t* cp, long long q,
                                              const Args& a) {
  q = q < 0 ? 0 : (q >= a.comp_len ? a.comp_len - 1 : q);
  return q < a.comp_width ? __ldg(cp + q) : 0u;
}

// A dense pass's byte: comp[(anchor + drow) * 128 + qlane] for the dq entry
// d, in 32-bit arithmetic.  Clipping the anchor to [-4, comp_rows] first
// keeps the sum in range and leaves the clipped index as it was.
__device__ __forceinline__ uint32_t comp_row_byte(const uint8_t* cp, int32_t anchor, uint32_t d,
                                                  const Args& a) {
  const int r = min(max(anchor, -4), a.comp_len / kLanes) + static_cast<int>((d >> 7) & 3);
  const int q = min(max(r * kLanes + static_cast<int>(d & 127), 0), a.comp_len - 1);
  return q < a.comp_width ? __ldg(cp + q) : 0u;
}

__device__ __forceinline__ uint32_t set_byte(uint32_t w, int j, uint32_t b) {
  return (w & ~(0xFFu << (8 * j))) | (b << (8 * j));
}

// RAW block: out[p] = comp[p] below min(comp_len, comp_width), 0 after, for
// the bytes [lo, hi) of the plane (multiples of 16: the whole plane on the
// shared route, a CTA's rows on the cluster route).  Each thread loads
// kRawBatch of its chunks before it stores any, so that many loads are in
// flight.
__device__ void copy_raw(const uint8_t* cp, uint8_t* out, int lo, int hi, int out_len,
                         const Args& a) {
  const int lim = min(min(a.comp_len, a.comp_width), out_len);
  const uintptr_t align = reinterpret_cast<uintptr_t>(cp);
  if ((align & 15) == 0) {
    uint4* o = reinterpret_cast<uint4*>(out);
    const uint4* s = reinterpret_cast<const uint4*>(cp);
    for (int i0 = lo / 16 + threadIdx.x; i0 < hi / 16; i0 += kRawBatch * kThreads) {
      uint4 v[kRawBatch];
#pragma unroll
      for (int r = 0; r < kRawBatch; ++r) {
        const int i = i0 + r * kThreads;
        v[r] = make_uint4(0, 0, 0, 0);
        if (16 * i + 16 <= lim) {
          v[r] = __ldg(s + i);
        } else if (16 * i < lim) {
          uint32_t b[4] = {0, 0, 0, 0};
          for (int j = 0; 16 * i + j < lim; ++j)
            b[j >> 2] |= static_cast<uint32_t>(__ldg(cp + 16 * i + j)) << (8 * (j & 3));
          v[r] = make_uint4(b[0], b[1], b[2], b[3]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRawBatch; ++r)
        if (i0 + r * kThreads < hi / 16) o[i0 + r * kThreads] = v[r];
    }
    return;
  }
  uint32_t* o = reinterpret_cast<uint32_t*>(out);
  const bool words = (align & 3) == 0;
  for (int w0 = lo / 4 + threadIdx.x; w0 < hi / 4; w0 += kRawBatch * kThreads) {
    uint32_t v[kRawBatch];
#pragma unroll
    for (int r = 0; r < kRawBatch; ++r) {
      const int w = w0 + r * kThreads;
      v[r] = 0;
      if (words && 4 * w + 4 <= lim) {
        v[r] = __ldg(reinterpret_cast<const uint32_t*>(cp) + w);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (4 * w + j < lim) v[r] |= static_cast<uint32_t>(__ldg(cp + 4 * w + j)) << (8 * j);
      }
    }
#pragma unroll
    for (int r = 0; r < kRawBatch; ++r)
      if (w0 + r * kThreads < hi / 4) o[w0 + r * kThreads] = v[r];
  }
}

// Dense and comp passes for the thread's words into dst (the shared plane,
// a CTA's slice, or the block's output row from tile t0 on).  Word i of thread t (w = t + 1024 i) lies in
// row r = t / 32 + 32 (i & 3) of tile i >> 2 (a tile is 128 rows), so the
// sweep takes the four row classes g = i & 3 in turn and, within one, its
// words of kGroup tiles at once.  A warp's word covers one row: lane l
// holds the row's anchor of dense pass l + 1 in every tile (row_a keeps a
// row's tiles together, so that is one 32-byte sector, loaded once), and
// each byte takes its pass's anchor by a shuffle.
//
// Tiles [t0, t0 + nt) of the plane, nt <= 8 (the shared route sweeps its
// 1-8 tiles in one call, each CTA of the cluster route its own); dst holds
// tile t0's first word.
__device__ __forceinline__ void sweep_tiles(const Block& k, uint32_t* dst, const Args& a,
                                            int t0, int nt) {
  const int out_len = a.out_rows * kLanes;
  const int tiles = a.out_rows / kLanes;
  const uint2* dqr = reinterpret_cast<const uint2*>(a.dq + static_cast<long long>(k.di) * out_len);
  // Anchor plane j of wire row di is [128, tiles]: row r of tile c at [r, c].
  const int32_t* ra = a.row_a + static_cast<long long>(k.di) * a.dcap * a.out_rows + t0;
  const int lane = threadIdx.x & 31;
  const uint32_t np = k.dense_on ? static_cast<uint32_t>(min(min(k.dn, a.dcap), 63)) : 0u;
  const bool vec = nt == 8 && tiles % 4 == 0 && (reinterpret_cast<uintptr_t>(ra) & 15) == 0;
#pragma unroll 1
  for (int g = 0; g < 4; ++g) {
    const int r = (threadIdx.x >> 5) + 32 * g;
    const int32_t* rr = ra + static_cast<long long>(lane) * a.out_rows + r * tiles;
    int32_t anc[8];
    if (vec && lane < np) {
      const int4 lo = __ldg(reinterpret_cast<const int4*>(rr));
      const int4 hi = __ldg(reinterpret_cast<const int4*>(rr) + 1);
      anc[0] = lo.x, anc[1] = lo.y, anc[2] = lo.z, anc[3] = lo.w;
      anc[4] = hi.x, anc[5] = hi.y, anc[6] = hi.z, anc[7] = hi.w;
    } else {
#pragma unroll
      for (int t = 0; t < 8; ++t) anc[t] = lane < np && t < nt ? __ldg(rr + t) : 0;
    }
#pragma unroll
    for (int c0 = 0; c0 < 8; c0 += kGroup) {
      if (c0 >= nt) break;
      uint32_t v[kGroup];
#pragma unroll
      for (int cc = 0; cc < kGroup; ++cc) v[cc] = 0;
      if (np) {
        uint2 d4[kGroup];
#pragma unroll
        for (int cc = 0; cc < kGroup; ++cc)
          d4[cc] = c0 + cc < nt ? __ldg(dqr + threadIdx.x + (4 * (t0 + c0 + cc) + g) * kThreads)
                                : make_uint2(0, 0);
#pragma unroll
        for (int cc = 0; cc < kGroup; ++cc) {
          // Passes 33 and on (a unit with more than 32 dense passes): one
          // load a word.
          const int32_t a1 = np > 32 && lane + 32 < np && c0 + cc < nt
              ? __ldg(rr + 32LL * a.out_rows + c0 + cc) : 0;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t d = ((j < 2 ? d4[cc].x : d4[cc].y) >> (16 * (j & 1))) & 0xFFFFu;
            const uint32_t x = ((d >> 9) & 0x3F) - 1u;     // the pass's index; pid 0 wraps
            int32_t an = __shfl_sync(0xffffffffu, anc[c0 + cc], x & 31);
            if (np > 32) {                                  // warp-uniform
              const int32_t an1 = __shfl_sync(0xffffffffu, a1, x & 31);
              if (x >= 32) an = an1;
            }
            if (x < np) v[cc] = set_byte(v[cc], j, comp_row_byte(k.cp, an, d, a));
          }
        }
      }
      for (int kk = 0; kk < k.ncomp; ++kk) {
        // The pass's cells of the words' rows, se and shift loaded together.
        uint32_t s[kGroup];
        int32_t sh[kGroup];
#pragma unroll
        for (int cc = 0; cc < kGroup; ++cc) {
          const long long cell = (k.base + kk) * a.out_rows + 128 * (t0 + c0 + cc) + r;
          s[cc] = c0 + cc < nt ? static_cast<uint16_t>(__ldg(a.se + cell)) : 0u;
          sh[cc] = c0 + cc < nt ? __ldg(a.shift + cell) : 0;
        }
#pragma unroll
        for (int cc = 0; cc < kGroup; ++cc) {
          const int w = threadIdx.x + (4 * (t0 + c0 + cc) + g) * kThreads;
          const int lane0 = lane * 4;
          const int start = (s[cc] >> 8) & 0x7F, end = s[cc] & 0xFF;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int q = lane0 + j;
            if (q >= start && q < end)
              v[cc] = set_byte(v[cc], j,
                               comp_byte(k.cp, w * 4 + j + static_cast<long long>(sh[cc]), a));
          }
        }
      }
#pragma unroll
      for (int cc = 0; cc < kGroup; ++cc)
        if (c0 + cc < nt) dst[threadIdx.x + (4 * (c0 + cc) + g) * kThreads] = v[cc];
    }
  }
}

// A pass's se/shift cells of every row, staged in shared memory (one
// coalesced load per row), so the pass's gathers do not wait on L2 per word.
struct Cells {
  int32_t* shift;                 // [2][out_rows]
  uint16_t* se;                   // [2][out_rows]
};

__device__ __forceinline__ void stage_cells(const Block& k, int kk, int buf, const Cells& c,
                                            const Args& a) {
  for (int r = threadIdx.x; r < a.out_rows; r += kThreads) {
    const long long cell = (k.base + kk) * a.out_rows + r;
    c.se[buf * a.out_rows + r] = static_cast<uint16_t>(__ldg(a.se + cell));
    c.shift[buf * a.out_rows + r] = __ldg(a.shift + cell);
  }
}

// Out passes on the shared plane: gather all, barrier, write all (and stage
// the next pass's cells), barrier.  The first pass's cells are staged
// before the call, behind its barrier.
__device__ void out_passes(const Block& k, uint32_t* plane, const Cells& c, const Args& a) {
  const int out_words = a.out_rows * (kLanes / 4);
  const int out_len = a.out_rows * kLanes;
  const uint8_t* pb = reinterpret_cast<const uint8_t*>(plane);
  for (int kk = k.ncomp; kk < k.npass; ++kk) {
    const int buf = (kk - k.ncomp) & 1;
    const uint16_t* cse = c.se + buf * a.out_rows;
    const int32_t* csh = c.shift + buf * a.out_rows;
    uint32_t pend[kMaxWords];
#pragma unroll
    for (int i = 0; i < kMaxWords; ++i) {
      const int w = threadIdx.x + i * kThreads;
      if (w < out_words) {
        const int row = w >> 5;
        const int lane0 = (w & 31) * 4;
        const uint32_t s = cse[row];
        const int start = (s >> 8) & 0x7F, end = s & 0xFF;
        uint32_t v = plane[w];
        if (start < lane0 + 4 && end > lane0 && start < end) {
          const long long sh = csh[row];
          for (int j = 0; j < 4; ++j) {
            const int lane = lane0 + j;
            if (lane >= start && lane < end) {
              long long q = w * 4 + j + sh;
              q = q < 0 ? 0 : (q >= out_len ? out_len - 1 : q);
              v = set_byte(v, j, pb[q]);
            }
          }
        }
        pend[i] = v;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kMaxWords; ++i) {
      const int w = threadIdx.x + i * kThreads;
      if (w < out_words) plane[w] = pend[i];
    }
    if (kk + 1 < k.npass) stage_cells(k, kk + 1, buf ^ 1, c, a);
    __syncthreads();
  }
}

// A CTA's slice of the plane on the cluster route: rows [row0, row0 + rows).
struct Slice {
  int rank;                       // the CTA's rank in its cluster
  int row0;                       // 1024 * rank
  int rows;                       // 1024, fewer in the last CTA of a plane
};

// Stages pass kk's cells of the slice's rows (the shift only of live rows);
// returns whether any of them is live in this thread.
__device__ __forceinline__ bool stage_slice_cells(const Block& k, int kk, int buf, const Cells& c,
                                                  const Slice& s, const Args& a) {
  bool live = false;
  for (int r = threadIdx.x; r < s.rows; r += kThreads) {
    const long long cell = (k.base + kk) * a.out_rows + s.row0 + r;
    const uint16_t se = static_cast<uint16_t>(__ldg(a.se + cell));
    const bool on = ((se >> 8) & 0x7F) < (se & 0xFF);
    c.se[buf * kSliceRows + r] = se;
    c.shift[buf * kSliceRows + r] = on ? __ldg(a.shift + cell) : 0;
    live = live || on;
  }
  return live;
}

// Word q / 4 (q a multiple of 4) and byte q of the block's plane, read from
// the slice of the cluster's CTA that holds them.
__device__ __forceinline__ uint32_t plane_word(const cg::cluster_group& cl, uint32_t* slice, int q) {
  return *cl.map_shared_rank(slice + ((q & ((1 << kSliceShift) - 1)) >> 2), q >> kSliceShift);
}

__device__ __forceinline__ uint32_t plane_byte(const cg::cluster_group& cl, uint32_t* slice, int q) {
  uint8_t* b = reinterpret_cast<uint8_t*>(slice) + (q & ((1 << kSliceShift) - 1));
  return *cl.map_shared_rank(b, q >> kSliceShift);
}

// Out passes on the cluster route: per pass each CTA gathers the new value
// of the words of its rows that the pass writes, from whichever slice holds
// their source bytes, cluster barrier, writes them into its slice (and
// stages the next pass's cells), cluster barrier.  `live`: whether the first
// pass writes any of the slice's rows.
__device__ void out_passes_cluster(const Block& k, uint32_t* slice, const Cells& c, const Slice& s,
                                   bool live, const Args& a) {
  const cg::cluster_group cl = cg::this_cluster();
  const int out_len = a.out_rows * kLanes;
  const int words = s.rows * (kLanes / 4);
  const int w0 = s.row0 * (kLanes / 4);            // the slice's first word in the plane
  for (int kk = k.ncomp; kk < k.npass; ++kk) {
    const int buf = (kk - k.ncomp) & 1;
    const uint16_t* cse = c.se + buf * kSliceRows;
    const int32_t* csh = c.shift + buf * kSliceRows;
    uint32_t pend[kMaxWords];
    uint32_t mask = 0;                             // bit i: word i takes pend[i]
    if (live) {
#pragma unroll
      for (int i = 0; i < kMaxWords; ++i) {
        const int wl = threadIdx.x + i * kThreads;
        pend[i] = 0;
        if (wl >= words) continue;
        const int row = wl >> 5;
        const int lane0 = (wl & 31) * 4;
        const uint32_t cs = cse[row];
        const int start = (cs >> 8) & 0x7F, end = cs & 0xFF;
        if (!(start < lane0 + 4 && end > lane0 && start < end)) continue;
        const long long q0 = 4LL * (w0 + wl) + csh[row];
        uint32_t v;
        if (start <= lane0 && end >= lane0 + 4 && q0 >= 0 && q0 <= out_len - 4) {
          // The whole word from its (possibly unaligned) source: two
          // aligned words, the second inside the plane when the first is
          // not its last.
          const int q = static_cast<int>(q0);
          const uint32_t lo = plane_word(cl, slice, q & ~3);
          v = (q & 3) ? __funnelshift_r(lo, plane_word(cl, slice, (q & ~3) + 4), 8 * (q & 3)) : lo;
        } else {
          v = slice[wl];
          for (int j = 0; j < 4; ++j) {
            const int lane = lane0 + j;
            if (lane >= start && lane < end) {
              long long q = q0 + j;
              q = q < 0 ? 0 : (q >= out_len ? out_len - 1 : q);
              v = set_byte(v, j, plane_byte(cl, slice, static_cast<int>(q)));
            }
          }
        }
        pend[i] = v;
        mask |= 1u << i;
      }
    }
    cl.sync();                                     // every CTA has read the plane
#pragma unroll
    for (int i = 0; i < kMaxWords; ++i)
      if ((mask >> i) & 1u) slice[threadIdx.x + i * kThreads] = pend[i];
    if (kk + 1 < k.npass) {
      live = __syncthreads_or(stage_slice_cells(k, kk + 1, buf ^ 1, c, s, a));
      cl.sync();                                   // every CTA has written its slice
    } else {
      __syncthreads();
    }
  }
}

__device__ __forceinline__ void bulk_store(void* gdst, const void* ssrc, int bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(ssrc));
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(gdst), "r"(s), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Block b's plan into k (the same in every thread); false for a RAW block.
__device__ __forceinline__ bool load_block(int b, Block& k, const Args& a) {
  k.dn = __ldg(a.dense + b);
  // A table of rows: resident blocks read in place.  (Clipped in 32 bits: a
  // 64-bit clip made the bench's launch 1.5% slower.)
  int row = b;
  if (a.src_row != nullptr) row = min(max(__ldg(a.src_row + b), 0), a.comp_n - 1);
  k.cp = a.comp + static_cast<long long>(row) * a.comp_stride;
  if (k.dn < 0) return false;
  // Pass bounds, clamped to the wire so a malformed plan cannot read past it.
  k.base = __ldg(a.p_off + b);
  long long np = __ldg(a.p_used + b);
  if (k.base < 0) np = 0;
  if (np > a.s_rows - k.base) np = a.s_rows - k.base;
  if (np < 0) np = 0;
  k.npass = static_cast<int>(np);
  int nc = __ldg(a.p0 + b);
  k.ncomp = nc < 0 ? 0 : (nc > k.npass ? k.npass : nc);
  k.di = __ldg(a.dq_idx + b);
  k.dense_on = k.dn > 0 && k.di >= 0 && k.di < a.dq_rows;
  return true;
}

// Block b on the shared route, by class (the CTA's threads all take the
// same branch).
__device__ void decode_block(int b, uint32_t* plane, const Cells& cells, const Args& a) {
  const int out_len = a.out_rows * kLanes;
  Block k;
  uint8_t* out = a.out + static_cast<long long>(b) * out_len;
  if (!load_block(b, k, a)) {   // RAW: the output is the comp plane
    copy_raw(k.cp, out, 0, out_len, out_len, a);
    return;
  }
  if (k.ncomp == k.npass) {     // no out pass: straight to device memory
    sweep_tiles(k, reinterpret_cast<uint32_t*>(out), a, 0, a.out_rows / kLanes);
    return;
  }
  // The plane may still be read by the previous block's bulk store.
  if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  __syncthreads();
  sweep_tiles(k, plane, a, 0, a.out_rows / kLanes);
  stage_cells(k, k.ncomp, 0, cells, a);
  __syncthreads();
  out_passes(k, plane, cells, a);
  // The plane's generic-proxy writes, made visible to the bulk store.
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (threadIdx.x == 0) bulk_store(out, plane, out_len);
}

// Block b, which has out passes, in the cluster kernel: this CTA's rows.
__device__ void decode_out_block(int b, uint32_t* slice, const Cells& cells, const Slice& s,
                                 const Args& a) {
  const int out_len = a.out_rows * kLanes;
  Block k;
  load_block(b, k, a);
  if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  __syncthreads();
  sweep_tiles(k, slice, a, s.row0 / kLanes, s.rows / kLanes);
  const bool live = __syncthreads_or(stage_slice_cells(k, k.ncomp, 0, cells, s, a));
  cg::this_cluster().sync();    // every slice swept: the first pass may read any
  out_passes_cluster(k, slice, cells, s, live, a);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (threadIdx.x == 0)
    bulk_store(a.out + static_cast<long long>(b) * out_len + s.row0 * kLanes, slice,
               s.rows * kLanes);
}

// Shared memory: the plane (the cluster kernel: the CTA's slice), the
// queue's slots (16 bytes), two passes' cells.
__device__ __forceinline__ Cells cells_after(int* next, int rows) {
  return {next + 4, reinterpret_cast<uint16_t*>(next + 4 + 2 * rows)};
}

// The shared route (planes of up to 1024 rows): one CTA a block.
__global__ void __launch_bounds__(kThreads, 1) decode_flat_kernel_shared(Args a) {
  extern __shared__ __align__(16) uint32_t plane[];
  int* next = reinterpret_cast<int*>(plane + a.out_rows * kLanes / 4);
  const Cells cells = cells_after(next, a.out_rows);
  // The first block is the CTA's own index; each later one is taken from
  // the queue when the block before it ends.  (Taking it while that block
  // runs hides the atomic's latency but fixes the CTA's next block before
  // it knows how long this one takes: batches that mix RAW copies with
  // decodes then end up to 1.5x slower.)
  int b = blockIdx.x;
  for (int it = 0; b < a.n; ++it) {
    decode_block(b, plane, cells, a);
    if (threadIdx.x == 0) next[it & 1] = static_cast<int>(gridDim.x) + atomicAdd(a.queue, 1);
    __syncthreads();
    b = next[it & 1];
  }
  if (threadIdx.x == 0) {
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    // The last CTA to finish sets the queue back to 0 for the stream's next
    // launch: every other CTA has taken its last block by then.
    __threadfence();
    if (atomicAdd(a.queue + 1, 1) == static_cast<int>(gridDim.x) - 1) {
      a.queue[0] = 0;
      a.queue[1] = 0;
    }
  }
}

// The tall route's first kernel (planes of 1025 to 8192 rows): each block
// in a.parts parts of its 1024-row slices (1 when there are at least as
// many blocks as CTAs, else as many as keep every CTA busy), the n * parts
// parts shared out in block order among persistent CTAs on every SM, a
// CTA's run [i U / G, (i + 1) U / G).  RAW and no-out-pass slices are
// copied or swept straight to device memory (a CTA pays a block's plan and
// first loads once for its run); a block with out passes is only listed,
// at its part 0, for the cluster kernel: list[count++], count being
// queue[2].
__global__ void __launch_bounds__(kThreads, 1) decode_flat_kernel_slices(Args a) {
  const int ctas = (a.out_rows + kSliceRows - 1) / kSliceRows;
  const int out_len = a.out_rows * kLanes;
  const long long units = static_cast<long long>(a.n) * a.parts;
  const long long u0 = units * blockIdx.x / gridDim.x, u1 = units * (blockIdx.x + 1) / gridDim.x;
  int cur = -1;
  Block k;
  bool raw = false;
  for (long long u = u0; u < u1; ++u) {
    const int b = static_cast<int>(u / a.parts), part = static_cast<int>(u % a.parts);
    if (b != cur) {
      cur = b;
      raw = !load_block(b, k, a);
    }
    uint8_t* out = a.out + static_cast<long long>(b) * out_len;
    if (!raw && k.ncomp < k.npass) {
      if (part == 0 && threadIdx.x == 0) a.list[atomicAdd(a.queue + 2, 1)] = b;
      continue;
    }
    for (int r = part * ctas / a.parts; r < (part + 1) * ctas / a.parts; ++r) {
      const int row0 = r * kSliceRows, rows = min(kSliceRows, a.out_rows - row0);
      if (raw)
        copy_raw(k.cp, out, row0 * kLanes, (row0 + rows) * kLanes, out_len, a);
      else
        sweep_tiles(k, reinterpret_cast<uint32_t*>(out + row0 * kLanes), a, row0 / kLanes,
                    rows / kLanes);
    }
  }
}

// The tall route's second kernel: the listed blocks (those with out passes),
// one cluster a block.  A cluster's next block is taken by its rank-0 CTA
// (one atomic a block) and written into every CTA's slot before the
// barrier.
__global__ void __launch_bounds__(kThreads, 1) decode_flat_kernel_cluster(Args a) {
  extern __shared__ __align__(16) uint32_t plane[];
  int* next = reinterpret_cast<int*>(plane + kSliceRows * kLanes / 4);
  const Cells cells = cells_after(next, kSliceRows);
  const cg::cluster_group cl = cg::this_cluster();
  const int ctas = static_cast<int>(cl.num_blocks());
  const int clusters = static_cast<int>(gridDim.x) / ctas;
  Slice s;
  s.rank = static_cast<int>(cl.block_rank());
  s.row0 = s.rank * kSliceRows;
  s.rows = min(kSliceRows, a.out_rows - s.row0);
  const int listed = a.queue[2];    // written by the first kernel
  if (listed == 0) return;          // no block with out passes: the queue is still 0
  for (int it = 0;; ++it) {
    if (s.rank == 0 && threadIdx.x == 0) {
      const int j = atomicAdd(a.queue, 1);
      const int b = j < listed ? a.list[j] : -1;
      for (int r = 0; r < ctas; ++r) *cl.map_shared_rank(next + (it & 1), r) = b;
    }
    cl.sync();                  // also: no CTA reads another's slice past here
    const int b = next[it & 1];
    if (b < 0) break;
    decode_out_block(b, plane, cells, s, a);
  }
  if (threadIdx.x == 0) {
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    // The last cluster to finish sets the queue and the list's count back
    // to 0: every cluster has taken its last entry by then.
    if (s.rank == 0) {
      __threadfence();
      if (atomicAdd(a.queue + 1, 1) == clusters - 1) {
        a.queue[0] = 0;
        a.queue[1] = 0;
        a.queue[2] = 0;
      }
    }
  }
}

}  // namespace

// CTAs that decode one block of an `out_rows`-row plane: 1 on the shared
// route (up to 1024 rows), else the cluster route's ceil(out_rows / 1024);
// 0 past a cluster of 8 slices (8192 rows).
extern "C" int bt_decode_flat_cluster_ctas(int out_rows) {
  if (out_rows <= 0 || out_rows > kSliceRows * kMaxCluster) return 0;
  return out_rows <= kSliceRows ? 1 : (out_rows + kSliceRows - 1) / kSliceRows;
}

namespace {

constexpr int kHeights = kSliceRows / kLanes;   // plane heights of the shared route: 8
constexpr int kCachedDevices = 64;

// Dynamic shared memory of the shared kernel for planes of out_rows (the
// plane, the queue slots, two passes' cells: int32 shift, int16 se) and of
// the cluster kernel (a 1024-row slice of the plane, the same).
constexpr int shared_smem(int out_rows) { return out_rows * kLanes + 16 + 2 * out_rows * 6; }
constexpr int kClusterSmem = shared_smem(kSliceRows);

// What the card answers the same on every launch of the process, per
// device: its SM count, the resident CTAs per SM of the shared kernel at
// each plane height and of the slice kernel, and the cluster kernel's
// resident clusters at each cluster size.  Each is asked once (with the
// kernel's shared-memory opt-in before it) and kept as value + 1, so 0 is
// "not asked yet"; two threads that ask at once keep the same answer.
struct DeviceShape {
  std::atomic<int> sms;
  std::atomic<int> shared_per_sm[kHeights + 1];     // by out_rows / 128
  std::atomic<int> slices_per_sm;
  std::atomic<int> clusters[kMaxCluster + 1];       // by cluster CTAs
};
DeviceShape g_shapes[kCachedDevices];               // static: zero, nothing asked

// The kept answer of `slot`, else `ask(&value)`'s (a CUDA call on the
// current device), kept when it succeeds.
template <typename Ask>
cudaError_t kept(std::atomic<int>& slot, int* value, Ask ask) {
  const int v = slot.load(std::memory_order_relaxed);
  if (v > 0) {
    *value = v - 1;
    return cudaSuccess;
  }
  const cudaError_t err = ask(value);
  if (err == cudaSuccess) slot.store(*value + 1, std::memory_order_relaxed);
  return err;
}

// The cluster kernel's launch for planes of out_rows on `stream`: grid (one
// cluster; the caller sets how many), block, shared memory, cluster size.
void cluster_launch(int out_rows, cudaStream_t stream, cudaLaunchConfig_t* cfg,
                    cudaLaunchAttribute* attr) {
  *cfg = {};
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = bt_decode_flat_cluster_ctas(out_rows);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->gridDim = dim3(attr->val.clusterDim.x);
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = kClusterSmem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// Clusters of the cluster kernel for planes of out_rows (2 or more CTAs)
// that can be resident at once on the current device, `shape`'s.
cudaError_t resident_clusters(DeviceShape& shape, int out_rows, int* clusters) {
  return kept(shape.clusters[bt_decode_flat_cluster_ctas(out_rows)], clusters, [&](int* v) {
    cudaError_t err = bt::smem_opt_in(decode_flat_kernel_cluster, bt::kSmemMax);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cluster_launch(out_rows, nullptr, &cfg, &attr);
    return cudaOccupancyMaxActiveClusters(v, decode_flat_kernel_cluster, &cfg);
  });
}

// A launch settled but for its output, block queue, list and stream: the
// kernels' arguments and grids, on one device.  Made by
// bt_decode_flat_prepare into a buffer of bt_decode_flat_launch_bytes()
// that the caller owns, launched by bt_decode_flat_run as often as wanted.
struct Launch {
  Args a;                 // out, queue and list are the run's
  int device;
  int grid;               // the shared kernel's CTAs, or the slice kernel's
  int cluster_grid;       // the cluster kernel's CTAs (tall route)
};

}  // namespace

// Clusters of the tall route's kernel for planes of out_rows that can be
// resident at once on the current device (GPCs, not SMs, bound it), or a
// negative CUDA error code.
extern "C" int bt_decode_flat_resident_clusters(int out_rows) {
  if (bt_decode_flat_cluster_ctas(out_rows) < 2) return -static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, clusters = 0;
  cudaError_t err = cudaGetDevice(&dev);
  DeviceShape scratch{};
  if (err == cudaSuccess)
    err = resident_clusters(dev < kCachedDevices ? g_shapes[dev] : scratch, out_rows, &clusters);
  return err == cudaSuccess ? clusters : -static_cast<int>(err);
}

extern "C" int bt_decode_flat_launch_bytes() { return static_cast<int>(sizeof(Launch)); }

// Settles a launch on `device` into `record` (bt_decode_flat_launch_bytes()
// bytes, 8-byte aligned): checks the arguments, fills the kernels'
// arguments and sizes the grids from the device's kept shape.  Block b reads
// comp row b, or with `src_row` (n ints) row src_row[b] of the comp_n rows
// (clipped to them), so blocks resident in a larger buffer decode where
// they lie.  Planes of up to 1024 rows: the shared route's persistent CTAs,
// as many as can be resident, at most n.  Taller planes: the slice kernel on
// every SM, then the cluster kernel, as many clusters as can be resident, at
// most n.  Pointers are device pointers; `dq` is 8-byte aligned.  Returns
// the CUDA error code (0 on success).
extern "C" int bt_decode_flat_prepare(
    void* record, const void* comp, long long comp_stride, int comp_width, int comp_rows,
    const void* p_used, const void* p_off, const void* p0, const void* dense,
    const void* dq_idx, const void* se, const void* shift, long long s_rows,
    const void* dq, int dq_rows, const void* row_a, int dcap, int n, int out_rows,
    const void* src_row, long long comp_n, int device) {
  const int ctas = bt_decode_flat_cluster_ctas(out_rows);
  if (ctas == 0 || out_rows % kLanes != 0 || device < 0 ||
      comp_rows <= 0 || comp_rows > (1 << 24) || dcap <= 0 || n < 0 ||
      (reinterpret_cast<uintptr_t>(dq) & 7) != 0 ||
      (src_row != nullptr && (comp_n <= 0 || comp_n > INT32_MAX)))
    return static_cast<int>(cudaErrorInvalidValue);
  Launch& l = *static_cast<Launch*>(record);
  l = {};
  Args& a = l.a;
  a.comp = static_cast<const uint8_t*>(comp);
  a.comp_stride = comp_stride;
  a.src_row = static_cast<const int32_t*>(src_row);
  a.comp_n = static_cast<int>(comp_n);
  a.comp_width = comp_width;
  a.comp_len = comp_rows * kLanes;
  a.p_used = static_cast<const int32_t*>(p_used);
  a.p_off = static_cast<const int32_t*>(p_off);
  a.p0 = static_cast<const int32_t*>(p0);
  a.dense = static_cast<const int32_t*>(dense);
  a.dq_idx = static_cast<const int32_t*>(dq_idx);
  a.se = static_cast<const int16_t*>(se);
  a.shift = static_cast<const int32_t*>(shift);
  a.s_rows = s_rows;
  a.dq = static_cast<const int16_t*>(dq);
  a.dq_rows = dq_rows;
  a.row_a = static_cast<const int32_t*>(row_a);
  a.dcap = dcap;
  a.out_rows = out_rows;
  a.n = n;
  a.parts = 1;
  l.device = device;
  if (n == 0) return 0;
  int previous = 0, sms = 0, per_sm = 0;
  cudaError_t err = bt::enter_device(device, &previous);
  if (err != cudaSuccess) return static_cast<int>(err);
  DeviceShape scratch{};
  DeviceShape& shape = device < kCachedDevices ? g_shapes[device] : scratch;
  err = kept(shape.sms, &sms, [&](int* v) {
    return cudaDeviceGetAttribute(v, cudaDevAttrMultiProcessorCount, device);
  });
  if (err == cudaSuccess && ctas == 1) {
    err = kept(shape.shared_per_sm[out_rows / kLanes], &per_sm, [&](int* v) {
      const cudaError_t e = bt::smem_opt_in(decode_flat_kernel_shared, bt::kSmemMax);
      return e != cudaSuccess ? e : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          v, decode_flat_kernel_shared, kThreads, shared_smem(out_rows));
    });
    l.grid = per_sm < 1 ? 1 : (n < per_sm * sms ? n : per_sm * sms);
  } else if (err == cudaSuccess) {
    int clusters = 0;
    err = kept(shape.slices_per_sm, &per_sm, [&](int* v) {
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(v, decode_flat_kernel_slices,
                                                           kThreads, 0);
    });
    if (err == cudaSuccess) err = resident_clusters(shape, out_rows, &clusters);
    if (err == cudaSuccess && clusters < 1) err = cudaErrorLaunchOutOfResources;
    const int ctas_on_card = per_sm < 1 ? 1 : per_sm * sms;
    a.parts = std::max(1, std::min(ctas, ctas_on_card / n));
    l.grid = static_cast<int>(std::min<long long>(static_cast<long long>(n) * a.parts,
                                                  ctas_on_card));
    l.cluster_grid = ctas * (n < clusters ? n : clusters);
  }
  if (previous != device) cudaSetDevice(previous);
  return static_cast<int>(err);
}

// Launches a prepared `record` on `stream` into `out` (n * out_rows * 128
// bytes, 16-byte aligned), reading `comp` in place of the prepared rows
// when not null (rows laid out as those: width, stride, count).  `queue`
// (three ints) must be 0 and is 0 again when the launch ends, so launches
// that share a queue must run in turn, as on one stream; the tall route
// takes `list` (n ints).  Returns the CUDA error code (0 on success), also
// when the card refuses the cluster launch.
extern "C" int bt_decode_flat_run(const void* record, const void* comp, void* out, void* queue,
                                  void* list, void* stream) {
  const Launch& l = *static_cast<const Launch*>(record);
  const bool tall = bt_decode_flat_cluster_ctas(l.a.out_rows) > 1;
  if ((reinterpret_cast<uintptr_t>(out) & 15) != 0 || (tall && list == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (l.a.n == 0) return 0;
  Args a = l.a;
  if (comp != nullptr) a.comp = static_cast<const uint8_t*>(comp);
  a.out = static_cast<uint8_t*>(out);
  a.queue = static_cast<int*>(queue);
  a.list = static_cast<int*>(list);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int previous = 0;
  cudaError_t err = bt::enter_device(l.device, &previous);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!tall) {
    decode_flat_kernel_shared<<<l.grid, kThreads, shared_smem(a.out_rows), st>>>(a);
    err = cudaGetLastError();
  } else {
    decode_flat_kernel_slices<<<l.grid, kThreads, 0, st>>>(a);
    if ((err = cudaGetLastError()) == cudaSuccess) {
      cudaLaunchConfig_t cfg;
      cudaLaunchAttribute attr;
      cluster_launch(a.out_rows, st, &cfg, &attr);
      cfg.gridDim = dim3(l.cluster_grid);
      if ((err = cudaLaunchKernelEx(&cfg, decode_flat_kernel_cluster, a)) == cudaSuccess)
        err = cudaGetLastError();
    }
  }
  if (previous != l.device) cudaSetDevice(previous);
  return static_cast<int>(err);
}

// One launch on the current device (bt_decode_flat_prepare, then
// bt_decode_flat_run): the caller allocates `out`, on the tall route `list`
// (n ints), and `queue`.  Returns the CUDA error code (0 on success).
extern "C" int bt_decode_flat_launch(
    const void* comp, long long comp_stride, int comp_width, int comp_rows,
    const void* p_used, const void* p_off, const void* p0, const void* dense,
    const void* dq_idx, const void* se, const void* shift, long long s_rows,
    const void* dq, int dq_rows, const void* row_a, int dcap, void* out, int n,
    int out_rows, void* queue, void* list, const void* src_row, long long comp_n,
    void* stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  Launch l;
  const int rc = bt_decode_flat_prepare(&l, comp, comp_stride, comp_width, comp_rows, p_used,
                                        p_off, p0, dense, dq_idx, se, shift, s_rows, dq,
                                        dq_rows, row_a, dcap, n, out_rows, src_row, comp_n, dev);
  return rc != 0 ? rc : bt_decode_flat_run(&l, nullptr, out, queue, list, stream);
}
