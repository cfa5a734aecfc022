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

#include <cstdint>

#include "cuda_util.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 1024;
constexpr int kRowsPerWarp = kMaxRows / kWarps;   // 32
constexpr int kRowWords = 33;                     // a plane row: 32 words and one of padding
constexpr int kMaxClassed = 4096;                 // passes the prologue classes; later ones read the plane
constexpr int kOrderBuckets = 4096;               // pass counts the block order tells apart
constexpr unsigned kFull = 0xffffffffu;

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
  int* queue;                   // [next block to take, CTAs done]: 0 at launch
};

// Shared memory: the padded plane, one pass's cells, the pass classes, the
// next block.
struct Smem {
  uint32_t* plane;              // [out_rows][kRowWords]
  int32_t* se;                  // [out_rows]
  int32_t* shift;               // [out_rows]
  uint32_t* reads;              // [kMaxClassed / 32]: bit k set when pass k reads the plane
  int* next;                    // [2]
};

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

__device__ __forceinline__ uint32_t plane_byte(const uint32_t* plane, uint32_t row,
                                               uint32_t lane) {
  return reinterpret_cast<const uint8_t*>(plane)[row * (4 * kRowWords) + lane];
}

// S[row][lane] of block comp.
__device__ __forceinline__ uint32_t s_byte(const uint8_t* comp, const uint32_t* plane,
                                           const Args& a, uint32_t row, uint32_t lane) {
  if (row < static_cast<uint32_t>(a.comp_rows)) return __ldg(comp + row * 128u + lane);
  row -= a.comp_rows;
  if (row < static_cast<uint32_t>(a.out_rows)) return plane_byte(plane, row, lane);
  return 0;
}

__device__ __forceinline__ bool is_plane_pass(const Smem& s, int k) {
  return k >= kMaxClassed || ((s.reads[k >> 5] >> (k & 31)) & 1u);
}

// One comp-only pass on row r.  In the usual cell (q does not wrap, the
// anchor is not capped) every active lane reads S at q itself, so the row
// takes S[q0 .. q0 + n) in one piece: comp bytes, or zeros above the out
// region (a comp-only pass reads no out row).  It is copied 16 bytes at a
// time from at most five aligned comp words, all loaded before any is used;
// any other cell goes byte by byte.
__device__ __forceinline__ void comp_pass_row(const uint8_t* comp, uint8_t* row, const Cell& c,
                                              const Smem& s, const Args& a) {
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
      v[j] = l0 + j < c.hi ? s_byte(comp, s.plane, a, src, q & 127u) : 0u;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (l0 + j < c.hi) row[l0 + j] = static_cast<uint8_t>(v[j]);
  }
}

// Passes [k, k_end), all comp-only, applied by thread r to row r in order.
__device__ void comp_passes(const uint8_t* comp, const int32_t* se_b, const int32_t* sh_b,
                            int k, int k_end, const Smem& s, const Args& a) {
  const int r = threadIdx.x;
  if (r >= a.out_rows) return;
  uint8_t* row = reinterpret_cast<uint8_t*>(s.plane + r * kRowWords);
  uint32_t n_se = 0, n_sh = 0;
  if (k < k_end) {
    n_se = __ldg(se_b + static_cast<long long>(k) * a.out_rows + r);
    n_sh = __ldg(sh_b + static_cast<long long>(k) * a.out_rows + r);
  }
  for (; k < k_end; ++k) {
    const uint32_t se = n_se, sh = n_sh;
    if (k + 1 < k_end) {          // the next pass's cell, in flight during this one
      n_se = __ldg(se_b + static_cast<long long>(k + 1) * a.out_rows + r);
      n_sh = __ldg(sh_b + static_cast<long long>(k + 1) * a.out_rows + r);
    }
    const Cell c = cell_of(se, sh, r);
    if (c.lo < c.hi) comp_pass_row(comp, row, c, s, a);
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
        const uint32_t byte = s_byte(comp, s.plane, a, src, q[j] & 127u);
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

__device__ void decode_block(int b, const Smem& s, const Args& a) {
  const uint8_t* comp = a.comp + static_cast<long long>(b) * a.comp_rows * 128;
  const long long cells = static_cast<long long>(a.passes) * a.out_rows;
  const int32_t* se_b = a.se + b * cells;
  const int32_t* sh_b = a.shift + b * cells;
  const int np = max(0, min(__ldg(a.p_used + b), a.passes));
  const int r = threadIdx.x;
  if (r < a.out_rows)                              // each thread zeroes its own row
    for (int w = 0; w < kRowWords; ++w) s.plane[r * kRowWords + w] = 0;
  for (int w = threadIdx.x; w < kMaxClassed / 32; w += kThreads) s.reads[w] = 0;
  __syncthreads();
  // Prologue: the class of every pass (up to kMaxClassed).
  if (r < a.out_rows) {           // whole warps: out_rows is a multiple of 128
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
  for (int k = 0; k < np;) {
    if (is_plane_pass(s, k)) {
      plane_pass(comp, se_b, sh_b, k, s, a);       // its staging barrier orders earlier writes
      synced = false;
      ++k;
    } else {
      int k_end = k + 1;
      while (k_end < np && !is_plane_pass(s, k_end)) ++k_end;
      if (!synced) __syncthreads();                // the plane pass's writes, other rows
      comp_passes(comp, se_b, sh_b, k, k_end, s, a);
      synced = false;
      k = k_end;
    }
  }
  __syncthreads();
  // The plane out, 16 bytes a thread: row i / 8, words 4 (i % 8) ... + 3.
  uint4* dst = reinterpret_cast<uint4*>(a.out + static_cast<long long>(b) * a.out_rows * 128);
  for (int i = threadIdx.x; i < a.out_rows * 8; i += kThreads) {
    const uint32_t* w = s.plane + (i >> 3) * kRowWords + 4 * (i & 7);
    dst[i] = make_uint4(w[0], w[1], w[2], w[3]);
  }
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

__global__ void __launch_bounds__(kThreads, 1) decode_planned_kernel(Args a) {
  extern __shared__ __align__(16) uint32_t smem[];
  Smem s;
  s.plane = smem;
  s.se = reinterpret_cast<int32_t*>(smem + a.out_rows * kRowWords);
  s.shift = s.se + a.out_rows;
  s.reads = reinterpret_cast<uint32_t*>(s.shift + a.out_rows);
  s.next = reinterpret_cast<int*>(s.reads + kMaxClassed / 32);
  // The first block is the CTA's own index in the order; each later one is
  // taken from the queue once the block before it ends.
  int i = blockIdx.x;
  for (int it = 0; i < a.n; ++it) {
    decode_block(__ldg(a.order + i), s, a);
    if (threadIdx.x == 0) s.next[it & 1] = static_cast<int>(gridDim.x) + atomicAdd(a.queue, 1);
    __syncthreads();
    i = s.next[it & 1];
  }
  if (threadIdx.x == 0) {
    // The last CTA to finish sets the queue back to 0 for the stream's next
    // launch: every other CTA has taken its last block by then.
    __threadfence();
    if (atomicAdd(a.queue + 1, 1) == static_cast<int>(gridDim.x) - 1) {
      a.queue[0] = 0;
      a.queue[1] = 0;
    }
  }
}

}  // namespace

// Launches the block order (one CTA, into `order`, n ints) and then the
// persistent CTAs (as many as fit, at most n) on `stream` of `device`;
// returns the CUDA error code (0 on success).  Pointers are device
// pointers; the caller allocates `out` (16-byte aligned), `order` and the
// two ints of `queue`, which must be 0 and are 0 again when the launch ends
// (so launches that share a queue must run in turn, as on one stream).
extern "C" int bt_decode_planned_launch(const void* comp, int comp_rows, const void* p_used,
                                        const void* se, const void* shift, int passes,
                                        void* order, void* out, int n, int out_rows,
                                        void* queue, int device, void* stream) {
  if (n < 0 || comp_rows < 0 || passes < 0 || out_rows <= 0 || out_rows % 128 ||
      out_rows > kMaxRows || device < 0 || (reinterpret_cast<uintptr_t>(out) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = out_rows * kRowWords * 4 + out_rows * 8 + kMaxClassed / 8 + 16;
  const int smem_max = kMaxRows * kRowWords * 4 + kMaxRows * 8 + kMaxClassed / 8 + 16;
  // Opt in to the largest plane, so launches of other block sizes from
  // other threads never meet a smaller limit.
  int sms = 0, per_sm = 0;
  if ((err = bt::smem_opt_in(decode_planned_kernel, smem_max)) == cudaSuccess &&
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) ==
          cudaSuccess &&
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, decode_planned_kernel,
                                                           kThreads, smem)) == cudaSuccess) {
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
    const int grid = per_sm < 1 ? 1 : (n < per_sm * sms ? n : per_sm * sms);
    decode_planned_order_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        a.p_used, passes, n, static_cast<int32_t*>(order));
    err = cudaGetLastError();
    if (err == cudaSuccess) {
      decode_planned_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
      err = cudaGetLastError();
    }
  }
  if (current != device) cudaSetDevice(current);
  return static_cast<int>(err);
}
