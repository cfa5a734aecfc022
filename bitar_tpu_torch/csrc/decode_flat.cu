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
//
// Planes taller than 1024 rows (blocks of 256 KiB to 1 MiB: 8192 rows, 256
// words a thread) take the device-memory route, a second instantiation of
// the same kernel (kGlobal).  RAW blocks and blocks with no out pass are
// what they are on the shared route; the sweep walks the plane's tiles
// eight at a time.  A block with out passes is swept into its own output
// row, and each out pass gathers the new value of every word it writes into
// the CTA's scratch row in device memory, __syncthreads(), writes them to
// the output row, __syncthreads(): every read sees the plane as it stood
// before the pass (a CTA's global writes are visible to its threads after
// the barrier).  A pass moves ~3x the bytes it writes (read source, write
// and read scratch, write plane) through L2 instead of shared memory; no
// bulk store.  Holding the plane in a cluster's distributed shared memory is
// the Hopper design for a later version.

#include <cstdint>

#include "cuda_util.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxWords = 32;     // words per thread of the shared route: 1024 rows * 32 / 1024
constexpr int kGroup = 4;         // tiles whose words a thread sweeps at once
constexpr int kRawBatch = 4;      // 16-byte chunks a thread loads at once in a RAW copy
constexpr int kLanes = 128;
constexpr int kMaxRows = 65536;   // 8 MiB planes: every index inside a plane fits an int

struct Args {
  const uint8_t* comp;            // [n] rows of comp_stride bytes
  long long comp_stride;
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
  int* queue;                     // [next block to take, CTAs done]: 0 at launch
  uint32_t* scratch;              // device-memory route: [grid, out_rows * 32] words
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

// RAW block: out[p] = comp[p] below min(comp_len, comp_width), 0 after.
// Each thread loads kRawBatch of its chunks before it stores any, so that
// many loads are in flight.
__device__ void copy_raw(const uint8_t* cp, uint8_t* out, int out_len, const Args& a) {
  const int lim = min(min(a.comp_len, a.comp_width), out_len);
  const uintptr_t align = reinterpret_cast<uintptr_t>(cp);
  if ((align & 15) == 0) {
    uint4* o = reinterpret_cast<uint4*>(out);
    const uint4* s = reinterpret_cast<const uint4*>(cp);
    for (int i0 = threadIdx.x; i0 < out_len / 16; i0 += kRawBatch * kThreads) {
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
        if (i0 + r * kThreads < out_len / 16) o[i0 + r * kThreads] = v[r];
    }
    return;
  }
  uint32_t* o = reinterpret_cast<uint32_t*>(out);
  const bool words = (align & 3) == 0;
  for (int w0 = threadIdx.x; w0 < out_len / 4; w0 += kRawBatch * kThreads) {
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
      if (w0 + r * kThreads < out_len / 4) o[w0 + r * kThreads] = v[r];
  }
}

// Dense and comp passes for the thread's words into dst (the shared plane
// or the block's output row).  Word i of thread t (w = t + 1024 i) lies in
// row r = t / 32 + 32 (i & 3) of tile i >> 2 (a tile is 128 rows), so the
// sweep takes the four row classes g = i & 3 in turn and, within one, its
// words of kGroup tiles at once.  A warp's word covers one row: lane l
// holds the row's anchor of dense pass l + 1 in every tile (row_a keeps a
// row's tiles together, so that is one 32-byte sector, loaded once), and
// each byte takes its pass's anchor by a shuffle.
//
// Tiles [t0, t0 + nt) of the plane, nt <= 8 (the shared route sweeps its
// 1-8 tiles in one call, the device-memory route in octets).
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
        if (c0 + cc < nt) dst[threadIdx.x + (4 * (t0 + c0 + cc) + g) * kThreads] = v[cc];
    }
  }
}

template <bool kGlobal>
__device__ void sweep(const Block& k, uint32_t* dst, const Args& a) {
  const int tiles = a.out_rows / kLanes;           // 1 to 8 on the shared route
  if constexpr (kGlobal) {
#pragma unroll 1
    for (int t0 = 0; t0 < tiles; t0 += 8) sweep_tiles(k, dst, a, t0, min(8, tiles - t0));
  } else {
    sweep_tiles(k, dst, a, 0, tiles);
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

// Out passes on the block's output row in device memory (the device-memory
// route): per pass, the new value of every word the pass writes goes to the
// CTA's scratch row, barrier, the scratch words go to the plane, barrier.
// A thread reads back only the scratch words it wrote itself; the plane is
// read with plain loads (it is written during the kernel, so never __ldg).
__device__ void out_passes_global(const Block& k, uint32_t* plane, uint32_t* scratch,
                                  const Args& a) {
  const int out_words = a.out_rows * (kLanes / 4);
  const int out_len = a.out_rows * kLanes;
  const uint8_t* pb = reinterpret_cast<const uint8_t*>(plane);
  for (int kk = k.ncomp; kk < k.npass; ++kk) {
    const long long wire = (k.base + kk) * a.out_rows;
#pragma unroll 4
    for (int w = threadIdx.x; w < out_words; w += kThreads) {
      const int row = w >> 5;
      const int lane0 = (w & 31) * 4;
      const uint32_t s = static_cast<uint16_t>(__ldg(a.se + wire + row));
      const int start = (s >> 8) & 0x7F, end = s & 0xFF;
      if (start < lane0 + 4 && end > lane0 && start < end) {
        const long long sh = __ldg(a.shift + wire + row);
        uint32_t v = plane[w];
        for (int j = 0; j < 4; ++j) {
          const int lane = lane0 + j;
          if (lane >= start && lane < end) {
            long long q = w * 4LL + j + sh;
            q = q < 0 ? 0 : (q >= out_len ? out_len - 1 : q);
            v = set_byte(v, j, pb[q]);
          }
        }
        scratch[w] = v;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int w = threadIdx.x; w < out_words; w += kThreads) {
      const int lane0 = (w & 31) * 4;
      const uint32_t s = static_cast<uint16_t>(__ldg(a.se + wire + (w >> 5)));
      const int start = (s >> 8) & 0x7F, end = s & 0xFF;
      if (start < lane0 + 4 && end > lane0 && start < end) plane[w] = scratch[w];
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void bulk_store(void* gdst, const void* ssrc, int bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(ssrc));
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(gdst), "r"(s), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Block b, by class (the CTA's threads all take the same branch).
template <bool kGlobal>
__device__ void decode_block(int b, uint32_t* plane, const Cells& cells, const Args& a) {
  const int out_len = a.out_rows * kLanes;
  Block k;
  k.cp = a.comp + static_cast<long long>(b) * a.comp_stride;
  uint8_t* out = a.out + static_cast<long long>(b) * out_len;
  k.dn = __ldg(a.dense + b);
  if (k.dn < 0) {               // RAW: the output is the comp plane
    copy_raw(k.cp, out, out_len, a);
    return;
  }
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
  if (k.ncomp == k.npass) {     // no out pass: straight to device memory
    sweep<kGlobal>(k, reinterpret_cast<uint32_t*>(out), a);
    return;
  }
  if constexpr (kGlobal) {      // out passes on the output row itself
    uint32_t* row = reinterpret_cast<uint32_t*>(out);
    sweep<true>(k, row, a);
    __syncthreads();
    out_passes_global(k, row, a.scratch + static_cast<long long>(blockIdx.x) * out_len / 4, a);
  } else {
    // The plane may still be read by the previous block's bulk store.
    if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    __syncthreads();
    sweep<false>(k, plane, a);
    stage_cells(k, k.ncomp, 0, cells, a);
    __syncthreads();
    out_passes(k, plane, cells, a);
    // The plane's generic-proxy writes, made visible to the bulk store.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0) bulk_store(out, plane, out_len);
  }
}

// kGlobal: the device-memory route (planes taller than kMaxWords allows);
// its shared memory holds only the queue's two slots.
template <bool kGlobal>
__global__ void __launch_bounds__(kThreads, 1) decode_flat_kernel(Args a) {
  // Shared memory: the plane, the queue's two slots (16 bytes), the cells.
  extern __shared__ __align__(16) uint32_t plane[];
  const int out_len = kGlobal ? 0 : a.out_rows * kLanes;
  int* next = reinterpret_cast<int*>(plane + out_len / 4);
  const Cells cells = {next + 4, reinterpret_cast<uint16_t*>(next + 4 + 2 * a.out_rows)};
  // The first block is the CTA's own index; each later one is taken from
  // the queue when the block before it ends.  (Taking it while that block
  // runs hides the atomic's latency but fixes the CTA's next block before
  // it knows how long this one takes: batches that mix RAW copies with
  // decodes then end up to 1.5x slower.)
  int b = blockIdx.x;
  for (int it = 0; b < a.n; ++it) {
    decode_block<kGlobal>(b, plane, cells, a);
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

}  // namespace

// Rows of the largest plane the shared-memory route holds; taller planes
// take the device-memory route.
extern "C" int bt_decode_flat_shared_rows() { return kThreads * kMaxWords / (kLanes / 4); }

// Launches the persistent CTAs on `stream` (as many as fit on the device,
// at most n; on the device-memory route also at most scratch_ctas); returns
// the CUDA error code (0 on success).  Pointers are device pointers; the
// caller allocates `out`, the two ints of `queue`, which must be 0 and are
// 0 again when the launch ends (so launches that share a queue must run in
// turn, as on one stream), and for planes taller than
// bt_decode_flat_shared_rows() rows `scratch`, scratch_ctas rows of
// out_rows * 128 bytes.
extern "C" int bt_decode_flat_launch(
    const void* comp, long long comp_stride, int comp_width, int comp_rows,
    const void* p_used, const void* p_off, const void* p0, const void* dense,
    const void* dq_idx, const void* se, const void* shift, long long s_rows,
    const void* dq, int dq_rows, const void* row_a, int dcap, void* out, int n,
    int out_rows, void* queue, void* scratch, int scratch_ctas, void* stream) {
  const bool global = out_rows > bt_decode_flat_shared_rows();
  if (out_rows <= 0 || out_rows % kLanes != 0 || out_rows > kMaxRows ||
      comp_rows <= 0 || comp_rows > (1 << 24) || dcap <= 0 || n < 0 ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(dq) & 7) != 0 ||
      (global && (scratch == nullptr || scratch_ctas < 1 ||
                  (reinterpret_cast<uintptr_t>(scratch) & 15) != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  // The plane, the queue slots, two passes' cells (int32 shift, int16 se);
  // the device-memory route only the queue slots, so it needs no opt-in.
  const int smem = global ? 16 : out_rows * kLanes + 16 + 2 * out_rows * 6;
  cudaError_t err = cudaSuccess;
  if (!global && (err = bt::smem_opt_in(decode_flat_kernel<false>, bt::kSmemMax)) != cudaSuccess)
    return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, global ? decode_flat_kernel<true> : decode_flat_kernel<false>, kThreads,
           smem)) != cudaSuccess)
    return static_cast<int>(err);
  Args a;
  a.comp = static_cast<const uint8_t*>(comp);
  a.comp_stride = comp_stride;
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
  a.out = static_cast<uint8_t*>(out);
  a.out_rows = out_rows;
  a.n = n;
  a.queue = static_cast<int*>(queue);
  a.scratch = static_cast<uint32_t*>(scratch);
  int grid = per_sm < 1 ? 1 : (n < per_sm * sms ? n : per_sm * sms);
  if (global) {
    if (grid > scratch_ctas) grid = scratch_ctas;
    decode_flat_kernel<true><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  } else {
    decode_flat_kernel<false><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
