// Static candidate-offset match scoring for Hopper (sm_90a): kernel B3.
//
// Replaces the TPU kernel bitar_tpu/ops/pallas/lz4_match.py `_match_kernel`
// (called through `find_matches`): for every position of a block, over one
// offset tuple shared by all blocks, the first offset whose run is strictly
// the longest (runs capped at `cap`, the reference's doubling cap, the power
// of two at or above max_match), written as the run capped at max_match and
// the offset's index in the tuple (or its value with emit_values);
// ops/match.py states the function.
//
// Bound.  Per position and offset one byte comparison and one comparison
// with the best run: integer work of positions x offsets.  Device traffic is
// the plane read once and 8 bytes per position written.  At the tuple of 26
// offsets the work, not the traffic, is what the card's time goes to: by
// count of the code this design issues ~300 warp instructions per
// 1024-position span and offset, most of them the 32 run steps per lane, so
// it is bound by issue.  A one-CTA-per-block design that held the whole
// plane was bound by occupancy instead (one CTA per SM, 68 of 132 SMs idle at
// 64 blocks) and by a serial lane-0 loop per span and offset.  Building the
// match bits by one ballot per 32 positions (a byte load, a compare and a
// vote each) took 1.6x the time of the four-byte compares below (2.80
// against 1.77 ms for 1024 x 128 KiB blocks at max_match 64, H100 SXM).
//
// Design.  A CTA scores one tile of `tile` positions of one block, so the
// grid has blocks x tiles CTAs and a small batch still fills the 132 SMs.
// It stages in shared memory only the window its comparisons read,
// x[t0 - maxoff, t1 + cap) clipped to the plane (maxoff: the tuple's largest
// offset below L; a position below an offset never matches, and a run reads
// at most cap positions ahead), 16 bytes a thread by cp.async.  Where the
// window would be large (ops/match.py `tile_plan`) the tile is the whole
// plane, as in a one-CTA-per-block design.
//
// Each warp scores 1024-position spans.  Lane w owns the 32 positions
// p0 + 32 w + j (j < 32): it keeps their bytes in registers, and per offset
// builds their match bits itself, four bytes to a compare (`match_word`,
// match_tile.cuh, which B4 and B5 share).
// The run entering its word from the next is found warp-wide: a ballot of
// the all-ones words, one shuffle of the first word that is not, and past
// the span's end ballots that stop at the first word that is not all ones
// (the exit is warp-uniform).  Then the lane steps its 32 runs back to
// front in registers, each packed with its slot (run << 21 | ~slot) and
// kept by a max.  No bit words in shared memory, no serial lane-0 loop, no
// __syncwarp per offset.  Offsets are visited in tuple order and only a
// strictly longer run replaces the best, so the slot kept is the first that
// reaches the winning run, as in the reference: the output index is the
// slot itself, and a value is read from the tuple by it.  Stores are 16-byte
// vectors, each lane writing its 32 positions' run and index.

#include "match_tile.cuh"

namespace {

using bt::kSlotBits;
using bt::kSlotMax;
using bt::kSpan;
using bt::kWords;
using bt::match_word;
using bt::ones_from;

struct Args {
  const uint8_t* planes;        // [n, L]
  const int32_t* offs;          // [K]
  int K;
  int32_t* mlen;                // [n, L]
  int32_t* idx;                 // [n, L]
  int L, tile, tiles, maxoff, cap, max_match, emit_values;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

// The window of tile [t0, t1): bytes [lo, hi) of the plane, 16-aligned
// (ops/match.py `tile_windows` computes the same).
__device__ __forceinline__ int window_lo(int t0, const Args& a) {
  return max(0, t0 - a.maxoff) & ~15;
}
__device__ __forceinline__ int window_hi(int t1, const Args& a) {
  return min(a.L, (t1 + a.cap + 15) & ~15);
}

__global__ void __launch_bounds__(512) match_kernel(Args a) {
  extern __shared__ __align__(16) uint8_t win[];
  const int b = blockIdx.x / a.tiles;
  const int t0 = (blockIdx.x - b * a.tiles) * a.tile;
  const int t1 = min(a.L, t0 + a.tile);
  const int lo = window_lo(t0, a), hi = window_hi(t1, a);
  const uint8_t* plane = a.planes + static_cast<long long>(b) * a.L;
  for (int i = lo + 16 * threadIdx.x; i < hi; i += 16 * blockDim.x)
    cp_async16(win + (i - lo), plane + i);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  const uint8_t* x = win - lo;                // x[p] for p in [lo, hi)

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const uint32_t cap = static_cast<uint32_t>(a.cap);
  int32_t* mlen = a.mlen + static_cast<long long>(b) * a.L;
  int32_t* idx = a.idx + static_cast<long long>(b) * a.L;

  for (int p0 = t0 + warp * kSpan; p0 < t1; p0 += warps * kSpan) {
    const int nw = min(kWords, (t1 - p0) >> 5);   // L % 128 == 0: whole words
    const int end = p0 + 32 * nw;
    const int P = p0 + 32 * lane;                 // the lane's word: positions [P, P + 32)
    uint32_t xv[8] = {0, 0, 0, 0, 0, 0, 0, 0};    // x[P, P + 32)
    if (lane < nw) {
      const uint4 a0 = reinterpret_cast<const uint4*>(x + P)[0];
      const uint4 a1 = reinterpret_cast<const uint4*>(x + P)[1];
      xv[0] = a0.x, xv[1] = a0.y, xv[2] = a0.z, xv[3] = a0.w;
      xv[4] = a1.x, xv[5] = a1.y, xv[6] = a1.z, xv[7] = a1.w;
    }
    // best[b]: position p0 + 32 lane + b, packed run << 21 | (kSlotMax - slot),
    // so the larger packed value is the longer run, or the earlier slot.
    uint32_t best[32];
#pragma unroll
    for (int b = 0; b < 32; ++b) best[b] = 0;
    // Every position of the lane holds a run of cap: no later offset can
    // beat it (lanes past the span have no positions).
    bool saturated = lane >= nw;

    for (int k = 0; k < a.K; ++k) {
      if (__all_sync(0xffffffffu, saturated)) break;
      const int d = __ldg(a.offs + k);
      if (d >= end) continue;                     // no position of the span reaches back d
      const uint32_t inv = kSlotMax - static_cast<uint32_t>(k);
      if (d == 0) {                               // matches everywhere: every run is cap
#pragma unroll
        for (int b = 0; b < 32; ++b) best[b] = max(best[b], cap << kSlotBits | inv);
        break;
      }
      // The run from the span's end (p >= end > d, so p - d >= lo).
      uint32_t c_end = 0;
      for (int p = end + lane; c_end < cap; p += 32) {
        const bool e = p < hi && x[p] == x[p - d];
        const uint32_t o = ones_from(__ballot_sync(0xffffffffu, e));
        c_end = min(c_end + o, cap);
        if (o < 32) break;
      }
      // The lane's match bits, four bytes at a time; a word that starts
      // below d (the plane's first d positions) goes byte by byte.
      uint32_t mine = 0;
      if (lane < nw) {
        if (P >= d) {
          mine = match_word(x, P, d, xv);
        } else {
          for (int j = 0; j < 32; ++j)
            if (P + j >= d && x[P + j] == x[P + j - d]) mine |= 1u << j;
        }
      }
      // The run entering the lane's word from the next: whole words of ones
      // up to the first word that is not (its leading ones), or the run
      // from the span's end.
      const uint32_t lanes = nw == 32 ? 0xffffffffu : (1u << nw) - 1;
      const uint32_t full = __ballot_sync(0xffffffffu, mine == 0xffffffffu) & lanes;
      const uint32_t lead = ones_from(mine);
      const uint32_t stop = ~full & lanes & (lane == 31 ? 0u : 0xffffffffu << (lane + 1));
      const int j = stop ? __ffs(stop) - 1 : nw;
      const uint32_t lead_j = __shfl_sync(0xffffffffu, lead, j & 31);
      uint32_t run = min(32u * static_cast<uint32_t>(j - lane - 1) + (j < nw ? lead_j : c_end),
                         cap);
      if (!__any_sync(0xffffffffu, mine != 0)) continue;   // no position matches
      saturated = saturated || (mine == 0xffffffffu && run + 1u >= cap);
      // Runs of the lane's 32 positions, back to front, kept packed with
      // the slot (run << 21 | inv; the run capped at cap).
      const uint32_t one = 1u << kSlotBits, top = cap << kSlotBits | inv;
      uint32_t packed = run << kSlotBits | inv;
#pragma unroll
      for (int b = 31; b >= 0; --b) {
        packed = (mine >> b) & 1u ? min(packed + one, top) : inv;
        best[b] = max(best[b], packed);
      }
    }

    if (lane < nw) {
      int4* ml = reinterpret_cast<int4*>(mlen + p0 + 32 * lane);
      int4* ix = reinterpret_cast<int4*>(idx + p0 + 32 * lane);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        int r[4], o[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t bv = best[4 * q + i];
          const int run = static_cast<int>(bv >> kSlotBits);
          const int k = static_cast<int>(kSlotMax - (bv & kSlotMax));
          r[i] = min(run, a.max_match);
          o[i] = run == 0 ? 0 : (a.emit_values ? __ldg(a.offs + k) : k);
        }
        ml[q] = make_int4(r[0], r[1], r[2], r[3]);
        ix[q] = make_int4(o[0], o[1], o[2], o[3]);
      }
    }
  }
}

}  // namespace

// Launches n * ceil(L / tile) CTAs of `warps` warps on `stream`, each
// staging `window` bytes (the largest tile window, from ops/match.py
// `tile_plan`); returns the CUDA error code (0 on success).  Pointers are
// device pointers; the caller allocates the outputs.  Offsets must lie in
// [0, 2^20); max_match in [1, 1024].
extern "C" int bt_match_launch(const void* planes, const void* offs, int K, void* mlen,
                               void* idx, int n, int L, int max_match, int emit_values,
                               int tile, int maxoff, int window, int warps, void* stream) {
  if (n < 0 || L <= 0 || L % 128 || K < 1 || max_match < 1 || max_match > 1024 ||
      tile <= 0 || tile % 128 || maxoff < 0 || window < 16 || window > bt::kSmemMax ||
      warps < 1 || warps > 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  int cap = 1;
  while (cap < max_match) cap *= 2;
  Args a;
  a.planes = static_cast<const uint8_t*>(planes);
  a.offs = static_cast<const int32_t*>(offs);
  a.K = K;
  a.mlen = static_cast<int32_t*>(mlen);
  a.idx = static_cast<int32_t*>(idx);
  a.L = L;
  a.tile = tile;
  a.tiles = (L + tile - 1) / tile;
  a.maxoff = maxoff;
  a.cap = cap;
  a.max_match = max_match;
  a.emit_values = emit_values;
  const long long grid = static_cast<long long>(n) * a.tiles;
  if (grid > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  // The opt-in is the device maximum, whatever this launch's window, so a
  // launch from another thread never meets a smaller limit.
  const cudaError_t err = bt::smem_opt_in(match_kernel, bt::kSmemMax);
  if (err != cudaSuccess) return static_cast<int>(err);
  match_kernel<<<static_cast<unsigned>(grid), 32 * warps, window,
                 static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
