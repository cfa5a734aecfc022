// Fused dynamic-offset match scoring + greedy segment parse for Hopper
// (sm_90a): kernel B5 of the device compress path.
//
// Replaces the TPU kernel bitar_tpu/ops/pallas/lz4_match_dyn.py
// `_match_walk_kernel` (called through `find_matches_parse_dyn`).  Per
// block b and segment g (seg bytes at g * seg):
//   1. score (match_tile.cuh): best run and offset at every position;
//   2. walk: m_t = min(run, min(seg, blen - 5 - g*seg) - brow) is valid when
//      m_t >= min_match, g*seg + brow < blen - 12 and off >= 1; from pos = 0,
//      wcap times take the first valid brow >= pos, record (position, m_t,
//      off), and move pos past the match; the overflow flag says whether a
//      valid brow >= pos is left.
// Outputs P, M, O [N, nseg * wcap] int32 in (segment, step) order (P = -1,
// M = O = 0 in an empty slot) and one overflow flag per segment [N, nseg].
//
// The reference takes the source segment as (g - q) & (G - 1), which is
// mod G only for a power-of-two G; this kernel reads the true x[p - d].
//
// Bound.  Per position and offset one byte comparison and one comparison
// with the best run; device traffic is the raw plane of each block with an
// offset, once, and the records.  At the bench's one offset a live block the
// work is small, so what bounds the kernel is how fast the scoring and the
// walk issue, and that every SM has spans to score.
//
// Design.  A CTA of 8 warps takes 8 segments of one block (the grid is
// blocks x segment tiles, so 64 or 256 blocks fill the 132 SMs), a warp a
// segment.  A CTA whose block has no offsets writes empty records and exits
// without reading a plane byte; so does a warp whose segment lies past the
// block's length.  The warp scores its segment 1024 positions at a time in
// registers (`bt::score_span`), forms each position's valid bit with
// prefix masks and one compare of the packed best, keeps the packed best in
// shared memory (16-byte chunks XOR-swizzled by lane), and walks the span at
// once: the next valid position by a ballot of the lanes' masked bits and
// two __ffs, its run and slot by one shared-memory load, the cursor carried
// into the next span; spans the cursor has passed are not scored.  A
// segment shorter than 1024 positions leaves lanes idle (the device matcher
// runs seg 1024).  The warps' chains of loads, votes and shuffles wait more
// than they issue, so three CTAs an SM (80 registers, a few spilled) ran
// 8-14% faster than two (99 registers, none spilled) on the H100.

#include "match_tile.cuh"

namespace {

constexpr int kWarps = 8;               // segments a CTA takes, a warp each
constexpr int kMinCtas = 3;             // CTAs an SM holds: ptxas keeps 80 registers

struct Args {
  const uint8_t* planes;        // [n, L]
  const int32_t* noff;          // [n]
  const int32_t* offs;          // [n, K]
  int K;
  const int32_t* lengths;       // [n]
  int32_t* P;                   // [n, nseg * wcap]
  int32_t* M;
  int32_t* O;
  int32_t* flags;               // [n, nseg]
  int L, seg, nseg, tiles, min_match, wcap, max_match;
};

// Bits [0, k) set, for any k.
__device__ __forceinline__ uint32_t low_bits(int k) {
  return k >= 32 ? bt::kFull : k <= 0 ? 0u : (1u << k) - 1;
}

__global__ void __launch_bounds__(32 * kWarps, kMinCtas) match_walk_kernel(Args a) {
  __shared__ __align__(16) uint32_t spans[kWarps][bt::kSpan];   // each warp's packed best
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x / a.tiles;
  const int g = (blockIdx.x - b * a.tiles) * kWarps + warp;
  if (g >= a.nseg) return;                  // the whole warp; no CTA barrier follows
  int noff = __ldg(a.noff + b);
  noff = noff < 0 ? 0 : min(noff, a.K);
  const int blen = __ldg(a.lengths + b);
  const int gbase = g * a.seg;
  const int lim = min(a.seg, blen - 5 - gbase);
  // A match can start only at brow < reach (gbase + brow < blen - 12).
  const int reach = noff ? min(a.seg, blen - 12 - gbase) : 0;
  const long long out = (static_cast<long long>(b) * a.nseg + g) * a.wcap;
  const uint8_t* x = a.planes + static_cast<long long>(b) * a.L;
  const int32_t* offs = a.offs + static_cast<long long>(b) * a.K;
  // Valid needs run >= mm and lim - brow >= mm; for brow < reach,
  // lim - brow >= 1, and run >= 1 is what off >= 1 asks of a scored run.
  const int mm = min(max(a.min_match, 1), 2048);
  uint32_t* sbest = spans[warp];
  int pos = 0, t = 0, overflow = 0;

  for (int sub = 0; sub < reach && !overflow; sub += bt::kSpan) {
    const int nw = min(bt::kWords, (a.seg - sub) >> 5);   // seg % 128 == 0: whole words
    if (pos >= sub + 32 * nw) continue;                     // the walk is past this span
    uint32_t best[32];
    const int zslot = bt::score_span(x, a.L, gbase + sub, nw, offs, noff,
                                     static_cast<uint32_t>(a.max_match), best);
    // Valid bits of the lane's positions brow = r0 + i: run >= mm is one
    // compare of the packed value (mm <= max_match <= 2047 fits its field).
    const int r0 = sub + 32 * lane;
    uint32_t valid = lane < nw && mm <= a.max_match
                         ? low_bits(reach - r0) & low_bits(lim - r0 - mm + 1) : 0u;
    const uint32_t least = static_cast<uint32_t>(mm) << bt::kSlotBits;
    uint32_t good = 0;
    if (zslot < 0) {
#pragma unroll
      for (int i = 0; i < 32; ++i) good |= static_cast<uint32_t>(best[i] >= least) << i;
    } else {                                // an offset 0 won there: not valid
      const uint32_t zinv = bt::kSlotMax - static_cast<uint32_t>(zslot);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const bool v = best[i] >= least && (best[i] & bt::kSlotMax) != zinv;
        good |= static_cast<uint32_t>(v) << i;
      }
    }
    valid &= good;
    // The lane's row of 8 16-byte chunks, chunk q at q ^ (lane & 7), so the
    // stores meet no bank conflict; the walk reads entries back by position.
    uint4* keep = reinterpret_cast<uint4*>(sbest + 32 * lane);
#pragma unroll
    for (int q = 0; q < 8; ++q)
      keep[q ^ (lane & 7)] = make_uint4(best[4 * q], best[4 * q + 1], best[4 * q + 2],
                                        best[4 * q + 3]);
    __syncwarp();
    while (true) {                          // the same on every lane
      const int from = pos - r0;
      const uint32_t mine = from <= 0 ? valid : (from >= 32 ? 0u : valid & (bt::kFull << from));
      const uint32_t has = __ballot_sync(bt::kFull, mine != 0);
      if (!has) break;                      // none left in this span
      if (t == a.wcap) {
        overflow = 1;
        break;
      }
      const int l = __ffs(has) - 1;
      const int j = 32 * l + __ffs(__shfl_sync(bt::kFull, mine, l)) - 1;
      const uint32_t bv = sbest[(j & ~31) | (((j >> 2) ^ l) & 7) << 2 | (j & 3)];
      const int brow = sub + j;
      const int mt = min(static_cast<int>(bv >> bt::kSlotBits), lim - brow);
      if (lane == 0) {
        a.P[out + t] = gbase + brow;
        a.M[out + t] = mt;
        a.O[out + t] = __ldg(offs + (bt::kSlotMax - (bv & bt::kSlotMax)));
      }
      ++t;
      pos = brow + mt;
    }
    __syncwarp();                           // the next span overwrites sbest
  }
  for (int i = t + lane; i < a.wcap; i += 32) {
    a.P[out + i] = -1;
    a.M[out + i] = 0;
    a.O[out + i] = 0;
  }
  if (lane == 0) a.flags[static_cast<long long>(b) * a.nseg + g] = overflow;
}

}  // namespace

// Launches n x ceil(nseg / 8) CTAs on `stream` of `device`; returns the
// CUDA error code (0 on success).  Pointers are device pointers, `planes`
// 16-byte aligned; the caller allocates the outputs.  Offsets in the first
// noff[b] slots of a row must lie in [0, L).
extern "C" int bt_match_walk_launch(const void* planes, const void* noff, const void* offs,
                                    int K, const void* lengths, void* P, void* M, void* O,
                                    void* flags, int n, int L, int seg, int min_match,
                                    int wcap, int max_match, int device, void* stream) {
  if (n < 0 || L <= 0 || L % 128 || seg <= 0 || seg % 128 || L % seg || K < 0 || wcap < 0 ||
      max_match < 1 || max_match > 2047 || device < 0 ||
      (reinterpret_cast<uintptr_t>(planes) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  Args a;
  a.planes = static_cast<const uint8_t*>(planes);
  a.noff = static_cast<const int32_t*>(noff);
  a.offs = static_cast<const int32_t*>(offs);
  a.K = K;
  a.lengths = static_cast<const int32_t*>(lengths);
  a.P = static_cast<int32_t*>(P);
  a.M = static_cast<int32_t*>(M);
  a.O = static_cast<int32_t*>(O);
  a.flags = static_cast<int32_t*>(flags);
  a.L = L;
  a.seg = seg;
  a.nseg = L / seg;
  a.tiles = (a.nseg + kWarps - 1) / kWarps;
  a.min_match = min_match;
  a.wcap = wcap;
  a.max_match = max_match;
  const long long grid = static_cast<long long>(n) * a.tiles;
  if (grid > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  int previous = 0;
  cudaError_t err = bt::enter_device(device, &previous);
  if (err != cudaSuccess) return static_cast<int>(err);
  match_walk_kernel<<<static_cast<unsigned>(grid), 32 * kWarps, 0,
                      static_cast<cudaStream_t>(stream)>>>(a);
  err = cudaGetLastError();
  if (previous != device) cudaSetDevice(previous);
  return static_cast<int>(err);
}
