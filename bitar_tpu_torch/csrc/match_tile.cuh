// Match scoring in registers for Hopper (sm_90a): the four-byte compare of
// match.cu (B3), and the dynamic-offset span scorer of match_walk.cu (B5)
// and match_dyn.cu (B4).
//
// Function of `score_span`.  For positions p of a block's raw plane x[0, L)
// and each offset d = offs[k] of the block in slot order k < noff: run(p) is
// the number of consecutive positions p' >= p with p' >= d and
// x[p'] == x[p' - d], capped at cap (max_match); a position keeps the first
// slot whose run is strictly the longest.  The reference doubles runs over a
// cyclic plane; for d >= 1 position 0 never matches, so its cyclic runs stop
// at the plane end like these linear ones.  d == 0 matches everywhere,
// cyclically: every run is cap.  An offset of L or more never matches; a
// negative one is out of contract and skipped.
//
// Design (B3's, csrc/match.cu).  A warp scores a span of up to 1024
// positions; lane w owns the 32 positions p0 + 32 w + j (j < 32), keeps their
// bytes in registers and, per offset, builds their match bits itself, four
// bytes to a compare (`match_word`).  The run entering its word from the next
// is found warp-wide: a ballot of the all-ones words and one shuffle of the
// first word that is not.  Past the span's end the run is counted only when
// the span's last position matches (`run_from`), and not cut at any segment
// or tile end: the uncut run decides between offsets.  Then the lane steps
// its 32 runs back to front in registers, each packed with its slot
// (run << 21 | ~slot) and kept by a max, so the first slot that reaches the
// longest run wins.  No bit words in shared memory, no serial lane-0 loop,
// no __syncwarp per offset.
//
// The sources are read through L1/L2 from device memory, not staged: a
// block's offsets live on the device and reach back up to L - 128 bytes, so
// the window [t0 - max d, t1 + cap) of a tile is known only in the kernel
// and is the whole plane at the detectors' larger offsets, while the bytes a
// span's comparisons read are its own 1024 and 1024 behind each offset.  A
// copy that staged the window in 40 KiB of shared memory by cp.async where
// it fit ran B5 13% slower on the bench corpus and B4 no faster (H100).

#pragma once

#include <cstdint>

#include "cuda_util.cuh"

namespace bt {

constexpr int kWords = 32;               // 32-bit match words per span
constexpr int kSpan = 32 * kWords;       // positions a warp scores at once
constexpr int kSlotBits = 21;            // slot field of a packed best entry
constexpr uint32_t kSlotMax = (1u << kSlotBits) - 1;
constexpr unsigned kFull = 0xffffffffu;

// Ones running on from bit 0 of m (32 when m is all ones).
__device__ __forceinline__ uint32_t ones_from(uint32_t m) { return __clz(__brev(~m)); }

// Match bits of the 32 positions [P, P + 32), P % 32 == 0 and P >= d: bit j
// is x[P + j] == x[P + j - d].  xv holds x[P, P + 32).  The source bytes
// x[P - d, P - d + 32) come from three aligned 16-byte loads (their start
// is 16-aligned below P - d, so they end before P + 32) shifted into place;
// each word's four byte compares fold into a nibble (the zero bytes of
// their XOR, read off exactly, then gathered by one multiply).
__device__ __forceinline__ uint32_t match_word(const uint8_t* x, int P, int d,
                                               const uint32_t (&xv)[8]) {
  const int s = P - d;
  const uint4* src4 = reinterpret_cast<const uint4*>(x + (s & ~15));
  const uint4 b0 = src4[0], b1 = src4[1], b2 = src4[2];
  const uint32_t w[12] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w,
                          b2.x, b2.y, b2.z, b2.w};
  const uint32_t sh = 8u * static_cast<uint32_t>(s & 3);
  uint32_t src[8];
  switch ((s & 15) >> 2) {        // the same in every lane: P % 16 == 0
#define BT_SRC(o)                                                  \
  _Pragma("unroll") for (int i = 0; i < 8; ++i)                    \
      src[i] = __funnelshift_r(w[i + (o)], w[i + (o) + 1], sh);    \
  break;
    case 0: BT_SRC(0)
    case 1: BT_SRC(1)
    case 2: BT_SRC(2)
    default: BT_SRC(3)
#undef BT_SRC
  }
  uint32_t m = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t v = xv[i] ^ src[i];
    const uint32_t eq = ~(((v & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | v) & 0x80808080u;
    m |= ((eq * 0x00204081u) >> 28) << (4 * i);
  }
  return m;
}

// x[P, P + 32) as eight little-endian words (P % 16 == 0).
__device__ __forceinline__ void load_word(const uint8_t* x, int P, uint32_t (&xv)[8]) {
  const uint4 a0 = reinterpret_cast<const uint4*>(x + P)[0];
  const uint4 a1 = reinterpret_cast<const uint4*>(x + P)[1];
  xv[0] = a0.x, xv[1] = a0.y, xv[2] = a0.z, xv[3] = a0.w;
  xv[4] = a1.x, xv[5] = a1.y, xv[6] = a1.z, xv[7] = a1.w;
}

// The run of offset d (1 <= d < q) from position q (q % 32 == 0) on,
// capped at cap; positions at or past L never match.  The first 32
// positions by one ballot of byte compares (most runs end there), then 1024
// a step by four-byte compares, stopping at the first word that is not all
// ones.  Called by all 32 lanes; the result is the same in each.
__device__ __forceinline__ uint32_t run_from(const uint8_t* x, int L, int q, int d,
                                             uint32_t cap) {
  const int lane = threadIdx.x & 31;
  const int p = q + lane;
  uint32_t c = ones_from(__ballot_sync(kFull, p < L && x[p] == x[p - d]));
  if (c < 32) return min(c, cap);
  for (int base = q + 32; c < cap; base += kSpan) {
    const int P = base + 32 * lane;
    uint32_t m = 0;
    if (P < L) {
      uint32_t xv[8];
      load_word(x, P, xv);
      m = match_word(x, P, d, xv);
    }
    const uint32_t full = __ballot_sync(kFull, m == kFull);
    if (full == kFull) {
      c += kSpan;
      continue;
    }
    const int j = __ffs(~full) - 1;
    c += 32u * static_cast<uint32_t>(j) + __shfl_sync(kFull, ones_from(m), j);
    break;
  }
  return min(c, cap);
}

// Scores the span [p0, p0 + 32 nw) of the L-byte plane x (p0 % 32 == 0,
// 1 <= nw <= 32, p0 + 32 nw <= L, x 16-byte aligned) over the block's
// offsets offs[0, noff) with runs capped at cap (1 <= cap <= 2047).  Leaves
// in best[j], for position p0 + 32 lane + j, run << kSlotBits | (kSlotMax -
// slot) of the winning slot (run 0: nothing matches there).  Returns the
// slot of the offset 0 it met (no later slot can win), or -1.  Called by
// all 32 lanes, with the same arguments.
__device__ __forceinline__ int score_span(const uint8_t* x, int L, int p0, int nw,
                                          const int32_t* offs, int noff, uint32_t cap,
                                          uint32_t (&best)[32]) {
  const int lane = threadIdx.x & 31;
  const int end = p0 + 32 * nw;
  const int P = p0 + 32 * lane;                 // the lane's word: positions [P, P + 32)
  uint32_t xv[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (lane < nw) load_word(x, P, xv);
#pragma unroll
  for (int j = 0; j < 32; ++j) best[j] = 0;
  // Every position of the lane holds a run of cap: no later offset can
  // beat it (lanes past the span have no positions).
  bool saturated = lane >= nw;
  const uint32_t lanes = nw == 32 ? kFull : (1u << nw) - 1;
  for (int k = 0; k < noff; ++k) {
    if (__all_sync(kFull, saturated)) break;
    const int d = __ldg(offs + k);
    if (d < 0 || d >= end) continue;            // no position of the span reaches back d
    const uint32_t inv = kSlotMax - static_cast<uint32_t>(k);
    if (d == 0) {                               // matches everywhere: every run is cap
#pragma unroll
      for (int j = 0; j < 32; ++j) best[j] = max(best[j], cap << kSlotBits | inv);
      return k;
    }
    // The lane's match bits; a word that starts below d (the plane's first
    // d positions) goes byte by byte.
    uint32_t mine = 0;
    if (lane < nw) {
      if (P >= d) {
        mine = match_word(x, P, d, xv);
      } else {
        for (int j = 0; j < 32; ++j)
          if (P + j >= d && x[P + j] == x[P + j - d]) mine |= 1u << j;
      }
    }
    if (!__any_sync(kFull, mine != 0)) continue;   // no position matches
    // The run entering the lane's word from the next: whole words of ones
    // up to the first word that is not (its leading ones), or, past the
    // last word, the run from the span's end (counted only if the span's
    // last position matches).
    const uint32_t full = __ballot_sync(kFull, mine == kFull) & lanes;
    const bool last_matches = __shfl_sync(kFull, mine, nw - 1) >> 31;
    const uint32_t c_end = last_matches ? run_from(x, L, end, d, cap) : 0u;
    const uint32_t lead = ones_from(mine);
    const uint32_t stop = ~full & lanes & (lane == 31 ? 0u : kFull << (lane + 1));
    const int j = stop ? __ffs(stop) - 1 : nw;
    const uint32_t lead_j = __shfl_sync(kFull, lead, j & 31);
    const uint32_t run = min(32u * static_cast<uint32_t>(j - lane - 1) + (j < nw ? lead_j : c_end),
                             cap);
    saturated = saturated || (mine == kFull && run + 1u >= cap);
    // Runs of the lane's 32 positions, back to front, kept packed with the
    // slot (run << 21 | inv; the run capped at cap, clamped before the add
    // so that a cap of 2047 never carries out of the word).
    const uint32_t one = 1u << kSlotBits, below_top = (cap - 1) << kSlotBits | inv;
    uint32_t packed = run << kSlotBits | inv;
#pragma unroll
    for (int b = 31; b >= 0; --b) {
      packed = (mine >> b) & 1u ? min(packed, below_top) + one : inv;
      best[b] = max(best[b], packed);
    }
  }
  return -1;
}

}  // namespace bt
