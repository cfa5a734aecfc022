// Dynamic-offset match scoring shared by match_walk.cu (B5) and
// match_dyn.cu (B4).
//
// For positions p of one span of a block's raw plane x[0, L) and each offset
// d of the block in order, run(p) is the number of consecutive positions
// p' >= p with p' >= d and x[p'] == x[p' - d], capped at max_match; best[p]
// keeps the first offset whose run is strictly the longest, packed as
// run | d << 11.  The reference doubles runs over a cyclic plane; for d >= 1
// position 0 never matches, so its cyclic runs stop at the plane end like
// these linear ones.  d == 0 matches everywhere, cyclically: every run is
// max_match.
//
// One warp scores one span.  Per offset it builds the span's match bits
// (with max_match positions of lookahead) by ballots, counts the ones that
// run on from each 32-bit word's start (one lane, back to front), and then
// each lane reads its positions' runs off the bits: no per-position loop
// over the run.

#pragma once

#include <cstdint>

#include "cuda_util.cuh"

namespace bt {

constexpr int kSpan = 1024;        // positions one warp scores at a time
constexpr int kRunBits = 11;       // run field of a packed best entry

__host__ __device__ inline int span_words(int span, int max_match) {
  return (span + max_match + 31) / 32;
}

// 32-bit words of shared scratch one warp uses: bits[W], cws[W + 1], best[span].
__host__ __device__ inline int warp_scratch_words(int span, int max_match) {
  return 2 * span_words(span, max_match) + 1 + span;
}

__device__ inline const uint32_t* span_best(const uint32_t* scratch, int span,
                                            int max_match) {
  return scratch + 2 * span_words(span, max_match) + 1;
}

// Scores positions [p0, p0 + span) of x (span <= kSpan) over offs[0, noff);
// leaves best in the scratch (see span_best).  Called by all 32 lanes.
__device__ inline void score_span(const uint8_t* x, int L, int p0, int span,
                                  const int32_t* offs, int noff, int max_match,
                                  uint32_t* scratch) {
  const int lane = threadIdx.x & 31;
  const int W = span_words(span, max_match);
  uint32_t* bits = scratch;
  uint32_t* cws = scratch + W;
  uint32_t* best = scratch + 2 * W + 1;
  for (int j = lane; j < span; j += 32) best[j] = 0;
  __syncwarp();
  for (int k = 0; k < noff; ++k) {
    const int d = offs[k];
    if (d == 0) {
      for (int j = lane; j < span; j += 32)
        if (max_match > static_cast<int>(best[j] & 0x7FF))
          best[j] = static_cast<uint32_t>(max_match);
      __syncwarp();
      continue;
    }
    for (int w = 0; w < W; ++w) {
      const int p = p0 + w * 32 + lane;
      const bool e = p < L && p >= d && p - d < L && x[p] == x[p - d];
      const uint32_t m = __ballot_sync(0xffffffffu, e);
      if (lane == 0) bits[w] = m;
    }
    __syncwarp();
    if (lane == 0) {              // ones running on from each word's start
      uint32_t c = 0;
      cws[W] = 0;
      for (int w = W - 1; w >= 0; --w) {
        const uint32_t m = bits[w];
        c = m == 0xffffffffu ? c + 32u : static_cast<uint32_t>(__ffs(~m) - 1);
        cws[w] = c;
      }
    }
    __syncwarp();
    for (int j = lane; j < span; j += 32) {
      const int w = j >> 5, b = j & 31;
      const uint32_t m = bits[w] >> b;
      const uint32_t r = m == (0xffffffffu >> b) ? (32u - b) + cws[w + 1]
                                                 : static_cast<uint32_t>(__ffs(~m) - 1);
      const uint32_t run = r < static_cast<uint32_t>(max_match) ? r : max_match;
      if (run > (best[j] & 0x7FF))
        best[j] = run | (static_cast<uint32_t>(d) << kRunBits);
    }
    __syncwarp();
  }
}

// Loads block b's plane (L bytes, L % 16 == 0) and its K offsets into shared
// memory.  Called by the whole CTA; ends with a barrier.
__device__ inline void load_block(const uint8_t* planes, const int32_t* offs, int K,
                                  int L, int b, uint8_t* plane, int32_t* soffs) {
  const uint4* src = reinterpret_cast<const uint4*>(planes + static_cast<long long>(b) * L);
  uint4* dst = reinterpret_cast<uint4*>(plane);
  for (int i = threadIdx.x; i < L / 16; i += blockDim.x) dst[i] = src[i];
  for (int i = threadIdx.x; i < K; i += blockDim.x)
    soffs[i] = offs[static_cast<long long>(b) * K + i];
  __syncthreads();
}

// Warps per CTA for a per-warp scratch of `words` words beside an L-byte
// plane and K offsets (at most 16, at least 1); 0 if even one does not fit.
inline int warps_that_fit(int L, int K, int words) {
  const int room = kSmemMax - L - 4 * K;
  const int w = room / (4 * words);
  return w < 1 ? 0 : (w > 16 ? 16 : w);
}

inline int smem_bytes(int L, int K, int words, int warps) {
  return L + 4 * K + 4 * words * warps;
}

}  // namespace bt
