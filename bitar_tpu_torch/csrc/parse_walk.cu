// Greedy segment parse over precomputed match planes for Hopper (sm_90a):
// kernel B6.
//
// Replaces the TPU kernel bitar_tpu/ops/pallas/lz4_match_dyn.py
// `_walk_kernel` (called through `parse_walk_dyn`).  Per block b and
// segment g (seg bytes at g * seg), with lim = min(seg, blen - 5 - g*seg):
//   m_t[brow] = min(mlen, lim - brow) is valid when m_t >= min_match,
//   g*seg + brow < blen - 12 and moff >= 1.  From pos = 0, wcap steps each
//   take the first valid brow >= pos and record (P, M, O) = (g*seg + brow,
//   m_t, moff), then set pos = brow + m_t; a step that finds none records
//   (-1, 0, 0) and sets pos = seg.  The segment's overflow flag says whether
//   a valid brow >= pos is left after the last step.
// Outputs P, M, O [N, nseg * wcap] int32 in (segment, step) order and one
// flag per segment, [N, nseg] int32 (the wrapper reduces them per block).
//
// Design.  One warp per (block, segment), eight warps per CTA.  The warp
// reads mlen and moff in their natural [N, L] layout, 32 positions at a
// time (one coalesced 128-byte load of each plane), forms the valid bits
// with __ballot_sync and jumps to the first with __ffs.  The TPU kernel's
// segment-major transpose was a lane-layout device and is not carried over.
//
// Bound.  Device traffic: at most both int32 planes once (the walk skips
// what its matches cover) and the records; the work per position is a few
// integer operations, so the planes' bytes bound it.

#include <cstdint>

#include "cuda_util.cuh"

namespace {

constexpr int kWarps = 8;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const int32_t* mlen;          // [n, L]
  const int32_t* moff;          // [n, L]
  const int32_t* lengths;       // [n]
  int32_t* P;                   // [n, nseg * wcap]
  int32_t* M;
  int32_t* O;
  int32_t* flags;               // [n, nseg]
  int n, L, seg, nseg, min_match, wcap;
};

struct Segment {
  const int32_t* mlen;
  const int32_t* moff;
  int seg, gbase, lim, blen, min_match;

  __device__ int m_t(int brow) const { return min(mlen[brow], lim - brow); }

  // The first valid brow >= from, or seg; the same on every lane.
  __device__ int next_valid(int from, int lane) const {
    const int start = from < 0 ? 0 : from;
    for (int c = start & ~31; c < seg; c += 32) {
      const int brow = c + lane;
      bool v = false;
      if (brow >= start && brow < seg)
        v = m_t(brow) >= min_match && gbase + brow < blen - 12 && moff[brow] >= 1;
      const unsigned m = __ballot_sync(kFull, v);
      if (m) return c + __ffs(m) - 1;
    }
    return seg;
  }
};

__global__ void __launch_bounds__(32 * kWarps) parse_walk_kernel(Args a) {
  const int w = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (w >= a.n * a.nseg) return;            // the whole warp leaves together
  const int b = w / a.nseg, g = w % a.nseg;
  const long long base = static_cast<long long>(b) * a.L + static_cast<long long>(g) * a.seg;
  Segment s;
  s.mlen = a.mlen + base;
  s.moff = a.moff + base;
  s.seg = a.seg;
  s.gbase = g * a.seg;
  s.blen = a.lengths[b];
  s.lim = min(a.seg, s.blen - 5 - s.gbase);
  s.min_match = a.min_match;
  const long long out = static_cast<long long>(w) * a.wcap;   // (b * nseg + g) * wcap
  int pos = 0;
  for (int t = 0; t < a.wcap; ++t) {
    const int nxt = s.next_valid(pos, lane);
    int p = -1, m = 0, o = 0;
    if (nxt < a.seg) {
      m = s.m_t(nxt);
      o = s.moff[nxt];
      p = s.gbase + nxt;
      pos = nxt + m;
    } else {
      pos = a.seg;
    }
    if (lane == 0) {
      a.P[out + t] = p;
      a.M[out + t] = m;
      a.O[out + t] = o;
    }
  }
  const int left = s.next_valid(pos, lane);
  if (lane == 0) a.flags[w] = left < a.seg ? 1 : 0;
}

}  // namespace

// Launches the walk on `stream`; returns the CUDA error code (0 on success).
// Pointers are device pointers; the caller allocates the outputs.
extern "C" int bt_parse_walk_launch(const void* mlen, const void* moff, const void* lengths,
                                    void* P, void* M, void* O, void* flags, int n, int L,
                                    int seg, int min_match, int wcap, void* stream) {
  if (n < 0 || L <= 0 || seg <= 0 || L % seg || wcap < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  Args a;
  a.mlen = static_cast<const int32_t*>(mlen);
  a.moff = static_cast<const int32_t*>(moff);
  a.lengths = static_cast<const int32_t*>(lengths);
  a.P = static_cast<int32_t*>(P);
  a.M = static_cast<int32_t*>(M);
  a.O = static_cast<int32_t*>(O);
  a.flags = static_cast<int32_t*>(flags);
  a.n = n;
  a.L = L;
  a.seg = seg;
  a.nseg = L / seg;
  a.min_match = min_match;
  a.wcap = wcap;
  const long long warps = static_cast<long long>(n) * a.nseg;
  const long long ctas = (warps + kWarps - 1) / kWarps;
  if (ctas > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  parse_walk_kernel<<<static_cast<unsigned>(ctas), 32 * kWarps, 0,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
