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
// 0/1 flag per segment, [N, nseg] int32 (the wrapper reduces them per block).
//
// Bound.  Device memory: 4 bytes of mlen at each position the walk must
// examine (from each cursor to the match it takes, to the segment end
// where none is left, and the overflow scan), 4 bytes of moff where such a
// position passes the length and position tests, and the records
// (`match_dyn.walk_bound_bytes`); a few integer operations a position.
//
// Design.  One warp per (block, segment), eight warps per CTA, planes read
// in their natural [N, L] layout.  A scan is a chain of load, vote, jump, so
// what limits it is the bytes a warp keeps in flight, not the rate:
//   - the scan ends at min(seg, blen - 12 - g*seg): a segment wholly past
//     the block's length writes its empty records and a 0 flag without
//     reading a plane;
//   - the first chunk after each cursor is 32 positions (one 128-byte load):
//     a match there, the common case in dense segments, jumps the cursor
//     with little over-read;
//   - a scan that goes on widens to 128 positions a chunk, one 16-byte load
//     a lane (four 4-byte loads where seg % 4 or the planes' alignment
//     forbid it), and issues the next chunk's load before the current chunk's
//     vote, so each warp keeps 512 bytes of mlen in flight while it decides
//     (32 KiB an SM at 64 resident warps, above the ~25 KiB that 3.35 TB/s
//     at ~1 us of load latency asks of each of 132 SMs);
//   - moff is read only where mlen and the position tests pass, and the
//     found position's length and offset come back by shuffle, not reload;
//   - lane t % 32 keeps step t's record and the warp stores 32 records at a
//     time, coalesced.
// The TPU kernel's segment-major transpose was a lane-layout device and is
// not carried over.

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

// kWide: 16-byte loads of mlen (seg % 4 == 0, planes 16-byte aligned), a
// compile-time choice so that the scan loop carries no branch on it.
template <bool kWide>
struct Segment {
  const int32_t* mlen;
  const int32_t* moff;
  int seg, end, lim, min_match;

  // Whether brow (< end) is valid; its m_t and moff in m and o.
  __device__ __forceinline__ bool test(int brow, int len, int& m, int& o) const {
    m = min(len, lim - brow);
    o = 0;
    if (m < min_match) return false;
    o = moff[brow];
    return o >= 1;
  }

  // mlen at positions c + 4 * lane + [0, 4), 0 from end on.
  __device__ __forceinline__ int4 chunk(int c, int lane) const {
    const int p = c + 4 * lane;
    if constexpr (kWide)
      return p < end ? __ldg(reinterpret_cast<const int4*>(mlen + p)) : make_int4(0, 0, 0, 0);
    return make_int4(p < end ? mlen[p] : 0, p + 1 < end ? mlen[p + 1] : 0,
                     p + 2 < end ? mlen[p + 2] : 0, p + 3 < end ? mlen[p + 3] : 0);
  }

  // The first valid brow >= from, or seg, the same on every lane; its m_t
  // and moff in m and o.
  __device__ int next_valid(int from, int lane, int& m, int& o) const {
    const int start = from < 0 ? 0 : from;
    if (start >= end) return seg;
    int c = start & ~31;
    {
      const int p = c + lane;
      int mm = 0, oo = 0;
      const bool v = p >= start && p < end && test(p, mlen[p], mm, oo);
      const unsigned bal = __ballot_sync(kFull, v);
      if (bal) {
        const int i = __ffs(bal) - 1;
        m = __shfl_sync(kFull, mm, i);
        o = __shfl_sync(kFull, oo, i);
        return c + i;
      }
      c += 32;
    }
    int4 cur = chunk(c, lane);
    for (; c < end; c += 128) {
      const int4 nxt = chunk(c + 128, lane);          // in flight during this vote
      const int vals[4] = {cur.x, cur.y, cur.z, cur.w};
      int first = 4, mm = 0, oo = 0;
#pragma unroll
      for (int q = 3; q >= 0; --q) {
        const int p = c + 4 * lane + q;
        int mq, oq;
        if (p < end && test(p, vals[q], mq, oq)) {
          first = q;
          mm = mq;
          oo = oq;
        }
      }
      const unsigned bal = __ballot_sync(kFull, first < 4);
      if (bal) {
        const int i = __ffs(bal) - 1;
        m = __shfl_sync(kFull, mm, i);
        o = __shfl_sync(kFull, oo, i);
        return c + 4 * i + __shfl_sync(kFull, first, i);
      }
      cur = nxt;
    }
    return seg;
  }
};

template <bool kWide>
__global__ void __launch_bounds__(32 * kWarps) parse_walk_kernel(Args a) {
  const int w = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (w >= a.n * a.nseg) return;            // the whole warp leaves together
  const int b = w / a.nseg, g = w % a.nseg;
  const long long base = static_cast<long long>(b) * a.L + static_cast<long long>(g) * a.seg;
  const int gbase = g * a.seg;
  const int blen = a.lengths[b];
  Segment<kWide> s;
  s.mlen = a.mlen + base;
  s.moff = a.moff + base;
  s.seg = a.seg;
  s.lim = min(a.seg, blen - 5 - gbase);
  s.end = max(0, min(a.seg, blen - 12 - gbase));     // the position test, as a scan end
  s.min_match = a.min_match;
  const long long out = static_cast<long long>(w) * a.wcap;   // (b * nseg + g) * wcap
  int pos = 0, rp = -1, rm = 0, ro = 0;
  for (int t = 0; t < a.wcap; ++t) {
    int m = 0, o = 0;
    const int nxt = s.next_valid(pos, lane, m, o);
    int p = -1;
    if (nxt < a.seg) {
      p = gbase + nxt;
      pos = nxt + m;
    } else {
      m = 0;
      o = 0;
      pos = a.seg;
    }
    if (lane == (t & 31)) {
      rp = p;
      rm = m;
      ro = o;
    }
    if ((t & 31) == 31 || t == a.wcap - 1) {         // 32 records at a time
      const int t0 = t & ~31;
      if (lane <= t - t0) {
        a.P[out + t0 + lane] = rp;
        a.M[out + t0 + lane] = rm;
        a.O[out + t0 + lane] = ro;
      }
    }
  }
  int m, o;
  const int left = s.next_valid(pos, lane, m, o);
  if (lane == 0) a.flags[w] = left < a.seg ? 1 : 0;
}

}  // namespace

// Launches the walk on `stream` of `device`; returns the CUDA error code (0
// on success).  Pointers are device pointers; the caller allocates the
// outputs.
extern "C" int bt_parse_walk_launch(const void* mlen, const void* moff, const void* lengths,
                                    void* P, void* M, void* O, void* flags, int n, int L,
                                    int seg, int min_match, int wcap, int device,
                                    void* stream) {
  if (n < 0 || L <= 0 || seg <= 0 || L % seg || wcap < 0 || device < 0)
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
  int previous = 0;
  cudaError_t err = bt::enter_device(device, &previous);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (seg % 4 == 0 && (reinterpret_cast<uintptr_t>(mlen) & 15) == 0)
    parse_walk_kernel<true><<<static_cast<unsigned>(ctas), 32 * kWarps, 0,
                              static_cast<cudaStream_t>(stream)>>>(a);
  else
    parse_walk_kernel<false><<<static_cast<unsigned>(ctas), 32 * kWarps, 0,
                               static_cast<cudaStream_t>(stream)>>>(a);
  err = cudaGetLastError();
  if (previous != device) cudaSetDevice(previous);
  return static_cast<int>(err);
}
