// Fused dynamic-offset match scoring + greedy segment parse for Hopper
// (sm_90a): kernel B5 of the device compress path.
//
// Replaces the TPU kernel bitar_tpu/ops/pallas/lz4_match_dyn.py
// `_match_walk_kernel` (called through `find_matches_parse_dyn`).  Per
// block b and segment g (seg bytes at g * seg):
//   1. score (match_score.cuh): best run and offset at every position;
//   2. walk: m_t = min(run, min(seg, blen - 5 - g*seg) - brow) is valid when
//      m_t >= min_match, g*seg + brow < blen - 12 and off >= 1; from pos = 0,
//      wcap times take the first valid brow >= pos, record (position, m_t,
//      off), and move pos past the match; the overflow flag says whether a
//      valid brow >= pos is left.
// Output rec [N, 3*wcap + 1, nseg] int32, as the TPU kernel writes it: rows
// [0, W) positions (-1 empty), [W, 2W) lengths, [2W, 3W) offsets, 3W flags.
//
// The reference takes the source segment as (g - q) & (G - 1), which is
// mod G only for a power-of-two G; this kernel reads the true x[p - d].
//
// Design.  One CTA of 16 warps per block; the block's raw plane (up to
// 128 KiB) sits in shared memory.  A warp takes a segment, scores it
// 1024 positions at a time (match bits by ballots over the plane, runs read
// off the bits) and walks each span as soon as it is scored, carrying the
// cursor into the next span; spans the cursor has passed are not scored.
//
// Bound.  Integer work: for each position and offset, one byte compare and
// a few bit operations; the device traffic is the raw plane once and rec.

#include "match_score.cuh"

namespace {

struct Args {
  const uint8_t* planes;        // [n, L]
  const int32_t* noff;          // [n]
  const int32_t* offs;          // [n, K]
  int K;
  const int32_t* lengths;       // [n]
  int32_t* rec;                 // [n, 3*wcap + 1, nseg]
  int L, seg, nseg, min_match, wcap, max_match;
  int warps, words;
};

__global__ void __launch_bounds__(512) match_walk_kernel(Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* plane = smem;
  int32_t* soffs = reinterpret_cast<int32_t*>(smem + a.L);
  uint32_t* scratch_all = reinterpret_cast<uint32_t*>(smem + a.L + 4 * a.K);
  const int b = blockIdx.x;
  bt::load_block(a.planes, a.offs, a.K, a.L, b, plane, soffs);
  int noff = a.noff[b];
  noff = noff < 0 ? 0 : (noff > a.K ? a.K : noff);
  const int blen = a.lengths[b];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t* scratch = scratch_all + warp * a.words;
  const int W = a.wcap, G = a.nseg;
  int32_t* rec = a.rec + static_cast<long long>(b) * (3 * W + 1) * G;

  for (int g = warp; g < G; g += a.warps) {
    const int gbase = g * a.seg;
    const int lim = min(a.seg, blen - 5 - gbase);
    if (lane == 0)
      for (int t = 0; t < W; ++t) {
        rec[t * G + g] = -1;
        rec[(W + t) * G + g] = 0;
        rec[(2 * W + t) * G + g] = 0;
      }
    int pos = 0, t = 0, overflow = 0;
    for (int sub = 0; sub < a.seg && !overflow; sub += bt::kSpan) {
      const int span = min(bt::kSpan, a.seg - sub);
      if (pos >= sub + span) continue;          // the walk is past this span
      bt::score_span(plane, a.L, gbase + sub, span, soffs, noff, a.max_match, scratch);
      const uint32_t* best = bt::span_best(scratch, span, a.max_match);
      uint32_t* valid = scratch;                 // the match bits are spent
      const int nw = (span + 31) >> 5;
      for (int w = 0; w < nw; ++w) {
        const int j = w * 32 + lane;
        bool v = false;
        if (j < span) {
          const uint32_t bv = best[j];
          const int brow = sub + j;
          const int mt = min(static_cast<int>(bv & 0x7FF), lim - brow);
          v = mt >= a.min_match && gbase + brow < blen - 12 && (bv >> bt::kRunBits) >= 1;
        }
        const uint32_t m = __ballot_sync(0xffffffffu, v);
        if (lane == 0) valid[w] = m;
      }
      __syncwarp();
      if (lane == 0) {
        while (true) {
          const int from = pos > sub ? pos - sub : 0;
          int nxt = -1;
          for (int w = from >> 5; w < nw; ++w) {
            uint32_t m = valid[w];
            if (w == (from >> 5)) m &= 0xffffffffu << (from & 31);
            if (m) {
              nxt = w * 32 + __ffs(m) - 1;
              break;
            }
          }
          if (nxt < 0) break;                    // none left in this span
          if (t == W) {
            overflow = 1;
            break;
          }
          const uint32_t bv = best[nxt];
          const int brow = sub + nxt;
          const int mt = min(static_cast<int>(bv & 0x7FF), lim - brow);
          rec[t * G + g] = gbase + brow;
          rec[(W + t) * G + g] = mt;
          rec[(2 * W + t) * G + g] = static_cast<int32_t>(bv >> bt::kRunBits);
          ++t;
          pos = brow + mt;
        }
      }
      pos = __shfl_sync(0xffffffffu, pos, 0);
      t = __shfl_sync(0xffffffffu, t, 0);
      overflow = __shfl_sync(0xffffffffu, overflow, 0);
      __syncwarp();
    }
    if (lane == 0) rec[3 * W * G + g] = overflow;
  }
}

}  // namespace

// Launches one CTA per block on `stream`; returns the CUDA error code (0 on
// success).  Pointers are device pointers; the caller allocates `rec`.
// Offsets in the first noff[b] slots of a row must lie in [0, L).
extern "C" int bt_match_walk_launch(const void* planes, const void* noff, const void* offs,
                                    int K, const void* lengths, void* rec, int n, int L,
                                    int seg, int min_match, int wcap, int max_match,
                                    void* stream) {
  if (n < 0 || L <= 0 || L % 128 || seg <= 0 || L % seg || K < 0 || wcap < 0 ||
      max_match < 1 || max_match > 2047)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const int words = bt::warp_scratch_words(min(bt::kSpan, seg), max_match);
  const int warps = bt::warps_that_fit(L, K, words);
  if (warps == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = bt::smem_bytes(L, K, words, warps);
  const cudaError_t err = bt::smem_opt_in(match_walk_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a;
  a.planes = static_cast<const uint8_t*>(planes);
  a.noff = static_cast<const int32_t*>(noff);
  a.offs = static_cast<const int32_t*>(offs);
  a.K = K;
  a.lengths = static_cast<const int32_t*>(lengths);
  a.rec = static_cast<int32_t*>(rec);
  a.L = L;
  a.seg = seg;
  a.nseg = L / seg;
  a.min_match = min_match;
  a.wcap = wcap;
  a.max_match = max_match;
  a.warps = warps;
  a.words = words;
  match_walk_kernel<<<n, 32 * warps, smem,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
