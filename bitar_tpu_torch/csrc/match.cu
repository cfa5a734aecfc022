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
// Design.  The scoring of match_score.cuh (kernels B4 and B5) with the
// tuple as every block's offsets and `cap` as its run cap: one CTA of up to
// 16 warps per block, the raw plane and the tuple in shared memory, each
// warp scoring 1024-position spans by ballots.  An index is the first slot of
// the tuple holding the winning value: a later duplicate never wins a tie.
//
// Bound.  Per position and offset a ballot bit and a run read off the bit
// words: integer work of positions x offsets.  Device traffic is the plane
// read once and 8 bytes per position written.

#include "match_score.cuh"

namespace {

struct Args {
  const uint8_t* planes;        // [n, L]
  const int32_t* offs;          // [K]
  int K;
  int32_t* mlen;                // [n, L]
  int32_t* idx;                 // [n, L]
  int L, cap, max_match, warps, words, emit_values;
};

__global__ void __launch_bounds__(512) match_kernel(Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* plane = smem;
  int32_t* soffs = reinterpret_cast<int32_t*>(smem + a.L);
  uint32_t* scratch_all = reinterpret_cast<uint32_t*>(smem + a.L + 4 * a.K);
  const int b = blockIdx.x;
  const uint4* src = reinterpret_cast<const uint4*>(a.planes + static_cast<long long>(b) * a.L);
  uint4* dst = reinterpret_cast<uint4*>(plane);
  for (int i = threadIdx.x; i < a.L / 16; i += blockDim.x) dst[i] = src[i];
  for (int i = threadIdx.x; i < a.K; i += blockDim.x) soffs[i] = a.offs[i];
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t* scratch = scratch_all + warp * a.words;
  int32_t* mlen = a.mlen + static_cast<long long>(b) * a.L;
  int32_t* idx = a.idx + static_cast<long long>(b) * a.L;
  for (int p0 = warp * bt::kSpan; p0 < a.L; p0 += a.warps * bt::kSpan) {
    const int span = min(bt::kSpan, a.L - p0);
    bt::score_span(plane, a.L, p0, span, soffs, a.K, a.cap, scratch);
    const uint32_t* best = bt::span_best(scratch, span, a.cap);
    for (int j = lane; j < span; j += 32) {
      const uint32_t bv = best[j];
      const int run = static_cast<int>(bv & 0x7FF);
      const int d = static_cast<int>(bv >> bt::kRunBits);
      int out = 0;
      if (a.emit_values) {
        out = d;
      } else if (run > 0) {
        int k = 0;
        while (k < a.K - 1 && soffs[k] != d) ++k;
        out = k;
      }
      mlen[p0 + j] = run < a.max_match ? run : a.max_match;
      idx[p0 + j] = out;
    }
    __syncwarp();
  }
}

}  // namespace

// Launches one CTA per block on `stream`; returns the CUDA error code (0 on
// success).  Pointers are device pointers; the caller allocates the outputs.
// Offsets must lie in [0, 2^20); max_match in [1, 1024].
extern "C" int bt_match_launch(const void* planes, const void* offs, int K, void* mlen,
                               void* idx, int n, int L, int max_match, int emit_values,
                               void* stream) {
  if (n < 0 || L <= 0 || L % 128 || K < 1 || max_match < 1 || max_match > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  int cap = 1;
  while (cap < max_match) cap *= 2;
  const int words = bt::warp_scratch_words(bt::kSpan, cap);
  const int warps = bt::warps_that_fit(L, K, words);
  if (warps == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = bt::smem_bytes(L, K, words, warps);
  const cudaError_t err = bt::smem_opt_in(match_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a;
  a.planes = static_cast<const uint8_t*>(planes);
  a.offs = static_cast<const int32_t*>(offs);
  a.K = K;
  a.mlen = static_cast<int32_t*>(mlen);
  a.idx = static_cast<int32_t*>(idx);
  a.L = L;
  a.cap = cap;
  a.max_match = max_match;
  a.warps = warps;
  a.words = words;
  a.emit_values = emit_values;
  match_kernel<<<n, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
