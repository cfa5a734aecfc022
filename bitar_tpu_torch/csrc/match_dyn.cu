// Dynamic-offset match scoring for Hopper (sm_90a): kernel B4 of the device
// compress path (segments below 1024 bytes).
//
// Replaces the TPU kernel bitar_tpu/ops/pallas/lz4_match_dyn.py
// `_dyn_match_kernel` (called through `find_matches_dyn`): for every
// position of a block, the best run over the block's offsets and that
// offset (match_score.cuh), written as mlen, moff [N, L] int32.
//
// Design.  One CTA of up to 16 warps per block; the raw plane sits in shared
// memory and each warp scores 1024-position spans in turn, then writes its
// span's two output rows.
//
// Bound.  The same integer work per position and offset as B5, plus 8 bytes
// of output per position written to device memory.

#include "match_score.cuh"

namespace {

struct Args {
  const uint8_t* planes;        // [n, L]
  const int32_t* noff;          // [n]
  const int32_t* offs;          // [n, K]
  int K;
  int32_t* mlen;                // [n, L]
  int32_t* moff;                // [n, L]
  int L, max_match, warps, words;
};

__global__ void __launch_bounds__(512) match_dyn_kernel(Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* plane = smem;
  int32_t* soffs = reinterpret_cast<int32_t*>(smem + a.L);
  uint32_t* scratch_all = reinterpret_cast<uint32_t*>(smem + a.L + 4 * a.K);
  const int b = blockIdx.x;
  bt::load_block(a.planes, a.offs, a.K, a.L, b, plane, soffs);
  int noff = a.noff[b];
  noff = noff < 0 ? 0 : (noff > a.K ? a.K : noff);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t* scratch = scratch_all + warp * a.words;
  int32_t* mlen = a.mlen + static_cast<long long>(b) * a.L;
  int32_t* moff = a.moff + static_cast<long long>(b) * a.L;
  for (int p0 = warp * bt::kSpan; p0 < a.L; p0 += a.warps * bt::kSpan) {
    const int span = min(bt::kSpan, a.L - p0);
    bt::score_span(plane, a.L, p0, span, soffs, noff, a.max_match, scratch);
    const uint32_t* best = bt::span_best(scratch, span, a.max_match);
    for (int j = lane; j < span; j += 32) {
      const uint32_t bv = best[j];
      mlen[p0 + j] = static_cast<int32_t>(bv & 0x7FF);
      moff[p0 + j] = static_cast<int32_t>(bv >> bt::kRunBits);
    }
    __syncwarp();
  }
}

}  // namespace

// Launches one CTA per block on `stream`; returns the CUDA error code (0 on
// success).  Pointers are device pointers; the caller allocates the outputs.
// Offsets in the first noff[b] slots of a row must lie in [0, L).
extern "C" int bt_match_dyn_launch(const void* planes, const void* noff, const void* offs,
                                   int K, void* mlen, void* moff, int n, int L,
                                   int max_match, void* stream) {
  if (n < 0 || L <= 0 || L % 128 || K < 0 || max_match < 1 || max_match > 2047)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const int words = bt::warp_scratch_words(bt::kSpan, max_match);
  const int warps = bt::warps_that_fit(L, K, words);
  if (warps == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = bt::smem_bytes(L, K, words, warps);
  const cudaError_t err = bt::smem_opt_in(match_dyn_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a;
  a.planes = static_cast<const uint8_t*>(planes);
  a.noff = static_cast<const int32_t*>(noff);
  a.offs = static_cast<const int32_t*>(offs);
  a.K = K;
  a.mlen = static_cast<int32_t*>(mlen);
  a.moff = static_cast<int32_t*>(moff);
  a.L = L;
  a.max_match = max_match;
  a.warps = warps;
  a.words = words;
  match_dyn_kernel<<<n, 32 * warps, smem,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
