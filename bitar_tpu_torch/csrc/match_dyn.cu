// Dynamic-offset match scoring for Hopper (sm_90a): kernel B4 of the device
// compress path (segments below 1024 bytes).
//
// Replaces the TPU kernel bitar_tpu/ops/pallas/lz4_match_dyn.py
// `_dyn_match_kernel` (called through `find_matches_dyn`): for every
// position of a block, the best run over the block's offsets and that
// offset (match_tile.cuh), written as mlen, moff [N, L] int32.
//
// Bound.  8 bytes of output per position written to device memory (64 MiB
// for 64 x 128 KiB), against one byte compare and one comparison with the
// best run per position and offset: at a few offsets a block the writes
// bound it.
//
// Design.  A CTA of 8 warps takes a tile of 8192 positions of one block
// (the grid is blocks x tiles, so 64 blocks fill the 132 SMs), a warp one
// 1024-position span, scored in registers (`bt::score_span`).  A lane holds
// 32 consecutive positions, so its own 16-byte stores would scatter a warp's
// store over 32 lines (B4 then wrote at ~0.6 TB/s): each plane goes out
// through the warp's 4 KiB of shared memory instead, written by rows with
// the 16-byte chunks XOR-swizzled (no bank conflict either way) and read
// back so that each store instruction covers 512 contiguous bytes.  A CTA
// whose block has no offsets writes zeros without reading a plane byte.

#include "match_tile.cuh"

namespace {

constexpr int kWarps = 8;                       // spans a CTA takes, a warp each

struct Args {
  const uint8_t* planes;        // [n, L]
  const int32_t* noff;          // [n]
  const int32_t* offs;          // [n, K]
  int K;
  int32_t* mlen;                // [n, L]
  int32_t* moff;                // [n, L]
  int L, tiles, max_match;
};

// Stores the lane's 32 values value(j) (positions P + j of the span, lane w
// owning P = p0 + 32 w) to out = plane + p0, 512 contiguous bytes a
// store, through the warp's buffer of 256 16-byte chunks (lane w's row of 8
// chunks, chunk q at q ^ (w & 7)).
template <typename Value>
__device__ __forceinline__ void store_span(int4* out, uint4* buf, int nw, int lane,
                                           Value value) {
#pragma unroll
  for (int q = 0; q < 8; ++q)
    buf[8 * lane + (q ^ (lane & 7))] =
        make_uint4(value(4 * q), value(4 * q + 1), value(4 * q + 2), value(4 * q + 3));
  __syncwarp();
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int i = 32 * q + lane, row = i >> 3;      // chunk i of the span, from lane `row`
    if (row < nw) {
      const uint4 v = buf[8 * row + ((i & 7) ^ (row & 7))];
      out[i] = make_int4(static_cast<int>(v.x), static_cast<int>(v.y), static_cast<int>(v.z),
                         static_cast<int>(v.w));
    }
  }
  __syncwarp();                                     // the buffer is reused
}

__global__ void __launch_bounds__(32 * kWarps) match_dyn_kernel(Args a) {
  __shared__ uint4 bufs[kWarps][256];               // each warp's 4 KiB store buffer
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x / a.tiles;
  const int p0 = ((blockIdx.x - b * a.tiles) * kWarps + warp) * bt::kSpan;
  if (p0 >= a.L) return;                        // the whole warp
  const int nw = min(bt::kWords, (a.L - p0) >> 5);     // L % 128 == 0: whole words
  int noff = __ldg(a.noff + b);
  noff = noff < 0 ? 0 : min(noff, a.K);
  const long long base = static_cast<long long>(b) * a.L + p0;
  int4* ml = reinterpret_cast<int4*>(a.mlen + base);
  int4* mo = reinterpret_cast<int4*>(a.moff + base);
  if (noff == 0) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int i = 32 * q + lane;
      if ((i >> 3) < nw) ml[i] = mo[i] = make_int4(0, 0, 0, 0);
    }
    return;
  }
  const int32_t* offs = a.offs + static_cast<long long>(b) * a.K;
  uint32_t best[32];
  bt::score_span(a.planes + static_cast<long long>(b) * a.L, a.L, p0, nw, offs, noff,
                 static_cast<uint32_t>(a.max_match), best);
  uint4* buf = bufs[warp];
  store_span(ml, buf, nw, lane, [&](int j) { return best[j] >> bt::kSlotBits; });
  store_span(mo, buf, nw, lane, [&](int j) {     // the slot's offset where a run is
    const uint32_t bv = best[j];
    if (bv >> bt::kSlotBits == 0) return 0u;
    return static_cast<uint32_t>(__ldg(offs + (bt::kSlotMax - (bv & bt::kSlotMax))));
  });
}

}  // namespace

// Launches n x ceil(L / 8192) CTAs on `stream` of `device`; returns the CUDA
// error code (0 on success).  Pointers are device pointers, `planes`,
// `mlen` and `moff` 16-byte aligned; the caller allocates the outputs.
// Offsets in the first noff[b] slots of a row must lie in [0, L).
extern "C" int bt_match_dyn_launch(const void* planes, const void* noff, const void* offs,
                                   int K, void* mlen, void* moff, int n, int L,
                                   int max_match, int device, void* stream) {
  const auto misaligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) != 0;
  };
  if (n < 0 || L <= 0 || L % 128 || K < 0 || max_match < 1 || max_match > 2047 ||
      device < 0 || misaligned(planes) || misaligned(mlen) || misaligned(moff))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  Args a;
  a.planes = static_cast<const uint8_t*>(planes);
  a.noff = static_cast<const int32_t*>(noff);
  a.offs = static_cast<const int32_t*>(offs);
  a.K = K;
  a.mlen = static_cast<int32_t*>(mlen);
  a.moff = static_cast<int32_t*>(moff);
  a.L = L;
  a.tiles = (L + kWarps * bt::kSpan - 1) / (kWarps * bt::kSpan);
  a.max_match = max_match;
  const long long grid = static_cast<long long>(n) * a.tiles;
  if (grid > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  int previous = 0;
  cudaError_t err = bt::enter_device(device, &previous);
  if (err != cudaSuccess) return static_cast<int>(err);
  match_dyn_kernel<<<static_cast<unsigned>(grid), 32 * kWarps, 0,
                     static_cast<cudaStream_t>(stream)>>>(a);
  err = cudaGetLastError();
  if (previous != device) cudaSetDevice(previous);
  return static_cast<int>(err);
}
