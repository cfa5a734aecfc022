// Dense-plan block decode for Hopper (sm_90a): kernel B7.
//
// Replaces the TPU kernel bitar_tpu/ops/pallas/lz4_decode_planned.py
// `_planned_kernel` (called through `decode_blocks_planned`).  Per block i,
// over the stacked plane S = [comp rows | out rows | zeros] of w_rows rows:
// each pass k < min(p_used[i], passes), in order, reads S as it stood before
// the pass.  In out row r, lane l is active when start <= l < end (start =
// se >>> 8, end = se & 0xFF); it takes q = r*128 + l + shift (int32,
// wrapping), qrow = q >>> 7, and with row_a = min(min over the row's active
// lanes of qrow, w_rows - 2) the byte S[qrow == row_a ? row_a : row_a + 1]
// [q & 127].  Only active lanes are written.
//
// Design.  One CTA of 1024 threads per block; the out plane (at most 1024
// rows, 128 KiB) lives in shared memory, as in decode_flat.cu.  A warp owns
// a row and each lane four consecutive bytes of it (one 32-bit word), so the
// row's anchor is one __reduce_min_sync.  Comp rows are read from global
// memory through L2; rows past comp_rows + out_rows read 0.  A pass gathers
// every word into registers (inactive bytes keep their old value), then
// __syncthreads(), then writes every word, then __syncthreads().  The TPU
// kernel's one-hot MXU row fetch and its bf16 plane are not carried over.
//
// Bound.  Device traffic: the comp planes and the plan cells (8 bytes per
// pass and row) read once, the planes written once; each pass is a few
// integer operations per byte.

#include <cstdint>

#include "cuda_util.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 1024;
constexpr int kRowsPerWarp = kMaxRows / kWarps;   // 32
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const uint8_t* comp;          // [n, comp_rows, 128]
  int comp_rows;
  const int32_t* p_used;        // [n]
  const int32_t* se;            // [n, passes, out_rows]
  const int32_t* shift;         // [n, passes, out_rows]
  int passes;
  uint8_t* out;                 // [n, out_rows, 128]
  int out_rows, w_rows;
};

__device__ __forceinline__ uint32_t s_byte(const uint8_t* comp, const uint8_t* plane,
                                           int comp_rows, int out_rows, uint32_t row,
                                           uint32_t lane) {
  if (row < static_cast<uint32_t>(comp_rows)) return comp[row * 128u + lane];
  row -= comp_rows;
  if (row < static_cast<uint32_t>(out_rows)) return plane[row * 128u + lane];
  return 0;
}

__global__ void __launch_bounds__(kThreads, 1) decode_planned_kernel(Args a) {
  extern __shared__ __align__(16) uint32_t plane_words[];
  const uint8_t* plane = reinterpret_cast<const uint8_t*>(plane_words);
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int words = a.out_rows * 32;
  for (int i = threadIdx.x; i < words; i += kThreads) plane_words[i] = 0;
  __syncthreads();

  const uint8_t* comp = a.comp + static_cast<long long>(b) * a.comp_rows * 128;
  const long long cells = static_cast<long long>(a.passes) * a.out_rows;
  const int32_t* se_b = a.se + b * cells;
  const int32_t* sh_b = a.shift + b * cells;
  const int np = min(a.p_used[b], a.passes);
  const uint32_t row_cap = static_cast<uint32_t>(a.w_rows - 2);

  for (int k = 0; k < np; ++k) {
    uint32_t vals[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + kWarps * i;
      if (r >= a.out_rows) break;                    // warp-uniform
      const uint32_t se = static_cast<uint32_t>(se_b[k * a.out_rows + r]);
      const uint32_t sh = static_cast<uint32_t>(sh_b[k * a.out_rows + r]);
      const uint32_t start = se >> 8, end = se & 0xFFu;
      uint32_t q[4];
      uint32_t low = 1u << 29;
      unsigned active = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t l = 4u * lane + j;
        q[j] = static_cast<uint32_t>(r) * 128u + l + sh;
        if (l >= start && l < end) {
          active |= 1u << j;
          low = min(low, q[j] >> 7);
        }
      }
      const uint32_t row_a = min(__reduce_min_sync(kFull, low), row_cap);
      uint32_t v = plane_words[r * 32 + lane];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (active & (1u << j)) {
          const uint32_t src = (q[j] >> 7) == row_a ? row_a : row_a + 1;
          const uint32_t byte = s_byte(comp, plane, a.comp_rows, a.out_rows, src, q[j] & 127u);
          v = (v & ~(0xFFu << (8 * j))) | (byte << (8 * j));
        }
      }
      vals[i] = v;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + kWarps * i;
      if (r >= a.out_rows) break;
      plane_words[r * 32 + lane] = vals[i];
    }
    __syncthreads();
  }

  uint4* dst = reinterpret_cast<uint4*>(a.out + static_cast<long long>(b) * a.out_rows * 128);
  const uint4* src = reinterpret_cast<const uint4*>(plane_words);
  for (int i = threadIdx.x; i < a.out_rows * 8; i += kThreads) dst[i] = src[i];
}

}  // namespace

// Launches one CTA per block on `stream`; returns the CUDA error code (0 on
// success).  Pointers are device pointers; the caller allocates `out`.
extern "C" int bt_decode_planned_launch(const void* comp, int comp_rows, const void* p_used,
                                        const void* se, const void* shift, int passes,
                                        void* out, int n, int out_rows, void* stream) {
  if (n < 0 || comp_rows < 0 || passes < 0 || out_rows <= 0 || out_rows % 128 ||
      out_rows > kMaxRows)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const int smem = out_rows * 128;
  // Opt in to the largest plane once, so launches of other block sizes from
  // other threads never meet a smaller limit.
  const cudaError_t err = bt::smem_opt_in(decode_planned_kernel, kMaxRows * 128);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a;
  a.comp = static_cast<const uint8_t*>(comp);
  a.comp_rows = comp_rows;
  a.p_used = static_cast<const int32_t*>(p_used);
  a.se = static_cast<const int32_t*>(se);
  a.shift = static_cast<const int32_t*>(shift);
  a.passes = passes;
  a.out = static_cast<uint8_t*>(out);
  a.out_rows = out_rows;
  a.w_rows = (comp_rows + out_rows + 1023) / 1024 * 1024;
  decode_planned_kernel<<<n, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
