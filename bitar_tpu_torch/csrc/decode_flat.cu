// Flat-plan block decode for Hopper (sm_90a): LZ4, Snappy and RAW blocks.
//
// Replaces the TPU kernel bitar_tpu/ops/pallas/lz4_decode_flat.py
// `_flat_kernel` (called through `decode_blocks_flat`).  It computes what
// that module's numpy oracle `decode_flat_numpy` computes, per block:
//   1. RAW block (dense < 0): output = comp plane, zero past it.
//   2. otherwise the plane starts at zero; dense passes write every byte
//      whose dq pass id pid is in [1, dense]: comp[(row_a + drow)*128 + qlane];
//   3. comp passes k < p0: lanes [start, end) of row r take comp[p + shift];
//   4. out passes p0 <= k < p_used, in order, gather from the output plane
//      as it stood before the pass: out[p + shift].
// Every source index clips to its plane; comp bytes past the row width are 0.
//
// Design.  One CTA of 1024 threads decodes one block.  The block's out plane
// (out_rows * 128 bytes, at most 128 KiB) lives in dynamic shared memory.
// Thread t owns the 32-bit words w = t + i * 1024 of the plane, so the 32
// lanes of a warp cover one 128-byte row per step and read that row's
// se/shift cell as a broadcast.
//   * Dense and comp passes read only the comp plane, which nothing writes,
//     so each thread folds every such pass into its own words with no
//     barrier between passes (they are applied in plan order per byte, which
//     is the oracle's order).
//   * Out passes read bytes other threads own.  Each pass first gathers the
//     new value of all its words into registers, then __syncthreads(), then
//     writes them, then __syncthreads(): every read sees the plane as it was
//     before the pass, as the oracle requires.  The TPU kernel writes M-tile
//     by M-tile instead; that order is not copied.
// The comp plane is read from device memory through L2 (a comp plane of a
// 128 KiB block can be 128 KiB itself and does not fit beside the out plane).
//
// Bound.  A pass costs one gather per output byte: the kernel is bound by
// gathers (shared memory for out passes, L2 for comp and dense passes) and
// by the two barriers of every out pass, not by device-memory bandwidth:
// the device traffic is the comp bytes, the plan wire and the output.

#include <cstdint>

#include "cuda_util.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxWords = 32;     // words per thread: 1024 rows * 32 / 1024
constexpr int kLanes = 128;

struct Args {
  const uint8_t* comp;            // [n] rows of comp_stride bytes
  long long comp_stride;
  int comp_width;                 // bytes per row that hold data
  int comp_len;                   // comp plane length: comp_rows * 128
  const int32_t* p_used;
  const int32_t* p_off;
  const int32_t* p0;
  const int32_t* dense;
  const int32_t* dq_idx;
  const int16_t* se;              // [s_rows, out_rows]
  const int32_t* shift;           // [s_rows, out_rows]
  long long s_rows;
  const int16_t* dq;              // [dq_rows, out_rows * 128]
  int dq_rows;
  const int32_t* row_a;           // [dq_rows, dcap, 128, tiles]
  int dcap;
  uint8_t* out;                   // [n, out_rows * 128]
  int out_rows;
};

__device__ __forceinline__ uint32_t comp_byte(const uint8_t* cp, long long q,
                                              const Args& a) {
  q = q < 0 ? 0 : (q >= a.comp_len ? a.comp_len - 1 : q);
  return q < a.comp_width ? cp[q] : 0u;
}

__device__ __forceinline__ uint32_t set_byte(uint32_t w, int j, uint32_t b) {
  return (w & ~(0xFFu << (8 * j))) | (b << (8 * j));
}

__global__ void __launch_bounds__(kThreads, 1) decode_flat_kernel(Args a) {
  extern __shared__ uint32_t plane[];
  const int b = blockIdx.x;
  const int out_words = a.out_rows * (kLanes / 4);
  const int out_len = a.out_rows * kLanes;
  const uint8_t* cp = a.comp + static_cast<long long>(b) * a.comp_stride;
  uint32_t* outw = reinterpret_cast<uint32_t*>(
      a.out + static_cast<long long>(b) * out_len);
  const int dn = a.dense[b];

  if (dn < 0) {                   // RAW: the output is the comp plane
    for (int w = threadIdx.x; w < out_words; w += kThreads) {
      uint32_t v = 0;
      for (int j = 0; j < 4; ++j) {
        const int p = w * 4 + j;
        v |= (p < a.comp_len ? comp_byte(cp, p, a) : 0u) << (8 * j);
      }
      outw[w] = v;
    }
    return;
  }

  // Pass bounds, clamped to the wire so a malformed plan cannot read past it.
  const long long base = a.p_off[b];
  long long np = a.p_used[b];
  if (base < 0) np = 0;
  if (np > a.s_rows - base) np = a.s_rows - base;
  if (np < 0) np = 0;
  const int npass = static_cast<int>(np);
  int ncomp = a.p0[b];
  ncomp = ncomp < 0 ? 0 : (ncomp > npass ? npass : ncomp);
  const int di = a.dq_idx[b];
  const bool dense_on = dn > 0 && di >= 0 && di < a.dq_rows;
  const int tiles = a.out_rows / kLanes;

  // Dense and comp passes, straight into each thread's own words.
  for (int w = threadIdx.x; w < out_words; w += kThreads) {
    const int row = w >> 5;
    const int lane0 = (w & 31) * 4;
    uint32_t v = 0;
    if (dense_on) {
      const int16_t* dqr = a.dq + static_cast<long long>(di) * out_len;
      // Anchor plane j of wire row di is [128, tiles]: row r at [r & 127, r >> 7].
      const int32_t* ra =
          a.row_a + static_cast<long long>(di) * a.dcap * a.out_rows;
      for (int j = 0; j < 4; ++j) {
        const uint32_t d = static_cast<uint16_t>(dqr[w * 4 + j]);
        const int pid = (d >> 9) & 0x3F;
        if (pid >= 1 && pid <= dn && pid <= a.dcap) {
          const long long anchor =
              ra[static_cast<long long>(pid - 1) * a.out_rows +
                 (row & 127) * tiles + (row >> 7)];
          const long long q = (anchor + ((d >> 7) & 3)) * kLanes + (d & 127);
          v = set_byte(v, j, comp_byte(cp, q, a));
        }
      }
    }
    for (int k = 0; k < ncomp; ++k) {
      const long long cell = (base + k) * a.out_rows + row;
      const uint32_t s = static_cast<uint16_t>(a.se[cell]);
      const int start = (s >> 8) & 0x7F, end = s & 0xFF;
      if (start >= lane0 + 4 || end <= lane0 || start >= end) continue;
      const long long sh = a.shift[cell];
      for (int j = 0; j < 4; ++j) {
        const int lane = lane0 + j;
        if (lane >= start && lane < end)
          v = set_byte(v, j, comp_byte(cp, w * 4 + j + sh, a));
      }
    }
    plane[w] = v;
  }
  __syncthreads();

  // Out passes: gather all, barrier, write all, barrier.
  const uint8_t* pb = reinterpret_cast<const uint8_t*>(plane);
  for (int k = ncomp; k < npass; ++k) {
    uint32_t pend[kMaxWords];
#pragma unroll
    for (int i = 0; i < kMaxWords; ++i) {
      const int w = threadIdx.x + i * kThreads;
      if (w < out_words) {
        const int row = w >> 5;
        const int lane0 = (w & 31) * 4;
        const long long cell = (base + k) * a.out_rows + row;
        const uint32_t s = static_cast<uint16_t>(a.se[cell]);
        const int start = (s >> 8) & 0x7F, end = s & 0xFF;
        uint32_t v = plane[w];
        if (start < lane0 + 4 && end > lane0 && start < end) {
          const long long sh = a.shift[cell];
          for (int j = 0; j < 4; ++j) {
            const int lane = lane0 + j;
            if (lane >= start && lane < end) {
              long long q = w * 4 + j + sh;
              q = q < 0 ? 0 : (q >= out_len ? out_len - 1 : q);
              v = set_byte(v, j, pb[q]);
            }
          }
        }
        pend[i] = v;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kMaxWords; ++i) {
      const int w = threadIdx.x + i * kThreads;
      if (w < out_words) plane[w] = pend[i];
    }
    __syncthreads();
  }

  for (int w = threadIdx.x; w < out_words; w += kThreads) outw[w] = plane[w];
}

}  // namespace

// Launches one CTA per block on `stream`; returns cudaGetLastError() (0 on
// success).  Pointers are device pointers; the caller allocates `out`.
extern "C" int bt_decode_flat_launch(
    const void* comp, long long comp_stride, int comp_width, int comp_rows,
    const void* p_used, const void* p_off, const void* p0, const void* dense,
    const void* dq_idx, const void* se, const void* shift, long long s_rows,
    const void* dq, int dq_rows, const void* row_a, int dcap, void* out, int n,
    int out_rows, void* stream) {
  if (out_rows <= 0 || out_rows % kLanes != 0 ||
      out_rows * (kLanes / 4) > kThreads * kMaxWords || comp_rows <= 0 ||
      dcap <= 0 || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const int smem = out_rows * kLanes;
  const cudaError_t err = bt::smem_opt_in(decode_flat_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a;
  a.comp = static_cast<const uint8_t*>(comp);
  a.comp_stride = comp_stride;
  a.comp_width = comp_width;
  a.comp_len = comp_rows * kLanes;
  a.p_used = static_cast<const int32_t*>(p_used);
  a.p_off = static_cast<const int32_t*>(p_off);
  a.p0 = static_cast<const int32_t*>(p0);
  a.dense = static_cast<const int32_t*>(dense);
  a.dq_idx = static_cast<const int32_t*>(dq_idx);
  a.se = static_cast<const int16_t*>(se);
  a.shift = static_cast<const int32_t*>(shift);
  a.s_rows = s_rows;
  a.dq = static_cast<const int16_t*>(dq);
  a.dq_rows = dq_rows;
  a.row_a = static_cast<const int32_t*>(row_a);
  a.dcap = dcap;
  a.out = static_cast<uint8_t*>(out);
  a.out_rows = out_rows;
  decode_flat_kernel<<<n, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
