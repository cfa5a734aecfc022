// LZ4 / Snappy byte emission for Hopper (sm_90a): one emitter for the device
// compress path at every width.
//
// Replaces the TPU kernels of bitar_tpu/ops/pallas/lz4_emit.py:
// `_packed_kernel` (B8, via `materialize_pallas_packed`), `_compact_kernel`
// (B9) + `_emit_kernel` (B10, via `materialize_pallas`), and the XLA
// `materialize` of bitar_tpu/ops/device_compress.py.  All compute one
// function: output byte t < total[b] belongs to the last slot whose start
// is <= t (starts never decrease; of equal starts the last is the real
// slot), and its value follows from that slot's (lit_len, lit_start, mv,
// off):
//   LZ4:    token, literal-length extensions, literals from the raw plane,
//           2 offset bytes, match-length extensions;
//   Snappy: the uncompressed-length varint first, then per slot the literal
//           tag + 0-3 length bytes, literals, one 3-byte copy-2 element per
//           <= 64-byte match chunk.
// Bytes past total are 0; rows with total > out_width are garbage by
// contract (the caller stores them RAW).
//
// Design.  One thread per output byte.  A CTA emits a 2048-byte tile of one
// block: it stages the block's slot starts in shared memory, and each thread
// finds its slot by binary search there and reads the slot's fields and its
// literal byte through L1/L2.  The TPU kernels' one-hot MXU scatters,
// prefix-max wires and slot windows are layout devices of the TPU and are
// not carried over.
//
// Bound.  Device memory: the raw plane (literal bytes) read and the
// [N, out_width] output written, plus the slot layout.

#include <cstdint>

#include "cuda_util.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 2048;            // output bytes per CTA

struct Args {
  const uint8_t* planes;               // [n, L]
  int L;
  const int32_t* starts;               // [n, S] slot output starts
  const int32_t* lit_len;
  const int32_t* lit_start;
  const int32_t* mv;                   // match length - 4, -1 for none
  const int32_t* off;
  int S;
  const int32_t* total;                // [n]
  const int32_t* lengths;              // [n] raw lengths (Snappy varint)
  uint8_t* out;                        // [n, ow]
  int ow;
  int snappy;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ int emit_byte(const Args& a, const int32_t* sst, int b, int t,
                         const uint8_t* plane) {
  if (a.snappy) {
    const int blen = a.lengths[b];
    const int vl = 1 + (blen >= (1 << 7)) + (blen >= (1 << 14));
    if (t < vl) {
      int pre = (blen >> clampi(7 * t, 0, 28)) & 0x7F;
      if ((blen >> clampi(7 * (t + 1), 0, 28)) > 0) pre |= 0x80;
      return pre;
    }
  }
  int lo = 0, hi = a.S;                // first start > t
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sst[mid] <= t) lo = mid + 1; else hi = mid;
  }
  const int k = lo - 1;
  if (k < 0) return 0;
  const long long row = static_cast<long long>(b) * a.S + k;
  const int ll = a.lit_len[row], ls = a.lit_start[row];
  const int mv = a.mv[row], off = a.off[row];
  const int d = t - sst[k];
  if (!a.snappy) {
    const int hdr = 1 + (ll >= 15 ? (ll - 15) / 255 + 1 : 0);
    const int lit_end = hdr + ll;
    if (d == 0) return (min(ll, 15) << 4) | (mv >= 0 ? min(mv, 15) : 0);
    if (d < hdr) return clampi(ll - 15 - 255 * (d - 1), 0, 255);
    if (d < lit_end) return plane[clampi(ls + d - hdr, 0, a.L - 1)];
    if (d == lit_end) return off & 0xFF;
    if (d == lit_end + 1) return (off >> 8) & 0xFF;
    return clampi(mv - 15 - 255 * (d - lit_end - 2), 0, 255);
  }
  const int n1 = ll - 1;
  const int extra = n1 < 60 ? 0 : (n1 < 256 ? 1 : (n1 < 65536 ? 2 : 3));
  const int hdr = ll > 0 ? 1 + extra : 0;
  const int lit_end = hdr + ll;
  if (d < hdr) {
    if (d == 0) return extra == 0 ? (n1 << 2) & 0xFF : ((59 + extra) << 2) & 0xFF;
    return (n1 >> clampi(8 * (d - 1), 0, 24)) & 0xFF;
  }
  if (d < lit_end) return plane[clampi(ls + d - hdr, 0, a.L - 1)];
  const int cd = d - lit_end;
  const int ci = cd / 3, r3 = cd - 3 * ci;
  const int clen = clampi(mv + 4 - 64 * ci, 1, 64);
  if (r3 == 0) return 2 | ((clen - 1) << 2);
  return r3 == 1 ? off & 0xFF : (off >> 8) & 0xFF;
}

__global__ void __launch_bounds__(kThreads) emit_kernel(Args a) {
  extern __shared__ int32_t sst[];
  const int b = blockIdx.x;
  const int t0 = blockIdx.y * kTile;
  const int32_t* st = a.starts + static_cast<long long>(b) * a.S;
  for (int i = threadIdx.x; i < a.S; i += kThreads) sst[i] = st[i];
  __syncthreads();
  const int total = a.total[b];
  const uint8_t* plane = a.planes + static_cast<long long>(b) * a.L;
  uint8_t* out = a.out + static_cast<long long>(b) * a.ow;
  const int t1 = min(t0 + kTile, a.ow);
  for (int t = t0 + threadIdx.x; t < t1; t += kThreads)
    out[t] = static_cast<uint8_t>(t < total ? emit_byte(a, sst, b, t, plane) : 0);
}

}  // namespace

// Launches (n, ceil(ow / 2048)) CTAs on `stream`; returns the CUDA error
// code (0 on success).  Pointers are device pointers; the caller allocates
// `out`.
extern "C" int bt_emit_launch(const void* planes, int L, const void* starts,
                              const void* lit_len, const void* lit_start, const void* mv,
                              const void* off, int S, const void* total,
                              const void* lengths, void* out, int n, int ow, int snappy,
                              void* stream) {
  if (n < 0 || L <= 0 || S <= 0 || ow <= 0 || 4LL * S > bt::kSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const cudaError_t err = bt::smem_opt_in(emit_kernel, 4 * S);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a;
  a.planes = static_cast<const uint8_t*>(planes);
  a.L = L;
  a.starts = static_cast<const int32_t*>(starts);
  a.lit_len = static_cast<const int32_t*>(lit_len);
  a.lit_start = static_cast<const int32_t*>(lit_start);
  a.mv = static_cast<const int32_t*>(mv);
  a.off = static_cast<const int32_t*>(off);
  a.S = S;
  a.total = static_cast<const int32_t*>(total);
  a.lengths = static_cast<const int32_t*>(lengths);
  a.out = static_cast<uint8_t*>(out);
  a.ow = ow;
  a.snappy = snappy;
  const dim3 grid(n, (ow + kTile - 1) / kTile);
  emit_kernel<<<grid, kThreads, 4 * S, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
