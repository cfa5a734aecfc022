// Sequence-table block decode for Hopper (sm_90a): kernel B2.
//
// Replaces the TPU kernel bitar_tpu/ops/pallas/lz4_decode.py `_decode_kernel`
// (called through `decode_blocks`, with copydsl.copy_span / copy_match).  Per
// block b with ns = clamp(nseq[b], 0, S) sequences (ops/decode_tables.py):
//   1. the output plane starts at zero;
//   2. literals, in sequence order: out[out_pos + j] = comp[lit_ptr + j];
//   3. matches, in sequence order, dst = out_pos + lit_len:
//      out[dst + j] = out[dst - off + (j mod off)] for j < mlen.
// Writes outside the plane are dropped; comp bytes outside [0, width) and
// match sources before the plane (or off < 1) read 0.  Any table terminates
// and stays in its plane.
//
// Design.  One warp decodes one block; a CTA holds as many warps as their
// planes fit in shared memory (at most 8).  The plane lives in shared memory;
// the comp row is read through L2.  The lanes load 32 sequences' table
// entries at a time and broadcast each with __shfl_sync.
//   * Literal runs are independent: the lanes stride over one run's bytes,
//     run after run (a __syncwarp between runs keeps a later run's write last
//     where two overlap).
//   * A match reads only bytes before its dst, so all its bytes are
//     independent: the lanes stride over them, and one __syncwarp separates
//     matches.  This replaces the TPU's doubling copies (copy_match) with
//     LZ4's closed form.
//
// Bound.  Device traffic is the comp bytes, 20 bytes of table per sequence
// and the plane written once; the work is one shared-memory byte move per
// output byte, but matches run in sequence order, one warp step (32 bytes) at
// a time, so short sequences leave lanes idle: the kernel is bound by the
// serial walk over sequences, not by bytes.  (Staging each block's comp
// prefix in shared memory as well was measured: 15% off on 128 KiB blocks of
// ~2,700 sequences, nothing at 4 KiB; not kept.)

#include <algorithm>
#include <cstdint>

#include "cuda_util.cuh"

namespace {

constexpr int kMaxWarps = 8;

struct Args {
  const uint8_t* comp;            // [n] rows of comp_stride bytes
  long long comp_stride;
  int comp_width;
  const int32_t* nseq;            // [n]
  const int32_t* lit_ptr;         // [n, S] each
  const int32_t* lit_len;
  const int32_t* off;
  const int32_t* mlen;
  const int32_t* out_pos;
  int S;
  uint8_t* out;                   // [n, out_len]
  int n, out_len, warps;
};

__global__ void __launch_bounds__(32 * kMaxWarps) decode_tables_kernel(Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * a.warps + warp;
  if (b >= a.n) return;           // the warp's block does not exist; no CTA barrier below
  uint8_t* plane = smem + static_cast<long long>(warp) * a.out_len;
  const uint8_t* cp = a.comp + static_cast<long long>(b) * a.comp_stride;
  const long long row = static_cast<long long>(b) * a.S;
  const long long olen = a.out_len;
  int ns = a.nseq[b];
  ns = ns < 0 ? 0 : (ns > a.S ? a.S : ns);

  uint4* pv = reinterpret_cast<uint4*>(plane);
  for (int i = lane; i < a.out_len / 16; i += 32) pv[i] = make_uint4(0, 0, 0, 0);
  __syncwarp();

  // Literals.
  for (int base = 0; base < ns; base += 32) {
    const int s = base + lane;
    int lp = 0, ll = 0, op = 0;
    if (s < ns) {
      lp = a.lit_ptr[row + s];
      ll = a.lit_len[row + s];
      op = a.out_pos[row + s];
    }
    const int cnt = min(32, ns - base);
    for (int k = 0; k < cnt; ++k) {
      const long long p0 = __shfl_sync(0xffffffffu, op, k);
      const long long q0 = __shfl_sync(0xffffffffu, lp, k);
      const long long len = __shfl_sync(0xffffffffu, ll, k);
      const long long lo = p0 < 0 ? -p0 : 0;
      const long long hi = len < olen - p0 ? len : olen - p0;
      for (long long j = lo + lane; j < hi; j += 32) {
        const long long q = q0 + j;
        plane[p0 + j] = (q >= 0 && q < a.comp_width) ? cp[q] : 0;
      }
      __syncwarp();
    }
  }

  // Matches.
  for (int base = 0; base < ns; base += 32) {
    const int s = base + lane;
    int op = 0, ll = 0, of = 0, ml = 0;
    if (s < ns) {
      op = a.out_pos[row + s];
      ll = a.lit_len[row + s];
      of = a.off[row + s];
      ml = a.mlen[row + s];
    }
    const int cnt = min(32, ns - base);
    for (int k = 0; k < cnt; ++k) {
      const long long d = static_cast<long long>(__shfl_sync(0xffffffffu, op, k)) +
                          __shfl_sync(0xffffffffu, ll, k);
      const long long o = __shfl_sync(0xffffffffu, of, k);
      const long long m = __shfl_sync(0xffffffffu, ml, k);
      if (m <= 0) continue;       // uniform across the warp
      const long long lo = d < 0 ? -d : 0;
      const long long hi = m < olen - d ? m : olen - d;
      for (long long j = lo + lane; j < hi; j += 32) {
        uint8_t v = 0;
        if (o >= 1) {
          // j < olen < 2^31 and 1 <= o < 2^31: a 32-bit remainder.
          const long long r = j < o ? j : static_cast<unsigned>(j) % static_cast<unsigned>(o);
          const long long q = d - o + r;
          if (q >= 0) v = plane[q];
        }
        plane[d + j] = v;
      }
      __syncwarp();
    }
  }

  uint4* ov = reinterpret_cast<uint4*>(a.out + static_cast<long long>(b) * a.out_len);
  for (int i = lane; i < a.out_len / 16; i += 32) ov[i] = pv[i];
}

}  // namespace

// Launches ceil(n / warps) CTAs on `stream`; returns the CUDA error code (0
// on success).  Pointers are device pointers; the caller allocates `out`.
extern "C" int bt_decode_tables_launch(
    const void* comp, long long comp_stride, int comp_width, const void* nseq,
    const void* lit_ptr, const void* lit_len, const void* off, const void* mlen,
    const void* out_pos, int S, void* out, int n, int out_rows, void* stream) {
  const long long out_len = static_cast<long long>(out_rows) * 128;
  if (n < 0 || S < 1 || out_rows < 1 || comp_width < 0 || out_len > bt::kSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const int warps = static_cast<int>(std::min<long long>(kMaxWarps, bt::kSmemMax / out_len));
  const int smem = static_cast<int>(warps * out_len);
  // The whole opt-in range at once: a launch with a larger plane from
  // another thread then never meets a smaller limit set for this one.
  const cudaError_t err = bt::smem_opt_in(decode_tables_kernel, bt::kSmemMax);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a;
  a.comp = static_cast<const uint8_t*>(comp);
  a.comp_stride = comp_stride;
  a.comp_width = comp_width;
  a.nseq = static_cast<const int32_t*>(nseq);
  a.lit_ptr = static_cast<const int32_t*>(lit_ptr);
  a.lit_len = static_cast<const int32_t*>(lit_len);
  a.off = static_cast<const int32_t*>(off);
  a.mlen = static_cast<const int32_t*>(mlen);
  a.out_pos = static_cast<const int32_t*>(out_pos);
  a.S = S;
  a.out = static_cast<uint8_t*>(out);
  a.n = n;
  a.out_len = static_cast<int>(out_len);
  a.warps = warps;
  const int grid = (n + warps - 1) / warps;
  decode_tables_kernel<<<grid, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
