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
// Bound.  Device traffic is the comp bytes, 20 bytes of table per sequence
// and the plane written once: a few microseconds for the engine's bursts.
// What held the first design (one warp per block, every sequence in turn)
// far from it was the serial walk: ~2,700 sequences of a 128 KiB text block,
// each a dependent chain of L2 reads and a warp barrier, on one warp per SM.
//
// Design.  One CTA per block, its plane in shared memory; 128 threads for a
// 4 KiB plane, up to 1024 for 128 KiB (32 plane bytes a thread), so small
// blocks put many CTAs on an SM.  The CTA first classifies its block
// (__syncthreads_and over the sequences):
//   * Well-formed (out_pos[0] == 0, no negative length, each sequence starts
//     where the one before it ends, in 64-bit sums: what the parser emits).
//     Then no two sequences write one byte and a match byte's source lies
//     before it, so every byte's final value follows from the table and the
//     comp row whatever the order.  By the block's sequence count:
//     - one literal run and no match (a RAW block): copied straight from the
//       comp row to device memory, 16 bytes a thread;
//     - at most 8 sequences (most 4 KiB blocks, RLE runs): swept in order,
//       all threads on each sequence's literal bytes, a barrier, all threads
//       on its match bytes in closed form, a barrier;
//     - more: windows of up to W (128-256) sequences whose starts lie within
//       64 KiB of the first (entries double-buffered in shared memory, the
//       next window's prefetched in registers).  A thread takes chunks of 8
//       consecutive bytes with their sequence in registers (one binary
//       search a chunk), loads a chunk's literal bytes together and, for
//       windows of more than 16 sequences, records each byte's sequence in a
//       map.  A barrier, then the match bytes: a source before the window
//       reads the finished plane; a source inside it is chased back through
//       the window's entries, each hop to an earlier sequence, so at most W
//       hops (a phrase repeated a thousand times would otherwise make a
//       chain a thousand long).  ~2,700 warp-serial steps of a text block
//       become ~11 windows of two barriers.
//     A match byte's r mod off advances with its position: one division a
//     sequence (the first designs divided a byte, searched a byte and kept a
//     lookup struct in local memory, and ran 1.3-7x slower at 4 KiB than the
//     warp walk they replaced on an H100).
//   * Otherwise (a table the parser never emits: overlapping or out-of-order
//     writes, negative lengths) the first warp walks the sequences in order,
//     as the function is defined: all literals, then each match with its
//     bytes in closed form, a __syncwarp between runs.  That is the
//     function for such tables, not a fallback; both kinds share a launch.
// The plane leaves in 16-byte words; a well-formed block's bytes past its
// extent are stored as zeros, never zeroed in shared memory first.
//
// Planes that do not fit in shared memory beside the windows and the map
// (blocks of 256 KiB to 1 MiB) take the device-memory route, a second
// instantiation of the same kernel (kGlobal): the plane is the block's
// output row, every path reads earlier output bytes from device memory and
// synchronizes where the shared route does (__syncwarp in the serial walk,
// __syncthreads at the windows' barriers; a CTA's global writes are visible
// to its threads after them), and a well-formed block's bytes past its
// extent are zeroed in place instead of being copied out.
//
// A launch optionally adds its blocks to paths[0] (well-formed, decoded in
// parallel) and paths[1] (serial walk), so a caller can show which path its
// tables took.

#include <algorithm>
#include <atomic>
#include <cstdint>

#include "cuda_util.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxWindow = 256;     // sequences per window
constexpr int kEntryBytes = 20;     // lit_ptr, lit_len, off, mlen, out_pos
constexpr int kMaxMap = 65536;      // bytes a window's sequence map covers
constexpr int kChunk = 8;           // consecutive bytes a thread takes at once
constexpr int kMapMin = 16;         // windows of more entries map each byte to its entry
constexpr int kSweepMax = 8;        // blocks of at most this many sequences are swept in order

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
  int n, out_len;
  int window;                     // W: a power of two, at most blockDim.x
  int map_len;                    // min(out_len, kMaxMap)
  int* paths;                     // [2] or null
};

// One window's entries in shared memory.
struct Window {
  int32_t* op;
  int32_t* ll;
  int32_t* lp;
  int32_t* off;
  int32_t* ml;
};

__device__ __forceinline__ Window window_at(uint8_t* base, int w) {
  int32_t* p = reinterpret_cast<int32_t*>(base);
  return {p, p + w, p + 2 * w, p + 3 * w, p + 4 * w};
}

// The last entry i < cnt with op[i] <= p (op is nondecreasing, op[0] <= p).
__device__ __forceinline__ int find(const int32_t* op, int cnt, int p, int half) {
  int i = 0;
  for (int step = half; step > 0; step >>= 1)
    if (i + step < cnt && op[i + step] <= p) i += step;
  return i;
}

// The window entry that holds byte p (lo <= p < the window's end): from the
// map of each byte's entry when the window has one (more than kMapMin
// entries and a match), else by binary search.  (Plain arguments, not a
// struct: a struct passed by reference here went to local memory.)
__device__ __forceinline__ int entry_of(int p, const int32_t* op, const uint8_t* map, int lo,
                                        int map_len, int cnt, int half, bool use_map) {
  if (!use_map) return find(op, cnt, p, half);
  return p - lo < map_len ? map[p - lo] : cnt - 1;     // every entry starts below lo + map_len
}

// Entry i of a window in registers: where it starts, where its literals and
// its match end (clamped to int), its offset, and lit_ptr - out_pos.
struct Seq {
  int op, d, end, off;
  long long lp;

  __device__ __forceinline__ void load(const Window& w, int i, int cnt) {
    op = w.op[i];
    d = static_cast<int>(min(static_cast<long long>(op) + w.ll[i], 0x7fffffffLL));
    end = i + 1 < cnt ? w.op[i + 1] : 0x7fffffff;
    off = w.off[i];
    lp = static_cast<long long>(w.lp[i]) - op;
  }
};

// The final value of byte p, a byte of the window (p >= lo).  Each hop goes
// to an earlier entry (a source lies before its match's dst), so the loop
// ends within cnt hops.
__device__ __forceinline__ uint8_t chase(int p, const uint8_t* plane, const Window& w,
                                         const uint8_t* map, int lo, int map_len, int cnt,
                                         int half, bool use_map) {
  for (;;) {
    const int i = entry_of(p, w.op, map, lo, map_len, cnt, half, use_map);
    if (p - w.op[i] < w.ll[i]) return plane[p];       // a literal of this window
    const int d = w.op[i] + w.ll[i];                  // <= p, so no overflow
    const int o = w.off[i];
    if (o < 1) return 0;
    const int r = p - d;
    const int src = r < o ? p - o : d - o + static_cast<int>(static_cast<unsigned>(r) %
                                                             static_cast<unsigned>(o));
    if (src < 0) return 0;
    if (src < lo) return plane[src];                  // finished by an earlier window
    p = src;
  }
}

// Well-formed blocks: the sequences in windows of at most W entries whose
// starts lie within map_len bytes of the first.  Each thread takes chunks of
// kChunk consecutive bytes and keeps the current entry in registers (one
// binary search a chunk, a step where an entry ends): a chunk's literal
// bytes are loaded together, and a match byte's source offset (r mod off)
// advances by one a byte instead of a division a byte.
__device__ void decode_windows(const Args& a, const uint8_t* cp, long long row, int ns,
                               uint8_t* plane, uint8_t* entries, uint8_t* map) {
  const int T = blockDim.x, tid = threadIdx.x, W = a.window, half = W / 2;
  const int olen = a.out_len, map_len = a.map_len;
  int n_op = 0, n_ll = 0, n_lp = 0, n_off = 0, n_ml = 0;     // this thread's next entry
  auto fetch = [&](int s) {
    if (tid < W && s + tid < ns) {
      const long long e = row + s + tid;
      n_op = __ldg(a.out_pos + e);
      n_ll = __ldg(a.lit_len + e);
      n_lp = __ldg(a.lit_ptr + e);
      n_off = __ldg(a.off + e);
      n_ml = __ldg(a.mlen + e);
    }
  };
  fetch(0);
  for (int s0 = 0, buf = 0; s0 < ns; buf ^= 1) {
    const Window w = window_at(entries + buf * W * kEntryBytes, W);
    const int avail = min(W, ns - s0);
    const bool mine = tid < avail && n_ml > 0;
    if (tid < avail) {
      w.op[tid] = n_op;
      w.ll[tid] = n_ll;
      w.lp[tid] = n_lp;
      w.off[tid] = n_off;
      w.ml[tid] = n_ml;
    }
    // The entries, and the plane as the previous window left it; whether
    // the entries hold a match.  (The other buffer and the map are free:
    // every thread has ended the previous window.)
    const bool matches = __syncthreads_or(mine);
    const int lo = w.op[0];
    if (lo >= olen) break;                      // the rest lies past the plane
    const int cnt = 1 + find(w.op, avail, lo + map_len - 1, half);
    fetch(s0 + cnt);                            // in flight during this window
    const long long hi64 = static_cast<long long>(w.op[cnt - 1]) + w.ll[cnt - 1] + w.ml[cnt - 1];
    const int hi = static_cast<int>(min(hi64, static_cast<long long>(olen)));
    const bool use_map = matches && cnt > kMapMin;
    for (int c0 = lo + kChunk * tid; c0 < hi; c0 += kChunk * T) {
      int i = find(w.op, cnt, c0, half);
      Seq q;
      q.load(w, i, cnt);
      int src[kChunk];                          // comp index of a literal byte, -2 past the
#pragma unroll                                  // row, -1 not a literal
      for (int j = 0; j < kChunk; ++j) {
        const int p = c0 + j;
        src[j] = -1;
        if (p < hi) {
          while (p >= q.end) q.load(w, ++i, cnt);
          if (use_map && p - lo < map_len) map[p - lo] = static_cast<uint8_t>(i);
          if (p < q.d) {
            const long long c = q.lp + p;
            src[j] = c >= 0 && c < a.comp_width ? static_cast<int>(c) : -2;
          }
        }
      }
      uint8_t v[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) v[j] = src[j] >= 0 ? __ldg(cp + src[j]) : 0;
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
        if (src[j] != -1) plane[c0 + j] = v[j];
    }
    if (!matches) {                             // the next window's barrier orders the writes
      s0 += cnt;
      continue;
    }
    __syncthreads();                            // the window's literals and map
    for (int c0 = lo + kChunk * tid; c0 < hi; c0 += kChunk * T) {
      int i = entry_of(c0, w.op, map, lo, map_len, cnt, half, use_map);
      Seq q;
      q.load(w, i, cnt);
      int m = -1;                               // r mod off of the last match byte, or -1
#pragma unroll 1
      for (int j = 0; j < kChunk; ++j) {
        const int p = c0 + j;
        if (p >= hi) break;
        while (p >= q.end) {
          q.load(w, ++i, cnt);
          m = -1;
        }
        if (p < q.d) continue;
        uint8_t v = 0;
        if (q.off >= 1) {
          const int r = p - q.d;
          int src = p - q.off;
          if (r >= q.off) {
            m = m < 0 ? static_cast<int>(static_cast<unsigned>(r) % static_cast<unsigned>(q.off))
                      : (m + 1 == q.off ? 0 : m + 1);
            src = q.d - q.off + m;
          }
          if (src >= lo) v = chase(src, plane, w, map, lo, map_len, cnt, half, use_map);
          else if (src >= 0) v = plane[src];
        }
        plane[p] = v;
      }
    }
    s0 += cnt;
  }
  __syncthreads();
}

// A well-formed block of at most kSweepMax sequences: each sequence in turn,
// all threads on its literal bytes, a barrier, all threads on its match
// bytes in closed form (their sources lie before dst, final by then), a
// barrier.  A thread's bytes are T apart, so its r mod off steps by T mod
// off: one division a sequence.  (Windows would search, map and chase for
// blocks that are one or two long runs, as most 4 KiB blocks are.)
__device__ void decode_sweep(const Args& a, const uint8_t* cp, long long row, int ns,
                             uint8_t* plane) {
  const int T = blockDim.x, tid = threadIdx.x;
  const long long olen = a.out_len;
  for (int s = 0; s < ns; ++s) {
    const long long op = __ldg(a.out_pos + row + s), ll = __ldg(a.lit_len + row + s);
    const long long lp = __ldg(a.lit_ptr + row + s) - op;
    for (long long p = op + tid; p < min(op + ll, olen); p += T) {
      const long long q = lp + p;
      plane[p] = q >= 0 && q < a.comp_width ? __ldg(cp + q) : 0;
    }
    __syncthreads();
    const long long d = op + ll, end = min(d + __ldg(a.mlen + row + s), olen);
    const int o = __ldg(a.off + row + s);
    if (d + tid < end) {
      const int tm = o >= 1 ? T % o : 0;
      int m = -1;                           // r mod o once r >= o
      for (long long p = d + tid; p < end; p += T) {
        const int r = static_cast<int>(p - d);
        long long src = -1;
        if (o >= 1) {
          if (r < o) {
            src = p - o;
          } else {
            m = m < 0 ? r % o : (m + tm >= o ? m + tm - o : m + tm);
            src = d - o + m;
          }
        }
        plane[p] = src >= 0 ? plane[src] : 0;
      }
    }
    __syncthreads();
  }
}

// A well-formed block of one literal run and no match (a RAW block): bytes
// [0, len) are the comp row from lit_ptr (0 outside the row), zeros after;
// copied straight to device memory, 16 bytes a thread where the source is
// 16-byte aligned and inside the row.
__device__ void copy_literal_block(const Args& a, const uint8_t* cp, long long lp, long long len,
                                   uint8_t* out) {
  uint4* o = reinterpret_cast<uint4*>(out);
  const int words = a.out_len / 16;
  if (lp >= 0 && lp + len <= a.comp_width && (reinterpret_cast<uintptr_t>(cp + lp) & 15) == 0) {
    const uint4* s = reinterpret_cast<const uint4*>(cp + lp);
#pragma unroll 4
    for (int i = threadIdx.x; i < words; i += blockDim.x) {
      uint4 v = make_uint4(0, 0, 0, 0);
      if (16LL * i + 16 <= len) {
        v = __ldg(s + i);
      } else if (16LL * i < len) {
        uint32_t w[4] = {0, 0, 0, 0};
        for (int j = 0; 16LL * i + j < len; ++j)
          w[j >> 2] |= static_cast<uint32_t>(__ldg(cp + lp + 16 * i + j)) << (8 * (j & 3));
        v = make_uint4(w[0], w[1], w[2], w[3]);
      }
      o[i] = v;
    }
    return;
  }
  for (int i = threadIdx.x; i < words; i += blockDim.x) {
    uint32_t w[4] = {0, 0, 0, 0};
    for (int j = 0; j < 16 && 16LL * i + j < len; ++j) {
      const long long q = lp + 16LL * i + j;
      if (q >= 0 && q < a.comp_width) w[j >> 2] |= static_cast<uint32_t>(__ldg(cp + q)) << (8 * (j & 3));
    }
    o[i] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// Any table: the first warp walks the sequences in order (the function's
// definition); the plane is zeroed first.
__device__ void decode_serial(const Args& a, const uint8_t* cp, long long row, int ns,
                              uint8_t* plane) {
  uint4* pv = reinterpret_cast<uint4*>(plane);
  for (int i = threadIdx.x; i < a.out_len / 16; i += blockDim.x) pv[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const long long olen = a.out_len;
    for (int base = 0; base < ns; base += 32) {      // literals
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
    for (int base = 0; base < ns; base += 32) {      // matches
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
  }
  __syncthreads();
}

// kGlobal: the plane is the output row (the device-memory route).
template <bool kGlobal>
__global__ void __launch_bounds__(kMaxThreads) decode_tables_kernel(Args a) {
  // Shared memory: the plane (shared route only), two windows of entries,
  // the window's map (the entry of each byte).
  extern __shared__ __align__(16) uint8_t smem[];
  const int b = blockIdx.x;
  uint8_t* out = a.out + static_cast<long long>(b) * a.out_len;
  uint8_t* plane = kGlobal ? out : smem;
  uint8_t* windows = kGlobal ? smem : smem + a.out_len;
  const uint8_t* cp = a.comp + static_cast<long long>(b) * a.comp_stride;
  const long long row = static_cast<long long>(b) * a.S;
  int ns = a.nseq[b];
  ns = ns < 0 ? 0 : (ns > a.S ? a.S : ns);

  bool ok = true;
  for (int s = threadIdx.x; s < ns; s += blockDim.x) {
    const long long op = __ldg(a.out_pos + row + s);
    const long long ll = __ldg(a.lit_len + row + s);
    const long long ml = __ldg(a.mlen + row + s);
    ok = ok && ll >= 0 && ml >= 0 && (s > 0 || op == 0) &&
         (s + 1 >= ns || __ldg(a.out_pos + row + s + 1) == op + ll + ml);
  }
  const bool well = __syncthreads_and(ok);
  if (a.paths != nullptr && threadIdx.x == 0) atomicAdd(a.paths + (well ? 0 : 1), 1);

  if (well && ns == 1 && __ldg(a.mlen + row) == 0) {
    const long long ll = __ldg(a.lit_len + row);
    copy_literal_block(a, cp, __ldg(a.lit_ptr + row), ll < a.out_len ? ll : a.out_len, out);
    return;
  }
  long long lim = a.out_len;        // bytes of the plane that hold decoded data
  if (well) {
    if (ns > 0) {
      const long long e = row + ns - 1;
      const long long end = static_cast<long long>(__ldg(a.out_pos + e)) + __ldg(a.lit_len + e) +
                            __ldg(a.mlen + e);
      lim = min(lim, end);
    } else {
      lim = 0;
    }
    if (ns <= kSweepMax)
      decode_sweep(a, cp, row, ns, plane);
    else
      decode_windows(a, cp, row, ns, plane, windows, windows + 2 * a.window * kEntryBytes);
  } else {
    decode_serial(a, cp, row, ns, plane);
  }

  if constexpr (kGlobal) {          // zeros past the decoded extent, in place
    const long long head = min(static_cast<long long>(a.out_len), (lim + 15) & ~15LL);
    for (long long p = lim + threadIdx.x; p < head; p += blockDim.x)
      out[p] = 0;
    uint4* ov = reinterpret_cast<uint4*>(out);
    for (int i = static_cast<int>((lim + 15) >> 4) + threadIdx.x; i < a.out_len / 16;
         i += blockDim.x)
      ov[i] = make_uint4(0, 0, 0, 0);
    return;
  }
  uint4* ov = reinterpret_cast<uint4*>(out);
  const uint4* pv = reinterpret_cast<const uint4*>(plane);
  for (int i = threadIdx.x; i < a.out_len / 16; i += blockDim.x) {
    uint4 v = make_uint4(0, 0, 0, 0);
    if (16LL * i + 16 <= lim) {
      v = pv[i];
    } else if (16LL * i < lim) {
      uint32_t w[4] = {0, 0, 0, 0};
      for (int j = 0; 16LL * i + j < lim; ++j)
        w[j >> 2] |= static_cast<uint32_t>(plane[16 * i + j]) << (8 * (j & 3));
      v = make_uint4(w[0], w[1], w[2], w[3]);
    }
    ov[i] = v;
  }
}

// Devices whose shared-memory opt-in is done (bit d for device d < 64),
// per route.
std::atomic<unsigned long long> g_opted[2] = {0, 0};

}  // namespace

// Rows of the largest plane the shared-memory route holds.
extern "C" int bt_decode_tables_shared_rows() {
  return (bt::kSmemMax - 2 * kMaxWindow * kEntryBytes - kMaxMap) / 128;
}

// Launches one CTA per block on `stream` of `device`, on the shared-memory
// route when the plane fits beside the windows and the map, else on the
// device-memory route; returns the CUDA error code (0 on success).
// Pointers are device pointers; the caller allocates `out` (16-byte
// aligned) and, if not null, `paths` (two ints).
extern "C" int bt_decode_tables_launch(
    const void* comp, long long comp_stride, int comp_width, const void* nseq,
    const void* lit_ptr, const void* lit_len, const void* off, const void* mlen,
    const void* out_pos, int S, void* out, int n, int out_rows, void* paths, int device,
    void* stream) {
  const long long out_len = static_cast<long long>(out_rows) * 128;
  const int threads = static_cast<int>(std::min<long long>(kMaxThreads,
                                                           std::max<long long>(128, out_len / 32)));
  const int window = std::min(threads, kMaxWindow);
  const int map_len = static_cast<int>(std::min<long long>(out_len, kMaxMap));
  // The shared route holds the plane beside the windows and the map; a
  // plane that does not fit takes the device-memory route.
  const long long tables_smem = 2LL * window * kEntryBytes + map_len;
  const bool global = out_len + tables_smem > bt::kSmemMax;
  const long long smem = global ? tables_smem : out_len + tables_smem;
  if (n < 0 || S < 1 || out_rows < 1 || out_rows > (1 << 16) || comp_width < 0 ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0 || device < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // The whole opt-in range, once per device: a launch with a larger plane
  // from another thread then never meets a smaller limit set for this one.
  auto* kernel = global ? decode_tables_kernel<true> : decode_tables_kernel<false>;
  if (device >= 64 || !(g_opted[global].load() & (1ULL << device))) {
    err = bt::smem_opt_in(kernel, bt::kSmemMax);
    if (err == cudaSuccess && device < 64) g_opted[global].fetch_or(1ULL << device);
  }
  if (err == cudaSuccess) {
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
    a.window = window;
    a.map_len = map_len;
    a.paths = static_cast<int*>(paths);
    kernel<<<n, threads, static_cast<int>(smem), static_cast<cudaStream_t>(stream)>>>(a);
    err = cudaGetLastError();
  }
  if (current != device) cudaSetDevice(current);
  return static_cast<int>(err);
}
