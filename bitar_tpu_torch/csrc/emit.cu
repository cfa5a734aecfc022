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
// off) and d = t - start:
//   LZ4:    token, literal-length extensions, literals from the raw plane,
//           2 offset bytes, match-length extensions;
//   Snappy: the uncompressed-length varint first (t < vl), then per slot
//           the literal tag + 0-3 length bytes, literals, one 3-byte copy-2
//           element per <= 64-byte match chunk.
// Bytes before the first start, and from total on, are 0.  Rows with total
// > out_width are garbage by contract (the caller stores them RAW), but the
// kernel writes the same bytes there as the plain version.
//
// Bound.  Device memory: the literal bytes within min(total, ow), the fields
// of the slots that start there, the totals, and [N, ow] written
// (`emit.bound_bytes`).  A layout with the worst-case sequence budget
// (`match_offsets`: 21,889 slots a 128 KiB block, most of them empty) also
// makes any emitter read the starts of every slot up to min(total, ow), since
// only the starts tell an empty slot from a real one; that term is not in
// the bound.
//
// Design: byte tiles, slot-major staging, no search per byte.  A warp
// emits one tile of `tile` output bytes of one row: 256 where the slots
// outnumber the bytes (S > ow) or the grid fits in one wave, else 512.
// Tiles wholly in the zero tail [min(total, ow), ow) only store 16-byte
// zeros.  Otherwise the warp finds the last slot starting at or before its
// first byte by a warp-wide search over starts in device memory: the first
// 32 probes go out with the row's total, further rounds only until the
// first batch of starts covers the rest, which settles it.  From there it
// streams the slots in batches (a 16-byte load of starts a lane and group
// of 128 slots, the next batch's loads issued before the current one is
// used) until a slot starts past the tile.  Of each batch, the lanes find
// the nonempty ranges [starts[k], starts[k+1]) within the tile, stage those
// slots' other fields in shared memory with cp.async (16 bytes a lane, only
// lanes that own a nonempty slot) and mark each range's first byte with its
// slot; one warp-wide prefix max maps every byte of the tile to its slot.  Then all
// bytes of the batch's span are computed at once, a lane a byte, from the
// staged fields and, for literals, coalesced loads of the raw plane: no
// byte waits on another's load.  With 512-byte tiles (rows wider than one
// wave of 256-byte tiles) and 16-byte aligned planes and rows, a span that
// one slot owns alone (a tile inside a long literal run, as in text's
// one-period heads) skips the staging and the map: its literal bytes go
// out in one round of loads, a lane a 16-byte store from two aligned
// 16-byte plane loads joined by funnel shifts.
//
// What bounds it on the card is not bytes but the chain of dependent
// rounds a tile waits through (total and probes, starts, fields, plane
// bytes) and how many warps an SM holds to overlap them.  Batches of 256
// slots (6 KiB of shared memory a warp, 64 registers: 32 warps an SM) are
// the default; where slots far outnumber bytes (S > 4 ow, the worst-case
// budget of `match_offsets`) batches of 512 halve the rounds a streamed
// slot costs, at 20 warps an SM.  The TPU kernels' one-hot MXU scatters,
// prefix-max wires and slot windows are layout devices of the TPU and are
// not carried over.

#include <cstdint>

#include "cuda_util.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileMax = 512;          // output bytes a warp emits, at most
constexpr int kCtasPerSm = 8;          // of the 256-slot variant (64 registers)
constexpr unsigned kFull = 0xffffffffu;

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
  const int32_t* lengths;              // [n] raw lengths (Snappy varint), or null: L
  uint8_t* out;                        // [n, ow]
  int n, ow, snappy, tile, tiles;      // tiles: warps a row
};

struct Slot {
  int st, ll, ls, mv, off;
};

// A warp's shared memory: one batch of kGroups * 128 slots' staged fields
// and the tile's map.
template <int kGroups>
struct Stage {
  static constexpr int kBatch = 128 * kGroups;
  int4 st[kBatch / 4], ll[kBatch / 4], ls[kBatch / 4], mv[kBatch / 4], off[kBatch / 4];
  int16_t own[kTileMax];               // batch slot of each tile byte
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int comp(const int4& v, int q) {
  return q == 0 ? v.x : (q == 1 ? v.y : (q == 2 ? v.z : v.w));
}

__device__ __forceinline__ int comp_at(const int4* v, int i) {
  return reinterpret_cast<const int*>(v)[i];
}

// Bytes of a slot's head before its literals: LZ4's token and
// literal-length extensions, Snappy's literal tag and length bytes (as
// slot_byte counts them inline: taking this helper there made the
// byte loop 2-4% slower on an H100).
__device__ __forceinline__ int head_bytes(int ll, int snappy) {
  if (!snappy) return 1 + (ll >= 15 ? (ll - 15) / 255 + 1 : 0);
  const int n1 = ll - 1;
  return ll > 0 ? 1 + (n1 < 60 ? 0 : (n1 < 256 ? 1 : (n1 < 65536 ? 2 : 3))) : 0;
}

// Byte d >= 0 of slot s.
__device__ __forceinline__ int slot_byte(const Args& a, const Slot& s, int d,
                                         const uint8_t* plane) {
  const int ll = s.ll, mv = s.mv, off = s.off;
  if (!a.snappy) {
    const int hdr = 1 + (ll >= 15 ? (ll - 15) / 255 + 1 : 0);
    const int lit_end = hdr + ll;
    if (d == 0) return (min(ll, 15) << 4) | (mv >= 0 ? min(mv, 15) : 0);
    if (d < hdr) return clampi(ll - 15 - 255 * (d - 1), 0, 255);
    if (d < lit_end) return __ldg(plane + clampi(s.ls + d - hdr, 0, a.L - 1));
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
  if (d < lit_end) return __ldg(plane + clampi(s.ls + d - hdr, 0, a.L - 1));
  const int cd = d - lit_end;
  const int ci = cd / 3, r3 = cd - 3 * ci;
  const int clen = clampi(mv + 4 - 64 * ci, 1, 64);
  if (r3 == 0) return 2 | ((clen - 1) << 2);
  return r3 == 1 ? off & 0xFF : (off >> 8) & 0xFF;
}

// Word i (0-7) of u, with i the same on every lane.
__device__ __forceinline__ unsigned pick(const unsigned (&u)[8], int i) {
  unsigned v = u[0];
#pragma unroll
  for (int j = 1; j < 8; ++j) v = i == j ? u[j] : v;
  return v;
}

// Output bytes [x0, x1) of row (at most one tile), all literal bytes of one
// slot, output byte t from plane byte t + delta, by the warp in one round of
// loads: a lane a 16-byte store between byte edges, from two aligned
// 16-byte plane loads joined by funnel shifts, and a lane an edge byte.
// Needs 16-byte aligned planes and rows, L % 16 == 0, and the run within the
// plane.
__device__ __forceinline__ void literal_run(const Args& a, int delta, int x0, int x1,
                                            const uint8_t* plane, uint8_t* row, int lane) {
  static_assert(kTileMax <= 32 * 16, "a tile is at most a 16-byte store a lane");
  const int v0 = min((x0 + 15) & ~15, x1), v1 = max(x1 & ~15, v0);
  const int sh = (v0 + delta) & 15, src = v0 + delta - sh + 16 * lane;
  const bool body = lane < (v1 - v0) >> 4;
  uint4 w0 = make_uint4(0, 0, 0, 0), w1 = w0;
  if (body) {
    w0 = __ldg(reinterpret_cast<const uint4*>(plane + src));
    if (sh && src + 16 < a.L) w1 = __ldg(reinterpret_cast<const uint4*>(plane + src + 16));
  }
  const int t = lane < v0 - x0 ? x0 + lane : v1 + lane - (v0 - x0);   // < 16 a side
  const bool edge = lane < (v0 - x0) + (x1 - v1);
  const uint8_t e = edge ? __ldg(plane + t + delta) : 0;
  if (edge) row[t] = e;
  if (body) {
    const unsigned u[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
    const int q = sh >> 2, r = 8 * (sh & 3);
    uint4 o;
    o.x = __funnelshift_r(pick(u, q), pick(u, q + 1), r);
    o.y = __funnelshift_r(pick(u, q + 1), pick(u, q + 2), r);
    o.z = __funnelshift_r(pick(u, q + 2), pick(u, q + 3), r);
    o.w = __funnelshift_r(pick(u, q + 3), pick(u, q + 4), r);
    *reinterpret_cast<uint4*>(row + v0 + 16 * lane) = o;
  }
}

// count zero bytes at dst by the warp: 16-byte stores between byte edges.
__device__ void zero_run(uint8_t* dst, int count, int lane) {
  const int h = min(count, static_cast<int>((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15));
  if (lane < h) dst[lane] = 0;
  dst += h;
  count -= h;
  uint4* dv = reinterpret_cast<uint4*>(dst);
  const int nv = count >> 4;
  for (int i = lane; i < nv; i += 32) dv[i] = make_uint4(0, 0, 0, 0);
  for (int i = 16 * nv + lane; i < count; i += 32) dst[i] = 0;
}

// Four slots of `field` from global slot index g; past the tensor's end
// (index >= end) nothing is read.
__device__ __forceinline__ int4 load4(const int32_t* field, long long g, long long end) {
  if (g + 3 < end) return __ldg(reinterpret_cast<const int4*>(field + g));
  int4 v = make_int4(0, 0, 0, 0);
  if (g < end) v.x = field[g];
  if (g + 1 < end) v.y = field[g + 1];
  if (g + 2 < end) v.z = field[g + 2];
  return v;
}

// 16 bytes of `field` at global slot index g into shared memory, in flight
// until cp_wait (the tensor's last partial 16 bytes by plain loads).
__device__ __forceinline__ void cp16(int4* dst, const int32_t* field, long long g, long long end) {
  if (g + 3 < end) {
    const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa), "l"(field + g));
  } else {
    *dst = load4(field, g, end);
  }
}

__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_all;\n" ::); }

// kGroups 16-byte loads of starts a lane and batch: 2 (6 KiB of shared
// memory a warp, at most 64 registers, 32 warps an SM) unless a layout's
// slots far outnumber its bytes, then 4 (half the dependent rounds a
// streamed slot).  kLiteral: spans that one slot owns alone take the
// literal path (literal_run); compiled in for 512-byte tiles of aligned
// planes and rows only (see bt_emit_launch).
template <int kGroups, bool kLiteral>
__global__ void __launch_bounds__(kThreads, kGroups == 2 ? kCtasPerSm : 1) emit_kernel(Args a) {
  constexpr int kBatch = Stage<kGroups>::kBatch;
  __shared__ Stage<kGroups> stage[kWarps];
  const int lane = threadIdx.x & 31;
  Stage<kGroups>& sm = stage[threadIdx.x >> 5];
  const long long wid = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (wid >= static_cast<long long>(a.n) * a.tiles) return;      // whole warps leave
  const int b = static_cast<int>(wid / a.tiles);
  const int lo = static_cast<int>(wid % a.tiles) * a.tile;
  const int hi = min(lo + a.tile, a.ow);
  const int ow = a.ow, S = a.S;
  const long long rowS = static_cast<long long>(b) * S;
  const long long endS = static_cast<long long>(a.n) * S;
  const int32_t* st = a.starts + rowS;

  const int total = a.total[b];
  // The first round of the search for the tile's first slot goes out with
  // the total (its probes do not depend on the key).
  const int step1 = (S + 31) >> 5;
  const int j1 = lane * step1;
  const int v1 = j1 < S ? __ldg(st + j1) : 0;
  const int lim = clampi(total, 0, ow);
  int vl = 0, blen = a.L;
  if (a.snappy) {
    if (a.lengths) blen = a.lengths[b];
    vl = 1 + (blen >= (1 << 7)) + (blen >= (1 << 14));
  }
  const uint8_t* plane = a.planes + static_cast<long long>(b) * a.L;
  uint8_t* row = a.out + static_cast<long long>(b) * ow;

  // The varint, the zero tail; then the slot bytes [s0, s1) of the tile.
  for (int t = lo + lane; t < min(hi, min(vl, lim)); t += 32) {
    int pre = (blen >> clampi(7 * t, 0, 28)) & 0x7F;
    if ((blen >> clampi(7 * (t + 1), 0, 28)) > 0) pre |= 0x80;
    row[t] = static_cast<uint8_t>(pre);
  }
  const int z0 = max(lo, lim);
  if (z0 < hi) zero_run(row + z0, hi - z0, lane);
  const int s0 = max(lo, vl), s1 = min(hi, lim);
  if (s0 >= s1) return;

  // k0: the last slot with start <= s0, by a warp-wide 32-ary search: the
  // first slot with start > s0 lies in [klo, khi], narrowed by rounds of 32
  // probes until the first batch of starts below covers it, which then
  // settles it.
  int klo = 0, khi = S;
  {
    const unsigned m = __ballot_sync(kFull, j1 < S && v1 > s0);
    if (m) {
      const int i = __ffs(m) - 1;
      khi = i * step1;
      if (i) klo = (i - 1) * step1 + 1;
    } else {
      klo = (31 - __clz(__ballot_sync(kFull, j1 < S))) * step1 + 1;
    }
  }
  while (khi - klo > kBatch - 8) {
    const int step = (khi - klo + 31) >> 5;
    const int j = klo + lane * step;
    const bool in = j < khi;
    const unsigned m = __ballot_sync(kFull, in && st[j] > s0);
    if (m) {
      const int i = __ffs(m) - 1;
      khi = klo + i * step;
      if (i) klo += (i - 1) * step + 1;
    } else {
      klo += (31 - __clz(__ballot_sync(kFull, in))) * step + 1;
    }
  }
  for (int i = lane; i < kTileMax; i += 32) sm.own[i] = -1;

  // The first batch: the starts from slot klo - 1.
  const int kb0 = max(klo - 1, 0);
  long long g4 = (rowS + kb0) & ~3LL;  // 16-byte aligned global slot of the batch
  int4 cur[kGroups], nxt[kGroups];
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const long long gi = g4 + 128 * g + 4 * lane;
    const bool live = gi + 3 >= rowS + kb0 && gi < rowS + S;
    cur[g] = live ? load4(a.starts, gi, endS) : make_int4(0, 0, 0, 0);
  }
  int cnt = 0;
#pragma unroll
  for (int g = 0; g < kGroups; ++g)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = static_cast<int>(g4 - rowS) + 128 * g + 4 * lane + q;
      cnt += j >= klo && j < khi && comp(cur[g], q) <= s0;
    }
  int k0 = klo - 1 + __reduce_add_sync(kFull, cnt);
  if (k0 < 0) {                        // bytes before the first start are 0
    const int e = min(st[0], s1);
    if (s0 < e) zero_run(row + s0, e - s0, lane);
    k0 = 0;
  }

  // Stream the slots from there in batches; the next batch's starts load
  // while this one is used.
  while (true) {
    const int w4 = static_cast<int>(g4 - rowS);         // row-relative first slot
    // More slots may own tile bytes when the batch's last slot starts in it.
    const int last = __shfl_sync(kFull, cur[kGroups - 1].w, 31);
    const bool more = w4 + kBatch < S && last < s1;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const long long gi = g4 + kBatch + 128 * g + 4 * lane;
      nxt[g] = more && gi < rowS + S ? load4(a.starts, gi, endS) : make_int4(0, 0, 0, 0);
    }
    const int first_next = __shfl_sync(kFull, nxt[0].x, 0);
    // Each lane's four slots of each group: their ranges within the tile.
    int blo = 0x7fffffff, bhi = -1, nown = 0, wown = 0, stown = 0;
    unsigned owns = 0;                 // bit g: this lane owns a nonempty slot of group g
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int nx_in = __shfl_sync(kFull, cur[g].x, (lane + 1) & 31);
      const int nx_up = __shfl_sync(kFull, cur[g + 1 < kGroups ? g + 1 : g].x, 0);
      const int next4 = lane < 31 ? nx_in : (g + 1 < kGroups ? nx_up : first_next);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = w4 + 128 * g + 4 * lane + q;
        const int nj = q < 3 ? comp(cur[g], q + 1) : next4;
        const int r0 = max(comp(cur[g], q), s0);
        const int r1 = j + 1 < S ? min(nj, s1) : s1;
        if (j >= k0 && j < S && r0 < r1) {
          owns |= 1u << g;
          ++nown;
          wown = 128 * g + 4 * lane + q;
          stown = comp(cur[g], q);
          blo = min(blo, r0);
          bhi = max(bhi, r1);
          sm.own[r0 - lo] = static_cast<int16_t>(128 * g + 4 * lane + q);
        }
      }
    }
    blo = __reduce_min_sync(kFull, blo);
    bhi = __reduce_max_sync(kFull, bhi);
    // Where one slot owns the span: its literal bytes by 16-byte stores, the
    // others a lane a byte.
    int owner = -1;
    if (kLiteral && blo < bhi && __reduce_add_sync(kFull, nown) == 1)
      owner = __ffs(__ballot_sync(kFull, nown)) - 1;
    if (owner >= 0) {
      const long long gw = g4 + __shfl_sync(kFull, wown, owner);
      const Slot s{__shfl_sync(kFull, stown, owner), __ldg(a.lit_len + gw),
                   __ldg(a.lit_start + gw), __ldg(a.mv + gw), __ldg(a.off + gw)};
      const int hdr = head_bytes(s.ll, a.snappy);
      int x0 = bhi, x1 = bhi;                          // the literal bytes within the span
      if (s.ls >= 0 && s.ll >= 0 && s.ls <= a.L - s.ll) {
        x0 = clampi(s.st + hdr, blo, bhi);
        x1 = clampi(s.st + hdr + s.ll, x0, bhi);
      }
      for (int i = lane; i < (x0 - blo) + (bhi - x1); i += 32) {
        const int t = i < x0 - blo ? blo + i : x1 + i - (x0 - blo);
        row[t] = static_cast<uint8_t>(slot_byte(a, s, t - s.st, plane));
      }
      if (x0 < x1) literal_run(a, s.ls - s.st - hdr, x0, x1, plane, row, lane);
    } else if (blo < bhi) {
      // Stage the fields of the slots that own bytes, then map each byte.
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const int c = 32 * g + lane;
        sm.st[c] = cur[g];
        if ((owns >> g) & 1) {
          const long long gi = g4 + 128 * g + 4 * lane;
          cp16(&sm.ll[c], a.lit_len, gi, endS);
          cp16(&sm.ls[c], a.lit_start, gi, endS);
          cp16(&sm.mv[c], a.mv, gi, endS);
          cp16(&sm.off[c], a.off, gi, endS);
        }
      }
      __syncwarp();
      // Prefix max of the marks over [blo, bhi): each byte's slot.
      const int len = bhi - blo, chunk = (len + 31) >> 5;
      const int p0 = blo - lo + lane * chunk;
      int m = -1;
      for (int i = 0; i < chunk && p0 + i < bhi - lo; ++i)
        m = max(m, static_cast<int>(sm.own[p0 + i]));
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(kFull, m, o);
        if (lane >= o) m = max(m, v);
      }
      int run = __shfl_up_sync(kFull, m, 1);
      if (lane == 0) run = -1;
      for (int i = 0; i < chunk && p0 + i < bhi - lo; ++i) {
        run = max(run, static_cast<int>(sm.own[p0 + i]));
        sm.own[p0 + i] = static_cast<int16_t>(run);
      }
      cp_wait();
      __syncwarp();
      // Every byte of the span at once, a lane a byte.
#pragma unroll 4
      for (int t = blo + lane; t < bhi; t += 32) {
        const int w = sm.own[t - lo];
        const Slot s{comp_at(sm.st, w), comp_at(sm.ll, w), comp_at(sm.ls, w), comp_at(sm.mv, w),
                     comp_at(sm.off, w)};
        row[t] = static_cast<uint8_t>(slot_byte(a, s, t - s.st, plane));
      }
      __syncwarp();
    }
    if (!more) break;
    g4 += kBatch;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) cur[g] = nxt[g];
  }
}

// The same grid with no work: the launch floor of a shape.
__global__ void __launch_bounds__(kThreads) emit_floor() {}

// Output bytes a warp emits: 256 where the slots outnumber the bytes (the
// warps then stream fewer slot starts each) or where 256-byte tiles still
// fit in one wave of the `sms` SMs at the 256-slot variant's occupancy (a
// single wave's time is one tile's chain), else 512.
int tile_for(int n, int S, int ow, int sms) {
  return S > ow || n * static_cast<long long>((ow + 255) / 256) <= sms * kCtasPerSm * kWarps
             ? 256
             : kTileMax;
}

// Batches of 512 slots where slots far outnumber bytes, else 256.
bool wide_batches(int S, int ow) { return S > 4 * ow; }

long long ctas_for(int n, int S, int ow, int sms) {
  const int tile = tile_for(n, S, ow, sms);
  return (n * static_cast<long long>((ow + tile - 1) / tile) + kWarps - 1) / kWarps;
}

// Enters `device` and reads its SM count; returns the CUDA error code and
// sets `previous` to the device to restore afterwards (`device` itself
// where none was entered).
cudaError_t enter(int device, int* previous, int* sms) {
  const cudaError_t err = bt::enter_device(device, previous);
  if (err != cudaSuccess) {
    *previous = device;
    return err;
  }
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
}

}  // namespace

// Launches ceil(n * tiles / 4) CTAs of 4 warps on `stream` of `device`,
// tiles = ceil(ow / tile) a row (tile_for); returns the CUDA error code (0
// on success).  Pointers are device pointers, the five slot fields 16-byte
// aligned; starts never decrease along a row; `lengths` may be null (every
// raw length is L); the caller allocates `out`.
extern "C" int bt_emit_launch(const void* planes, int L, const void* starts,
                              const void* lit_len, const void* lit_start, const void* mv,
                              const void* off, int S, const void* total,
                              const void* lengths, void* out, int n, int ow, int snappy,
                              int device, void* stream) {
  if (n < 0 || L <= 0 || S <= 0 || ow <= 0 || S > 0x7fffffff - 512 || device < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  for (const void* p : {starts, lit_len, lit_start, mv, off})
    if (reinterpret_cast<uintptr_t>(p) & 15) return static_cast<int>(cudaErrorMisalignedAddress);
  if (n == 0) return 0;
  int previous = 0, sms = 0;
  cudaError_t err = enter(device, &previous, &sms);
  const long long ctas = ctas_for(n, S, ow, sms);
  if (err == cudaSuccess && ctas > 0x7fffffffLL) err = cudaErrorInvalidValue;
  if (err != cudaSuccess) {
    if (previous != device) cudaSetDevice(previous);
    return static_cast<int>(err);
  }
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
  a.n = n;
  a.ow = ow;
  a.snappy = snappy;
  a.tile = tile_for(n, S, ow, sms);
  a.tiles = (ow + a.tile - 1) / a.tile;
  // The literal path pays where tiles of 512 bytes lie inside long literal
  // runs (wide rows: text's one-period heads); with 256-byte tiles its check
  // cost the device path's layouts ~4% on an H100, and where slots far
  // outnumber bytes a span seldom has one owner.
  const bool literal = a.tile == kTileMax && (reinterpret_cast<uintptr_t>(planes) & 15) == 0 &&
                       L % 16 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0 &&
                       ow % 16 == 0;
  const unsigned grid = static_cast<unsigned>(ctas);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide_batches(S, ow))
    emit_kernel<4, false><<<grid, kThreads, 0, s>>>(a);
  else if (literal)
    emit_kernel<2, true><<<grid, kThreads, 0, s>>>(a);
  else
    emit_kernel<2, false><<<grid, kThreads, 0, s>>>(a);
  err = cudaGetLastError();
  if (previous != device) cudaSetDevice(previous);
  return static_cast<int>(err);
}

// Launches emit_floor on the grid bt_emit_launch would use for (n, S, ow)
// on `device`.
extern "C" int bt_emit_floor_launch(int n, int S, int ow, int device, void* stream) {
  if (n <= 0 || S <= 0 || ow <= 0 || device < 0) return static_cast<int>(cudaErrorInvalidValue);
  int previous = 0, sms = 0;
  cudaError_t err = enter(device, &previous, &sms);
  const long long ctas = ctas_for(n, S, ow, sms);
  if (err == cudaSuccess && ctas > 0x7fffffffLL) err = cudaErrorInvalidValue;
  if (err == cudaSuccess) {
    emit_floor<<<static_cast<unsigned>(ctas), kThreads, 0, static_cast<cudaStream_t>(stream)>>>();
    err = cudaGetLastError();
  }
  if (previous != device) cudaSetDevice(previous);
  return static_cast<int>(err);
}
