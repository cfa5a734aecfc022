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
// (blocks of ~150 KiB to 1 MiB) take the cluster route, a second kernel
// built from the same templates.  What bounds such a block is the chain of
// its windows: ~21,000 sequences of a 1 MiB text block make ~83 windows of
// 256, one after another, and on one CTA with its plane in device memory
// each took ~20 us, every literal write and match-source read an L2 round
// trip (the first version: 1.92 ms for 32 text blocks on 32 SMs).  Now a
// thread-block cluster of C CTAs (2, 4 or 8: the least power of two whose
// 128 KiB slices hold the plane) decodes one block, its plane dealt to the
// CTAs' shared memory in stripes of 1 KiB (stripe s to CTA s mod C), and:
//   * the windows take up to 1024 sequences whose starts lie within 64 KiB
//     of the first (~21 a 1 MiB text block), each CTA staging the window's
//     entries itself; each CTA takes the window's chunks that lie in its
//     own stripes, so its writes stay in its shared memory and a window's
//     bytes spread over the cluster's 8192 threads (with the plane in
//     contiguous 128 KiB slices a window lay in one CTA, and the other
//     seven's byte traffic to it ran 32 text blocks 2.2x slower than the
//     first version); match-source and chase reads go to the CTA that holds
//     the byte (distributed shared memory).  A thread resolves each match
//     byte of its chunk to the plane byte it copies (the chase's hops need
//     no plane read) and then issues the chunk's reads together.  Chunks
//     are 4 bytes for literals and for the matches of a sparse window, 1
//     byte for the matches of a dense one (entries under 256 bytes on
//     average: a text window's chase chains are long, and a thread's bytes
//     run one after another; with 8-byte chunks 32 text blocks of 1 MiB
//     took 3.23 ms, 1.7x the first version).  A byte map of the shared
//     route's kind would need 16 bits a byte for 1024 entries and does not
//     fit beside a slice, so each CTA indexes the window's entries by
//     64-byte bucket (the last entry that starts at or before each bucket):
//     a lookup is one load and a search among a bucket's few entries, where
//     a search among all 1024 made every hop of a chase ten dependent
//     loads.  The barrier between the literals and the matches is a cluster
//     barrier, and it also orders the previous windows' writes;
//   * a block of at most 8 sequences: each CTA sweeps the bytes of its
//     stripes (remote reads only for match sources), with cluster barriers;
//   * the literal-block copy: each CTA a C-th of the output;
//     the serial walk: the first warp of the cluster, through distributed
//     shared memory, with a cluster-scope fence before each __syncwarp;
//   * the classifier splits the sequences across the cluster and combines
//     the CTAs' verdicts through distributed shared memory.
// Each CTA stores its stripes at the end, zeros past the decoded extent.
// What bounds the route now is still the windows' chain: a dense window's
// match bytes wait on their chase hops, and each window costs a cluster
// barrier; 32 blocks of 1 MiB are 256 CTAs of one an SM, more than the card
// holds at once, so they take rounds.  A cluster launch the card refuses
// returns its error.

// A launch optionally adds its blocks to paths[0] (well-formed, decoded in
// parallel) and paths[1] (serial walk), so a caller can show which path its
// tables took.

#include <cooperative_groups.h>

#include <algorithm>
#include <atomic>
#include <cstdint>

#include "cuda_util.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxWindow = 256;     // sequences per window
constexpr int kEntryBytes = 20;     // lit_ptr, lit_len, off, mlen, out_pos
constexpr int kMaxMap = 65536;      // bytes a window's sequence map covers
constexpr int kChunk = 8;           // consecutive bytes a thread takes at once
constexpr int kMapMin = 16;         // windows of more entries map each byte to its entry
constexpr int kSweepMax = 8;        // blocks of at most this many sequences are swept in order
constexpr int kSliceBytes = 1 << 17;  // plane bytes a cluster CTA holds at most
constexpr int kStripeShift = 10;    // the cluster route's plane: 1 KiB stripes dealt to the CTAs
constexpr int kMaxCluster = 8;      // the portable cluster size: planes of up to 1 MiB
constexpr int kClusterWindow = 1024;  // sequences per window on the cluster route
constexpr int kClusterChunk = 4;    // consecutive bytes a thread takes at once there: the
                                    // literals, and the matches of a sparse window;
constexpr int kDenseChunk = 1;      // the matches of a dense window (entries of fewer than
constexpr int kDenseBytes = 256;    // kDenseBytes bytes on average: text)
constexpr int kBucketShift = 6;     // the cluster route's entry index: one slot a 64-byte bucket
constexpr int kBuckets = kMaxMap >> kBucketShift;

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
  int span;                       // a window's starts lie within this many bytes of its first
  int map_len;                    // min(out_len, kMaxMap); 0 on the cluster route (no map)
  int* paths;                     // [2] or null
};

// Where a block's plane lives, and which threads share it.  CtaPlane: the
// shared route, the whole plane in the CTA's shared memory.  ClusterPlane:
// the cluster route, the plane dealt to the cluster's C CTAs (a power of
// two) in stripes of 1 KiB, stripe s to CTA s mod C, packed in its shared
// memory at (s / C) KiB; so any stretch of the plane spreads over every CTA.
//   * at(p): byte p wherever it lives;
//   * block(), tid(), threads(): the block, and the threads that share its
//     bytes;
//   * chunk0<K>(lo) and chunk_next<K>(c0): the chunks of K bytes this
//     thread takes of a window from byte lo on (the shared route's are
//     kChunk bytes whatever K; the cluster route's lie in the CTA's own
//     stripes, K-aligned, so the first may start before lo);
//   * own0(a) and own_step(): the bytes from a on that this thread takes in
//     a sweep (the CTA's own on the cluster route);
//   * local(), own_words(out_len), plane_word(k): the CTA's bytes in its
//     shared memory, how many 16-byte words of them hold the plane, and the
//     plane's word index of local word k;
//   * word_range: the 16-byte words of the output this CTA writes when the
//     plane is not needed (a literal block);
//   * sync(), fence(), all(): barriers over the plane's threads, a fence that
//     orders a warp's accesses to other CTAs' shared memory before its
//     __syncwarp (the serial walk), and every thread's verdict.
struct CtaPlane {
  static constexpr bool kCluster = false;
  static constexpr int kChunkBytes = kChunk;
  uint8_t* base;

  __device__ __forceinline__ uint8_t& at(int p) const { return base[p]; }
  __device__ __forceinline__ int block() const { return blockIdx.x; }
  __device__ __forceinline__ int tid() const { return threadIdx.x; }
  __device__ __forceinline__ int threads() const { return blockDim.x; }
  template <int K>
  __device__ __forceinline__ int chunk0(int lo) const { return lo + kChunk * threadIdx.x; }
  template <int K>
  __device__ __forceinline__ int chunk_next(int c0) const { return c0 + kChunk * blockDim.x; }
  __device__ __forceinline__ long long own0(long long a) const { return a + threadIdx.x; }
  __device__ __forceinline__ int own_step() const { return blockDim.x; }
  __device__ __forceinline__ uint8_t* local() const { return base; }
  __device__ __forceinline__ int own_words(int out_len) const { return out_len / 16; }
  __device__ __forceinline__ int plane_word(int k) const { return k; }
  __device__ __forceinline__ void word_range(int out_len, int* w0, int* w1) const {
    *w0 = 0;
    *w1 = out_len / 16;
  }
  __device__ __forceinline__ void sync() const { __syncthreads(); }
  __device__ __forceinline__ void fence() const {}
  __device__ __forceinline__ bool all(bool ok, int*) const { return __syncthreads_and(ok); }
};

struct ClusterPlane {
  static constexpr bool kCluster = true;
  static constexpr int kChunkBytes = kClusterChunk;
  uint8_t* slice;
  int rank, lg;                    // the CTA's rank, log2 of the cluster's CTAs

  __device__ __forceinline__ uint8_t& at(int p) const {
    const int s = p >> kStripeShift;
    uint8_t* q = slice + (((s >> lg) << kStripeShift) | (p & ((1 << kStripeShift) - 1)));
    return *cg::cluster_group::map_shared_rank(q, s & ((1 << lg) - 1));
  }
  __device__ __forceinline__ int block() const { return blockIdx.x >> lg; }
  __device__ __forceinline__ int tid() const { return rank * blockDim.x + threadIdx.x; }
  __device__ __forceinline__ int threads() const { return blockDim.x << lg; }
  // Own chunk j of the window (a stripe holds 1024 / K): in own stripe
  // j K / 1024 after the first at or past lo, at (j K) mod 1024; thread t's
  // chunks are j = t + i blockDim.x (blockDim.x K a multiple of 1024).
  template <int K>
  __device__ __forceinline__ int chunk0(int lo) const {
    const int first = (lo >> kStripeShift) + ((rank - (lo >> kStripeShift)) & ((1 << lg) - 1));
    const int j = threadIdx.x * K;
    return ((first + ((j >> kStripeShift) << lg)) << kStripeShift) +
           (j & ((1 << kStripeShift) - 1));
  }
  template <int K>
  __device__ __forceinline__ int chunk_next(int c0) const {
    return c0 + ((blockDim.x * K) << lg);
  }
  __device__ __forceinline__ long long own0(long long a) const {
    long long p = ((a >> kStripeShift) << kStripeShift) + threadIdx.x;
    if (p < a) p += 1 << kStripeShift;
    return p + ((static_cast<long long>((rank - (p >> kStripeShift)) & ((1 << lg) - 1)))
                << kStripeShift);
  }
  __device__ __forceinline__ int own_step() const { return 1 << (lg + kStripeShift); }
  __device__ __forceinline__ uint8_t* local() const { return slice; }
  __device__ __forceinline__ int own_words(int out_len) const {
    const int stripes = (out_len + (1 << kStripeShift) - 1) >> kStripeShift;
    return ((stripes - rank + (1 << lg) - 1) >> lg) << (kStripeShift - 4);
  }
  __device__ __forceinline__ int plane_word(int k) const {
    return ((rank + ((k >> (kStripeShift - 4)) << lg)) << (kStripeShift - 4)) |
           (k & ((1 << (kStripeShift - 4)) - 1));
  }
  __device__ __forceinline__ void word_range(int out_len, int* w0, int* w1) const {
    const int words = out_len / 16;
    *w0 = static_cast<int>(static_cast<long long>(words) * rank >> lg);
    *w1 = static_cast<int>(static_cast<long long>(words) * (rank + 1) >> lg);
  }
  __device__ __forceinline__ void sync() const { cg::cluster_group::sync(); }
  __device__ __forceinline__ void fence() const {
    asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
  }
  // Every CTA's verdict, each written into every CTA's `flags` before a
  // cluster barrier (which also makes sure every CTA of the cluster runs
  // before any reads another's shared memory).
  __device__ __forceinline__ bool all(bool ok, int* flags) const {
    const bool mine = __syncthreads_and(ok);
    if (threadIdx.x == 0)
      for (int r = 0; r < (1 << lg); ++r)
        *cg::cluster_group::map_shared_rank(flags + rank, r) = mine;
    cg::cluster_group::sync();
    bool every = true;
    for (int r = 0; r < (1 << lg); ++r) every = every && flags[r] != 0;
    return every;
  }
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

// The window entry that holds byte p (lo <= p < the window's end) on the
// cluster route: bk[k] is the last entry that starts at or before byte
// lo + 64 k of the window's span, so p's entry lies between the entries of
// its bucket's two ends: a binary search over the few of them.
__device__ __forceinline__ int entry_in_buckets(int p, const int32_t* op, const int16_t* bk, int lo,
                                                int cnt) {
  const int d = p - lo;
  if (d >= kMaxMap) return cnt - 1;               // every entry starts below lo + span
  int i = bk[d >> kBucketShift];
  int j = (d >> kBucketShift) + 1 < kBuckets ? bk[(d >> kBucketShift) + 1] : cnt - 1;
  while (i < j) {
    const int m = (i + j + 1) >> 1;
    if (op[m] <= p) i = m;
    else j = m - 1;
  }
  return i;
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
template <class Plane, class Lookup>
__device__ __forceinline__ uint8_t chase(int p, const Plane& plane, const Window& w, int lo,
                                         const Lookup& entry) {
  for (;;) {
    const int i = entry(p);
    if (p - w.op[i] < w.ll[i]) return plane.at(p);    // a literal of this window
    const int d = w.op[i] + w.ll[i];                  // <= p, so no overflow
    const int o = w.off[i];
    if (o < 1) return 0;
    const int r = p - d;
    const int src = r < o ? p - o : d - o + static_cast<int>(static_cast<unsigned>(r) %
                                                             static_cast<unsigned>(o));
    if (src < 0) return 0;
    if (src < lo) return plane.at(src);               // finished by an earlier window
    p = src;
  }
}

// Where byte p of the window (p >= lo) gets its final value: the plane byte
// it copies (a literal of the window or a byte before it), or -1 for 0.
// The hops of chase() without its read, so that a chunk's reads can be in
// flight together (the cluster route: each read may cross the cluster).
template <class Lookup>
__device__ __forceinline__ int chase_to(int p, const Window& w, int lo, const Lookup& entry) {
  for (;;) {
    const int i = entry(p);
    if (p - w.op[i] < w.ll[i]) return p;
    const int d = w.op[i] + w.ll[i];
    const int o = w.off[i];
    if (o < 1) return -1;
    const int r = p - d;
    const int src = r < o ? p - o : d - o + static_cast<int>(static_cast<unsigned>(r) %
                                                             static_cast<unsigned>(o));
    if (src < lo) return src < 0 ? -1 : src;
    p = src;
  }
}

// The cluster route's match bytes of a window [lo, hi), in this thread's
// chunks of K bytes: each match byte's source first (chase_to), then the
// chunk's reads together, then its writes (to the CTA's own stripes).
template <int K, class Lookup>
__device__ __forceinline__ void cluster_matches(const ClusterPlane& plane, const Window& w, int lo,
                                                int hi, int cnt, const Lookup& entry) {
  for (int c0 = plane.chunk0<K>(lo); c0 < hi; c0 = plane.chunk_next<K>(c0)) {
    int i = entry(max(c0, lo));
    Seq q;
    q.load(w, i, cnt);
    int m = -1;
    int src[K];                                 // the byte to read, -1 for 0, -2 no match byte
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int p = c0 + j;
      src[j] = -2;
      if (p < lo || p >= hi) continue;
      while (p >= q.end) {
        q.load(w, ++i, cnt);
        m = -1;
      }
      if (p < q.d) continue;
      src[j] = -1;
      if (q.off >= 1) {
        const int r = p - q.d;
        int s = p - q.off;
        if (r >= q.off) {
          m = m < 0 ? static_cast<int>(static_cast<unsigned>(r) % static_cast<unsigned>(q.off))
                    : (m + 1 == q.off ? 0 : m + 1);
          s = q.d - q.off + m;
        }
        src[j] = s >= lo ? chase_to(s, w, lo, entry) : (s < 0 ? -1 : s);
      }
    }
    uint8_t v[K];
#pragma unroll
    for (int j = 0; j < K; ++j) v[j] = src[j] >= 0 ? plane.at(src[j]) : 0;
#pragma unroll
    for (int j = 0; j < K; ++j)
      if (src[j] != -2) plane.at(c0 + j) = v[j];
  }
}

// Well-formed blocks: the sequences in windows of at most W entries whose
// starts lie within a.span bytes of the first.  Each of the plane's threads
// takes chunks of kChunk consecutive bytes and keeps the current entry in
// registers (one binary search a chunk, a step where an entry ends): a
// chunk's literal bytes are loaded together, and a match byte's source
// offset (r mod off) advances by one a byte instead of a division a byte.
// Each CTA stages the window's entries in its own shared memory.  `map`:
// the shared route's byte map, or the cluster route's bucket index.
template <class Plane>
__device__ void decode_windows(const Args& a, const uint8_t* cp, long long row, int ns,
                               const Plane& plane, uint8_t* entries, uint8_t* map) {
  constexpr int K = Plane::kChunkBytes;          // bytes a thread takes at once
  const int W = a.window, half = W / 2;
  const int ctid = threadIdx.x;                 // this CTA's copy of the entries
  const int olen = a.out_len, map_len = a.map_len;
  int n_op = 0, n_ll = 0, n_lp = 0, n_off = 0, n_ml = 0;     // this thread's next entry
  auto fetch = [&](int s) {
    if (ctid < W && s + ctid < ns) {
      const long long e = row + s + ctid;
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
    const bool mine = ctid < avail && n_ml > 0;
    if (ctid < avail) {
      w.op[ctid] = n_op;
      w.ll[ctid] = n_ll;
      w.lp[ctid] = n_lp;
      w.off[ctid] = n_off;
      w.ml[ctid] = n_ml;
    }
    // The entries; whether they hold a match.  (The other buffer and the
    // map are free: every thread of the CTA has ended the previous window.
    // On the shared route this barrier also orders the previous window's
    // writes; on the cluster route the barrier before the matches does.)
    const bool matches = __syncthreads_or(mine);
    const int lo = w.op[0];
    if (lo >= olen) break;                      // the rest lies past the plane
    const int cnt = 1 + find(w.op, avail, lo + a.span - 1, half);
    fetch(s0 + cnt);                            // in flight during this window
    const long long hi64 = static_cast<long long>(w.op[cnt - 1]) + w.ll[cnt - 1] + w.ml[cnt - 1];
    const int hi = static_cast<int>(min(hi64, static_cast<long long>(olen)));
    const bool use_map = matches && cnt > kMapMin && map_len > 0;
    int16_t* bk = reinterpret_cast<int16_t*>(map);
    const auto entry = [&](int p) {
      if constexpr (Plane::kCluster) return entry_in_buckets(p, w.op, bk, lo, cnt);
      else return entry_of(p, w.op, map, lo, map_len, cnt, half, use_map);
    };
    if constexpr (Plane::kCluster) {            // this CTA's bucket index of the window
      for (int k = ctid; k < kBuckets; k += blockDim.x)
        bk[k] = static_cast<int16_t>(find(w.op, cnt, lo + (k << kBucketShift), half));
      __syncthreads();
    }
    for (int c0 = plane.template chunk0<K>(lo); c0 < hi; c0 = plane.template chunk_next<K>(c0)) {
      int i;
      if constexpr (Plane::kCluster) i = entry(max(c0, lo));
      else i = find(w.op, cnt, c0, half);
      Seq q;
      q.load(w, i, cnt);
      int src[K];                               // comp index of a literal byte, -2 past the
#pragma unroll                                  // row, -1 not a literal
      for (int j = 0; j < K; ++j) {
        const int p = c0 + j;
        src[j] = -1;
        if (p < hi && (!Plane::kCluster || p >= lo)) {
          while (p >= q.end) q.load(w, ++i, cnt);
          if (use_map && p - lo < map_len) map[p - lo] = static_cast<uint8_t>(i);
          if (p < q.d) {
            const long long c = q.lp + p;
            src[j] = c >= 0 && c < a.comp_width ? static_cast<int>(c) : -2;
          }
        }
      }
      uint8_t v[K];
#pragma unroll
      for (int j = 0; j < K; ++j) v[j] = src[j] >= 0 ? __ldg(cp + src[j]) : 0;
#pragma unroll
      for (int j = 0; j < K; ++j)
        if (src[j] != -1) plane.at(c0 + j) = v[j];
    }
    if (!matches) {                             // a later barrier orders the writes
      s0 += cnt;
      continue;
    }
    plane.sync();                               // the window's literals and map
    if constexpr (Plane::kCluster) {
      if (hi - lo < kDenseBytes * cnt)
        cluster_matches<kDenseChunk>(plane, w, lo, hi, cnt, entry);
      else
        cluster_matches<kClusterChunk>(plane, w, lo, hi, cnt, entry);
      s0 += cnt;
      continue;
    }
    for (int c0 = plane.template chunk0<K>(lo); c0 < hi; c0 = plane.template chunk_next<K>(c0)) {
      int i = entry(c0);
      Seq q;
      q.load(w, i, cnt);
      int m = -1;                               // r mod off of the last match byte, or -1
#pragma unroll 1
      for (int j = 0; j < K; ++j) {
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
          if (src >= lo) v = chase(src, plane, w, lo, entry);
          else if (src >= 0) v = plane.at(src);
        }
        plane.at(p) = v;
      }
    }
    s0 += cnt;
  }
  plane.sync();
}

// A well-formed block of at most kSweepMax sequences: each sequence in turn,
// each CTA's threads on the literal bytes it holds, a barrier, on its match
// bytes in closed form (their sources lie before dst, final by then), a
// barrier.  A thread's bytes are T apart (T = own_step()), so its r mod off
// steps by T mod off: one division a sequence.  (Windows would search, map and chase for
// blocks that are one or two long runs, as most 4 KiB blocks are.)
template <class Plane>
__device__ void decode_sweep(const Args& a, const uint8_t* cp, long long row, int ns,
                             const Plane& plane) {
  const int T = plane.own_step();
  const long long olen = a.out_len;
  for (int s = 0; s < ns; ++s) {
    const long long op = __ldg(a.out_pos + row + s), ll = __ldg(a.lit_len + row + s);
    const long long lp = __ldg(a.lit_ptr + row + s) - op;
    for (long long p = plane.own0(op); p < min(op + ll, olen); p += T) {
      const long long q = lp + p;
      plane.at(p) = q >= 0 && q < a.comp_width ? __ldg(cp + q) : 0;
    }
    plane.sync();
    const long long d = op + ll, end = min(d + __ldg(a.mlen + row + s), olen);
    const int o = __ldg(a.off + row + s);
    const long long p0 = plane.own0(d);
    if (p0 < end) {
      const int tm = o >= 1 ? T % o : 0;
      int m = -1;                           // r mod o once r >= o
      for (long long p = p0; p < end; p += T) {
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
        plane.at(p) = src >= 0 ? plane.at(src) : 0;
      }
    }
    plane.sync();
  }
}

// A well-formed block of one literal run and no match (a RAW block): bytes
// [0, len) are the comp row from lit_ptr (0 outside the row), zeros after;
// this CTA's 16-byte words [lo, words) of them copied straight to device
// memory, 16 bytes a thread where the source is 16-byte aligned and inside
// the row.
__device__ void copy_literal_block(const Args& a, const uint8_t* cp, long long lp, long long len,
                                   uint8_t* out, int lo, int words) {
  uint4* o = reinterpret_cast<uint4*>(out);
  if (lp >= 0 && lp + len <= a.comp_width && (reinterpret_cast<uintptr_t>(cp + lp) & 15) == 0) {
    const uint4* s = reinterpret_cast<const uint4*>(cp + lp);
#pragma unroll 4
    for (int i = lo + threadIdx.x; i < words; i += blockDim.x) {
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
  for (int i = lo + threadIdx.x; i < words; i += blockDim.x) {
    uint32_t w[4] = {0, 0, 0, 0};
    for (int j = 0; j < 16 && 16LL * i + j < len; ++j) {
      const long long q = lp + 16LL * i + j;
      if (q >= 0 && q < a.comp_width) w[j >> 2] |= static_cast<uint32_t>(__ldg(cp + q)) << (8 * (j & 3));
    }
    o[i] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// Any table: the first warp walks the sequences in order (the function's
// definition); each CTA zeroes its bytes of the plane first.
template <class Plane>
__device__ void decode_serial(const Args& a, const uint8_t* cp, long long row, int ns,
                              const Plane& plane) {
  uint4* pv = reinterpret_cast<uint4*>(plane.local());
  const int own = plane.own_words(a.out_len);
  for (int i = threadIdx.x; i < own; i += blockDim.x) pv[i] = make_uint4(0, 0, 0, 0);
  plane.sync();
  if (plane.tid() < 32) {
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
          plane.at(static_cast<int>(p0 + j)) = (q >= 0 && q < a.comp_width) ? cp[q] : 0;
        }
        plane.fence();
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
            if (q >= 0) v = plane.at(static_cast<int>(q));
          }
          plane.at(static_cast<int>(d + j)) = v;
        }
        plane.fence();
        __syncwarp();
      }
    }
  }
  plane.sync();
}

// One block: classify, decode into the plane, store this CTA's bytes of it
// (zeros past a well-formed block's extent).  `flags`: the cluster route's
// verdict slots.
template <class Plane>
__device__ void decode_block(const Args& a, const Plane& plane, uint8_t* windows, int* flags) {
  const int b = plane.block();
  uint8_t* out = a.out + static_cast<long long>(b) * a.out_len;
  const uint8_t* cp = a.comp + static_cast<long long>(b) * a.comp_stride;
  const long long row = static_cast<long long>(b) * a.S;
  int ns = a.nseq[b];
  ns = ns < 0 ? 0 : (ns > a.S ? a.S : ns);

  bool ok = true;
  for (int s = plane.tid(); s < ns; s += plane.threads()) {
    const long long op = __ldg(a.out_pos + row + s);
    const long long ll = __ldg(a.lit_len + row + s);
    const long long ml = __ldg(a.mlen + row + s);
    ok = ok && ll >= 0 && ml >= 0 && (s > 0 || op == 0) &&
         (s + 1 >= ns || __ldg(a.out_pos + row + s + 1) == op + ll + ml);
  }
  const bool well = plane.all(ok, flags);
  if (a.paths != nullptr && plane.tid() == 0) atomicAdd(a.paths + (well ? 0 : 1), 1);

  if (well && ns == 1 && __ldg(a.mlen + row) == 0) {
    const long long ll = __ldg(a.lit_len + row);
    int w0, w1;
    plane.word_range(a.out_len, &w0, &w1);
    copy_literal_block(a, cp, __ldg(a.lit_ptr + row), ll < a.out_len ? ll : a.out_len, out, w0,
                       w1);
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

  // This CTA's bytes of the plane: local word k is the plane's word i.
  const uint8_t* pl = plane.local();
  uint4* ov = reinterpret_cast<uint4*>(out);
  const uint4* pv = reinterpret_cast<const uint4*>(pl);
  const int own = plane.own_words(a.out_len);
  for (int k = threadIdx.x; k < own; k += blockDim.x) {
    const int i = plane.plane_word(k);
    if (i >= a.out_len / 16) break;                 // the last stripe's words past the plane
    uint4 v = make_uint4(0, 0, 0, 0);
    if (16LL * i + 16 <= lim) {
      v = pv[k];
    } else if (16LL * i < lim) {
      uint32_t w[4] = {0, 0, 0, 0};
      for (int j = 0; 16LL * i + j < lim; ++j)
        w[j >> 2] |= static_cast<uint32_t>(pl[16 * k + j]) << (8 * (j & 3));
      v = make_uint4(w[0], w[1], w[2], w[3]);
    }
    ov[i] = v;
  }
}

// Shared memory: the plane (shared route) or the CTA's slice of it
// (cluster route), two windows of entries, the window's map (shared route
// only), the cluster's verdict slots (cluster route only).
__global__ void __launch_bounds__(kMaxThreads) decode_tables_kernel_shared(Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  decode_block(a, CtaPlane{smem}, smem + a.out_len, nullptr);
}

__global__ void __launch_bounds__(kMaxThreads, 1) decode_tables_kernel_cluster(Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const ClusterPlane plane{smem, static_cast<int>(cg::cluster_group::block_rank()),
                           __ffs(static_cast<int>(cg::cluster_group::num_blocks())) - 1};
  uint8_t* windows = smem + kSliceBytes;     // then the bucket index, the verdict slots
  decode_block(a, plane, windows,
               reinterpret_cast<int*>(windows + 2 * a.window * kEntryBytes + 2 * kBuckets));
}

// Devices whose shared-memory opt-in is done (bit d for device d < 64),
// per route.
std::atomic<unsigned long long> g_opted[2] = {0, 0};

// Bytes of shared memory the shared route needs for a plane of out_len.
long long shared_route_bytes(long long out_len, int* threads, int* window, int* map_len) {
  *threads = static_cast<int>(std::min<long long>(kMaxThreads, std::max<long long>(128, out_len / 32)));
  *window = std::min(*threads, kMaxWindow);
  *map_len = static_cast<int>(std::min<long long>(out_len, kMaxMap));
  return out_len + 2LL * *window * kEntryBytes + *map_len;
}

}  // namespace

// CTAs that decode one block of an `out_rows`-row plane: 1 on the shared
// route (the plane fits beside the windows and the map), else a cluster of
// the least power of two of 128 KiB slices that holds the plane (2, 4 or
// 8); 0 for a plane the kernel does not take.
extern "C" int bt_decode_tables_cluster_ctas(int out_rows) {
  if (out_rows < 1 || out_rows > (1 << 16)) return 0;
  int threads, window, map_len;
  const long long out_len = static_cast<long long>(out_rows) * 128;
  if (shared_route_bytes(out_len, &threads, &window, &map_len) <= bt::kSmemMax) return 1;
  int ctas = 2;                     // a power of two that holds the plane in 128 KiB slices
  while (ctas < kMaxCluster && static_cast<long long>(ctas) * kSliceBytes < out_len) ctas *= 2;
  return static_cast<long long>(ctas) * kSliceBytes >= out_len ? ctas : 0;
}

// Launches one CTA (shared route) or one cluster (cluster route) per block
// on `stream` of `device`; returns the CUDA error code (0 on success), also
// when the card refuses the cluster launch.  Pointers are device pointers;
// the caller allocates `out` (16-byte aligned) and, if not null, `paths`
// (two ints).
extern "C" int bt_decode_tables_launch(
    const void* comp, long long comp_stride, int comp_width, const void* nseq,
    const void* lit_ptr, const void* lit_len, const void* off, const void* mlen,
    const void* out_pos, int S, void* out, int n, int out_rows, void* paths, int device,
    void* stream) {
  const int ctas = bt_decode_tables_cluster_ctas(out_rows);
  if (n < 0 || S < 1 || ctas == 0 || comp_width < 0 ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0 || device < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const long long out_len = static_cast<long long>(out_rows) * 128;
  const bool cluster = ctas > 1;
  int threads, window, map_len;
  long long smem = shared_route_bytes(out_len, &threads, &window, &map_len);
  if (cluster) {                    // the slice, two windows of entries, the bucket index,
    threads = kMaxThreads;          // the verdict slots
    window = kClusterWindow;
    map_len = 0;
    smem = kSliceBytes + 2LL * window * kEntryBytes + 2 * kBuckets + 4 * kMaxCluster;
  }
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // The whole opt-in range, once per device: a launch with a larger plane
  // from another thread then never meets a smaller limit set for this one.
  auto* kernel = cluster ? decode_tables_kernel_cluster : decode_tables_kernel_shared;
  if (device >= 64 || !(g_opted[cluster].load() & (1ULL << device))) {
    err = bt::smem_opt_in(kernel, bt::kSmemMax);
    if (err == cudaSuccess && device < 64) g_opted[cluster].fetch_or(1ULL << device);
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
    a.span = cluster ? kMaxMap : map_len;
    a.map_len = map_len;
    a.paths = static_cast<int*>(paths);
    if (cluster) {
      cudaLaunchConfig_t cfg = {};
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = ctas;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cfg.gridDim = dim3(static_cast<unsigned>(n) * ctas);
      cfg.blockDim = dim3(threads);
      cfg.dynamicSmemBytes = static_cast<size_t>(smem);
      cfg.stream = static_cast<cudaStream_t>(stream);
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      err = cudaLaunchKernelEx(&cfg, kernel, a);
      if (err == cudaSuccess) err = cudaGetLastError();
    } else {
      kernel<<<n, threads, static_cast<int>(smem), static_cast<cudaStream_t>(stream)>>>(a);
      err = cudaGetLastError();
    }
  }
  if (current != device) cudaSetDevice(current);
  return static_cast<int>(err);
}
