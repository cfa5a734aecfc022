// Decode-plan builder: LZ77 sequences -> scheduled slope-1 fragment passes.
//
// The TPU-native decode design splits decompression into a host PLAN stage
// and a device EXECUTE stage.  The plan turns a block's sequences into
// "fragments" — disjoint output spans, each a slope-1 copy
//
//   out[p] = src_plane[p + shift]     for p in [dst, dst+len)
//
// where src_plane is either the compressed stream (literals, and matches
// that resolve there cleanly) or the partially-built output (deep match
// chains).  Fragments are then greedily scheduled into PASSES: each pass
// supplies at most one fragment per 128-byte output row, all sources of a
// fragment are materialized in strictly earlier passes, and every pass
// reads from a single source plane (comp-source passes first, then
// out-source passes).  The device kernel executes one pass with pure
// vector work — an MXU one-hot row gather plus a per-lane shuffle — so
// total decode cost is (number of passes) x (a few microseconds),
// independent of sequence count.
//
// Key choices:
// * Matches whose source projects onto <= kSplitLimit comp-space pieces are
//   resolved immediately (collapses the common shallow chains of real
//   text); deeper or splintered chains stay out-space references.
// * Overlapping matches (offset < length, the RLE case) are split into
//   log2(len/offset) doubling pieces, each a plain slope-1 out-space copy.
// * A block whose schedule exceeds the caller's pass budget is reported
//   unplannable; the engine falls back to the scalar-walk kernel.

#include "bitar_host.h"

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cstring>
#include <functional>
#include <memory>
#include <thread>
#include <vector>

namespace {

thread_local int g_split_limit = 2;  // per-thread: see bt_plan_rows' split_limit arg

// Phase profiling accumulators (ns, summed across worker threads):
// [0]=parse [1]=build [2]=densify [3]=schedule [4]=emit-wire [5]=pack
// [6]=densify:collect-resolve [7]=densify:window-write (sub-phases of 2).
// Cheap enough to keep always-on; read/reset via bt_plan_prof_get.
std::atomic<int64_t> g_prof[8];

struct ProfScope {
  int idx;
  std::chrono::steady_clock::time_point t0;
  explicit ProfScope(int i) : idx(i), t0(std::chrono::steady_clock::now()) {}
  ~ProfScope() {
    g_prof[idx].fetch_add(
        std::chrono::duration_cast<std::chrono::nanoseconds>(
            std::chrono::steady_clock::now() - t0)
            .count(),
        std::memory_order_relaxed);
  }
};

inline int32_t Gcd(int32_t a, int32_t b) {
  while (b != 0) {
    const int32_t t = a % b;
    a = b;
    b = t;
  }
  return a;
}

struct Frag {
  int32_t dst;
  int32_t len;
  int32_t shift;      // src = p + shift in the source plane; for kFill:
                      // the base source row rs
  uint8_t out_space;  // 0 = comp plane, 1 = output plane, 2 = row fill
  int32_t aux;        // kFill only: source period in rows (g)
  int32_t cell_base;  // index of this fragment's first row-cell pass
};

// Fragment kinds (Frag::out_space).
constexpr uint8_t kComp = 0;
constexpr uint8_t kOut = 1;
// Row fill: every target row r copies SOURCE ROW rs + ((r - rs) mod g)
// whole-row (per-row cell shift = (sr - r) * 128).  This collapses the
// tail of an overlapping match (offset < length, the RLE/periodic case)
// into ONE pass regardless of length: once g consecutive rows hold the
// repeating content, every later row is a plain row copy — expressible
// in the existing kernel wire because plan cells are per (pass, row)
// and carry their own shift.  The log-doubling expansion only runs
// until those g source rows exist.
constexpr uint8_t kFill = 2;
// Fill applies when g = offset / gcd(offset, 128) beats the doubling
// pass count it replaces; this caps the source-row window regardless.
constexpr int32_t kMaxFillPeriodRows = 32;

// Per-(fragment, row) plan-cell shift: the wire value stored in the
// flat plan for row r of fragment f.
inline int32_t CellShift(const Frag& f, int32_t r) {
  if (f.out_space != kFill) return f.shift;
  const int32_t sr = f.shift + ((r - f.shift) % f.aux);
  return (sr - r) * 128;
}

class Planner {
 public:
  // Fragment covering output pos (fragments are dense, dst-ordered).
  // A per-row first-fragment index makes the lookup O(frags in the row)
  // instead of O(log n) — ProjectToComp calls this once per chain link
  // per piece and dominated plan-build time under gprof.
  int FindIdx(int32_t pos) const {
    if (pos < 0) return -1;
    const size_t r = static_cast<size_t>(pos) >> 7;
    if (r >= row_idx_.size()) return -1;
    int idx = row_idx_[r];
    if (idx < 0) return -1;
    const int n = static_cast<int>(frags_.size());
    while (idx < n && frags_[idx].dst + frags_[idx].len <= pos) ++idx;
    if (idx >= n || frags_[idx].dst > pos) return -1;
    return idx;
  }

  void Append(int32_t dst, int32_t len, int32_t shift, bool out_space) {
    if (len <= 0) return;
    if (!frags_.empty()) {
      Frag& b = frags_.back();
      // Merge contiguous continuations of the same copy — but an
      // out-space fragment must never grow to overlap its own source
      // (len <= offset, offset = -shift), or a single pass would read
      // bytes it writes.
      if (b.dst + b.len == dst && b.shift == shift &&
          b.out_space == (out_space ? 1 : 0) &&
          (!out_space || b.len + len <= -shift)) {
        b.len += len;
        IndexRows(static_cast<int>(frags_.size()) - 1, dst, len);
        return;
      }
    }
    frags_.push_back({dst, len, shift, static_cast<uint8_t>(out_space), 0, 0});
    IndexRows(static_cast<int>(frags_.size()) - 1, dst, len);
  }

  // Append a row-fill fragment (see kFill): [dst, dst+len) with dst
  // row-aligned, base source row rs, source period g rows.
  void AppendFill(int32_t dst, int32_t len, int32_t rs, int32_t g) {
    if (len <= 0) return;
    frags_.push_back({dst, len, rs, kFill, g, 0});
    IndexRows(static_cast<int>(frags_.size()) - 1, dst, len);
  }

  struct Piece { int32_t comp_src; int32_t len; };

  // Projects an output range onto comp-space pieces, following out-space
  // fragments transitively (collapses match-of-match chains).  Fails when
  // the projection splinters past the piece limit or recurses too deep
  // (pathological chains stay out-space instead).
  bool ProjectToComp(int32_t pos, int32_t len, std::vector<Piece>* pieces,
                     int depth) const {
    if (depth > 64) return false;
    int fi = FindIdx(pos);
    while (len > 0) {
      if (fi < 0 || fi >= static_cast<int>(frags_.size())) return false;
      const Frag& f = frags_[fi];
      if (f.dst > pos || f.dst + f.len <= pos) return false;  // gap
      const int32_t take = std::min(len, f.dst + f.len - pos);
      if (f.out_space == kFill) {
        // Per-row variable shifts don't project to one slope-1 span.
        return false;
      }
      if (f.out_space) {
        if (!ProjectToComp(pos + f.shift, take, pieces, depth + 1)) {
          return false;
        }
      } else {
        const int32_t src = pos + f.shift;
        if (!pieces->empty() &&
            pieces->back().comp_src + pieces->back().len == src) {
          pieces->back().len += take;
        } else {
          if (static_cast<int>(pieces->size()) >= g_split_limit) return false;
          pieces->push_back({src, take});
        }
      }
      pos += take;
      len -= take;
      ++fi;  // fragments are dense: the next piece starts at f.dst + f.len
    }
    return true;
  }

  // Emit fragments for a match piece [d, d+len) copying from out-space
  // [d-off, d-off+len) (no self-overlap: off >= len guaranteed by caller).
  // Resolves to comp-space when the transitive projection stays small,
  // else emits one out-space fragment.
  bool EmitMatch(int32_t d, int32_t len, int32_t off) {
    static thread_local std::vector<Piece> pieces;
    pieces.clear();
    if (ProjectToComp(d - off, len, &pieces, 0)) {
      int32_t e = d;
      for (const Piece& p : pieces) {
        Append(e, p.len, p.comp_src - e, /*out_space=*/false);
        e += p.len;
      }
      return true;
    }
    if (FindIdx(d - off) < 0) return false;  // malformed source range
    Append(d, len, -off, /*out_space=*/true);
    return true;
  }

  bool Build(int nseq, const int32_t* lit_ptr, const int32_t* lit_len,
             const int32_t* off, const int32_t* mlen, const int32_t* out_pos,
             int max_frags) {
    for (int s = 0; s < nseq; ++s) {
      if (static_cast<int>(frags_.size()) > max_frags) return false;
      Append(out_pos[s], lit_len[s], lit_ptr[s] - out_pos[s], false);
      const int32_t m = mlen[s];
      if (m <= 0) continue;
      const int32_t d = out_pos[s] + lit_len[s];
      const int32_t o = off[s];
      if (o >= m) {
        if (!EmitMatch(d, m, o)) return false;
        continue;
      }
      // Overlap (offset < length): out[p] = out[p - o] makes the whole
      // region [d-o, d+m) periodic with period o.  Once g = o/gcd(o,128)
      // consecutive FULL rows of that region exist, every later row is a
      // whole-row copy of one of them — a single kFill pass regardless
      // of match length.  Doubling pieces [d, d+o), [d+o, d+2o), ...
      // build only the head.
      int32_t needed = m;          // head bytes before the fill can start
      int32_t rs = 0, g = 0;
      if (d - o >= 0) {
        g = o / Gcd(o, 128);
        // Doubling passes the fill would replace: log2(m / o)-ish.
        int32_t dbl = 0;
        for (int64_t c = o; c < m; c <<= 1) ++dbl;
        if (g <= kMaxFillPeriodRows && g < dbl) {
          rs = (d - o + 127) / 128;          // first full row in the region
          const int32_t head = (rs + g) * 128 - d;
          // Worth a fill only when the tail spans at least two rows.
          if (head >= 0 && head < m && (m - head) >= 2 * 128) {
            needed = head;
          }
        }
      }
      int32_t defined = 0;
      while (defined < std::min(needed, m)) {
        int32_t chunk = std::min(defined == 0 ? o : defined, m - defined);
        if (needed < m) chunk = std::min(chunk, needed - defined);
        // Piece start e = d + defined copies from `step` bytes back:
        // o for the first piece, then the doubling distance `defined` —
        // both guarantee the source is fully materialized.
        const int32_t step = (defined == 0) ? o : defined;
        // Doubling pieces over a tiny period splinter into unit-length
        // comp fragments under projection (an RLE head would resolve to
        // ~chunk one-byte fragments, each its own pass in its row);
        // budget the projection by piece length so tiny pieces stay
        // out-space.
        const int saved_limit = g_split_limit;
        g_split_limit = std::min(saved_limit, std::max(1, chunk / 16));
        const bool ok = EmitMatch(d + defined, chunk, step);
        g_split_limit = saved_limit;
        if (!ok) return false;
        defined += chunk;
      }
      if (defined < m) {
        AppendFill(d + defined, m - defined, rs, g);
      }
    }
    return true;
  }

  // Greedy pass scheduling at ROW-CELL granularity: every (fragment, row)
  // pair is scheduled independently, so a fragment spanning many rows does
  // not force one global pass (which would cascade into a pass-count
  // "staircase" along the block).  Invariants per cell:
  //   * at most one cell per (row, pass),
  //   * comp-source cells take passes [0, p0), out-source cells [p0, P),
  //   * an out-source cell's pass strictly exceeds the passes of all cells
  //     covering its source byte range,
  //   * with band_rows > 0: per (pass, band_tile-row output tile), all
  //     source rows fit one window of band_rows rows whose 8-aligned base
  //     the device kernel uses for a single static-K gather matmul
  //     (lz4_decode_flat.py KBAND) — the constraint that turns every
  //     gather from O(plane rows) into O(band_rows).  band_tile must
  //     equal the kernel's M-tile (mt_max); finer tiles bind the
  //     constraint less (fewer extra passes) at more per-pass M-tile
  //     iterations.
  // Returns total passes, or -1 when over budget.
  static constexpr int kTileRows = 1024;  // default kernel M-tile (mt_max)

  struct Band {
    int32_t lo = -1, hi = -1;
    bool Fits(int32_t srlo, int32_t srhi, int band_rows) const {
      const int32_t nlo = lo < 0 ? srlo : std::min(lo, srlo);
      const int32_t nhi = lo < 0 ? srhi : std::max(hi, srhi);
      return nhi - (nlo & ~7) < band_rows;
    }
    void Add(int32_t srlo, int32_t srhi) {
      lo = lo < 0 ? srlo : std::min(lo, srlo);
      hi = hi < 0 ? srhi : std::max(hi, srhi);
    }
  };

  int Schedule(int nrows, int max_passes, int* p0_out, int band_rows = 0,
               int band_tile = kTileRows) {
    AllocCells();

    const int ntiles = (nrows + band_tile - 1) / band_tile;
    std::vector<Band> bands;
    if (band_rows > 0) {
      bands.assign(static_cast<size_t>(max_passes) * ntiles, Band{});
    }
    // (row, pass) occupancy for the comp phase: band constraints leave
    // holes, so a plain per-row counter no longer works.
    std::vector<uint8_t> comp_used;
    std::vector<int> comp_slots(nrows, 0);
    if (band_rows > 0) {
      comp_used.assign(static_cast<size_t>(nrows) * max_passes, 0);
    }
    int p0 = 0;
    for (const Frag& f : frags_) {
      if (f.out_space) continue;
      const int r0 = f.dst / 128;
      const int r1 = (f.dst + f.len - 1) / 128;
      for (int r = r0; r <= r1; ++r) {
        if (cell_is_dense(f.cell_base + (r - r0))) continue;
        int pass;
        if (band_rows > 0) {
          const int32_t cell_lo = std::max(f.dst, r * 128);
          const int32_t cell_hi = std::min(f.dst + f.len, (r + 1) * 128);
          const int32_t srlo = (cell_lo + f.shift) >> 7;
          const int32_t srhi = (cell_hi - 1 + f.shift) >> 7;
          const int tile = r / band_tile;
          uint8_t* row_used =
              comp_used.data() + static_cast<size_t>(r) * max_passes;
          pass = 0;
          while (pass < max_passes &&
                 (row_used[pass] ||
                  !bands[static_cast<size_t>(pass) * ntiles + tile].Fits(
                      srlo, srhi, band_rows))) {
            ++pass;
          }
          if (pass >= max_passes) return -1;
          row_used[pass] = 1;
          bands[static_cast<size_t>(pass) * ntiles + tile].Add(srlo, srhi);
        } else {
          pass = comp_slots[r]++;
        }
        cell_pass_[f.cell_base + (r - r0)] = pass;
        p0 = std::max(p0, pass + 1);
      }
    }
    if (p0 > max_passes) return -1;
    // Out passes take pass numbers >= p0, so the same per-pass band slots
    // serve both phases without a reset (comp bands live in [0, p0)).

    // Out-source cells: dependency floors leave holes in a row's pass
    // sequence; reuse them (first-fit above the floor) instead of only
    // appending, which keeps P near the true per-row density.
    std::vector<uint8_t> used(static_cast<size_t>(nrows) * max_passes, 0);
    int total = p0;
    for (const Frag& f : frags_) {
      if (!f.out_space) continue;
      const int r0 = f.dst / 128;
      const int r1 = (f.dst + f.len - 1) / 128;
      for (int r = r0; r <= r1; ++r) {
        if (cell_is_dense(f.cell_base + (r - r0))) continue;
        const int32_t cell_lo = std::max(f.dst, r * 128);
        const int32_t cell_hi = std::min(f.dst + f.len, (r + 1) * 128);
        const int32_t cs = CellShift(f, r);
        // Dependency floor over the source range of this cell (linear
        // forward walk: fragments are dense).
        int floor_pass = p0 - 1;
        int32_t pos = cell_lo + cs;
        int32_t remaining = cell_hi - cell_lo;
        int fi = FindIdx(pos);
        while (remaining > 0) {
          if (fi < 0 || fi >= static_cast<int>(frags_.size())) return -1;
          const Frag& s = frags_[fi];
          if (s.dst > pos || s.dst + s.len <= pos) return -1;
          const int32_t take = std::min(remaining, s.dst + s.len - pos);
          const int sr0 = s.dst / 128;
          for (int sr = pos / 128; sr <= (pos + take - 1) / 128; ++sr) {
            floor_pass = std::max(
                floor_pass, cell_pass_[s.cell_base + (sr - sr0)]);
          }
          pos += take;
          remaining -= take;
          ++fi;
        }
        int pass = std::max(floor_pass + 1, p0);
        uint8_t* row_used = used.data() + static_cast<size_t>(r) * max_passes;
        if (band_rows > 0) {
          const int32_t srlo = (cell_lo + cs) >> 7;
          const int32_t srhi = (cell_hi - 1 + cs) >> 7;
          const int tile = r / band_tile;
          while (pass < max_passes &&
                 (row_used[pass] ||
                  !bands[static_cast<size_t>(pass) * ntiles + tile].Fits(
                      srlo, srhi, band_rows))) {
            ++pass;
          }
          if (pass >= max_passes) return -1;
          bands[static_cast<size_t>(pass) * ntiles + tile].Add(srlo, srhi);
        } else {
          while (pass < max_passes && row_used[pass]) ++pass;
          if (pass >= max_passes) return -1;
        }
        row_used[pass] = 1;
        cell_pass_[f.cell_base + (r - r0)] = pass;
        total = std::max(total, pass + 1);
      }
    }
    *p0_out = p0;
    return total;
  }

  std::vector<Frag>& frags() { return frags_; }
  const std::vector<int32_t>& cell_pass() const { return cell_pass_; }

  // --- Dense comp passes (v5 wire) ------------------------------------
  //
  // Comp-sourced cells of one output row source small windows of the
  // comp plane (a row's literals span ~compressed-row-size bytes;
  // re-sourced match reads scatter, but each cell still spans <= 2
  // source rows).  Per row the cells are covered greedily by up to
  // kDenseMax 3-row windows; every covered cell moves OFF the pass
  // schedule and executes in the window's dense pass from a per-byte
  // wire
  //
  //   dq[p] = pass+1(bits 9..14) | drow(bits 7..8) | src_lane(bits 0..6)
  //   row_a[j][r] = pass j's anchor source row for output row r;
  //                 byte src row = row_a + drow (drow <= 2)
  //
  // gathered through a triple-paired source plane (rows a, a+1, a+2).
  // Each dense pass costs one anchored gather over all rows (~ one
  // scheduled pass); a handful replace up to ~56 scheduled comp passes
  // on low-entropy data.  Rows needing more than kDenseMax windows keep
  // their largest-coverage windows dense; the rest stay scheduled
  // (kDenseMax 63 covers every corpus measured — markdown-heavy text
  // peaks at ~13 windows/row; the cap is the wire field, not a tuning).
  // Must run before Schedule(); fills cell_dense_ (parallel to
  // cell_pass_) and the caller-provided planes.
  static constexpr int kDenseMax = 63;   // pass ids 1..63 in 6 wire bits

  // Transitively resolve output byte p to its comp-plane source, chasing
  // out-space and fill fragments (chains strictly reference earlier
  // positions, so this terminates; the depth cap guards pathologies).
  // Memoized per block: fill rows all chase the same seed bytes, so the
  // naive walk re-resolves them once per row (measured 3x plan-build
  // cost); with the memo total work is one hop per distinct position.
  // Returns the comp position or -1.
  static constexpr int32_t kUnresolved = -2;
  int32_t ResolveToComp(int32_t p) {
    static thread_local std::vector<int32_t> chain;
    chain.clear();
    int32_t result = -1;
    for (int depth = 0; depth <= 64; ++depth) {
      if (p >= 0 && p < static_cast<int32_t>(resolve_memo_.size())) {
        const int32_t m = resolve_memo_[p];
        if (m != kUnresolved) { result = m; break; }
      }
      const int fi = FindIdx(p);
      if (fi < 0) break;
      const Frag& f = frags_[fi];
      if (f.out_space == kComp) { result = p + f.shift; break; }
      chain.push_back(p);
      p += CellShift(f, p >> 7);     // kOut: f.shift; kFill: row remap
    }
    for (const int32_t q : chain) {
      if (q >= 0 && q < static_cast<int32_t>(resolve_memo_.size())) {
        resolve_memo_[q] = result;
      }
    }
    return result;
  }

  void Densify(int nrows, int16_t* dq, int32_t* row_a, int32_t* dense_out) {
    AllocCells();
    cell_dense_.assign(cell_pass_.size(), 0);
    resolve_memo_.assign(static_cast<size_t>(nrows) * 128, kUnresolved);
    *dense_out = 0;
    const int32_t memo_size = static_cast<int32_t>(resolve_memo_.size());
    // Prefill comp fragments as resolved ramps (memo[p] = p + shift).
    // Without this, any out/fill cell sourcing a literal region misses
    // the memo and pays the generic per-byte walk — measured 4x the
    // whole collect phase on RLE/periodic corpora (the fill rows all
    // chase the seed row, whose literal byte was never memoized).
    for (const Frag& f : frags_) {
      if (f.out_space != kComp) continue;
      const int32_t end = std::min(f.dst + f.len, memo_size);
      int32_t* mp = resolve_memo_.data();
      for (int32_t p = f.dst < 0 ? 0 : f.dst; p < end; ++p) {
        mp[p] = p + f.shift;
      }
    }

    // src_base >= 0: per-byte resolved sources in byte_src (out/fill
    // cells whose bytes ALL chase to comp within a 3-row window);
    // src_base < 0: slope-1 comp cell, src = p + frag.shift.
    struct Cell { int32_t frag; int32_t lo, hi, srlo, srhi, src_base; };
    static thread_local std::vector<Cell> cells;
    static thread_local std::vector<int32_t> row_head;
    static thread_local std::vector<int32_t> byte_src;
    cells.clear();
    row_head.assign(static_cast<size_t>(nrows) + 1, 0);
    byte_src.clear();

    // Bucket candidate cells by row (fragments are dst-ordered, so
    // cells arrive row-sorted; counting sort by row).
    {
    ProfScope prof_collect(6);
    for (int fi = 0; fi < static_cast<int>(frags_.size()); ++fi) {
      const Frag& f = frags_[fi];
      const int r0 = f.dst / 128;
      const int r1 = (f.dst + f.len - 1) / 128;
      for (int r = r0; r <= r1 && r < nrows; ++r) {
        const int32_t lo = std::max(f.dst, r * 128);
        const int32_t hi = std::min(f.dst + f.len, (r + 1) * 128);
        if (f.out_space == kComp) {
          cells.push_back({fi, lo, hi, (lo + f.shift) >> 7,
                           (hi - 1 + f.shift) >> 7, -1});
          ++row_head[r + 1];
          continue;
        }
        // Out/fill cell: per-byte transitive resolution.  Cheap gate:
        // both endpoints must resolve to rows <= 2 apart before paying
        // for the full per-byte chase (RLE doubling pieces and periodic
        // fills resolve to a literal-byte window; deep scattered chains
        // reject on the endpoints).
        const int32_t s_lo = ResolveToComp(lo);
        if (s_lo < 0) continue;
        const int32_t s_hi = ResolveToComp(hi - 1);
        if (s_hi < 0) continue;
        int32_t rlo = std::min(s_lo, s_hi) >> 7;
        int32_t rhi = std::max(s_lo, s_hi) >> 7;
        if (rhi - rlo > 2) continue;
        const int32_t base = static_cast<int32_t>(byte_src.size());
        byte_src.resize(base + (hi - lo));
        bool ok = true;
        // One-hop fast path: byte p chases p + cshift, which earlier
        // iterations (rows ascend, bytes ascend) have already memoized
        // in the common case — the generic ResolveToComp walk (FindIdx
        // + chain vector per byte) measured 15-25 ns/byte and dominated
        // plan build (3.2 ms per 128 KiB text block); the inlined memo
        // hop is ~3 ns.
        const int32_t cshift = CellShift(f, r);
        int32_t* bs = byte_src.data() + base;
        // Vector fast path: when the whole cell's one-hop window is in
        // range, the loop is a contiguous memo load + contiguous store +
        // running min (autovectorized; ~0.5 ns/byte vs ~3 for the
        // scalar hop).  Any negative (unresolved/-1) falls back to the
        // scalar walk below.  Reads complete before memo writes, so a
        // self-overlapping window (q range intersecting [lo, hi)) sees
        // kUnresolved and falls back — the scalar loop handles it.
        const int32_t qlo = lo + cshift;
        bool fast_done = false;
        if (qlo >= 0 && hi + cshift <= memo_size) {
          const int32_t* mm = resolve_memo_.data() + qlo;
          const int32_t n_cell = hi - lo;
          int32_t vneg = 0, vlo = INT32_MAX, vhi = INT32_MIN;
          for (int32_t k = 0; k < n_cell; ++k) {
            const int32_t s = mm[k];
            bs[k] = s;
            vneg |= s >> 31;           // any s < 0 (incl. kUnresolved)
            vlo = std::min(vlo, s);
            vhi = std::max(vhi, s);
          }
          if (vneg == 0) {
            rlo = std::min(rlo, vlo >> 7);
            rhi = std::max(rhi, vhi >> 7);
            if (rhi - rlo > 2) {
              ok = false;
            } else {
              std::memcpy(resolve_memo_.data() + lo, bs,
                          sizeof(int32_t) * n_cell);
            }
            fast_done = true;
          }
        }
        if (!fast_done && ok) {
        for (int32_t p = lo; p < hi; ++p) {
          const int32_t q = p + cshift;
          int32_t s = (q >= 0 && q < memo_size) ? resolve_memo_[q]
                                                : kUnresolved;
          if (s == kUnresolved) s = ResolveToComp(p);
          if (s < 0) { ok = false; break; }
          resolve_memo_[p] = s;
          rlo = std::min(rlo, s >> 7);
          rhi = std::max(rhi, s >> 7);
          if (rhi - rlo > 2) { ok = false; break; }
          bs[p - lo] = s;
        }
        }
        if (!ok) {
          byte_src.resize(base);
          continue;
        }
        cells.push_back({fi, lo, hi, rlo, rhi, base});
        ++row_head[r + 1];
      }
    }
    }
    if (cells.empty()) return;
    for (int r = 0; r < nrows; ++r) row_head[r + 1] += row_head[r];
    // cells were appended fragment-major = dst-major = row-major already,
    // so [row_head[r], row_head[r+1]) is exactly row r's slice.

    struct Win { int32_t a; int64_t cov; int32_t lo, hi; };  // cell range
    static thread_local std::vector<Win> wins;
    int ndense = 0;
    // Self-cleaning planes: Densify fully defines dq and the used
    // row_a planes for any block it marks dense (ndense > 0) — covered
    // bytes get their values, every OTHER byte of those planes is
    // zeroed below at row granularity.  Callers can therefore reuse
    // dirty buffers without a 0.5 MB/block pre-memset (first-touch
    // page faults on fresh buffers measured ~0.13 GB/s on this VM —
    // seconds per 1024-block unit, 10x the planner's own work).
    static thread_local std::vector<uint8_t> row_written;
    static thread_local std::vector<int8_t> row_nwins;
    row_written.assign(static_cast<size_t>(nrows), 0);
    row_nwins.assign(static_cast<size_t>(nrows), 0);
    ProfScope prof_write(7);
    for (int r = 0; r < nrows; ++r) {
      const int b0 = row_head[r], b1 = row_head[r + 1];
      if (b0 == b1) continue;
      // Sort the row's cells by source row (literals ascend with dst,
      // but re-sourced match reads scatter).
      std::sort(cells.begin() + b0, cells.begin() + b1,
                [](const Cell& x, const Cell& y) { return x.srlo < y.srlo; });
      // Greedy ascending cover: minimal #windows for 3-row windows.
      wins.clear();
      int i = b0;
      while (i < b1) {
        const int32_t a = cells[i].srlo;
        Win w{a, 0, i, i};
        while (i < b1 && cells[i].srhi <= a + 2) {
          w.cov += cells[i].hi - cells[i].lo;
          ++i;
        }
        w.hi = i;
        wins.push_back(w);
      }
      if (static_cast<int>(wins.size()) > kDenseMax) {
        // Keep the largest-coverage windows dense; the rest stay on the
        // classic schedule.
        std::partial_sort(wins.begin(), wins.begin() + kDenseMax,
                          wins.end(), [](const Win& x, const Win& y) {
                            return x.cov > y.cov;
                          });
        wins.resize(kDenseMax);
      }
      row_written[r] = 1;
      row_nwins[r] = static_cast<int8_t>(wins.size());
      // Zero this row's dq span once, then write covered bytes (cells
      // may not tile the row).
      std::memset(dq + static_cast<size_t>(r) * 128, 0,
                  128 * sizeof(int16_t));
      for (int j = 0; j < static_cast<int>(wins.size()); ++j) {
        const Win& w = wins[j];
        row_a[static_cast<size_t>(j) * nrows + r] = w.a;
        const int32_t wbase = w.a << 7;
        const int32_t tag = (j + 1) << 9;
        for (int ci = w.lo; ci < w.hi; ++ci) {
          const Cell& c = cells[ci];
          const Frag& f = frags_[c.frag];
          const int fr0 = f.dst / 128;
          cell_dense_[f.cell_base + (r - fr0)] = 1;
          if (c.src_base < 0) {
            // Slope-1 comp cell: dq is an arithmetic ramp (drow<<7|lane
            // == src - wbase for any src in the 3-row window).
            const int32_t v0 = tag + (c.lo + f.shift - wbase);
            for (int32_t p = c.lo; p < c.hi; ++p) {
              dq[p] = static_cast<int16_t>(v0 + (p - c.lo));
            }
          } else {
            const int32_t* bs = byte_src.data() + c.src_base;
            for (int32_t p = c.lo; p < c.hi; ++p) {
              dq[p] = static_cast<int16_t>(tag + (bs[p - c.lo] - wbase));
            }
          }
        }
      }
      ndense = std::max(ndense, static_cast<int>(wins.size()));
    }
    if (ndense > 0) {
      // Finish the planes: zero dq rows with no windows and the unused
      // anchor slots of used planes (the kernel ships whole planes).
      for (int r = 0; r < nrows; ++r) {
        if (!row_written[r]) {
          std::memset(dq + static_cast<size_t>(r) * 128, 0,
                      128 * sizeof(int16_t));
        }
        for (int j = row_nwins[r]; j < ndense; ++j) {
          row_a[static_cast<size_t>(j) * nrows + r] = 0;
        }
      }
    }
    *dense_out = ndense;
  }

  bool cell_is_dense(size_t idx) const {
    return !cell_dense_.empty() && cell_dense_[idx];
  }

  void AllocCells() {
    if (!cell_pass_.empty()) return;
    size_t total_cells = 0;
    for (Frag& f : frags_) {
      f.cell_base = static_cast<int32_t>(total_cells);
      total_cells += (f.dst + f.len - 1) / 128 - f.dst / 128 + 1;
    }
    cell_pass_.assign(total_cells, -1);
  }

 private:
  // Mark ``idx`` as the first fragment of every row [dst, dst+len)
  // touches that has no earlier fragment (append order = dst order).
  void IndexRows(int idx, int32_t dst, int32_t len) {
    const size_t r1 = static_cast<size_t>(dst + len - 1) >> 7;
    if (r1 >= row_idx_.size()) row_idx_.resize(r1 + 1, -1);
    for (size_t r = static_cast<size_t>(dst) >> 7; r <= r1; ++r) {
      if (row_idx_[r] < 0) row_idx_[r] = idx;
    }
  }

  std::vector<Frag> frags_;
  std::vector<int32_t> cell_pass_;
  std::vector<uint8_t> cell_dense_;
  std::vector<int32_t> resolve_memo_;   // per-byte ResolveToComp cache
  std::vector<int32_t> row_idx_;
};

}  // namespace

extern "C" {

// Builds the scheduled per-row pass plan for one block.
//
// Outputs (caller-allocated):
//   r_dstart, r_dend, r_shift — int32 [max_passes * nrows], pass-major
//   pass_space                — int32 [max_passes]; 0 comp-source,
//                               1 out-source (valid for passes < P)
//   p0_out                    — int32[1]: number of comp-source passes
//
// Returns P (total passes, <= max_passes), or BT_ERR_CAPACITY when the
// block exceeds the pass budget, or another negative status on error.
int bt_plan_rows(int nseq, const int32_t* lit_ptr, const int32_t* lit_len,
                 const int32_t* off, const int32_t* mlen,
                 const int32_t* out_pos, int out_len, int nrows,
                 int max_passes, int32_t* r_dstart, int32_t* r_dend,
                 int32_t* r_shift, int32_t* pass_space, int32_t* p0_out) {
  if (nseq < 0 || out_len < 0 || nrows <= 0 || max_passes <= 0) {
    return BT_ERR_INVALID;
  }
  // The schedule's row tables are sized nrows; a block claiming to decode
  // past nrows*128 would index comp_slots/used out of bounds.
  if (static_cast<int64_t>(out_len) > static_cast<int64_t>(nrows) * 128) {
    return BT_ERR_INVALID;
  }
  Planner planner;
  const int max_frags = nrows * max_passes + 64;
  if (!planner.Build(nseq, lit_ptr, lit_len, off, mlen, out_pos, max_frags)) {
    return BT_ERR_CAPACITY;
  }
  // Coverage check.
  int32_t covered = 0;
  for (const Frag& f : planner.frags()) {
    if (f.dst != covered) return BT_ERR_IO;
    covered += f.len;
  }
  if (covered != out_len) return BT_ERR_IO;

  int p0 = 0;
  const int total = planner.Schedule(nrows, max_passes, &p0);
  if (total < 0) return BT_ERR_CAPACITY;

  const size_t cells = static_cast<size_t>(max_passes) * nrows;
  std::memset(r_dstart, 0, sizeof(int32_t) * cells);
  std::memset(r_dend, 0, sizeof(int32_t) * cells);
  std::memset(r_shift, 0, sizeof(int32_t) * cells);
  for (int p = 0; p < max_passes; ++p) {
    pass_space[p] = (p < p0) ? 0 : 1;
  }
  *p0_out = p0;

  for (const Frag& f : planner.frags()) {
    const int r0 = f.dst / 128;
    const int r1 = (f.dst + f.len - 1) / 128;
    for (int r = r0; r <= r1 && r < nrows; ++r) {
      const int pass = planner.cell_pass()[f.cell_base + (r - r0)];
      const size_t cell = static_cast<size_t>(pass) * nrows + r;
      // Clip the fragment range to this row: the full range would be
      // re-asserted at a different pass in the neighboring rows, and the
      // kernel's active mask must not fire early there.
      r_dstart[cell] = std::max(f.dst, r * 128);
      r_dend[cell] = std::min(f.dst + f.len, (r + 1) * 128);
      r_shift[cell] = CellShift(f, r);
    }
  }
  return total;
}

// Convenience: parse an LZ4/Snappy block and plan it in one call.
int bt_plan_block(int codec, const uint8_t* src, int src_len, int out_len,
                  int nrows, int max_passes, int32_t* r_dstart,
                  int32_t* r_dend, int32_t* r_shift, int32_t* pass_space,
                  int32_t* p0_out) {
  const int max_seq = src_len + 2;
  std::vector<int32_t> t(static_cast<size_t>(max_seq) * 5);
  int32_t* lit_ptr = t.data();
  int32_t* lit_len = lit_ptr + max_seq;
  int32_t* offv = lit_len + max_seq;
  int32_t* mlenv = offv + max_seq;
  int32_t* out_posv = mlenv + max_seq;
  int nseq;
  if (codec == BT_CODEC_LZ4) {
    nseq = bt_lz4_parse(src, src_len, max_seq, lit_ptr, lit_len, offv, mlenv,
                        out_posv);
  } else if (codec == BT_CODEC_SNAPPY) {
    nseq = bt_snappy_parse(src, src_len, max_seq, lit_ptr, lit_len, offv,
                           mlenv, out_posv);
  } else {
    return BT_ERR_INVALID;
  }
  if (nseq < 0) return nseq;
  return bt_plan_rows(nseq, lit_ptr, lit_len, offv, mlenv, out_posv, out_len,
                      nrows, max_passes, r_dstart, r_dend, r_shift,
                      pass_space, p0_out);
}

void bt_set_split_limit(int v) { g_split_limit = v < 1 ? 1 : v; }

// Planner phase profile: copies the accumulated per-phase nanoseconds
// ([0]=parse [1]=build [2]=densify [3]=schedule [4]=emit-wire [5]=pack,
// summed over worker threads) into `out_ns[6]`, resetting when
// reset != 0.
void bt_plan_prof_get(int64_t* out_ns, int reset) {
  for (int i = 0; i < 8; ++i) {
    out_ns[i] = g_prof[i].load(std::memory_order_relaxed);
    if (reset != 0) g_prof[i].store(0, std::memory_order_relaxed);
  }
}

}  // extern "C"

namespace {

// Plan ONE block straight into the flat kernel wire (se int16 packed
// start<<8|end + plane-local shift), skipping the dense r_dstart/r_dend
// intermediate of bt_plan_rows.  Comp passes land in [0, p0_pad), out
// passes in [p0_pad, total_pad), both padded to `cb` multiples with empty
// (zero) passes so the kernel's batched phase loops stay branch-free.
// The plan lands in se_v/shift_v, sized to exactly total_pad * nrows
// cells — memory scales with the ACTUAL plan, not the pass budget
// (a dense [max_passes, nrows] scratch per block measured 10x the
// planner's own time in page faults alone at 256-block batches).
// Returns BT_OK and fills p_used/p0 (padded counts), or a negative code
// (BT_ERR_CAPACITY -> caller falls back to the sequence-walk kernel).
int PlanOneFlat(int codec, const uint8_t* src, int src_len, int out_len,
                int nrows, int max_passes, int split_limit, int cb,
                int band_rows, int band_tile, std::vector<int16_t>* se_v,
                std::vector<int32_t>* shift_v, int32_t* p_used_out,
                int32_t* p0_out, uint8_t* lit_out, int lit_cap,
                int32_t* lit_used_out, int16_t* dq, int32_t* row_a,
                int32_t* dense_out) {
  if (out_len < 0 || static_cast<int64_t>(out_len) > static_cast<int64_t>(nrows) * 128) {
    return BT_ERR_INVALID;
  }
  if (band_tile <= 0) band_tile = Planner::kTileRows;
  const auto pad = [cb](int v) { return (v + cb - 1) / cb * cb; };

  if (codec == BT_CODEC_RAW) {
    // Identity copy: the kernel's identity-dense mode (dense = -1)
    // copies the comp plane straight to the output — no per-byte wire,
    // no anchor planes, no scheduled passes (the per-block wire would
    // be 2x the payload for a block that needs none).
    *dense_out = -1;
    se_v->clear();
    shift_v->clear();
    *p_used_out = 0;
    *p0_out = 0;
    return BT_OK;
  }
  if (codec != BT_CODEC_LZ4 && codec != BT_CODEC_SNAPPY &&
      codec != BT_CODEC_ZSTD) {
    return BT_ERR_NOT_IMPLEMENTED;
  }

  // Parse into thread-local reusable sequence tables.
  static thread_local std::vector<int32_t> seq_buf;
  const int max_seq = std::max(src_len, out_len) + 2;
  if (static_cast<int>(seq_buf.size()) < max_seq * 5) {
    seq_buf.resize(static_cast<size_t>(max_seq) * 5);
  }
  int32_t* lit_ptr = seq_buf.data();
  int32_t* lit_len = lit_ptr + max_seq;
  int32_t* offv = lit_len + max_seq;
  int32_t* mlenv = offv + max_seq;
  int32_t* out_posv = mlenv + max_seq;
  int nseq;
  {
  ProfScope prof_parse(0);
  if (codec == BT_CODEC_ZSTD) {
    // Entropy-decode literals to the caller's plane; the sequence table
    // references THAT plane ("comp space" = decoded literals), so zstd
    // sequence execution rides the same device kernel as LZ4/Snappy.
    if (lit_out == nullptr) return BT_ERR_NOT_IMPLEMENTED;
    nseq = bt_zstd_parse(src, src_len, max_seq, lit_out, lit_cap,
                         lit_used_out, lit_ptr, lit_len, offv, mlenv,
                         out_posv);
  } else {
    nseq = codec == BT_CODEC_LZ4
               ? bt_lz4_parse(src, src_len, max_seq, lit_ptr, lit_len, offv,
                              mlenv, out_posv)
               : bt_snappy_parse(src, src_len, max_seq, lit_ptr, lit_len,
                                 offv, mlenv, out_posv);
  }
  }
  if (nseq < 0) return nseq;

  // Leave pass head-room for the cb padding of both phases.
  const int budget = max_passes - 2 * (cb - 1);
  if (budget <= 0) return BT_ERR_INVALID;

  const int saved_split = g_split_limit;
  g_split_limit = split_limit < 1 ? 1 : split_limit;
  Planner planner;
  const int max_frags = nrows * budget + 64;
  bool built;
  {
    ProfScope prof_build(1);
    built = planner.Build(nseq, lit_ptr, lit_len, offv, mlenv, out_posv,
                          max_frags);
  }
  g_split_limit = saved_split;
  if (!built) return BT_ERR_CAPACITY;

  int32_t covered = 0;
  for (const Frag& f : planner.frags()) {
    if (f.dst != covered) return BT_ERR_IO;
    covered += f.len;
  }
  if (covered != out_len) return BT_ERR_IO;

  {
    ProfScope prof_densify(2);
    planner.Densify(nrows, dq, row_a, dense_out);
  }

  int p0 = 0;
  int total;
  {
    ProfScope prof_schedule(3);
    total = planner.Schedule(nrows, budget, &p0, band_rows, band_tile);
  }
  if (total < 0) return BT_ERR_CAPACITY;

  const int p0_pad = pad(p0);
  const int total_pad = p0_pad + pad(total - p0);
  if (total_pad > max_passes) return BT_ERR_CAPACITY;
  ProfScope prof_emit(4);
  se_v->assign(static_cast<size_t>(total_pad) * nrows, 0);
  shift_v->assign(static_cast<size_t>(total_pad) * nrows, 0);
  int16_t* se = se_v->data();
  int32_t* shift = shift_v->data();

  for (const Frag& f : planner.frags()) {
    const int r0 = f.dst / 128;
    const int r1 = (f.dst + f.len - 1) / 128;
    for (int r = r0; r <= r1 && r < nrows; ++r) {
      if (planner.cell_is_dense(f.cell_base + (r - r0))) continue;
      int pass = planner.cell_pass()[f.cell_base + (r - r0)];
      if (f.out_space) pass = p0_pad + (pass - p0);
      const size_t cell = static_cast<size_t>(pass) * nrows + r;
      const int start = std::max(f.dst - r * 128, 0);
      const int end = std::min(f.dst + f.len - r * 128, 128);
      se[cell] = static_cast<int16_t>((start << 8) | end);
      shift[cell] = CellShift(f, r);
    }
  }
  *p_used_out = total_pad;
  *p0_out = p0_pad;
  return BT_OK;
}

// Per-batch plan context: block i's compact plan rows (exactly
// p_used[i] * nrows cells each) between the plan and pack phases.
struct BtPlanCtx {
  int nrows = 0;
  std::vector<std::vector<int16_t>> se;
  std::vector<std::vector<int32_t>> shift;
};

void RunWorkers(int nthreads, int nblocks, const std::function<void(int)>& fn) {
  if (nthreads < 1) nthreads = 1;
  const unsigned hw = std::thread::hardware_concurrency();
  if (hw > 0 && nthreads > static_cast<int>(hw)) nthreads = static_cast<int>(hw);
  if (nthreads > nblocks) nthreads = nblocks;
  std::atomic<int> next{0};
  auto worker = [&]() {
    for (;;) {
      const int i = next.fetch_add(1, std::memory_order_relaxed);
      if (i >= nblocks) return;
      fn(i);
    }
  };
  if (nthreads == 1) {
    worker();
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(static_cast<size_t>(nthreads));
  for (int t = 0; t < nthreads; ++t) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// Phase 1 of the batched flat-wire planner: parse + fragment build +
// schedule every block in parallel, holding each block's plan rows in a
// compact per-block buffer (exactly p_used[i] passes — memory scales
// with the real plan, not nblocks x max_passes).  p_used[i]/p0[i]
// receive the cb-padded pass counts and status[i] the per-block outcome
// (BT_ERR_CAPACITY = unplannable, fall back; other negatives =
// malformed input).  Blocks whose first attempt at `split_limit`
// exceeds the budget retry once at limit 2 (deep-chain data plans
// smaller with less comp-space resolution).  Returns an opaque context
// for bt_plan_batch_pack / bt_plan_batch_abort (never NULL for
// nblocks > 0; NULL for nblocks <= 0).
// dq / row_a / dense are the dense-pass planes (see Planner::Densify):
// dq int16 [nblocks][nrows*128], row_a int32 [nblocks][64][nrows]
// (pass-major anchor planes, kDenseMax+1 = 64 per block; only the first
// `dense[i]` are meaningful), dense int32 [nblocks] = number of dense
// passes (0..63), or -1 for identity (RAW) blocks.
void* bt_plan_batch_begin(int codec, const int32_t* codec_ids, int nthreads,
                          int nblocks, const uint8_t* src,
                          const int64_t* src_off, const int32_t* src_len,
                          const int32_t* out_len, int nrows, int max_passes,
                          int split_limit, int cb, int band_rows,
                          int band_tile, int32_t* p_used, int32_t* p0,
                          int32_t* status, uint8_t* lit_out,
                          int64_t lit_stride, int32_t* lit_used,
                          int16_t* dq, int32_t* row_a, int32_t* dense) {
  if (nblocks <= 0) return nullptr;
  auto ctx = std::make_unique<BtPlanCtx>();
  ctx->nrows = nrows;
  ctx->se.resize(static_cast<size_t>(nblocks));
  ctx->shift.resize(static_cast<size_t>(nblocks));
  BtPlanCtx* c_ = ctx.get();

  RunWorkers(nthreads, nblocks, [&, c_](int i) {
    const int c = codec_ids != nullptr ? codec_ids[i] : codec;
    uint8_t* lit_i =
        lit_out != nullptr ? lit_out + static_cast<int64_t>(i) * lit_stride
                           : nullptr;
    const int lit_cap_i = lit_out != nullptr ? static_cast<int>(lit_stride) : 0;
    if (lit_used != nullptr) lit_used[i] = 0;
    int32_t* lit_used_i = lit_used != nullptr ? lit_used + i : nullptr;
    int32_t lit_scratch = 0;
    if (lit_used_i == nullptr) lit_used_i = &lit_scratch;
    int16_t* dq_i = dq + static_cast<size_t>(i) * nrows * 128;
    int32_t* row_a_i =
        row_a + static_cast<size_t>(i) * (Planner::kDenseMax + 1) * nrows;
    int rc = PlanOneFlat(c, src + src_off[i], src_len[i], out_len[i], nrows,
                         max_passes, split_limit, cb, band_rows, band_tile,
                         &c_->se[i], &c_->shift[i], p_used + i, p0 + i, lit_i,
                         lit_cap_i, lit_used_i, dq_i, row_a_i, dense + i);
    if (rc == BT_ERR_CAPACITY && split_limit != 2) {
      rc = PlanOneFlat(c, src + src_off[i], src_len[i], out_len[i], nrows,
                       max_passes, /*split_limit=*/2, cb, band_rows, band_tile,
                       &c_->se[i], &c_->shift[i], p_used + i, p0 + i, lit_i,
                       lit_cap_i, lit_used_i, dq_i, row_a_i, dense + i);
    }
    status[i] = rc;
    if (rc != BT_OK) {
      p_used[i] = 0;
      p0[i] = 0;
      dense[i] = 0;
      c_->se[i].clear();
      c_->shift[i].clear();
    }
  });
  return ctx.release();
}

// Phase 2: copy block i's plan rows to pass-row offset p_off[i] of the
// caller's flat wire (se int16 / shift int32, each pass row = nrows
// cells), then free the context.  p_off entries must leave room for
// each block's p_used rows; failed blocks (empty plans) copy nothing.
void bt_plan_batch_pack(void* ctx_ptr, int nthreads, const int64_t* p_off,
                        int16_t* se, int32_t* shift) {
  std::unique_ptr<BtPlanCtx> ctx(static_cast<BtPlanCtx*>(ctx_ptr));
  if (!ctx) return;
  const int nblocks = static_cast<int>(ctx->se.size());
  const int nrows = ctx->nrows;
  BtPlanCtx* c_ = ctx.get();
  RunWorkers(nthreads, nblocks, [&, c_](int i) {
    ProfScope prof_pack(5);
    const std::vector<int16_t>& se_i = c_->se[i];
    if (se_i.empty()) return;
    const size_t base = static_cast<size_t>(p_off[i]) * nrows;
    std::memcpy(se + base, se_i.data(), se_i.size() * sizeof(int16_t));
    std::memcpy(shift + base, c_->shift[i].data(),
                c_->shift[i].size() * sizeof(int32_t));
  });
}

// Free a context without packing (e.g. the caller re-plans unbanded).
void bt_plan_batch_abort(void* ctx_ptr) {
  delete static_cast<BtPlanCtx*>(ctx_ptr);
}

// Compact the dense planes of selected blocks (threaded memcpy): block
// sel[j] contributes dq row j (nrows*128 int16) and its first dcap
// anchor planes RE-LAID to the kernel's [dcap, 128, tiles] column
// layout (the single other writer is pack_row_a_planes — keep them
// byte-identical).  Replaces ~500 MB of numpy fancy-index + concat +
// transpose copies per 1024-block unit (measured ~1.9 s of Python in
// ensure_plans vs ~0.05 s here).
void bt_plan_dense_pack(int nthreads, int nsel, const int64_t* sel,
                        const int16_t* dq_src, int16_t* dq_dst,
                        const int32_t* ra_src, int32_t* ra_dst, int nrows,
                        int src_planes, int dcap, const int32_t* ndense) {
  const size_t dq_row = static_cast<size_t>(nrows) * 128;
  const int tiles = nrows / 128;
  RunWorkers(nthreads, nsel, [&](int j) {
    const int64_t i = sel[j];
    std::memcpy(dq_dst + static_cast<size_t>(j) * dq_row,
                dq_src + static_cast<size_t>(i) * dq_row,
                dq_row * sizeof(int16_t));
    // Only the block's OWN dense planes carry data (the kernel reads
    // planes [0, dense[i]) for block i); packing all dcap planes for
    // every block measured 3x the real copy on mixed corpora (dcap is
    // the unit-wide pow-2 max; an RLE block needs 1 plane).
    int ncopy = dcap < src_planes ? dcap : src_planes;
    if (ndense != nullptr && ndense[i] < ncopy) ncopy = ndense[i];
    for (int p = 0; p < ncopy; ++p) {
      const int32_t* src = ra_src +
          (static_cast<size_t>(i) * src_planes + p) * nrows;
      int32_t* dst = ra_dst +
          (static_cast<size_t>(j) * dcap + p) * static_cast<size_t>(nrows);
      // [nrows] row-major -> [128, tiles] column layout:
      // dst[lane * tiles + t] = src[t * 128 + lane].
      for (int t = 0; t < tiles; ++t) {
        const int32_t* s_row = src + static_cast<size_t>(t) * 128;
        for (int lane = 0; lane < 128; ++lane) {
          dst[static_cast<size_t>(lane) * tiles + t] = s_row[lane];
        }
      }
    }
    for (int p = ncopy; p < dcap; ++p) {
      std::memset(ra_dst + (static_cast<size_t>(j) * dcap + p) * nrows, 0,
                  sizeof(int32_t) * nrows);
    }
  });
}

// Compat wrapper: batched parse+plan+pack with block i's plan rows at
// the dense offset i*max_passes in se/shift (each row nrows cells).
void bt_plan_batch(int codec, const int32_t* codec_ids, int nthreads,
                   int nblocks, const uint8_t* src, const int64_t* src_off,
                   const int32_t* src_len, const int32_t* out_len, int nrows,
                   int max_passes, int split_limit, int cb, int band_rows,
                   int band_tile, int16_t* se, int32_t* shift,
                   int32_t* p_used, int32_t* p0, int32_t* status,
                   uint8_t* lit_out, int64_t lit_stride, int32_t* lit_used,
                   int16_t* dq, int32_t* row_a, int32_t* dense) {
  if (nblocks <= 0) return;
  void* ctx = bt_plan_batch_begin(
      codec, codec_ids, nthreads, nblocks, src, src_off, src_len, out_len,
      nrows, max_passes, split_limit, cb, band_rows, band_tile, p_used, p0,
      status, lit_out, lit_stride, lit_used, dq, row_a, dense);
  std::vector<int64_t> p_off(static_cast<size_t>(nblocks));
  for (int i = 0; i < nblocks; ++i) {
    p_off[i] = static_cast<int64_t>(i) * max_passes;
  }
  bt_plan_batch_pack(ctx, nthreads, p_off.data(), se, shift);
}

// Debug/analysis export: parse + Build one block and dump the fragment
// list (dst, len, shift, space, aux) into caller arrays of capacity
// `cap`.  Returns the fragment count (may exceed cap; only cap rows are
// written) or a negative status.  Lets offline tooling prototype
// scheduler changes without re-exposing planner internals.
int bt_plan_frags(int codec, const uint8_t* src, int src_len, int out_len,
                  int split_limit, int cap, int32_t* dst, int32_t* len,
                  int32_t* shift, int32_t* space, int32_t* aux) {
  if (codec != BT_CODEC_LZ4 && codec != BT_CODEC_SNAPPY) {
    return BT_ERR_NOT_IMPLEMENTED;  // zstd/raw have no frag-export path
  }
  static thread_local std::vector<int32_t> seq_buf;
  const int max_seq = std::max(src_len, out_len) + 2;
  if (static_cast<int>(seq_buf.size()) < max_seq * 5) {
    seq_buf.resize(static_cast<size_t>(max_seq) * 5);
  }
  int32_t* lit_ptr = seq_buf.data();
  int32_t* lit_len = lit_ptr + max_seq;
  int32_t* offv = lit_len + max_seq;
  int32_t* mlenv = offv + max_seq;
  int32_t* out_posv = mlenv + max_seq;
  const int nseq =
      codec == BT_CODEC_LZ4
          ? bt_lz4_parse(src, src_len, max_seq, lit_ptr, lit_len, offv,
                         mlenv, out_posv)
          : bt_snappy_parse(src, src_len, max_seq, lit_ptr, lit_len, offv,
                            mlenv, out_posv);
  if (nseq < 0) return nseq;
  const int saved_split = g_split_limit;
  g_split_limit = split_limit < 1 ? 1 : split_limit;
  Planner planner;
  const bool built = planner.Build(nseq, lit_ptr, lit_len, offv, mlenv,
                                   out_posv, out_len + 64);
  g_split_limit = saved_split;
  if (!built) return BT_ERR_CAPACITY;
  const int n = static_cast<int>(planner.frags().size());
  for (int i = 0; i < n && i < cap; ++i) {
    const Frag& f = planner.frags()[i];
    dst[i] = f.dst;
    len[i] = f.len;
    shift[i] = f.shift;
    space[i] = f.out_space;
    aux[i] = f.aux;
  }
  return n;
}

}  // extern "C"
