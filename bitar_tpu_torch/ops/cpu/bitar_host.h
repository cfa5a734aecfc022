/* C ABI of the bitar-tpu native host codec library.
 *
 * TPU-native framework's host-side runtime: reference CPU codecs used as
 * (a) the bit-exactness oracle for the Pallas kernels, (b) the
 * multithreaded host ingest/verify path, and (c) the sequence-table
 * extractor feeding the TPU decode kernels.
 *
 * Error convention matches bitar_tpu.status: >= 0 on success (byte count),
 * negative arrow-style StatusCode on failure (reference encodes the same
 * way in src/include/util.h:157-175).
 */
#ifndef BITAR_HOST_H_
#define BITAR_HOST_H_

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* StatusCode bridge values (negated on return). */
enum {
  BT_OK = 0,
  BT_ERR_OOM = -1,
  BT_ERR_INVALID = -4,
  BT_ERR_IO = -5,
  BT_ERR_CAPACITY = -6,
  BT_ERR_INDEX = -7,
  BT_ERR_NOT_IMPLEMENTED = -10,
};

/* Codec ids shared with bitar_tpu.manifest. */
enum { BT_CODEC_LZ4 = 0, BT_CODEC_SNAPPY = 1, BT_CODEC_ZSTD = 2, BT_CODEC_RAW = 3 };

/* ---- LZ4 block format (no frame) ---------------------------------- */

/* Greedy LZ4 block compress; returns compressed length or negative code. */
int bt_lz4_compress(const uint8_t* src, int src_len, uint8_t* dst, int dst_cap);

/* As bt_lz4_compress with a minimum emitted match length (>= 4).  Larger
 * values keep marginal matches as literals: the stream stays LZ4
 * wire-compatible and barely grows, while the device decoder's pass
 * schedule shrinks dramatically on barely-compressible data (each tiny
 * match costs a scheduled pass on its output row; see plan.cc). */
int bt_lz4_compress_mm(const uint8_t* src, int src_len, uint8_t* dst,
                       int dst_cap, int min_match);

/* LZ4 block decompress; returns decompressed length or negative code. */
int bt_lz4_decompress(const uint8_t* src, int src_len, uint8_t* dst, int dst_cap);

/* Greedy LZ4 emission from accelerator match hints: mlen/off_idx are
 * per-position arrays (src_len entries) from the TPU match kernel;
 * off_idx indexes into `offsets`, or, when offsets == NULL (direct
 * mode, arbitrary-offset matchers), off_idx[i] IS the offset itself.
 * Hints are verified and extended before emission.  Returns compressed
 * length or negative code. */
int bt_lz4_emit_sequences(const uint8_t* src, int src_len,
                          const int32_t* mlen, const int32_t* off_idx,
                          const int32_t* offsets, int noffsets, uint8_t* dst,
                          int dst_cap);

/* Snappy twin of bt_lz4_emit_sequences: same codec-agnostic hint arrays,
 * emits a standard Snappy stream (varint preamble + literal/copy tags). */
int bt_snappy_emit_sequences(const uint8_t* src, int src_len,
                             const int32_t* mlen, const int32_t* off_idx,
                             const int32_t* offsets, int noffsets,
                             uint8_t* dst, int dst_cap);

/* Parse an LZ4 block into a sequence table (SoA). For sequence s:
 *   lit_ptr[s]  byte offset in src of the first literal byte
 *   lit_len[s]  number of literal bytes
 *   off[s]      match offset (0 for the final literals-only sequence)
 *   mlen[s]     match length (0 for the final sequence)
 *   out_pos[s]  output position where the literals of s land
 * Returns the number of sequences, or negative code (BT_ERR_CAPACITY if
 * more than max_seq sequences). */
int bt_lz4_parse(const uint8_t* src, int src_len, int max_seq,
                 int32_t* lit_ptr, int32_t* lit_len, int32_t* off,
                 int32_t* mlen, int32_t* out_pos);

/* ---- Snappy raw format -------------------------------------------- */

int bt_snappy_compress(const uint8_t* src, int src_len, uint8_t* dst, int dst_cap);

/* As bt_snappy_compress with a minimum emitted match length (>= 4; see
 * bt_lz4_compress_mm for the decode-cost rationale). */
int bt_snappy_compress_mm(const uint8_t* src, int src_len, uint8_t* dst,
                          int dst_cap, int min_match);

/* Minimum emitted match length for the hint-driven emitters
 * (bt_*_emit_sequences); thread-local, clamped to >= 4.  The
 * batch/direct compressors take it as an explicit parameter instead. */
void bt_set_emit_min_match(int v);
#ifdef __cplusplus
extern thread_local int bt_emit_min_match;
#endif

int bt_snappy_decompress(const uint8_t* src, int src_len, uint8_t* dst, int dst_cap);
/* Decoded length from the preamble varint, or negative code. */
int bt_snappy_uncompressed_len(const uint8_t* src, int src_len);

/* Parse a Snappy body into the same SoA sequence-table shape as LZ4
 * (literal run + optional copy per row). */
int bt_snappy_parse(const uint8_t* src, int src_len, int max_seq,
                    int32_t* lit_ptr, int32_t* lit_len, int32_t* off,
                    int32_t* mlen, int32_t* out_pos);

/* ---- Zstandard (RFC 8878), from-scratch codec (zstd.cc) ------------ */

/* Compress into a standard single-segment zstd frame (greedy LZ matching,
 * raw literals, predefined-FSE sequence coding, per-block raw fallback).
 * Returns compressed length or negative code. */
int bt_zstd_compress(const uint8_t* src, int src_len, uint8_t* dst,
                     int dst_cap);

/* Decode a standard zstd frame; returns decompressed length or negative
 * code.  Dictionaries unsupported; frame checksums skipped (the engine's
 * manifest checksums cover content integrity). */
int bt_zstd_decompress(const uint8_t* src, int src_len, uint8_t* dst,
                       int dst_cap);

/* Parse a zstd frame into the SoA sequence-table shape.  Literals are
 * entropy-decoded into lit_buf (lit_ptr indexes THAT buffer, not src) —
 * the sidecar that lets zstd sequence execution ride the TPU kernel.
 * Returns nseq or negative code; *lit_used receives the literal count. */
int bt_zstd_parse(const uint8_t* src, int src_len, int max_seq,
                  uint8_t* lit_buf, int lit_cap, int32_t* lit_used,
                  int32_t* lit_ptr, int32_t* lit_len, int32_t* off,
                  int32_t* mlen, int32_t* out_pos);

/* ---- Batched, multithreaded block APIs ----------------------------- *
 * The host analog of the reference's burst enqueue across worker lcores
 * (src/device.cc:465-535 + util.h:209-236): nblocks independent blocks,
 * dispatched over nthreads worker threads.
 *
 * dst_len[i] carries the per-block destination capacity on input and the
 * produced length on output.  status[i] receives 0 or a negative code.
 * codec may be BT_CODEC_LZ4 / BT_CODEC_SNAPPY / BT_CODEC_RAW; per-block
 * codec override via codec_ids (may be NULL -> use `codec` for all).
 */
/* min_match: smallest match length the LZ4/Snappy encoders emit
 * (clamped to >= 4; other codecs ignore it — see bt_lz4_compress_mm). */
void bt_batch_compress(int codec, const int32_t* codec_ids, int nthreads,
                       int nblocks, const uint8_t* src, const int64_t* src_off,
                       const int32_t* src_len, uint8_t* dst,
                       const int64_t* dst_off, int32_t* dst_len,
                       int32_t* status, int min_match);

void bt_batch_decompress(int codec, const int32_t* codec_ids, int nthreads,
                         int nblocks, const uint8_t* src, const int64_t* src_off,
                         const int32_t* src_len, uint8_t* dst,
                         const int64_t* dst_off, int32_t* dst_len,
                         int32_t* status);

/* ---- Decode plans (slope-1 fragment candidate tables) -------------- *
 * See plan.cc: host PLAN stage of the TPU plan-execute decoder.        */

int bt_plan_rows(int nseq, const int32_t* lit_ptr, const int32_t* lit_len,
                 const int32_t* off, const int32_t* mlen,
                 const int32_t* out_pos, int out_len, int nrows,
                 int max_passes, int32_t* r_dstart, int32_t* r_dend,
                 int32_t* r_shift, int32_t* pass_space, int32_t* p0_out);

int bt_plan_block(int codec, const uint8_t* src, int src_len, int out_len,
                  int nrows, int max_passes, int32_t* r_dstart,
                  int32_t* r_dend, int32_t* r_shift, int32_t* pass_space,
                  int32_t* p0_out);

/* Batched, multithreaded parse+plan+pack into the flat decode-kernel
 * wire (see ops/pallas/lz4_decode_flat.py).  Block i's plan rows land at
 * offset i*max_passes in se (int16, packed start<<8|end per (pass, row)
 * cell) and shift (int32, plane-local source shifts); p_used/p0 receive
 * cb-padded pass counts; dq / row_a may be DIRTY: for every block
 * reported dense > 0 the planner fully defines its dq plane and the
 * first `dense` anchor planes (other blocks' planes are unspecified
 * and must not be shipped); status[i] = BT_OK or negative
 * (BT_ERR_CAPACITY
 * = unplannable, use the fallback kernel).  band_rows > 0 constrains
 * every (pass, band_tile-row tile)'s source rows to one band_rows-row
 * window (8-aligned base) so the device kernel can gather with a single
 * static-K matmul per pass; band_rows = 0 means unconstrained and
 * band_tile <= 0 defaults to 1024 (the kernel's default M-tile). */
/* dq/row_a/dense: dense comp-pass planes (per-byte wire, see plan.cc
 * Planner::Densify) — dq int16 [nblocks][nrows*128] packs
 * (pass+1)<<9 | drow<<7 | src_lane per output byte (pass+1 in 6 bits,
 * 0 = byte not dense), row_a int32 [nblocks][64][nrows] pass-major
 * per-row anchor source rows (byte source row = row_a + drow,
 * drow <= 2), dense int32 [nblocks] = number of dense passes (0..63),
 * or -1 for the identity-dense mode (RAW blocks: the device copies the
 * comp plane verbatim; dq/row_a are not written for those blocks).
 * Comp cells covered by a row's <=63 greedy 3-row windows leave the
 * pass schedule; the device executes each window set in one anchored
 * gather per dense pass. */
void bt_plan_batch(int codec, const int32_t* codec_ids, int nthreads,
                   int nblocks, const uint8_t* src, const int64_t* src_off,
                   const int32_t* src_len, const int32_t* out_len, int nrows,
                   int max_passes, int split_limit, int cb, int band_rows,
                   int band_tile, int16_t* se, int32_t* shift,
                   int32_t* p_used, int32_t* p0, int32_t* status,
                   uint8_t* lit_out, int64_t lit_stride, int32_t* lit_used,
                   int16_t* dq, int32_t* row_a, int32_t* dense);

/* Two-phase variant: plan with compact per-block buffers (memory scales
 * with the actual plan, not nblocks*max_passes), then pack each block's
 * p_used[i] pass rows at pass-row offset p_off[i] of the caller's flat
 * wire once the offsets (cumsum of p_used) are known.  _pack frees the
 * context; _abort frees it without packing. */
void* bt_plan_batch_begin(int codec, const int32_t* codec_ids, int nthreads,
                          int nblocks, const uint8_t* src,
                          const int64_t* src_off, const int32_t* src_len,
                          const int32_t* out_len, int nrows, int max_passes,
                          int split_limit, int cb, int band_rows,
                          int band_tile, int32_t* p_used, int32_t* p0,
                          int32_t* status, uint8_t* lit_out,
                          int64_t lit_stride, int32_t* lit_used,
                          int16_t* dq, int32_t* row_a, int32_t* dense);
void bt_plan_batch_pack(void* ctx, int nthreads, const int64_t* p_off,
                        int16_t* se, int32_t* shift);
void bt_plan_batch_abort(void* ctx);

/* Compact + re-lay the dense planes of nsel selected blocks (threaded):
 * dq_dst[j] = dq_src[sel[j]] (nrows*128 int16 rows); ra_dst[j] = first
 * min(dcap, src_planes, ndense[sel[j]]) anchor planes of block sel[j]
 * transposed to the kernel's [dcap, 128, nrows/128] column layout,
 * zero-padded to dcap (ndense == NULL copies min(dcap, src_planes)). */
void bt_plan_dense_pack(int nthreads, int nsel, const int64_t* sel,
                        const int16_t* dq_src, int16_t* dq_dst,
                        const int32_t* ra_src, int32_t* ra_dst, int nrows,
                        int src_planes, int dcap, const int32_t* ndense);

/* Debug/analysis: parse + fragment-build one block, dumping up to `cap`
 * fragments (dst, len, shift, space, aux).  Returns the true fragment
 * count or a negative status.  For offline scheduler prototyping. */
int bt_plan_frags(int codec, const uint8_t* src, int src_len, int out_len,
                  int split_limit, int cap, int32_t* dst, int32_t* len,
                  int32_t* shift, int32_t* space, int32_t* aux);

/* Tune the planner's comp-resolution split limit (default 2). */
void bt_set_split_limit(int v);

/* Planner phase profile: out_ns[6] <- accumulated nanoseconds per phase
 * ([0]=parse [1]=build [2]=densify [3]=schedule [4]=emit-wire [5]=pack,
 * summed across worker threads); reset != 0 zeroes the accumulators. */
void bt_plan_prof_get(int64_t* out_ns, int reset);

/* Library version for the ctypes loader to sanity-check. */
int bt_abi_version(void);

#ifdef __cplusplus
}
#endif

#endif /* BITAR_HOST_H_ */
