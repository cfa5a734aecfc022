// Batched multithreaded block codec dispatch.
//
// Host analog of the reference's burst fan-out: N independent blocks worked
// by a pool of threads, one atomic work queue (the reference pins one queue
// pair per lcore instead, src/driver.cc:100-158 + src/include/util.h:209-236).

#include "bitar_host.h"

#include <atomic>
#include <cstring>
#include <thread>
#include <vector>

namespace {


int RawCopy(const uint8_t* src, int n, uint8_t* dst, int cap) {
  if (n > cap) return BT_ERR_CAPACITY;
  std::memcpy(dst, src, static_cast<size_t>(n));
  return n;
}

int DispatchOne(int codec, bool compress, const uint8_t* src, int src_len,
                uint8_t* dst, int dst_cap, int min_match) {
  switch (codec) {
    case BT_CODEC_LZ4:
      return compress ? bt_lz4_compress_mm(src, src_len, dst, dst_cap,
                                           min_match)
                      : bt_lz4_decompress(src, src_len, dst, dst_cap);
    case BT_CODEC_SNAPPY:
      return compress ? bt_snappy_compress_mm(src, src_len, dst, dst_cap,
                                              min_match)
                      : bt_snappy_decompress(src, src_len, dst, dst_cap);
    case BT_CODEC_RAW:
      return RawCopy(src, src_len, dst, dst_cap);
    case BT_CODEC_ZSTD:
      // Both directions native from-scratch (RFC 8878, zstd.cc).
      return compress ? bt_zstd_compress(src, src_len, dst, dst_cap)
                      : bt_zstd_decompress(src, src_len, dst, dst_cap);
    default:
      return BT_ERR_INVALID;
  }
}

void RunBatch(bool compress, int codec, const int32_t* codec_ids, int nthreads,
              int nblocks, const uint8_t* src, const int64_t* src_off,
              const int32_t* src_len, uint8_t* dst, const int64_t* dst_off,
              int32_t* dst_len, int32_t* status, int min_match = 4) {
  if (nblocks <= 0) return;
  if (nthreads < 1) nthreads = 1;
  const unsigned hw = std::thread::hardware_concurrency();
  if (hw > 0 && nthreads > static_cast<int>(hw)) nthreads = static_cast<int>(hw);
  if (nthreads > nblocks) nthreads = nblocks;

  std::atomic<int> next{0};
  auto worker = [&]() {
    for (;;) {
      const int i = next.fetch_add(1, std::memory_order_relaxed);
      if (i >= nblocks) return;
      const int c = codec_ids != nullptr ? codec_ids[i] : codec;
      const int rc = DispatchOne(c, compress, src + src_off[i], src_len[i],
                                 dst + dst_off[i], dst_len[i], min_match);
      if (rc < 0) {
        status[i] = rc;
        dst_len[i] = 0;
      } else {
        status[i] = BT_OK;
        dst_len[i] = rc;
      }
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

// min_match: smallest match length the LZ4/Snappy encoders emit (see
// bt_lz4_compress_mm); other codecs ignore it.
extern "C" void bt_batch_compress(int codec, const int32_t* codec_ids,
                                  int nthreads, int nblocks, const uint8_t* src,
                                  const int64_t* src_off, const int32_t* src_len,
                                  uint8_t* dst, const int64_t* dst_off,
                                  int32_t* dst_len, int32_t* status,
                                  int min_match) {
  RunBatch(true, codec, codec_ids, nthreads, nblocks, src, src_off, src_len,
           dst, dst_off, dst_len, status, min_match < 4 ? 4 : min_match);
}

extern "C" void bt_batch_decompress(int codec, const int32_t* codec_ids,
                                    int nthreads, int nblocks,
                                    const uint8_t* src, const int64_t* src_off,
                                    const int32_t* src_len, uint8_t* dst,
                                    const int64_t* dst_off, int32_t* dst_len,
                                    int32_t* status) {
  RunBatch(false, codec, codec_ids, nthreads, nblocks, src, src_off, src_len,
           dst, dst_off, dst_len, status);
}

extern "C" int bt_abi_version(void) { return 6; }
