// zoo_native — host-side data-plane primitives.
//
// The reference reaches native code through JNI for exactly these jobs:
// record-format checksums and copies (feature/pmem
// PersistentMemoryAllocator.java:37-43 native copy) and multi-threaded
// minibatch assembly (feature/common/MTSampleToMiniBatch.scala).  Here
// the same roles are a small C++ library loaded via ctypes:
//   - crc32c (castagnoli, slice-by-8): TFRecord / TensorBoard event
//     framing checksums at memory bandwidth instead of a Python loop
//   - gather_rows: parallel row gather (batch assembly) that releases
//     the GIL — called by FeatureSet for large batches.
//
// Built by native/__init__.py with: g++ -O3 -shared -fPIC -pthread

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

static uint32_t TBL[8][256];

static void build_tables() {
  const uint32_t poly = 0x82F63B78u;
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t crc = i;
    for (int k = 0; k < 8; k++)
      crc = (crc & 1) ? (crc >> 1) ^ poly : crc >> 1;
    TBL[0][i] = crc;
  }
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t crc = TBL[0][i];
    for (int s = 1; s < 8; s++) {
      crc = TBL[0][crc & 0xFF] ^ (crc >> 8);
      TBL[s][i] = crc;
    }
  }
}

// built once at library load — no lazy-init data race across caller
// threads (prefetch, async checkpoint, TB writer)
struct TableInit { TableInit() { build_tables(); } };
static TableInit table_init;

extern "C" {

uint32_t zoo_crc32c(const uint8_t* data, uint64_t n) {
  uint32_t crc = 0xFFFFFFFFu;
  // slice-by-8 over the aligned middle
  while (n >= 8) {
    uint64_t chunk;
    std::memcpy(&chunk, data, 8);
    chunk ^= crc;                      // little-endian hosts
    crc = TBL[7][chunk & 0xFF] ^ TBL[6][(chunk >> 8) & 0xFF] ^
          TBL[5][(chunk >> 16) & 0xFF] ^ TBL[4][(chunk >> 24) & 0xFF] ^
          TBL[3][(chunk >> 32) & 0xFF] ^ TBL[2][(chunk >> 40) & 0xFF] ^
          TBL[1][(chunk >> 48) & 0xFF] ^ TBL[0][(chunk >> 56) & 0xFF];
    data += 8;
    n -= 8;
  }
  while (n--) crc = TBL[0][(crc ^ *data++) & 0xFF] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

// Gather rows: dst[i] = src[idx[i]] for fixed-stride rows.
// Parallel memcpy across a thread pool for large batches.
void zoo_gather_rows(const char* src, const int64_t* idx, char* dst,
                     int64_t n_idx, int64_t row_bytes, int32_t n_threads) {
  if (n_threads <= 1 || n_idx < 4 * n_threads) {
    for (int64_t i = 0; i < n_idx; i++)
      std::memcpy(dst + i * row_bytes, src + idx[i] * row_bytes,
                  row_bytes);
    return;
  }
  std::vector<std::thread> workers;
  int64_t per = (n_idx + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; t++) {
    int64_t lo = t * per;
    int64_t hi = lo + per < n_idx ? lo + per : n_idx;
    if (lo >= hi) break;
    workers.emplace_back([=]() {
      for (int64_t i = lo; i < hi; i++)
        std::memcpy(dst + i * row_bytes, src + idx[i] * row_bytes,
                    row_bytes);
    });
  }
  for (auto& w : workers) w.join();
}

}  // extern "C"
