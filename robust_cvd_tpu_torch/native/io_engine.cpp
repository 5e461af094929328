// Native batched `.raw` result-tree IO engine.
//
// The pipeline's host-side data plane moves hundreds of `.raw` frames
// (color, depth, flow) per stage between the result tree and HBM staging
// buffers. The reference does this through OpenCV file IO inside lazily
// cached C++ frame objects (lib/core/CvUtil.cpp:25-42 freadim/fwriteim,
// lib/DepthStream.cpp:193-232, lib/ColorStream.cpp); the TPU-native design
// loads WHOLE CLIPS at once, so the IO engine is a thread-pooled batch
// reader/writer into one contiguous buffer (the numpy array the caller
// ships to the device in a single transfer).
//
// Format (little-endian, byte-locked against the reference):
//   [rows:i32][cols:i32][cv_type:i32][pixel_size:u64][row-major data]
//
// A copy of robust_cvd_tpu/native/io_engine.cpp, so both packages read
// and write the same bytes. Built on demand with g++ and loaded via ctypes
// (native/__init__.py).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Header {
  int32_t rows;
  int32_t cols;
  int32_t cvtype;
  uint64_t pixel_size;
} __attribute__((packed));

static_assert(sizeof(Header) == 20, "packed header must be 20 bytes");

// Returns 0 on success, nonzero error code otherwise.
int read_one(const char* path, int32_t rows, int32_t cols, int32_t cvtype,
             uint8_t* out, int64_t frame_bytes) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  Header h;
  if (std::fread(&h, sizeof(Header), 1, f) != 1) {
    std::fclose(f);
    return 2;
  }
  if (h.rows != rows || h.cols != cols || h.cvtype != cvtype) {
    std::fclose(f);
    return 3;
  }
  const uint64_t expect =
      static_cast<uint64_t>(rows) * static_cast<uint64_t>(cols) * h.pixel_size;
  if (expect != static_cast<uint64_t>(frame_bytes)) {
    std::fclose(f);
    return 4;
  }
  const size_t got = std::fread(out, 1, frame_bytes, f);
  std::fclose(f);
  return got == static_cast<size_t>(frame_bytes) ? 0 : 5;
}

int write_one(const char* path, int32_t rows, int32_t cols, int32_t cvtype,
              uint64_t pixel_size, const uint8_t* data, int64_t frame_bytes) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return 1;
  Header h{rows, cols, cvtype, pixel_size};
  if (std::fwrite(&h, sizeof(Header), 1, f) != 1) {
    std::fclose(f);
    return 2;
  }
  const size_t put = std::fwrite(data, 1, frame_bytes, f);
  std::fclose(f);
  return put == static_cast<size_t>(frame_bytes) ? 0 : 3;
}

template <typename Fn>
int run_pool(int64_t n, int32_t nthreads, int64_t* bad_index, Fn&& fn) {
  std::atomic<int64_t> next(0);
  std::atomic<int64_t> bad(-1);
  auto worker = [&]() {
    for (;;) {
      const int64_t i = next.fetch_add(1);
      if (i >= n || bad.load(std::memory_order_relaxed) >= 0) return;
      if (fn(i) != 0) {
        int64_t expect = -1;
        bad.compare_exchange_strong(expect, i);
        return;
      }
    }
  };
  int32_t t = nthreads;
  if (t <= 0) t = 1;
  if (t > n) t = static_cast<int32_t>(n);
  std::vector<std::thread> threads;
  threads.reserve(t);
  for (int32_t k = 0; k < t; ++k) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  const int64_t b = bad.load();
  if (bad_index) *bad_index = b;
  return b >= 0 ? 1 : 0;
}

}  // namespace

extern "C" {

// paths: n C strings. out: contiguous (n, rows, cols, channels) buffer.
// Every file must match (rows, cols, cvtype). Returns 0 on success; on
// failure returns 1 and *bad_index is the offending file's index.
int read_raw_batch(const char** paths, int64_t n, int32_t rows, int32_t cols,
                   int32_t cvtype, uint8_t* out, int64_t frame_bytes,
                   int32_t nthreads, int64_t* bad_index) {
  return run_pool(n, nthreads, bad_index, [&](int64_t i) {
    return read_one(paths[i], rows, cols, cvtype, out + i * frame_bytes,
                    frame_bytes);
  });
}

int write_raw_batch(const char** paths, int64_t n, int32_t rows, int32_t cols,
                    int32_t cvtype, uint64_t pixel_size, const uint8_t* data,
                    int64_t frame_bytes, int32_t nthreads,
                    int64_t* bad_index) {
  return run_pool(n, nthreads, bad_index, [&](int64_t i) {
    return write_one(paths[i], rows, cols, cvtype, pixel_size,
                     data + i * frame_bytes, frame_bytes);
  });
}

// Read just the (rows, cols, cvtype) header of one file. Returns 0 on
// success.
int read_raw_header(const char* path, int32_t* rows, int32_t* cols,
                    int32_t* cvtype) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  Header h;
  const bool ok = std::fread(&h, sizeof(Header), 1, f) == 1;
  std::fclose(f);
  if (!ok) return 2;
  *rows = h.rows;
  *cols = h.cols;
  *cvtype = h.cvtype;
  return 0;
}

}  // extern "C"
