// Native mel-batch assembly for the training data loader.
//
// The reference gets parallel batch collation from PyTorch's
// DataLoader worker processes (C++ under the hood, SURVEY.md §2.4 /
// reference utils/dataset.py:134-199). This is the framework's own
// native equivalent for the hot part of TTS collation: reading B
// float32 .npy mel files of shape (n_mels, T) and writing them
// TRANSPOSED into a caller-allocated (B, max_t, n_mels) float32 batch
// padded with the mel pad value — one pass, a worker-thread per slice,
// no intermediate Python copies (the pure-numpy path is
// load -> pad -> stack -> transpose -> astype: four full copies).
//
// Exposed through ctypes (forwardtacotron_tpu_torch/data/native_loader.py),
// whose callers fall back to the numpy path when any file fails
// validation.
//
// Build: g++ compiles it at first use (forwardtacotron_tpu_torch/native/
// __init__.py).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

// Minimal .npy (format version 1/2/3) header parse for little-endian
// C-order arrays of a given dtype ("<f4"/"<i8"), 1-D or 2-D. Returns 0
// and fills rows/cols/offset on success (1-D: rows = 1, cols = n); any
// deviation is a validation error so the Python caller can fall back.
int parse_npy_header_dtype(const uint8_t* buf, size_t len,
                           const char* descr, int64_t* rows,
                           int64_t* cols, size_t* data_offset) {
  if (len < 10 || memcmp(buf, "\x93NUMPY", 6) != 0) return -1;
  const uint8_t major = buf[6];
  size_t header_len, header_start;
  if (major == 1) {
    header_len = buf[8] | (buf[9] << 8);
    header_start = 10;
  } else if (major == 2 || major == 3) {
    if (len < 12) return -1;
    header_len = static_cast<size_t>(buf[8]) | (buf[9] << 8) |
                 (static_cast<size_t>(buf[10]) << 16) |
                 (static_cast<size_t>(buf[11]) << 24);
    header_start = 12;
  } else {
    return -1;
  }
  if (header_start + header_len > len) return -1;
  std::string header(reinterpret_cast<const char*>(buf + header_start),
                     header_len);
  const std::string d1 = std::string("'descr': '") + descr + "'";
  const std::string d2 = std::string("\"descr\": \"") + descr + "\"";
  if (header.find(d1) == std::string::npos &&
      header.find(d2) == std::string::npos) return -2;
  if (header.find("'fortran_order': False") == std::string::npos &&
      header.find("\"fortran_order\": false") == std::string::npos)
    return -3;
  size_t sp = header.find("'shape':");
  if (sp == std::string::npos) sp = header.find("\"shape\":");
  if (sp == std::string::npos) return -4;
  sp = header.find('(', sp);
  if (sp == std::string::npos) return -4;
  long long r = 0, c = 0;
  if (sscanf(header.c_str() + sp, "(%lld, %lld)", &r, &c) == 2) {
    if (r <= 0 || c <= 0) return -5;
    *rows = r;
    *cols = c;
  } else if (sscanf(header.c_str() + sp, "(%lld,)", &r) == 1) {
    if (r <= 0) return -5;
    *rows = 1;
    *cols = r;
  } else {
    return -5;
  }
  *data_offset = header_start + header_len;
  return 0;
}

int parse_npy_header(const uint8_t* buf, size_t len, int64_t* rows,
                     int64_t* cols, size_t* data_offset) {
  return parse_npy_header_dtype(buf, len, "<f4", rows, cols, data_offset);
}

struct Mapped {
  void* ptr = nullptr;
  size_t size = 0;
  ~Mapped() {
    if (ptr) munmap(ptr, size);
  }
};

int map_file(const char* path, Mapped* m) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -10;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < 16) {
    close(fd);
    return -11;
  }
  m->size = static_cast<size_t>(st.st_size);
  m->ptr = mmap(nullptr, m->size, PROT_READ, MAP_PRIVATE, fd, 0);
  close(fd);
  if (m->ptr == MAP_FAILED) {
    m->ptr = nullptr;
    return -12;
  }
  return 0;
}

// Run `fn(i)` for i in [0, n) over a transient thread pool; first
// nonzero return aborts the sweep and is returned.
template <typename Fn>
int parallel_for(int32_t n, int32_t n_threads, Fn fn) {
  if (n <= 0) return -1;
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = n;
  std::atomic<int32_t> next(0);
  std::atomic<int> err(0);
  auto worker = [&]() {
    for (;;) {
      const int32_t i = next.fetch_add(1);
      if (i >= n || err.load() != 0) break;
      const int rc = fn(i);
      if (rc != 0) {
        int expected = 0;
        err.compare_exchange_strong(expected, rc);
      }
    }
  };
  if (n_threads == 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(n_threads);
    for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return err.load();
}

// Load one (n_mels, T) file into out_item = (max_t, n_mels), transposed
// and padded with `fill` beyond T rows. Returns 0 on success.
int load_one(const char* path, float* out_item, int64_t max_t,
             int64_t n_mels, float fill, int32_t* out_len) {
  Mapped m;
  int rc = map_file(path, &m);
  if (rc != 0) return rc;
  const uint8_t* buf = static_cast<const uint8_t*>(m.ptr);

  int64_t rows = 0, cols = 0;
  size_t offset = 0;
  rc = parse_npy_header(buf, m.size, &rows, &cols, &offset);
  if (rc == 0 && rows != n_mels) rc = -6;       // shape (n_mels, T) only
  if (rc == 0 && cols > max_t) rc = -7;         // bucket must fit T
  if (rc == 0 &&
      offset + static_cast<size_t>(rows) * cols * 4 > m.size) rc = -8;
  if (rc != 0) return rc;
  const float* src = reinterpret_cast<const float*>(buf + offset);
  const int64_t T = cols;

  // blocked transpose (n_mels, T) -> (T, n_mels): walk source rows
  // (contiguous reads) in t-blocks sized to keep the destination
  // window inside L1/L2
  constexpr int64_t TB = 128;
  for (int64_t t0 = 0; t0 < T; t0 += TB) {
    const int64_t t1 = (t0 + TB < T) ? t0 + TB : T;
    for (int64_t c = 0; c < n_mels; ++c) {
      const float* s = src + c * T;
      for (int64_t t = t0; t < t1; ++t) {
        out_item[t * n_mels + c] = s[t];
      }
    }
  }
  // pad the remaining (max_t - T) rows
  float* tail = out_item + T * n_mels;
  const int64_t tail_n = (max_t - T) * n_mels;
  for (int64_t i = 0; i < tail_n; ++i) tail[i] = fill;

  if (out_len) *out_len = static_cast<int32_t>(T);
  return 0;
}

}  // namespace

extern "C" {

// Assemble a transposed, padded mel batch.
//   paths:    n_items file paths of float32 C-order (n_mels, T) .npy
//   out:      caller-allocated (n_items, max_t, n_mels) float32
//   mel_lens: caller-allocated int32[n_items], receives each T
// Returns 0 on success; the first nonzero per-item error otherwise
// (the caller treats any nonzero as "fall back to numpy").
int ftt_load_mel_batch(const char** paths, int32_t n_items, float* out,
                       int64_t max_t, int64_t n_mels, float fill,
                       int32_t* mel_lens, int32_t n_threads) {
  if (max_t <= 0 || n_mels <= 0) return -1;
  return parallel_for(n_items, n_threads, [&](int32_t i) {
    return load_one(paths[i],
                    out + static_cast<int64_t>(i) * max_t * n_mels, max_t,
                    n_mels, fill, mel_lens ? mel_lens + i : nullptr);
  });
}

// Header peek: the last-dimension length of each .npy (f32 2-D -> T,
// i8/i64 1-D -> n). `descr` selects the expected dtype ("<f4"/"<i8").
int ftt_npy_lengths(const char** paths, int32_t n_items,
                    const char* descr, int64_t* out_lens,
                    int32_t n_threads) {
  return parallel_for(n_items, n_threads, [&](int32_t i) {
    Mapped m;
    int rc = map_file(paths[i], &m);
    if (rc != 0) return rc;
    int64_t rows = 0, cols = 0;
    size_t offset = 0;
    rc = parse_npy_header_dtype(static_cast<const uint8_t*>(m.ptr),
                                m.size, descr, &rows, &cols, &offset);
    if (rc != 0) return rc;
    out_lens[i] = cols;
    return 0;
  });
}

// Column windows of float32 (n_mels, T) files, written TRANSPOSED as
// (n_items, win, n_mels) — the vocoder collator's random mel windows
// (reference utils/dataset.py:86-126) without reading the full file.
int ftt_load_mel_windows(const char** paths, int32_t n_items,
                         const int64_t* starts, int64_t win,
                         int64_t n_mels, float* out, int32_t n_threads) {
  if (win <= 0 || n_mels <= 0) return -1;
  return parallel_for(n_items, n_threads, [&](int32_t i) {
    Mapped m;
    int rc = map_file(paths[i], &m);
    if (rc != 0) return rc;
    const uint8_t* buf = static_cast<const uint8_t*>(m.ptr);
    int64_t rows = 0, cols = 0;
    size_t offset = 0;
    rc = parse_npy_header(buf, m.size, &rows, &cols, &offset);
    if (rc != 0) return rc;
    if (rows != n_mels) return -6;
    const int64_t s = starts[i];
    if (s < 0 || s + win > cols) return -7;
    if (offset + static_cast<size_t>(rows) * cols * 4 > m.size) return -8;
    const float* src = reinterpret_cast<const float*>(buf + offset);
    float* dst = out + static_cast<int64_t>(i) * win * n_mels;
    for (int64_t c = 0; c < n_mels; ++c) {
      const float* row = src + c * cols + s;
      for (int64_t t = 0; t < win; ++t) dst[t * n_mels + c] = row[t];
    }
    return 0;
  });
}

// Element windows of int64 1-D files (the quantized waveform labels) —
// contiguous, so a straight memcpy per item.
int ftt_load_i64_windows(const char** paths, int32_t n_items,
                         const int64_t* starts, int64_t count,
                         int64_t* out, int32_t n_threads) {
  if (count <= 0) return -1;
  return parallel_for(n_items, n_threads, [&](int32_t i) {
    Mapped m;
    int rc = map_file(paths[i], &m);
    if (rc != 0) return rc;
    const uint8_t* buf = static_cast<const uint8_t*>(m.ptr);
    int64_t rows = 0, cols = 0;
    size_t offset = 0;
    rc = parse_npy_header_dtype(buf, m.size, "<i8", &rows, &cols, &offset);
    if (rc != 0) return rc;
    if (rows != 1) return -6;
    const int64_t s = starts[i];
    if (s < 0 || s + count > cols) return -7;
    if (offset + static_cast<size_t>(cols) * 8 > m.size) return -8;
    memcpy(out + static_cast<int64_t>(i) * count,
           buf + offset + static_cast<size_t>(s) * 8,
           static_cast<size_t>(count) * 8);
    return 0;
  });
}

}  // extern "C"
