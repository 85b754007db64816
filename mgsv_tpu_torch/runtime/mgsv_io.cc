// Native IO runtime for the packed feature stores.
//
// The reference feeds training through torch DataLoader worker *processes*,
// each torch.load-ing one pickle file per sample per epoch
// (dataloaders/dataloader_MGSV_EC_feature.py:57-67, num_workers=32).  The
// TPU-native replacement is a memory-mapped contiguous store (one .npy per
// tensor) with this small C++ library doing the hot work: batch row-gather
// (fancy-index memcpy) with a thread pool, fp16->fp32 widening fused into
// the copy, and madvise-based readahead so the next batch's pages are in
// the page cache before the gather runs.
//
// Build: g++ -O3 -march=native -shared -fPIC -o libmgsv_io.so mgsv_io.cc -lpthread
// Exposed via ctypes (mgsv_tpu/runtime/native.py); pure-numpy fallback
// exists, this is the fast path.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Store {
  int fd = -1;
  void* map = nullptr;
  size_t map_size = 0;
  const char* data = nullptr;  // first row (after npy header)
  int64_t rows = 0;
  int64_t row_bytes = 0;
};

inline void copy_rows_range(const Store* s, const int64_t* idx, int64_t lo,
                            int64_t hi, char* out) {
  for (int64_t i = lo; i < hi; ++i) {
    std::memcpy(out + i * s->row_bytes, s->data + idx[i] * s->row_bytes,
                s->row_bytes);
  }
}

// fp16 -> fp32 widening copy (scalar; compilers vectorize with F16C where
// available).  half layout: IEEE 754 binary16.
inline float half_to_float(uint16_t h) {
  uint32_t sign = (uint32_t)(h >> 15) << 31;
  uint32_t exp = (h >> 10) & 0x1f;
  uint32_t mant = h & 0x3ff;
  uint32_t bits;
  if (exp == 0) {
    if (mant == 0) {
      bits = sign;
    } else {  // subnormal
      exp = 127 - 15 + 1;
      while ((mant & 0x400) == 0) {
        mant <<= 1;
        --exp;
      }
      mant &= 0x3ff;
      bits = sign | (exp << 23) | (mant << 13);
    }
  } else if (exp == 0x1f) {
    bits = sign | 0x7f800000u | (mant << 13);
  } else {
    bits = sign | ((exp - 15 + 127) << 23) | (mant << 13);
  }
  float f;
  std::memcpy(&f, &bits, sizeof(f));
  return f;
}

inline void widen_rows_range(const Store* s, const int64_t* idx, int64_t lo,
                             int64_t hi, float* out) {
  const int64_t elems = s->row_bytes / 2;
  for (int64_t i = lo; i < hi; ++i) {
    const uint16_t* src =
        reinterpret_cast<const uint16_t*>(s->data + idx[i] * s->row_bytes);
    float* dst = out + i * elems;
    for (int64_t j = 0; j < elems; ++j) dst[j] = half_to_float(src[j]);
  }
}

template <typename Fn>
void parallel_rows(int64_t n, int threads, Fn fn) {
  if (threads <= 1 || n < 64) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> pool;
  int64_t chunk = (n + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    int64_t lo = t * chunk, hi = std::min<int64_t>(n, lo + chunk);
    if (lo >= hi) break;
    pool.emplace_back([=] { fn(lo, hi); });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// Opens a raw data region inside a file (offset points past the npy header).
void* mgsv_open_store(const char* path, int64_t offset, int64_t rows,
                      int64_t row_bytes) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    ::close(fd);
    return nullptr;
  }
  void* map = ::mmap(nullptr, (size_t)st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  if (map == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  ::madvise(map, (size_t)st.st_size, MADV_WILLNEED);
  Store* s = new Store;
  s->fd = fd;
  s->map = map;
  s->map_size = (size_t)st.st_size;
  s->data = static_cast<const char*>(map) + offset;
  s->rows = rows;
  s->row_bytes = row_bytes;
  return s;
}

void mgsv_close_store(void* store) {
  Store* s = static_cast<Store*>(store);
  if (!s) return;
  if (s->map) ::munmap(s->map, s->map_size);
  if (s->fd >= 0) ::close(s->fd);
  delete s;
}

// Gather rows idx[0..n) into out (same dtype as stored).
void mgsv_gather(void* store, const int64_t* idx, int64_t n, char* out,
                 int threads) {
  Store* s = static_cast<Store*>(store);
  parallel_rows(n, threads,
                [&](int64_t lo, int64_t hi) { copy_rows_range(s, idx, lo, hi, out); });
}

// Gather fp16 rows widened to fp32.
void mgsv_gather_f16_to_f32(void* store, const int64_t* idx, int64_t n,
                            float* out, int threads) {
  Store* s = static_cast<Store*>(store);
  parallel_rows(n, threads,
                [&](int64_t lo, int64_t hi) { widen_rows_range(s, idx, lo, hi, out); });
}

// Hint the kernel to prefetch the pages of the given rows.
void mgsv_prefetch_rows(void* store, const int64_t* idx, int64_t n) {
  Store* s = static_cast<Store*>(store);
  long page = sysconf(_SC_PAGESIZE);
  for (int64_t i = 0; i < n; ++i) {
    const char* p = s->data + idx[i] * s->row_bytes;
    uintptr_t start = reinterpret_cast<uintptr_t>(p) & ~(uintptr_t)(page - 1);
    size_t len = (size_t)(reinterpret_cast<uintptr_t>(p) + s->row_bytes - start);
    ::madvise(reinterpret_cast<void*>(start), len, MADV_WILLNEED);
  }
}

}  // extern "C"
