// Native token-shard reader: mmap + multithreaded strided gather + readahead.
//
// The port's copy of the JAX package's reader
// (orion_tpu/data/native/native_loader.cpp), the same C ABI and the same
// bytes. The hot operation is gathering B windows of (S+1) tokens from a
// memmapped flat token file into one contiguous host batch buffer, which
// the trainer then moves to its device. The gather is memcpy-bound, so it
// fans out over threads; prefetch() issues MADV_WILLNEED for the *next*
// step's (deterministic) windows so page-ins overlap with the current step.
//
// Exposed as a plain C ABI for ctypes.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Handle {
  int fd;
  size_t bytes;
  const uint8_t* base;
};

}  // namespace

extern "C" {

// Returns an opaque handle, or nullptr on failure.
void* otn_open(const char* path) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size == 0) {
    close(fd);
    return nullptr;
  }
  void* p = mmap(nullptr, static_cast<size_t>(st.st_size), PROT_READ,
                 MAP_SHARED, fd, 0);
  if (p == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  // Window sampling is random-access; disable kernel sequential readahead.
  madvise(p, static_cast<size_t>(st.st_size), MADV_RANDOM);
  return new Handle{fd, static_cast<size_t>(st.st_size),
                    static_cast<const uint8_t*>(p)};
}

long long otn_len_bytes(void* hv) {
  return static_cast<long long>(static_cast<Handle*>(hv)->bytes);
}

// Copy n windows of `width` elements (elem_size bytes each), window i
// starting at element offsets[i], into out (contiguous [n, width]).
// Returns 0 on success, -1 if any window is out of bounds.
int otn_gather(void* hv, const long long* offsets, int n, int width,
               int elem_size, void* out, int nthreads) {
  Handle* h = static_cast<Handle*>(hv);
  const size_t row_bytes = static_cast<size_t>(width) * elem_size;
  for (int i = 0; i < n; i++) {
    if (offsets[i] < 0 ||
        static_cast<size_t>(offsets[i]) * elem_size + row_bytes > h->bytes) {
      return -1;
    }
  }
  uint8_t* dst = static_cast<uint8_t*>(out);
  auto worker = [&](int a, int b) {
    for (int i = a; i < b; i++) {
      memcpy(dst + static_cast<size_t>(i) * row_bytes,
             h->base + static_cast<size_t>(offsets[i]) * elem_size, row_bytes);
    }
  };
  int nt = std::max(1, nthreads);
  if (nt == 1 || n < 2 * nt) {
    worker(0, n);
    return 0;
  }
  std::vector<std::thread> threads;
  int per = (n + nt - 1) / nt;
  for (int t = 0; t < nt; t++) {
    int a = t * per, b = std::min(n, a + per);
    if (a >= b) break;
    threads.emplace_back(worker, a, b);
  }
  for (auto& th : threads) th.join();
  return 0;
}

// Hint the kernel to page in the given windows (the next step's batch).
void otn_prefetch(void* hv, const long long* offsets, int n, int width,
                  int elem_size) {
  Handle* h = static_cast<Handle*>(hv);
  const long page = sysconf(_SC_PAGESIZE);
  for (int i = 0; i < n; i++) {
    if (offsets[i] < 0) continue;
    size_t start = static_cast<size_t>(offsets[i]) * elem_size;
    size_t end = start + static_cast<size_t>(width) * elem_size;
    if (end > h->bytes) continue;
    size_t aligned = start & ~static_cast<size_t>(page - 1);
    madvise(const_cast<uint8_t*>(h->base) + aligned, end - aligned,
            MADV_WILLNEED);
  }
}

void otn_close(void* hv) {
  Handle* h = static_cast<Handle*>(hv);
  munmap(const_cast<uint8_t*>(h->base), h->bytes);
  close(h->fd);
  delete h;
}

}  // extern "C"
