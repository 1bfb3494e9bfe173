// Threaded latent-shard reader behind the precomputed-latent datasets
// (VAEMiraDataset).
//
// C API (ctypes-friendly):
//   ls_read_batch(paths, n, dests, sizes, n_threads) -> 0 on success
//     parallel whole-file reads into caller-provided buffers
//   ls_file_size(path) -> size in bytes (-1 on error)
//   ls_version() -> ABI version
//
// Built with g++ at first use by tokensgen_tpu_torch/data/native_store.py.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

int64_t ls_file_size(const char* path) {
  struct stat st;
  if (stat(path, &st) != 0) return -1;
  return static_cast<int64_t>(st.st_size);
}

// Read one whole file into dest (must hold `size` bytes). Returns bytes read.
static int64_t read_file(const char* path, uint8_t* dest, int64_t size) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
#ifdef POSIX_FADV_SEQUENTIAL
  posix_fadvise(fd, 0, 0, POSIX_FADV_SEQUENTIAL);
#endif
  int64_t off = 0;
  while (off < size) {
    ssize_t n = pread(fd, dest + off, static_cast<size_t>(size - off), off);
    if (n <= 0) break;
    off += n;
  }
  close(fd);
  return off;
}

// Parallel batch read: paths[i] -> dests[i] (sizes[i] bytes each).
// Returns 0 on success, else the count of failed files.
int ls_read_batch(const char** paths, int n, uint8_t** dests,
                  const int64_t* sizes, int n_threads) {
  if (n <= 0) return 0;
  if (n_threads <= 0) n_threads = 4;
  if (n_threads > n) n_threads = n;
  std::atomic<int> next(0);
  std::atomic<int> failures(0);
  auto worker = [&]() {
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      if (read_file(paths[i], dests[i], sizes[i]) != sizes[i]) {
        failures.fetch_add(1);
      }
    }
  };
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return failures.load();
}

int ls_version() { return 1; }

}  // extern "C"
