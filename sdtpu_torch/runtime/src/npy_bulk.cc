// Parallel bulk file reader for the ~1000-file npy dump tree.
// The reference loads the tree serially with a println! per file
// (src/model/load.rs:30-47); this reads every file concurrently into
// caller-provided buffers. C ABI via ctypes.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Stat pass: fill lens[i] with the byte size of each path (0 on error).
int sdtpu_file_sizes(const char** paths, int n, uint64_t* lens) {
  for (int i = 0; i < n; ++i) {
    FILE* f = fopen(paths[i], "rb");
    if (!f) { lens[i] = 0; continue; }
    fseek(f, 0, SEEK_END);
    lens[i] = static_cast<uint64_t>(ftell(f));
    fclose(f);
  }
  return 0;
}

// Read pass: read each file fully into bufs[i] (caller allocated to
// lens[i]). Returns number of files read successfully.
int sdtpu_read_files(const char** paths, int n, uint8_t** bufs,
                     const uint64_t* lens, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next(0), ok(0);

  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      FILE* f = fopen(paths[i], "rb");
      if (!f) continue;
      size_t got = fread(bufs[i], 1, lens[i], f);
      fclose(f);
      if (got == lens[i]) ok.fetch_add(1);
    }
  };

  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads - 1; ++t) threads.emplace_back(worker);
  worker();
  for (auto& t : threads) t.join();
  return ok.load();
}

}  // extern "C"
