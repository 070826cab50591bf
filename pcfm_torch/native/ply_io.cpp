// Fast PLY vertex parsing for the host data pipeline (the port's copy of
// pcfm/native/ply_io.cpp).
//
// The reference's datagen emits ASCII PLY point clouds (--ply-ascii) and its
// data path parses them with python; numpy.loadtxt on a 20k-point ASCII file
// costs tens of ms per cloud.
// This translation unit provides a threaded C parser exposed through a tiny
// C ABI (loaded with ctypes; no pybind11 dependency).
//
// Exposed functions:
//   pcfm_ply_parse_ascii(text, len, ncols, out_f32, max_rows) -> rows parsed
//   pcfm_subsample_gather(src (n,c) f32, idx (k,) i64, out (k,c) f32)
//
// Build: pcfm_torch/native/build.py (g++ -O3 -shared -fPIC -pthread).
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Parse `max_rows` whitespace-separated numeric rows of `ncols` columns from
// `text` (the PLY body after end_header). Returns rows parsed.
// Parallelized over row ranges by first indexing line starts.
int64_t pcfm_ply_parse_ascii(const char* text, int64_t len, int32_t ncols,
                             float* out, int64_t max_rows) {
  // index line starts
  std::vector<int64_t> starts;
  starts.reserve(static_cast<size_t>(max_rows) + 1);
  int64_t i = 0;
  while (i < len && static_cast<int64_t>(starts.size()) < max_rows) {
    // skip leading whitespace/newlines
    while (i < len && (text[i] == '\n' || text[i] == '\r' || text[i] == ' '))
      i++;
    if (i >= len) break;
    starts.push_back(i);
    while (i < len && text[i] != '\n') i++;
  }
  const int64_t rows = static_cast<int64_t>(starts.size());
  if (rows == 0) return 0;

  unsigned hw = std::thread::hardware_concurrency();
  int nthreads = hw ? static_cast<int>(hw) : 4;
  if (rows < 4096) nthreads = 1;
  if (nthreads > 16) nthreads = 16;

  auto worker = [&](int64_t r0, int64_t r1) {
    for (int64_t r = r0; r < r1; r++) {
      const char* p = text + starts[r];
      const char* line_end =
          (r + 1 < rows) ? text + starts[r + 1] : text + len;
      float* dst = out + r * ncols;
      for (int c = 0; c < ncols; c++) {
        char* endp = nullptr;
        dst[c] = strtof(p, &endp);
        if (endp == p || endp > line_end) {  // malformed column
          for (; c < ncols; c++) dst[c] = 0.0f;
          break;
        }
        p = endp;
      }
    }
  };

  if (nthreads == 1) {
    worker(0, rows);
  } else {
    std::vector<std::thread> ts;
    int64_t chunk = (rows + nthreads - 1) / nthreads;
    for (int t = 0; t < nthreads; t++) {
      int64_t r0 = t * chunk;
      int64_t r1 = r0 + chunk < rows ? r0 + chunk : rows;
      if (r0 >= r1) break;
      ts.emplace_back(worker, r0, r1);
    }
    for (auto& t : ts) t.join();
  }
  return rows;
}

// Gather rows: out[k] = src[idx[k]] — the per-item point subsample of the
// data loader, threaded for large K*C.
void pcfm_subsample_gather(const float* src, int64_t n, int32_t c,
                           const int64_t* idx, int64_t k, float* out) {
  auto worker = [&](int64_t a, int64_t b) {
    for (int64_t i = a; i < b; i++) {
      int64_t j = idx[i];
      if (j < 0 || j >= n) j = 0;
      std::memcpy(out + i * c, src + j * c, sizeof(float) * c);
    }
  };
  if (k * c < 1 << 18) {
    worker(0, k);
    return;
  }
  unsigned hw = std::thread::hardware_concurrency();
  int nthreads = hw ? static_cast<int>(hw) : 4;
  if (nthreads > 8) nthreads = 8;
  std::vector<std::thread> ts;
  int64_t chunk = (k + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; t++) {
    int64_t a = t * chunk;
    int64_t b = a + chunk < k ? a + chunk : k;
    if (a >= b) break;
    ts.emplace_back(worker, a, b);
  }
  for (auto& t : ts) t.join();
}

}  // extern "C"
