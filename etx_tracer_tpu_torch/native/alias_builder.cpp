// Batched Vose alias-table construction (host-side scene build).
//
// Counterpart of the reference's per-image sampling-table build
// (render/host/image_pool.cxx:226-266, row/column CDFs); the renderer
// samples with O(1) alias tables instead, and a 4k env map needs ~2k row
// tables of ~4k entries — a pure-Python Vose loop took tens of seconds of
// scene-build time, this does the same work in milliseconds.

#include <cstddef>
#include <cstdint>
#include <vector>

extern "C" {

// p: rows*n probabilities (each row sums to ~1; zeros allowed; rows that
// sum to 0 get uniform tables). Outputs prob (rows*n float32) and alias
// (rows*n int32).
int32_t etx_alias_build(const float* p, int32_t rows, int32_t n,
                        float* prob, int32_t* alias) {
  if (rows <= 0 || n <= 0) return -1;
  std::vector<int32_t> small_stack(n), large_stack(n);
  std::vector<double> scaled(n);

  for (int32_t r = 0; r < rows; ++r) {
    const float* pr = p + (size_t)r * n;
    float* out_p = prob + (size_t)r * n;
    int32_t* out_a = alias + (size_t)r * n;

    double sum = 0.0;
    for (int32_t i = 0; i < n; ++i) sum += pr[i];
    if (sum <= 0.0) {
      for (int32_t i = 0; i < n; ++i) { out_p[i] = 1.0f; out_a[i] = i; }
      continue;
    }
    const double k = (double)n / sum;
    int32_t ns = 0, nl = 0;
    for (int32_t i = 0; i < n; ++i) {
      scaled[i] = pr[i] * k;
      if (scaled[i] < 1.0) small_stack[ns++] = i; else large_stack[nl++] = i;
    }
    while (ns > 0 && nl > 0) {
      int32_t s = small_stack[--ns];
      int32_t l = large_stack[--nl];
      out_p[s] = (float)scaled[s];
      out_a[s] = l;
      scaled[l] = (scaled[l] + scaled[s]) - 1.0;
      if (scaled[l] < 1.0) small_stack[ns++] = l; else large_stack[nl++] = l;
    }
    while (nl > 0) { int32_t i = large_stack[--nl]; out_p[i] = 1.0f; out_a[i] = i; }
    while (ns > 0) { int32_t i = small_stack[--ns]; out_p[i] = 1.0f; out_a[i] = i; }
  }
  return 0;
}

}  // extern "C"
