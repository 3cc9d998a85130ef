// C entry points of the panel-strip kernel (panel_strip.cuh) in float32
// (3xTF32 on the tensor cores) and float64 (SIMT).

#include "panel_strip.cuh"

extern "C" {

// `x1` (m1, d) are the strip's rows, `x2` (m2, d) its columns; `la` and
// `lb` point at the first of m1 and m2 factor rows (row stride `ldl`),
// whose first `kdim` columns are the factored prefix. `row0` and `col0` are
// the global indices of the first row and column. The float32 kernel reads
// both operands through one map over `la`, so it takes `lb == la` (the
// strip's columns are its first rows), as the streamed factorization
// passes them. Returns the cudaError_t of the launch (0 on success).
int friedrich_panel_strip_f32(const float* x1, const float* x2,
                              const float* la, const float* lb, float* out,
                              int m1, int m2, int d, long long ldl, int kdim,
                              long long row0, long long col0, long long n,
                              double noise, int method, int needs,
                              CovProgram prog, void* stream) {
  return launch_tf32x3(x1, x2, la, lb, out, m1, m2, d, ldl, kdim, row0, col0, n, noise, method,
                       needs, prog, static_cast<cudaStream_t>(stream));
}

int friedrich_panel_strip_f64(const double* x1, const double* x2,
                              const double* la, const double* lb, double* out,
                              int m1, int m2, int d, long long ldl, int kdim,
                              long long row0, long long col0, long long n,
                              double noise, int method, int needs,
                              CovProgram prog, void* stream) {
  return launch_simt<double>(x1, x2, la, lb, out, m1, m2, d, ldl, kdim, row0, col0, n,
                             noise, method, needs, prog, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
