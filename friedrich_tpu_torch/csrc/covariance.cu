// C entry points of the covariance-tile kernel (covariance.cuh). The
// kernels themselves are instantiated in covariance_f32.cu and
// covariance_f64.cu, which nvcc builds in parallel with this file.

#include "covariance.cuh"

namespace friedrich {

#define FRIEDRICH_COV_METHODS(T)                                          \
  extern template int launch_method<T, GRAM>(                             \
      const CovArgs<T>&, int, const LeafConsts&, const CovProgram&,       \
      cudaStream_t);                                                      \
  extern template int launch_method<T, GRAM_BF16>(                        \
      const CovArgs<T>&, int, const LeafConsts&, const CovProgram&,       \
      cudaStream_t);                                                      \
  extern template int launch_method<T, DIRECT>(                           \
      const CovArgs<T>&, int, const LeafConsts&, const CovProgram&,       \
      cudaStream_t);
FRIEDRICH_COV_METHODS(float)
FRIEDRICH_COV_METHODS(double)
#undef FRIEDRICH_COV_METHODS

template <typename T>
int launch(const T* x1, const T* x2, T* out, int m1, int m2, int d,
           long long row0, long long n, double noise, int train, int method,
           int needs, int map, const LeafConsts& consts,
           const CovProgram& prog, void* stream) {
  const CovArgs<T> a{x1, x2, out, m1, m2, d, row0, n, static_cast<T>(noise),
                     train, needs};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (method) {
    case GRAM: return launch_method<T, GRAM>(a, map, consts, prog, s);
    case GRAM_BF16: return launch_method<T, GRAM_BF16>(a, map, consts, prog, s);
    case DIRECT: return launch_method<T, DIRECT>(a, map, consts, prog, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace friedrich

extern "C" {

// `map`: the leaf opcode whose map is compiled in (enum Op, with `consts`),
// or MAP_PROGRAM to interpret `prog`. Returns the cudaError_t of the launch
// (0 on success).
int friedrich_cov_f32(const float* x1, const float* x2, float* out, int m1,
                      int m2, int d, long long row0, long long n, double noise,
                      int train, int method, int needs, int map,
                      LeafConsts consts, CovProgram prog, void* stream) {
  return friedrich::launch<float>(x1, x2, out, m1, m2, d, row0, n, noise,
                                  train, method, needs, map, consts, prog,
                                  stream);
}

int friedrich_cov_f64(const double* x1, const double* x2, double* out, int m1,
                      int m2, int d, long long row0, long long n, double noise,
                      int train, int method, int needs, int map,
                      LeafConsts consts, CovProgram prog, void* stream) {
  return friedrich::launch<double>(x1, x2, out, m1, m2, d, row0, n, noise,
                                   train, method, needs, map, consts, prog,
                                   stream);
}

const char* friedrich_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
