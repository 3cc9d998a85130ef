// Covariance-tile kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_cov_pallas` with its body
// `_cov_kernel_body` and feature helper `_feats_tile`
// (friedrich_tpu/ops/pallas/covariance_pallas.py:31-136). One launch builds
// one (m1, m2) block of K(X1, X2):
//
//   dot    = x1 . x2                         (gram, gram_bf16 or direct)
//   sqdist = max(|x1|^2 + |x2|^2 - 2 dot, 0) (gram) | sum (x1 - x2)^2 (direct)
//   dist   = sqrt(sqdist)
//   k      = the kernel map, run as a postfix program (see below)
//
// Train mode: entries outside the live n x n block are the identity, and
// the diagonal is the program on diagonal features (sqdist = dist = 0,
// dot = |x|^2) plus noise^2 — never the Gram tile's cancellation-prone
// value. Cross mode: rows >= n are zero. `row0` is the global index of
// x1's first row, so a launch can build any strip of rows.
//
// The kernel map. The Pallas body re-traced the kernel's pointwise map for
// every Sum/Prod tree. Here the host encodes the tree into a postfix
// program (one opcode per leaf kernel, ADD and MUL; at most 16 nodes and
// 32 parameters) passed by value in the launch, and every thread runs the
// same program on its entries, so one compiled kernel serves every
// composition without divergence.
//
// Bound. At the main-path shape (50,512 x 50,512 float32, d = 8) an entry
// costs 2d = 16 FLOPs of dot product, a handful for the distance and one
// exp, against 4 bytes written: about 6 FLOP/byte, below the card's
// float32 balance of 20 FLOP/byte (67 TFLOP/s over 3.35 TB/s). The kernel
// is bound by writing the 10.2 GB output: 3.05 ms at 3.35 TB/s.
// What the design does about it: each output element is written exactly
// once, row-major, by stores in which a warp writes 32 consecutive
// elements; the features and the kernel map live only in registers; the
// inputs are staged in shared memory once per block. Nothing intermediate
// goes to device memory. Writing only the lower triangle in train mode,
// and wgmma/TMA for wide d, are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#define MAX_OPS 16
#define MAX_PARAMS 32

// Layout shared with friedrich_tpu_torch/ops/cuda/covariance_cuda.py
// (_Program).
struct CovProgram {
  int n_ops;
  int ops[MAX_OPS];
  int offs[MAX_OPS];  // first parameter of each leaf op
  double params[MAX_PARAMS];
};

namespace {

enum Op : int {
  OP_LINEAR = 0,
  OP_POLYNOMIAL = 1,
  OP_SQEXP = 2,
  OP_EXPONENTIAL = 3,
  OP_MATERN1 = 4,
  OP_MATERN2 = 5,
  OP_HYPERTAN = 6,
  OP_MULTIQUADRIC = 7,
  OP_RATQUAD = 8,
  OP_ADD = 9,
  OP_MUL = 10,
};

enum Method : int { GRAM = 0, GRAM_BF16 = 1, DIRECT = 2 };
enum Need : int { NEED_DOT = 1, NEED_SQ = 2, NEED_DIST = 4 };

constexpr int BM = 64;    // rows of a block tile
constexpr int BN = 128;   // columns of a block tile
constexpr int TX = 32;    // threads along columns (one warp)
constexpr int TY = 8;     // threads along rows
constexpr int RM = BM / TY;  // rows per thread
constexpr int RN = BN / TX;  // columns per thread
constexpr int DC = 16;    // feature columns staged per pass

__device__ __forceinline__ float m_exp(float v) { return expf(v); }
__device__ __forceinline__ double m_exp(double v) { return exp(v); }
__device__ __forceinline__ float m_pow(float a, float b) { return powf(a, b); }
__device__ __forceinline__ double m_pow(double a, double b) { return pow(a, b); }
__device__ __forceinline__ float m_tanh(float v) { return tanhf(v); }
__device__ __forceinline__ double m_tanh(double v) { return tanh(v); }
__device__ __forceinline__ float m_hypot(float a, float b) { return hypotf(a, b); }
__device__ __forceinline__ double m_hypot(double a, double b) { return hypot(a, b); }
__device__ __forceinline__ float m_abs(float v) { return fabsf(v); }
__device__ __forceinline__ double m_abs(double v) { return fabs(v); }
__device__ __forceinline__ float m_sqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double m_sqrt(double v) { return sqrt(v); }
__device__ __forceinline__ float m_max0(float v) { return fmaxf(v, 0.0f); }
__device__ __forceinline__ double m_max0(double v) { return fmax(v, 0.0); }

template <typename T>
__device__ __forceinline__ float to_bf16_float(T v) {
  return __bfloat162float(__float2bfloat16(static_cast<float>(v)));
}

// Runs the postfix program on one entry's features. The formulas are those
// of friedrich_tpu_torch/kernels/{stationary,dot}.py `pointwise`, in the
// same order of operations. Not inlined: one copy per dtype, instead of
// one per entry of the unrolled register tile, keeps registers and build
// time down.
template <typename T>
__device__ __noinline__ T eval_program(int n_ops, const int* ops,
                                       const int* offs, const T* prm, T dot,
                                       T sq, T dist) {
  const T sqrt3 = static_cast<T>(1.7320508075688772);
  const T sqrt5 = static_cast<T>(2.23606797749979);
  T stack[MAX_OPS];
  int top = 0;
  for (int i = 0; i < n_ops; ++i) {
    const T* p = prm + offs[i];
    T v;
    switch (ops[i]) {
      case OP_ADD:
        --top;
        stack[top - 1] = stack[top - 1] + stack[top];
        continue;
      case OP_MUL:
        --top;
        stack[top - 1] = stack[top - 1] * stack[top];
        continue;
      case OP_LINEAR:
        v = dot + p[0];
        break;
      case OP_POLYNOMIAL:
        v = m_pow(p[0] * dot + p[1], p[2]);
        break;
      case OP_SQEXP:
        v = m_abs(p[1]) * m_exp(-sq / (T(2) * p[0] * p[0]));
        break;
      case OP_EXPONENTIAL:
        v = m_abs(p[1]) * m_exp(-dist / (T(2) * p[0] * p[0]));
        break;
      case OP_MATERN1: {
        const T x = sqrt3 * dist / m_abs(p[0]);
        v = m_abs(p[1]) * (T(1) + x) * m_exp(-x);
        break;
      }
      case OP_MATERN2: {
        const T l = m_abs(p[0]);
        const T x = sqrt5 * dist / l;
        v = m_abs(p[1]) * (T(1) + x + (T(5) * dist * dist) / (T(3) * l * l)) *
            m_exp(-x);
        break;
      }
      case OP_HYPERTAN:
        v = m_tanh(p[0] * dot + p[1]);
        break;
      case OP_MULTIQUADRIC:
        v = m_hypot(sq, p[0]);
        break;
      case OP_RATQUAD:
        v = m_pow(T(1) + sq / (T(2) * p[0] * p[1] * p[1]), -p[0]);
        break;
      default:
        v = static_cast<T>(NAN);  // unknown opcode: never a silent value
    }
    stack[top++] = v;
  }
  return stack[0];
}

template <typename T, int METHOD>
__global__ void __launch_bounds__(TX * TY)
    cov_kernel(const T* __restrict__ x1, const T* __restrict__ x2,
               T* __restrict__ out, int m1, int m2, int d, long long row0,
               long long n, T noise, int train, int needs,
               const __grid_constant__ CovProgram prog) {
  // gram_bf16 accumulates the bf16-rounded products in float32
  using Acc = typename std::conditional<METHOD == GRAM_BF16, float, T>::type;

  __shared__ T s1[DC][BM + 1];  // x1 tile, transposed: s1[k][row]
  __shared__ T s2[DC][BN + 1];  // x2 tile, transposed: s2[k][col]
  __shared__ T sprm[MAX_PARAMS];
  __shared__ int sops[MAX_OPS];
  __shared__ int soffs[MAX_OPS];

  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const int tid = threadIdx.x;
  const int rbase = blockIdx.y * BM;
  const int cbase = blockIdx.x * BN;

  if (tid < MAX_PARAMS) sprm[tid] = static_cast<T>(prog.params[tid]);
  if (tid < MAX_OPS) {
    sops[tid] = prog.ops[tid];
    soffs[tid] = prog.offs[tid];
  }
  __syncthreads();

  const bool need_dot = (needs & NEED_DOT) != 0;
  const bool need_sq = (needs & (NEED_SQ | NEED_DIST)) != 0;
  const bool need_dist = (needs & NEED_DIST) != 0;

  Acc acc[RM][RN];   // dot products
  T dsq[RM][RN];     // direct squared distances
  T n1[RM], n2[RN];  // squared row norms
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    n1[i] = T(0);
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      acc[i][j] = Acc(0);
      dsq[i][j] = T(0);
    }
  }
#pragma unroll
  for (int j = 0; j < RN; ++j) n2[j] = T(0);

  for (int k0 = 0; k0 < d; k0 += DC) {
    __syncthreads();  // previous pass done reading the tiles
    for (int e = tid; e < BM * DC; e += TX * TY) {
      const int r = e / DC, kk = e % DC;
      const int gr = rbase + r, gk = k0 + kk;
      s1[kk][r] = (gr < m1 && gk < d) ? x1[(long long)gr * d + gk] : T(0);
    }
    for (int e = tid; e < BN * DC; e += TX * TY) {
      const int c = e / DC, kk = e % DC;
      const int gc = cbase + c, gk = k0 + kk;
      s2[kk][c] = (gc < m2 && gk < d) ? x2[(long long)gc * d + gk] : T(0);
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < DC; ++kk) {
      T a[RM], b[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = s1[kk][ty + TY * i];
#pragma unroll
      for (int j = 0; j < RN; ++j) b[j] = s2[kk][tx + TX * j];
#pragma unroll
      for (int i = 0; i < RM; ++i) n1[i] += a[i] * a[i];
#pragma unroll
      for (int j = 0; j < RN; ++j) n2[j] += b[j] * b[j];
      if (METHOD != DIRECT || need_dot) {
        if (METHOD == GRAM_BF16) {
          float ab[RM], bb[RN];
#pragma unroll
          for (int i = 0; i < RM; ++i) ab[i] = to_bf16_float(a[i]);
#pragma unroll
          for (int j = 0; j < RN; ++j) bb[j] = to_bf16_float(b[j]);
#pragma unroll
          for (int i = 0; i < RM; ++i)
#pragma unroll
            for (int j = 0; j < RN; ++j) acc[i][j] += Acc(ab[i] * bb[j]);
        } else {
#pragma unroll
          for (int i = 0; i < RM; ++i)
#pragma unroll
            for (int j = 0; j < RN; ++j) acc[i][j] += Acc(a[i] * b[j]);
        }
      }
      if (METHOD == DIRECT && need_sq) {
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) {
            const T diff = a[i] - b[j];
            dsq[i][j] += diff * diff;
          }
      }
    }
  }
  const T noise2 = noise * noise;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = rbase + ty + TY * i;
    if (r >= m1) continue;
    const long long gr = row0 + r;
    T* orow = out + (long long)r * m2;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int c = cbase + tx + TX * j;
      if (c >= m2) continue;
      T dot = static_cast<T>(acc[i][j]);
      T sq = T(0), dist = T(0);
      if (need_sq) {
        sq = (METHOD == DIRECT) ? dsq[i][j] : m_max0(n1[i] + n2[j] - T(2) * dot);
        if (need_dist) dist = m_sqrt(sq);
      }
      // train mode: the diagonal runs the program on diagonal features
      // (sqdist = dist = 0, dot = |x|^2) and adds noise^2; entries outside
      // the live block are the identity. Cross mode: rows >= n are zero.
      const bool diag = train && gr == c;
      const bool live = gr < n && (!train || c < n);
      if (diag) {
        dot = n2[j];
        sq = T(0);
        dist = T(0);
      }
      T v = diag ? T(1) : T(0);
      if (live) {
        v = eval_program<T>(prog.n_ops, sops, soffs, sprm, dot, sq, dist);
        if (diag) v += noise2;
      }
      orow[c] = v;
    }
  }
}

template <typename T>
int launch(const T* x1, const T* x2, T* out, int m1, int m2, int d,
           long long row0, long long n, double noise, int train, int method,
           int needs, CovProgram prog, void* stream) {
  const dim3 block(TX * TY);
  const dim3 grid((m2 + BN - 1) / BN, (m1 + BM - 1) / BM);
  if (grid.y > 65535u) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T nz = static_cast<T>(noise);
  switch (method) {
    case GRAM:
      cov_kernel<T, GRAM><<<grid, block, 0, s>>>(x1, x2, out, m1, m2, d, row0,
                                                 n, nz, train, needs, prog);
      break;
    case GRAM_BF16:
      cov_kernel<T, GRAM_BF16><<<grid, block, 0, s>>>(
          x1, x2, out, m1, m2, d, row0, n, nz, train, needs, prog);
      break;
    case DIRECT:
      cov_kernel<T, DIRECT><<<grid, block, 0, s>>>(
          x1, x2, out, m1, m2, d, row0, n, nz, train, needs, prog);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success).
int friedrich_cov_f32(const float* x1, const float* x2, float* out, int m1,
                      int m2, int d, long long row0, long long n, double noise,
                      int train, int method, int needs, CovProgram prog,
                      void* stream) {
  return launch<float>(x1, x2, out, m1, m2, d, row0, n, noise, train, method,
                       needs, prog, stream);
}

int friedrich_cov_f64(const double* x1, const double* x2, double* out, int m1,
                      int m2, int d, long long row0, long long n, double noise,
                      int train, int method, int needs, CovProgram prog,
                      void* stream) {
  return launch<double>(x1, x2, out, m1, m2, d, row0, n, noise, train, method,
                        needs, prog, stream);
}

const char* friedrich_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
