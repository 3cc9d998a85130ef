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
// The kernel map runs as a postfix program: see program.cuh.
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

#include <type_traits>

#include "program.cuh"

namespace {

constexpr int BM = 64;    // rows of a block tile
constexpr int BN = 128;   // columns of a block tile
constexpr int TX = 32;    // threads along columns (one warp)
constexpr int TY = 8;     // threads along rows
constexpr int RM = BM / TY;  // rows per thread
constexpr int RN = BN / TX;  // columns per thread
constexpr int DC = 16;    // feature columns staged per pass

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
