// Panel-strip kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fused_panel_strip_impl` with its body
// `_fused_body` (friedrich_tpu/ops/pallas/panel_fused.py:51-177). For the
// panel at column offset j0 and width B of the left-looking streamed
// Cholesky (friedrich_tpu_torch/ops/streamed.py), one launch writes the
// (cap - j0, B) pre-factor strip
//
//   S = K(X[j0:], X[j0:j0+B])  -  L[j0:, :j0] . L[j0:j0+B, :j0]^T
//
// where K is the padded training covariance: the kernel map (program.cuh),
// the analytic diagonal k(x, x) + noise^2 from diagonal features
// (sqdist = dist = 0, dot = |x|^2), and the identity outside the live
// n x n block, decided from the global indices row0 + i and col0 + j.
//
// Design. One 256-thread block per 128 x 128 output tile, an 8 x 8
// register tile per thread. The downdate loops over the factored prefix
// in slabs of 8 columns: each slab of L[j0 + rows, k] and L[j0 + cols, k]
// is read straight out of the full factor through its row stride (no
// slice copies), staged transposed in shared memory (double-buffered,
// the next slab's loads in flight while the current one is multiplied),
// and accumulated in registers in the input dtype. The epilogue computes
// the features of each entry from the inputs, runs the kernel map, and
// writes `map - acc` once. Rows, columns and the contraction have masked
// ragged edges, so any capacity, offset and width is one launch; j0 = 0 is
// the same kernel with an empty loop. No TF32 and no tensor cores: the
// product keeps full input precision, as the plain version's does.
//
// Bound. Per launch the downdate is 2 (cap - j0) B j0 operations against
// ((cap - j0) j0 + B j0 + (cap - j0) B) elements moved: for every panel
// with j0 > 0 at the main-path shapes (cap 100,512, B ~ 6,000, float32)
// that is thousands of operations per byte, far above the card's float32
// balance of 20 FLOP/byte (67 TFLOP/s over 3.35 TB/s). The kernel is bound
// by float32 FMA throughput; summed over a factorization the downdates are
// about cap^3 / 3 operations, 5.1 s at 67 TFLOP/s for cap 100,512.
// What the design does about it: 64 independent FMAs per thread for every
// 4 vector loads from shared memory, conflict-free transposed stores, and
// global loads overlapped with the multiply. Tensor cores (3xTF32 or
// wgmma), TMA and a persistent schedule are later work.

#include "program.cuh"

namespace {

constexpr int PBM = 128;               // rows of an output tile
constexpr int PBN = 128;               // columns of an output tile
constexpr int PTX = 16;                // threads along columns
constexpr int PTY = 16;                // threads along rows
constexpr int PRM = PBM / PTY;         // rows per thread (8)
constexpr int PRN = PBN / PTX;         // columns per thread (8)
constexpr int PTK = 8;                 // contraction slab
constexpr int PPAD = 4;                // keeps the transposed stores conflict-free
constexpr int NTHREADS = PTX * PTY;
constexpr int A_LOADS = PBM * PTK / NTHREADS;  // slab elements per thread
constexpr int B_LOADS = PBN * PTK / NTHREADS;

static_assert(PRM == 8 && PRN == 8, "load8 reads eight consecutive values");

template <typename T>
struct MinBlocks {
  static constexpr int value = sizeof(T) == 4 ? 2 : 1;
};

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const double* p, double (&v)[8]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const double2 a = *reinterpret_cast<const double2*>(p + 2 * q);
    v[2 * q] = a.x;
    v[2 * q + 1] = a.y;
  }
}

// Features of one (row, column) entry, as ops/distance.py computes them:
// gram: max(|a|^2 + |b|^2 - 2 a.b, 0); gram_bf16: the same with a.b from
// bfloat16-rounded products accumulated in float32; direct: sum (a - b)^2.
template <typename T, int METHOD>
__device__ __forceinline__ void entry_features(const T* __restrict__ a,
                                               const T* __restrict__ b, int d,
                                               bool need_sq, bool need_dist,
                                               T& dot, T& sq, T& dist) {
  T na = T(0), nb = T(0), dd = T(0), dsq = T(0);
  float dbf = 0.0f;
  for (int k = 0; k < d; ++k) {
    const T av = __ldg(a + k);
    const T bv = __ldg(b + k);
    if (METHOD == DIRECT) {
      const T diff = av - bv;
      dsq += diff * diff;
      dd += av * bv;
    } else {
      na += av * av;
      nb += bv * bv;
      if (METHOD == GRAM_BF16) {
        dbf += to_bf16_float(av) * to_bf16_float(bv);
      } else {
        dd += av * bv;
      }
    }
  }
  if (METHOD == GRAM_BF16) dd = static_cast<T>(dbf);
  dot = dd;
  sq = T(0);
  dist = T(0);
  if (need_sq) {
    sq = (METHOD == DIRECT) ? dsq : m_max0(na + nb - T(2) * dd);
    if (need_dist) dist = m_sqrt(sq);
  }
}

template <typename T, int METHOD>
__global__ void __launch_bounds__(NTHREADS, MinBlocks<T>::value)
    panel_strip_kernel(const T* __restrict__ x1, const T* __restrict__ x2,
                       const T* __restrict__ la, const T* __restrict__ lb,
                       T* __restrict__ out, int m1, int m2, int d,
                       long long ldl, int kdim, long long row0, long long col0,
                       long long n, T noise, int needs,
                       const __grid_constant__ CovProgram prog) {
  __shared__ __align__(16) T sa[2][PTK][PBM + PPAD];  // L[rows, k], transposed
  __shared__ __align__(16) T sb[2][PTK][PBN + PPAD];  // L[cols, k], transposed
  __shared__ T sprm[MAX_PARAMS];
  __shared__ int sops[MAX_OPS];
  __shared__ int soffs[MAX_OPS];

  const int tid = threadIdx.x;
  const int tx = tid % PTX;
  const int ty = tid / PTX;
  const int rbase = blockIdx.y * PBM;
  const int cbase = blockIdx.x * PBN;

  if (tid < MAX_PARAMS) sprm[tid] = static_cast<T>(prog.params[tid]);
  if (tid < MAX_OPS) {
    sops[tid] = prog.ops[tid];
    soffs[tid] = prog.offs[tid];
  }

  T acc[PRM][PRN];
#pragma unroll
  for (int i = 0; i < PRM; ++i)
#pragma unroll
    for (int j = 0; j < PRN; ++j) acc[i][j] = T(0);

  // Slab loads: element e of a (rows x PTK) slab is row e / PTK, column
  // e % PTK, so a warp reads 4 rows of 8 consecutive values.
  T pa[A_LOADS], pb[B_LOADS];
  auto load_slab = [&](int k0) {
#pragma unroll
    for (int q = 0; q < A_LOADS; ++q) {
      const int e = tid + q * NTHREADS;
      const int r = rbase + e / PTK, k = k0 + e % PTK;
      pa[q] = (r < m1 && k < kdim) ? la[(long long)r * ldl + k] : T(0);
    }
#pragma unroll
    for (int q = 0; q < B_LOADS; ++q) {
      const int e = tid + q * NTHREADS;
      const int c = cbase + e / PTK, k = k0 + e % PTK;
      pb[q] = (c < m2 && k < kdim) ? lb[(long long)c * ldl + k] : T(0);
    }
  };
  auto store_slab = [&](int buf) {
#pragma unroll
    for (int q = 0; q < A_LOADS; ++q) {
      const int e = tid + q * NTHREADS;
      sa[buf][e % PTK][e / PTK] = pa[q];
    }
#pragma unroll
    for (int q = 0; q < B_LOADS; ++q) {
      const int e = tid + q * NTHREADS;
      sb[buf][e % PTK][e / PTK] = pb[q];
    }
  };

  if (kdim > 0) {
    load_slab(0);
    store_slab(0);
  }
  __syncthreads();  // the slab and the program are in shared memory

  int buf = 0;
  for (int k0 = 0; k0 < kdim; k0 += PTK) {
    const bool more = k0 + PTK < kdim;
    if (more) load_slab(k0 + PTK);  // in flight during the multiply
#pragma unroll
    for (int kk = 0; kk < PTK; ++kk) {
      T a[PRM], b[PRN];
      load8(&sa[buf][kk][ty * PRM], a);
      load8(&sb[buf][kk][tx * PRN], b);
#pragma unroll
      for (int i = 0; i < PRM; ++i)
#pragma unroll
        for (int j = 0; j < PRN; ++j) acc[i][j] += a[i] * b[j];
    }
    if (more) store_slab(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }

  const bool need_sq = (needs & (NEED_SQ | NEED_DIST)) != 0;
  const bool need_dist = (needs & NEED_DIST) != 0;
  const T noise2 = noise * noise;
#pragma unroll
  for (int i = 0; i < PRM; ++i) {
    const int r = rbase + ty * PRM + i;
    if (r >= m1) continue;
    const long long gr = row0 + r;
    const T* xr = x1 + (long long)r * d;
    T* orow = out + (long long)r * m2;
#pragma unroll
    for (int j = 0; j < PRN; ++j) {
      const int c = cbase + tx * PRN + j;
      if (c >= m2) continue;
      const long long gc = col0 + c;
      const T* xc = x2 + (long long)c * d;
      const bool diag = gr == gc;
      T v = diag ? T(1) : T(0);
      if (gr < n && gc < n) {
        T dot, sq, dist;
        if (diag) {
          // diagonal features: dot = |x|^2, sqdist = dist = 0
          T nc = T(0);
          for (int k = 0; k < d; ++k) nc += __ldg(xc + k) * __ldg(xc + k);
          dot = nc;
          sq = T(0);
          dist = T(0);
        } else {
          entry_features<T, METHOD>(xr, xc, d, need_sq, need_dist, dot, sq,
                                    dist);
        }
        v = eval_program<T>(prog.n_ops, sops, soffs, sprm, dot, sq, dist);
        if (diag) v += noise2;
      }
      orow[c] = v - acc[i][j];
    }
  }
}

template <typename T>
int launch(const T* x1, const T* x2, const T* la, const T* lb, T* out, int m1,
           int m2, int d, long long ldl, int kdim, long long row0,
           long long col0, long long n, double noise, int method, int needs,
           CovProgram prog, void* stream) {
  const dim3 block(NTHREADS);
  const dim3 grid((m2 + PBN - 1) / PBN, (m1 + PBM - 1) / PBM);
  if (grid.y > 65535u) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T nz = static_cast<T>(noise);
  switch (method) {
    case GRAM:
      panel_strip_kernel<T, GRAM><<<grid, block, 0, s>>>(
          x1, x2, la, lb, out, m1, m2, d, ldl, kdim, row0, col0, n, nz, needs,
          prog);
      break;
    case GRAM_BF16:
      panel_strip_kernel<T, GRAM_BF16><<<grid, block, 0, s>>>(
          x1, x2, la, lb, out, m1, m2, d, ldl, kdim, row0, col0, n, nz, needs,
          prog);
      break;
    case DIRECT:
      panel_strip_kernel<T, DIRECT><<<grid, block, 0, s>>>(
          x1, x2, la, lb, out, m1, m2, d, ldl, kdim, row0, col0, n, nz, needs,
          prog);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// `x1` (m1, d) are the strip's rows, `x2` (m2, d) its columns; `la` and
// `lb` point at the first of m1 and m2 factor rows (row stride `ldl`),
// whose first `kdim` columns are the factored prefix. `row0` and `col0` are
// the global indices of the first row and column. Returns the cudaError_t
// of the launch (0 on success).
int friedrich_panel_strip_f32(const float* x1, const float* x2,
                              const float* la, const float* lb, float* out,
                              int m1, int m2, int d, long long ldl, int kdim,
                              long long row0, long long col0, long long n,
                              double noise, int method, int needs,
                              CovProgram prog, void* stream) {
  return launch<float>(x1, x2, la, lb, out, m1, m2, d, ldl, kdim, row0, col0,
                       n, noise, method, needs, prog, stream);
}

int friedrich_panel_strip_f64(const double* x1, const double* x2,
                              const double* la, const double* lb, double* out,
                              int m1, int m2, int d, long long ldl, int kdim,
                              long long row0, long long col0, long long n,
                              double noise, int method, int needs,
                              CovProgram prog, void* stream) {
  return launch<double>(x1, x2, la, lb, out, m1, m2, d, ldl, kdim, row0, col0,
                        n, noise, method, needs, prog, stream);
}

}  // extern "C"
