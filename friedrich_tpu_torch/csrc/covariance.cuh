// Covariance-tile kernel for NVIDIA Hopper (sm_90a): the kernel template.
// covariance_f32.cu and covariance_f64.cu instantiate it, each in its own
// nvcc process; covariance.cu holds the C entry points.
//
// Replaces the Pallas TPU kernel `_cov_pallas` with its body
// `_cov_kernel_body` and feature helper `_feats_tile`
// (friedrich_tpu/ops/pallas/covariance_pallas.py:31-136). One launch builds
// one (m1, m2) block of K(X1, X2), row-major:
//
//   dot    = x1 . x2                         (gram, gram_bf16 or direct)
//   sqdist = max(|x1|^2 + |x2|^2 - 2 dot, 0) (gram) | sum (x1 - x2)^2 (direct)
//   dist   = sqrt(sqdist)
//   k      = the kernel map
//
// Train mode: entries outside the live n x n block are the identity, and
// the diagonal is the map of diagonal features (sqdist = dist = 0,
// dot = |x|^2) plus noise^2 — never the Gram tile's cancellation-prone
// value. Cross mode: rows >= n are zero. `row0` is the global index of
// x1's first row, so a launch can build any strip of rows.
//
// Bound. At the main-path shape (50,512 x 50,512 float32, d = 8) an entry
// costs 2d = 16 operations of dot product, a handful for the distance and
// the exp, against 4 bytes written: below the card's float32 balance of 20
// operations per byte (67 TFLOP/s over 3.35 TB/s). The kernel is bound by
// writing the 10.2 GB output: 3.05 ms at 3.35 TB/s. What the design does
// about it:
// - The map of a kernel that is one leaf (the main path's SquaredExp) is
//   compiled in (leaf_map, program.cuh; the template parameter MAP), its
//   constants computed once per launch on the host in float64 and held in
//   registers. A Sum/Prod tree runs the postfix interpreter of program.cuh
//   (MAP = MAP_PROGRAM), one call per entry. The JAX kernel traces each
//   tree into its own body; per-tree instantiation is later work.
// - Per entry only the dot product, the distance and the map run. The
//   squared norms are computed once per tile row and column, into shared
//   memory; the live-block and diagonal masks run only in the few tiles
//   that cross the diagonal or the live block's edge (a uniform branch),
//   whose diagonal values are mapped once per row; a tile wholly outside
//   the live block writes the identity or zeros without computing.
// - Features are staged 8 columns at a time, so d = 8 runs no padding.
// - Each thread owns 4 consecutive columns of 8 rows, and writes each row's
//   4 entries with one 16-byte streaming store (st.global.cs: the output is
//   never read back through L2); a warp writes 512 contiguous bytes of a
//   row. Masked scalar stores only at a ragged edge, or where a row is not
//   16-byte aligned (m2 % 4 != 0 in float32, odd m2 in float64).
// - One-dimensional grid of 64 x 128 tiles in row-major order: no limit on
//   the rows beyond the grid's 2^31 - 1 blocks, and consecutive blocks
//   write consecutive column tiles of the same rows.
// - Each instantiation's registers are bounded (blocks_per_sm) so that none
//   spills and three or four blocks share an SM.

#pragma once

#include <climits>
#include <type_traits>

#include "program.cuh"

// Constants of a single-leaf map (leaf_map); layout shared with
// friedrich_tpu_torch/ops/cuda/build.py (LeafConstants).
struct LeafConsts {
  double c[4];
};

// One launch's arguments.
template <typename T>
struct CovArgs {
  const T* x1;
  const T* x2;
  T* out;
  int m1, m2, d;
  long long row0, n;
  T noise;
  int train;
  int needs;  // enum Need of the interpreted program (MAP_PROGRAM only)
};

// The map of a launch: a leaf opcode (enum Op), or the interpreter.
constexpr int MAP_PROGRAM = -1;

namespace {

constexpr int BM = 64;       // rows of a tile
constexpr int BN = 128;      // columns of a tile
constexpr int TX = 32;       // threads along columns: a warp spans a row
constexpr int TY = 8;        // threads along rows
constexpr int NT = TX * TY;  // threads of a block
constexpr int RM = BM / TY;  // rows per thread: ty, ty + TY, ...
constexpr int VN = BN / TX;  // consecutive columns per thread
constexpr int DC = 8;        // feature columns staged per pass
static_assert(VN == 4, "a thread's columns are one 16-byte float32 store");

// VN consecutive values from 16-byte aligned shared memory.
template <typename T>
__device__ __forceinline__ void load_vn(const T* p, T (&v)[VN]) {
  if constexpr (std::is_same<T, float>::value) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
    const double2 q0 = reinterpret_cast<const double2*>(p)[0];
    const double2 q1 = reinterpret_cast<const double2*>(p)[1];
    v[0] = q0.x, v[1] = q0.y, v[2] = q1.x, v[3] = q1.y;
  }
}

// Writes a thread's VN consecutive entries of one row, of which `valid`
// lie inside the output: 16-byte streaming stores where the row is
// aligned and whole, masked scalar ones otherwise.
template <typename T>
__device__ __forceinline__ void store_vn(T* p, const T (&v)[VN], int valid,
                                         bool aligned) {
  if (aligned && valid >= VN) {
    if constexpr (std::is_same<T, float>::value) {
      __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
    } else {
      __stcs(reinterpret_cast<double2*>(p), make_double2(v[0], v[1]));
      __stcs(reinterpret_cast<double2*>(p) + 1, make_double2(v[2], v[3]));
    }
  } else {
#pragma unroll
    for (int j = 0; j < VN; ++j)
      if (j < valid) __stcs(p + j, v[j]);
  }
}

template <typename T, int MAP>
__device__ __forceinline__ T kernel_map(const T* leaf, const CovProgram& prog,
                                        const int* ops, const int* offs,
                                        const T* prm, T dot, T sq, T dist) {
  if constexpr (MAP == MAP_PROGRAM) {
    return eval_program<T>(prog.n_ops, ops, offs, prm, dot, sq, dist);
  } else {
    return leaf_map<MAP, T>(leaf, dot, sq, dist);
  }
}

// One block's tile; the body of both kernel entries below.
template <typename T, int METHOD, int MAP>
__device__ __forceinline__ void cov_tile(const CovArgs<T>& a, int col_tiles,
                                         const LeafConsts& consts,
                                         const CovProgram& prog) {
  // gram_bf16 accumulates the bf16-rounded products in float32
  using Acc = typename std::conditional<METHOD == GRAM_BF16, float, T>::type;
  constexpr bool PROGRAM = MAP == MAP_PROGRAM;

  __shared__ T s1[DC][BM + 4];               // x1 tile, transposed: s1[k][row]
  __shared__ __align__(16) T s2[DC][BN + 4];  // x2 tile, transposed: s2[k][col]
  __shared__ T sn1[BM];                      // squared norms of the rows
  __shared__ __align__(16) T sn2[BN];         // and of the columns
  __shared__ T sdiag[BM];  // k(x, x) + noise^2 per row, tiles on the diagonal
  __shared__ T sprm[PROGRAM ? MAX_PARAMS : 1];
  __shared__ int sops[PROGRAM ? MAX_OPS : 1];
  __shared__ int soffs[PROGRAM ? MAX_OPS : 1];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int rbase = (blockIdx.x / col_tiles) * BM;
  const int cbase = (blockIdx.x % col_tiles) * BN;
  const int rows = min(BM, a.m1 - rbase);
  const int cols = min(BN, a.m2 - cbase);
  const long long g0 = a.row0 + rbase;  // global index of the tile's first row
  const bool train = a.train != 0;
  const bool aligned = a.m2 % (16 / static_cast<int>(sizeof(T))) == 0;
  const int valid = cols - VN * tx;  // of this thread's columns
  T* const out = a.out + static_cast<long long>(rbase) * a.m2 + cbase + VN * tx;

  // The tile against the live block and the diagonal; uniform over the block.
  const bool dead = g0 >= a.n || (train && cbase >= a.n);
  const bool on_diag = train && g0 < cbase + cols && cbase < g0 + rows;
  const bool edge = on_diag || g0 + rows > a.n || (train && cbase + cols > a.n);
  if (dead) {  // the identity (train) or zero (cross): nothing to compute
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = ty + TY * i;
      T v[VN];
#pragma unroll
      for (int j = 0; j < VN; ++j)
        v[j] = (train && g0 + r == cbase + VN * tx + j) ? T(1) : T(0);
      if (r < rows) store_vn(out + static_cast<long long>(r) * a.m2, v, valid, aligned);
    }
    return;
  }

  if constexpr (PROGRAM) {  // published by the __syncthreads after the norms
    if (tid < MAX_PARAMS) sprm[tid] = static_cast<T>(prog.params[tid]);
    if (tid < MAX_OPS) {
      sops[tid] = prog.ops[tid];
      soffs[tid] = prog.offs[tid];
    }
  }
  T leaf[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) leaf[k] = static_cast<T>(consts.c[k]);

  const int needs = PROGRAM ? a.needs : leaf_needs<MAP>();
  const bool need_dot = (needs & NEED_DOT) != 0;
  const bool need_sq = (needs & (NEED_SQ | NEED_DIST)) != 0;
  const bool need_dist = (needs & NEED_DIST) != 0;
  const bool do_dot = need_dot || (METHOD != DIRECT && need_sq);
  const bool do_diff = METHOD == DIRECT && need_sq;

  Acc acc[RM][VN];  // dot products
  T dsq[RM][VN];    // direct squared distances
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < VN; ++j) {
      acc[i][j] = Acc(0);
      dsq[i][j] = T(0);
    }
  // squared norm of row tid (tid < BM) or of column tid - BM (tid < BM + BN)
  T nrm = T(0);

  for (int k0 = 0; k0 < a.d; k0 += DC) {
    if (k0 > 0) __syncthreads();  // the previous pass is done with the tiles
    for (int e = tid; e < BM * DC; e += NT) {
      const int r = e / DC, kk = e % DC, gk = k0 + kk;
      s1[kk][r] = (r < rows && gk < a.d)
                      ? __ldg(a.x1 + static_cast<long long>(rbase + r) * a.d + gk)
                      : T(0);
    }
    for (int e = tid; e < BN * DC; e += NT) {
      const int c = e / DC, kk = e % DC, gk = k0 + kk;
      s2[kk][c] = (c < cols && gk < a.d)
                      ? __ldg(a.x2 + static_cast<long long>(cbase + c) * a.d + gk)
                      : T(0);
    }
    __syncthreads();
    if (tid < BM) {
#pragma unroll
      for (int kk = 0; kk < DC; ++kk) nrm += s1[kk][tid] * s1[kk][tid];
    } else if (tid < BM + BN) {
#pragma unroll
      for (int kk = 0; kk < DC; ++kk) nrm += s2[kk][tid - BM] * s2[kk][tid - BM];
    }
#pragma unroll
    for (int kk = 0; kk < DC; ++kk) {
      T x[RM], y[VN];
#pragma unroll
      for (int i = 0; i < RM; ++i) x[i] = s1[kk][ty + TY * i];
      load_vn(&s2[kk][VN * tx], y);
      if (do_dot) {
        if constexpr (METHOD == GRAM_BF16) {
          float xb[RM], yb[VN];
#pragma unroll
          for (int i = 0; i < RM; ++i) xb[i] = to_bf16_float(x[i]);
#pragma unroll
          for (int j = 0; j < VN; ++j) yb[j] = to_bf16_float(y[j]);
#pragma unroll
          for (int i = 0; i < RM; ++i)
#pragma unroll
            for (int j = 0; j < VN; ++j) acc[i][j] += xb[i] * yb[j];
        } else {
#pragma unroll
          for (int i = 0; i < RM; ++i)
#pragma unroll
            for (int j = 0; j < VN; ++j) acc[i][j] += x[i] * y[j];
        }
      }
      if (do_diff) {
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < VN; ++j) {
            const T diff = x[i] - y[j];
            dsq[i][j] += diff * diff;
          }
      }
    }
  }

  const T noise2 = a.noise * a.noise;
  if (tid < BM) {
    sn1[tid] = nrm;
    if (on_diag)
      sdiag[tid] = kernel_map<T, MAP>(leaf, prog, sops, soffs, sprm, nrm, T(0), T(0)) + noise2;
  } else if (tid < BM + BN) {
    sn2[tid - BM] = nrm;
  }
  __syncthreads();

  T n2[VN];
  load_vn(&sn2[VN * tx], n2);
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = ty + TY * i;
    const T n1 = sn1[r];
    T v[VN];
#pragma unroll
    for (int j = 0; j < VN; ++j) {
      const T dot = static_cast<T>(acc[i][j]);
      T sq = T(0), dist = T(0);
      if (need_sq) {
        sq = (METHOD == DIRECT) ? dsq[i][j] : m_max0(n1 + n2[j] - T(2) * dot);
        if (need_dist) dist = m_sqrt(sq);
      }
      v[j] = kernel_map<T, MAP>(leaf, prog, sops, soffs, sprm, dot, sq, dist);
    }
    if (edge) {  // train: the diagonal, identity outside the live block;
                 // cross: zero rows outside it
      const long long gr = g0 + r;
#pragma unroll
      for (int j = 0; j < VN; ++j) {
        const int c = cbase + VN * tx + j;
        const bool diag = train && gr == c;
        const bool live = gr < a.n && (!train || c < a.n);
        v[j] = live ? (diag ? sdiag[r] : v[j]) : (diag ? T(1) : T(0));
      }
    }
    if (r < rows) store_vn(out + static_cast<long long>(r) * a.m2, v, valid, aligned);
  }
}

// Blocks each SM must hold, which caps ptxas's registers a thread: 4 (64
// registers) for a float32 leaf map that takes no square root, 3 (80) for
// the other float32 leaf maps and the interpreter under gram, and no bound
// (0) for the rest: float64, and the float32 interpreter under gram_bf16
// and direct, which spill within 80 (up to 252 registers unbounded). Left
// to itself, ptxas gives some float32 leaf maps 64 registers and spills
// around the calls to sqrtf's slow path (<float, DIRECT, OP_MULTIQUADRIC>),
// and the interpreter 82, which fits only two blocks on an SM and costs it
// a third more time; within 64 the maps that take a square root spill. Any
// explicit bound changes ptxas's choice, hence none where none is needed.
template <typename T, int METHOD, int MAP>
constexpr int blocks_per_sm() {
  if (!std::is_same<T, float>::value) return 0;
  if (MAP == MAP_PROGRAM) return METHOD == GRAM ? 3 : 0;
  const bool takes_sqrt = (leaf_needs<MAP>() & NEED_DIST) || MAP == OP_MULTIQUADRIC;
  return takes_sqrt ? 3 : 4;
}

template <typename T, int METHOD, int MAP, int BLOCKS>
__global__ void __launch_bounds__(NT, BLOCKS)
    cov_kernel_bounded(const CovArgs<T> a, int col_tiles,
                       const LeafConsts consts,
                       const __grid_constant__ CovProgram prog) {
  cov_tile<T, METHOD, MAP>(a, col_tiles, consts, prog);
}

template <typename T, int METHOD, int MAP>
__global__ void __launch_bounds__(NT)
    cov_kernel(const CovArgs<T> a, int col_tiles, const LeafConsts consts,
               const __grid_constant__ CovProgram prog) {
  cov_tile<T, METHOD, MAP>(a, col_tiles, consts, prog);
}

template <typename T, int METHOD, int MAP>
int launch_map(const CovArgs<T>& a, const LeafConsts& consts,
               const CovProgram& prog, cudaStream_t stream) {
  const long long col_tiles = (a.m2 + BN - 1) / BN;
  const long long tiles = col_tiles * ((a.m1 + BM - 1) / BM);
  if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(tiles));
  constexpr int blocks = blocks_per_sm<T, METHOD, MAP>();
  if constexpr (blocks > 0) {
    cov_kernel_bounded<T, METHOD, MAP, blocks><<<grid, NT, 0, stream>>>(
        a, static_cast<int>(col_tiles), consts, prog);
  } else {
    cov_kernel<T, METHOD, MAP><<<grid, NT, 0, stream>>>(
        a, static_cast<int>(col_tiles), consts, prog);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

namespace friedrich {

// Launches the instantiation of one dtype and method for `map`; returns the
// launch's cudaError_t. Instantiated by covariance_f32.cu / _f64.cu.
template <typename T, int METHOD>
int launch_method(const CovArgs<T>& a, int map, const LeafConsts& consts,
                  const CovProgram& prog, cudaStream_t stream) {
  switch (map) {
    case OP_LINEAR: return launch_map<T, METHOD, OP_LINEAR>(a, consts, prog, stream);
    case OP_POLYNOMIAL: return launch_map<T, METHOD, OP_POLYNOMIAL>(a, consts, prog, stream);
    case OP_SQEXP: return launch_map<T, METHOD, OP_SQEXP>(a, consts, prog, stream);
    case OP_EXPONENTIAL: return launch_map<T, METHOD, OP_EXPONENTIAL>(a, consts, prog, stream);
    case OP_MATERN1: return launch_map<T, METHOD, OP_MATERN1>(a, consts, prog, stream);
    case OP_MATERN2: return launch_map<T, METHOD, OP_MATERN2>(a, consts, prog, stream);
    case OP_HYPERTAN: return launch_map<T, METHOD, OP_HYPERTAN>(a, consts, prog, stream);
    case OP_MULTIQUADRIC: return launch_map<T, METHOD, OP_MULTIQUADRIC>(a, consts, prog, stream);
    case OP_RATQUAD: return launch_map<T, METHOD, OP_RATQUAD>(a, consts, prog, stream);
    case MAP_PROGRAM: return launch_map<T, METHOD, MAP_PROGRAM>(a, consts, prog, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace friedrich
