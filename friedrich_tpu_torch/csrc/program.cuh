// The kernel-map interpreter shared by the hand-written CUDA kernels
// (covariance.cuh, panel_strip.cu), and the compiled-in map of a single
// leaf (leaf_map, the covariance kernel's).
//
// The Pallas bodies re-traced the kernel's pointwise map for every Sum/Prod
// tree. Here the host encodes the tree into a postfix program (one opcode
// per leaf kernel, ADD and MUL; at most 16 nodes and 32 parameters) passed
// by value in the launch, and every thread runs the same program on its
// entries, so one compiled kernel serves every composition without
// divergence.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define MAX_OPS 16
#define MAX_PARAMS 32

// Layout shared with friedrich_tpu_torch/ops/cuda/build.py (Program).
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
// same order of operations. Inlined where it is called once, in a rolled
// loop; see eval_program for unrolled register tiles.
template <typename T>
__device__ __forceinline__ T run_program(int n_ops, const int* ops,
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

// run_program, not inlined: one copy per dtype, instead of one per entry of
// an unrolled register tile, keeps registers and build time down.
template <typename T>
__device__ __noinline__ T eval_program(int n_ops, const int* ops,
                                       const int* offs, const T* prm, T dot,
                                       T sq, T dist) {
  return run_program<T>(n_ops, ops, offs, prm, dot, sq, dist);
}

// The map of a kernel that is a single leaf, compiled into the covariance
// kernel (covariance.cuh) instead of interpreted. The formulas of
// run_program in the same order of operations, except that each quotient
// of parameters is one constant c[], computed once per launch on the host
// in float64 (ops/cuda/build.py: leaf_constants):
//   SQEXP, EXPONENTIAL  c = (|ampl|, -1 / (2 ls^2))
//   MATERN1             c = (|ampl|, sqrt(3) / |ls|)
//   MATERN2             c = (|ampl|, sqrt(5) / |ls|, 5 / (3 ls^2))
//   RATQUAD             c = (-alpha, 1 / (2 alpha ls^2))
//   the others          c = their parameters, in PARAM_FIELDS order.
template <int OP, typename T>
__device__ __forceinline__ T leaf_map(const T* c, T dot, T sq, T dist) {
  if constexpr (OP == OP_LINEAR) {
    return dot + c[0];
  } else if constexpr (OP == OP_POLYNOMIAL) {
    return m_pow(c[0] * dot + c[1], c[2]);
  } else if constexpr (OP == OP_SQEXP) {
    return c[0] * m_exp(sq * c[1]);
  } else if constexpr (OP == OP_EXPONENTIAL) {
    return c[0] * m_exp(dist * c[1]);
  } else if constexpr (OP == OP_MATERN1) {
    const T x = dist * c[1];
    return c[0] * (T(1) + x) * m_exp(-x);
  } else if constexpr (OP == OP_MATERN2) {
    const T x = dist * c[1];
    return c[0] * (T(1) + x + dist * dist * c[2]) * m_exp(-x);
  } else if constexpr (OP == OP_HYPERTAN) {
    return m_tanh(c[0] * dot + c[1]);
  } else if constexpr (OP == OP_MULTIQUADRIC) {
    return m_hypot(sq, c[0]);
  } else {
    static_assert(OP == OP_RATQUAD, "leaf_map takes a leaf opcode");
    return m_pow(T(1) + sq * c[1], c[0]);
  }
}

// The features leaf_map<OP> reads (enum Need).
template <int OP>
__host__ __device__ constexpr int leaf_needs() {
  return (OP == OP_LINEAR || OP == OP_POLYNOMIAL || OP == OP_HYPERTAN) ? NEED_DOT
         : (OP == OP_SQEXP || OP == OP_MULTIQUADRIC || OP == OP_RATQUAD)
             ? NEED_SQ
             : NEED_SQ | NEED_DIST;
}

}  // namespace
