// C entry point of the panel-strip kernel (panel_strip.cuh) in float32 with
// one TF32 product of bfloat16-rounded operands: the factor precision
// "bf16".

#include "panel_strip.cuh"

extern "C" {

// As friedrich_panel_strip_f32 (panel_strip.cu), one pass.
int friedrich_panel_strip_f32_1pass(const float* x1, const float* x2,
                                    const float* la, const float* lb, float* out,
                                    int m1, int m2, int d, long long ldl, int kdim,
                                    long long row0, long long col0, long long n,
                                    double noise, int method, int needs,
                                    CovProgram prog, void* stream) {
  return launch_tc<MODE_ONE_PASS>(x1, x2, la, lb, out, m1, m2, d, ldl, kdim, row0, col0, n,
                                  noise, method, needs, prog, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
