// C entry point of the panel-strip kernel (panel_strip.cuh) in float32
// under the factor precision "bf16": the operands rounded to bfloat16 and
// multiplied by the warp-specialized bf16 wgmma kernel (FEED_F32).

#include "panel_strip.cuh"

extern "C" {

// As friedrich_panel_strip_f32 (panel_strip.cu), with `scratch` a buffer of
// m2 rows of round_up(kdim, 8) bfloat16 (16-byte aligned) that takes the
// panel's m2 rows rounded to bfloat16 (unused when kdim is 0).
int friedrich_panel_strip_f32_1pass(const float* x1, const float* x2,
                                    const float* la, const float* lb, void* scratch, float* out,
                                    int m1, int m2, int d, long long ldl, long long ldb,
                                    int kdim,
                                    long long row0, long long col0, long long n,
                                    double noise, int method, int needs,
                                    CovProgram prog, void* stream) {
  return launch_ws<FEED_F32>(x1, x2, la, lb, scratch, out, m1, m2, d, ldl, ldb, kdim, row0, col0, n,
                             noise, method, needs, prog, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
