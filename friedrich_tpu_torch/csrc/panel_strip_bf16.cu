// C entry point of the panel-strip kernel (panel_strip.cuh) with a bfloat16
// prefix and float32 inputs and strip: the factor storage "bf16", multiplied
// by the warp-specialized bf16 wgmma kernel (FEED_BF16).

#include "panel_strip.cuh"

extern "C" {

// As friedrich_panel_strip_f32 (panel_strip.cu), with `la` and `lb` rows of
// a bfloat16 factor (their raw 16-bit patterns), `ldl` and `ldb` in
// elements.
int friedrich_panel_strip_bf16(const float* x1, const float* x2,
                               const uint16_t* la, const uint16_t* lb, float* out,
                               int m1, int m2, int d, long long ldl, long long ldb,
                               int kdim,
                               long long row0, long long col0, long long n,
                               double noise, int method, int needs,
                               CovProgram prog, void* stream) {
  return launch_ws<FEED_BF16>(x1, x2, la, lb, nullptr, out, m1, m2, d, ldl, ldb, kdim, row0, col0, n,
                              noise, method, needs, prog, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
