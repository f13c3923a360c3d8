// The smm_kernel lane's layer epilogue, one definition for the two kernels
// that apply it: int8_features.cu's epilogue pass over smm_conv's output,
// and smm_conv_sm90.cu's store, which applies it as it writes.  Both give
// the numbers of int8_features/ref.py's epilogue_plain bit for bit:
//
//   s   = float32(layer_scale * x_scale), the product taken in double as
//         the host takes it;
//   out = y * s, then + bias[m] where there is a bias, each rounded on its
//         own (no FMA), then ReLU where asked, which keeps a NaN
//         (torch.relu).
//
// Included by name: kernels/_build.py puts this directory on nvcc's
// include path and keys each library by its source and this header.

#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float epilogue_scale(double layer_scale,
                                                const float* x_scale) {
  return (float)(layer_scale * (double)*x_scale);
}

__device__ __forceinline__ float finish(float v, float s, const float* bias,
                                        float add, int relu) {
  v = __fmul_rn(v, s);
  if (bias != nullptr) v = __fadd_rn(v, add);
  // torch.relu: NaN stays NaN, else max(v, 0)
  return (relu && !isnan(v)) ? fmaxf(v, 0.0f) : v;
}

}  // namespace
