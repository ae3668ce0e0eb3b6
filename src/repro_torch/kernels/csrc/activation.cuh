// Activation codes shared by the kernels' f32 epilogues, and the dtype
// conversions they use.  Codes (kernels/matmul.py ACTIVATIONS): 0 none,
// 1 relu, 2 silu, 3 gelu (tanh approximation, as jax.nn.gelu), 4 tanh,
// 5 sigmoid.
#pragma once
#include <cuda_bf16.h>

namespace repro_torch {

__device__ __forceinline__ float activate(float x, int act) {
  switch (act) {
    case 1: return fmaxf(x, 0.f);
    case 2: return x / (1.f + expf(-x));
    case 3: {
      const float c = 0.7978845608028654f;   // sqrt(2 / pi)
      return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
    }
    case 4: return tanhf(x);
    case 5: return 1.f / (1.f + expf(-x));
    default: return x;
  }
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

}  // namespace repro_torch
