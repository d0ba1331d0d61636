// Shared helpers for the port's CUDA kernels: storage-type decode/encode
// through the CUDA intrinsics, the IZH4 update with its rounding pinned, the
// C export macro, and the error-string export every library carries (each
// library is built from one .cu file).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);  // round to nearest even, as torch's .to(float16)
}

// One IZH4 tick of one neuron: `substeps` Euler steps, each taking (dv, du)
// from the same (v, u), then spike at v >= 30 and reset v <- c, u <- u + d.
// Updates v and u and returns the spike flag. Every multiply, add and
// subtract goes through __fmul_rn / __fadd_rn / __fsub_rn in the reference's
// term order, which nvcc never contracts into an FMA, so the result rounds
// exactly as eager PyTorch (kernels/ref.py:izh4_ref) does on the CPU and the
// card. izh4_update and fused_tick both call it, so they round identically.
__device__ __forceinline__ bool izh4_tick(float& v, float& u, float cur, float a,
                                          float b, float c, float d, float h,
                                          int substeps) {
  for (int s = 0; s < substeps; ++s) {
    // dv = 0.04*v*v + 5.0*v + 140.0 - u + i_syn, left to right
    const float dv = __fadd_rn(
        __fsub_rn(__fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(0.04f, v), v),
                                      __fmul_rn(5.0f, v)),
                            140.0f),
                  u),
        cur);
    // du = a*(b*v - u)
    const float du = __fmul_rn(a, __fsub_rn(__fmul_rn(b, v), u));
    v = __fadd_rn(v, __fmul_rn(h, dv));
    u = __fadd_rn(u, __fmul_rn(h, du));
  }
  const bool spk = v >= 30.0f;
  if (spk) {
    v = c;
    u = __fadd_rn(u, d);
  }
  return spk;
}

REPRO_EXPORT const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
