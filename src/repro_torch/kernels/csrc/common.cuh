// Shared helpers for the port's CUDA kernels: storage-type decode/encode
// through the CUDA intrinsics, the C export macro, and the error-string
// export every library carries (each library is built from one .cu file).
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

REPRO_EXPORT const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
