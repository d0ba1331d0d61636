// Dense pair-based STDP weight update for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/stdp_update.py
// (stdp_update -> _stdp_kernel): for every cell of a [P, Q] weight block,
//   w' = clip((w + a+ * (pre_t[p] * post_s[q])) - a- * (pre_s[p] * post_t[q]),
//             w_min, w_max)
// then +0.0 where the mask is false, stored back in the storage type.
//
// What bounds it: bytes, then launch latency. Per cell it reads the weight
// (2 B fp16, 4 B f32) and the mask byte and writes the weight: 5 B per cell
// at fp16, 40,000 cells at Synfire4's [200, 200] chain blocks, about
// 0.06 us at 3.35 TB/s, so a launch (a few microseconds) dominates. The
// design is the leanest launch: one thread per cell, consecutive threads on
// consecutive q (coalesced weight and mask rows); the four per-neuron
// operands are read through the read-only cache.
//
// Rounding: every multiply, add and subtract is spelled with __fmul_rn /
// __fadd_rn / __fsub_rn in the plain version's association
// (kernels/ref.py:stdp_update_ref), which nvcc never contracts into an FMA;
// the clip is fminf(fmaxf(.)) and the mask writes +0.0. The coefficients
// arrive as float, the f32 rounding of the configuration's doubles, as the
// plain version applies them. The kernel is therefore bit for bit equal to
// its plain version on the CPU and on the card.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float stdp_cell(float w, float pre_t, float pre_s, float post_t,
                                           float post_s, float a_plus, float a_minus,
                                           float w_min, float w_max) {
  const float ltp = __fmul_rn(a_plus, __fmul_rn(pre_t, post_s));
  const float ltd = __fmul_rn(a_minus, __fmul_rn(pre_s, post_t));
  return fminf(fmaxf(__fsub_rn(__fadd_rn(w, ltp), ltd), w_min), w_max);
}

template <typename T>
__global__ void stdp_update_kernel(const T* __restrict__ w, const uint8_t* __restrict__ mask,
                                   const float* __restrict__ pre_t,
                                   const float* __restrict__ post_t,
                                   const float* __restrict__ pre_s,
                                   const float* __restrict__ post_s, T* __restrict__ out,
                                   int P, int Q, float a_plus, float a_minus, float w_min,
                                   float w_max) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(P) * Q) return;
  const int p = static_cast<int>(i / Q);
  const int q = static_cast<int>(i - static_cast<long long>(p) * Q);
  const float v = stdp_cell(to_f32(w[i]), __ldg(pre_t + p), __ldg(pre_s + p),
                            __ldg(post_t + q), __ldg(post_s + q), a_plus, a_minus,
                            w_min, w_max);
  out[i] = from_f32<T>(mask[i] ? v : 0.0f);
}

template <typename T>
int launch(const void* w, const void* mask, const void* pre_t, const void* post_t,
           const void* pre_s, const void* post_s, void* out, int P, int Q, float a_plus,
           float a_minus, float w_min, float w_max, void* stream) {
  const long long cells = static_cast<long long>(P) * Q;
  if (cells <= 0) return 0;
  const long long blocks = (cells + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  stdp_update_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(w), static_cast<const uint8_t*>(mask),
      static_cast<const float*>(pre_t), static_cast<const float*>(post_t),
      static_cast<const float*>(pre_s), static_cast<const float*>(post_s),
      static_cast<T*>(out), P, Q, a_plus, a_minus, w_min, w_max);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define REPRO_STDP_UPDATE(NAME, T)                                                     \
  REPRO_EXPORT int NAME(const void* w, const void* mask, const void* pre_t,           \
                        const void* post_t, const void* pre_s, const void* post_s,    \
                        void* out, int P, int Q, float a_plus, float a_minus,         \
                        float w_min, float w_max, void* stream) {                     \
    return launch<T>(w, mask, pre_t, post_t, pre_s, post_s, out, P, Q, a_plus,        \
                     a_minus, w_min, w_max, stream);                                  \
  }

REPRO_STDP_UPDATE(stdp_update_f32, float)
REPRO_STDP_UPDATE(stdp_update_f16, __half)
