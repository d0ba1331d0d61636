// Pair-based STDP on CSR fan-in rows for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/stdp_gather.py
// (stdp_gather -> _stdp_gather_kernel): for every cell (q, k) of the
// [Q, F] fan-in rows, with j = idx[q, k],
//   w' = clip((w + a+ * (pre_t[j] * post_s[q])) - a- * (pre_s[j] * post_t[q]),
//             w_min, w_max)
// then +0.0 where valid is false, stored back in the storage type. idx is
// int16 or int32; padded cells carry index 0 and valid false.
//
// What bounds it: bytes, then launch latency. Per cell it reads the weight,
// the index and the validity byte and writes the weight: 7 B per cell at
// fp16 with int16 indices (Synfire4 sparse: Q = 200, F about 80, 16,000
// cells, about 0.03 us at 3.35 TB/s; Synfire4x10: Q = 2,000, F about 90,
// about 1.3 MB, 0.4 us), so a launch dominates at these sizes. One thread
// per cell, consecutive threads along a row (coalesced weight, index and
// validity rows); the gathered pre traces and spikes (P floats each) are
// read through the read-only cache, with no shared-memory staging and so
// no limit on P.
//
// Rounding: as in stdp_update.cu, every multiply, add and subtract is
// __fmul_rn / __fadd_rn / __fsub_rn in the plain version's association
// (kernels/ref.py:stdp_gather_ref), the clip fminf(fmaxf(.)), the mask
// +0.0: bit for bit equal to the plain version. An index outside [0, P)
// writes NaN, so a corrupt table shows in the weights instead of reading
// out of bounds (the plain version raises).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename I, typename T>
__global__ void stdp_gather_kernel(const T* __restrict__ w, const I* __restrict__ idx,
                                   const uint8_t* __restrict__ valid,
                                   const float* __restrict__ pre_t,
                                   const float* __restrict__ post_t,
                                   const float* __restrict__ pre_s,
                                   const float* __restrict__ post_s, T* __restrict__ out,
                                   int P, int Q, int F, float a_plus, float a_minus,
                                   float w_min, float w_max) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(Q) * F) return;
  const int q = static_cast<int>(i / F);
  const int j = static_cast<int>(idx[i]);
  float v;
  if (j < 0 || j >= P) {
    v = __int_as_float(0x7fc00000);
  } else {
    const float ltp = __fmul_rn(a_plus, __fmul_rn(__ldg(pre_t + j), __ldg(post_s + q)));
    const float ltd = __fmul_rn(a_minus, __fmul_rn(__ldg(pre_s + j), __ldg(post_t + q)));
    v = fminf(fmaxf(__fsub_rn(__fadd_rn(to_f32(w[i]), ltp), ltd), w_min), w_max);
    if (!valid[i]) v = 0.0f;
  }
  out[i] = from_f32<T>(v);
}

template <typename I, typename T>
int launch(const void* w, const void* idx, const void* valid, const void* pre_t,
           const void* post_t, const void* pre_s, const void* post_s, void* out, int P,
           int Q, int F, float a_plus, float a_minus, float w_min, float w_max,
           void* stream) {
  const long long cells = static_cast<long long>(Q) * F;
  if (cells <= 0) return 0;
  const long long blocks = (cells + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  stdp_gather_kernel<I, T><<<static_cast<unsigned>(blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(w), static_cast<const I*>(idx),
      static_cast<const uint8_t*>(valid), static_cast<const float*>(pre_t),
      static_cast<const float*>(post_t), static_cast<const float*>(pre_s),
      static_cast<const float*>(post_s), static_cast<T*>(out), P, Q, F, a_plus, a_minus,
      w_min, w_max);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define REPRO_STDP_GATHER(NAME, I, T)                                                   \
  REPRO_EXPORT int NAME(const void* w, const void* idx, const void* valid,             \
                        const void* pre_t, const void* post_t, const void* pre_s,      \
                        const void* post_s, void* out, int P, int Q, int F,            \
                        float a_plus, float a_minus, float w_min, float w_max,         \
                        void* stream) {                                                \
    return launch<I, T>(w, idx, valid, pre_t, post_t, pre_s, post_s, out, P, Q, F,     \
                        a_plus, a_minus, w_min, w_max, stream);                        \
  }

REPRO_STDP_GATHER(stdp_gather_i16_f32, int16_t, float)
REPRO_STDP_GATHER(stdp_gather_i16_f16, int16_t, __half)
REPRO_STDP_GATHER(stdp_gather_i32_f32, int32_t, float)
REPRO_STDP_GATHER(stdp_gather_i32_f16, int32_t, __half)
