// Shared helpers for the port's CUDA kernels: storage-type decode/encode
// (f32, fp16, bf16) through the CUDA intrinsics, the IZH4 update and the
// pair-STDP cell update with their rounding pinned, the C export macro, and
// the error-string export every library carries (each library is built
// from one .cu file).
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
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);  // round to nearest even, as torch's .to(bfloat16)
}

// An f32 value rounded to the storage type of `code` (0 f32, 1 fp16, 2
// bf16: kernels/_build.py STORAGE_CODE) and back.
__device__ __forceinline__ float round_to(int code, float x) {
  return code == 1 ? __half2float(__float2half_rn(x))
                   : code == 2 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
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

// The constants of a pair-STDP weight update.
struct StdpCoeffs {
  float a_plus, a_minus, w_min, w_max;
};

// The clip of torch.clamp and jnp.clip: a NaN stays NaN (fmaxf alone would
// turn it into the lower bound).
__device__ __forceinline__ float clip_keep_nan(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

// One pair-STDP synapse: clip((w + a+ * (pre_t * post_s)) - a- * (pre_s *
// post_t)), then +0.0 where `keep` is false (outside the mask or the row's
// valid cells). Every multiply, add and subtract is __fmul_rn / __fadd_rn /
// __fsub_rn in the plain versions' association (kernels/ref.py:
// stdp_update_ref, stdp_gather_ref), which nvcc never contracts into an
// FMA, so stdp_update and stdp_gather round as eager PyTorch does.
__device__ __forceinline__ float stdp_cell(float w, float pre_t, float pre_s, float post_t,
                                           float post_s, bool keep, const StdpCoeffs& c) {
  const float ltp = __fmul_rn(c.a_plus, __fmul_rn(pre_t, post_s));
  const float ltd = __fmul_rn(c.a_minus, __fmul_rn(pre_s, post_t));
  const float x = clip_keep_nan(__fsub_rn(__fadd_rn(w, ltp), ltd), c.w_min, c.w_max);
  return keep ? x : 0.0f;
}

// One trace step, trace * decay + spike (__fmul_rn then __fadd_rn), which is
// what core/plasticity.py:_trace_step gives in eager PyTorch: a multiply
// kernel, then an add kernel, no FMA.
__device__ __forceinline__ float trace_step(float trace, float decay, float spike) {
  return __fadd_rn(__fmul_rn(trace, decay), spike);
}

// One GroupRate monitor step of a neuron's filter level c on this tick's
// spike: c + alpha * (inst - c) with inst = spike ? rate : 0.0 (the spike
// times float32(1000 / dt), exact), __fsub_rn / __fmul_rn / __fadd_rn in
// telemetry/monitors.py:update's order, so the level rounds as eager
// PyTorch's three ops and is never contracted into an FMA.
__device__ __forceinline__ float rate_fold(float c, bool spike, float alpha, float rate) {
  return __fadd_rn(c, __fmul_rn(alpha, __fsub_rn(spike ? rate : 0.0f, c)));
}

// Whether a stored membrane value is finite, tested on the stored value
// itself: an fp16 membrane that overflowed to inf counts as non-finite,
// as the reference's isfinite on v.astype(f32) of the stored state does.
__device__ __forceinline__ bool stored_finite(float x) { return isfinite(x); }
__device__ __forceinline__ bool stored_finite(__half x) {
  return !__hisinf(x) && !__hisnan(x);
}
__device__ __forceinline__ bool stored_finite(__nv_bfloat16 x) {
  return !__hisinf(x) && !__hisnan(x);
}

// The in-run watches' two whole-net reductions of a tick, a Silent's and
// a NonFinite's, kept per lane in four int32 words (obs/watch.py,
// kernel_words): Silent {last, gap, flag0, flag1} (the local step of the
// last spike, the longest closed spike-free run), NonFinite {ticks, 0,
// flag0, flag1} (the steps with a non-finite membrane). No atomics and no
// grid barrier: at step s every warp with a spiking (non-finite) neuron
// stores 1 into the lane's flag of s's parity (watch_mark: a warp vote,
// one plain store of the same value), and at step s + 1 one thread per
// lane folds step s's flag into the words and clears it (watch_fold), in
// plain stores: the launches of a stream are ordered, so step s's flag is
// whole when s + 1 reads it, and s + 1 writes the other parity's. The last
// step's flag is folded once, when a run turns its words back into the
// carry. The result is exact and independent of the order the warps run
// in; kernels/ref.py:watch_fold_ref is the same fold in plain ops.
struct WatchWords {
  int a = 0, b = 0, flag = 0;  // the words of step - 1 and its flag
};

// The lane's words and step - 1's flag, loaded early (their latency
// overlaps the tick's work); nothing to load at step 0.
__device__ __forceinline__ WatchWords watch_load(const int* w, int step) {
  WatchWords r;
  if (w != nullptr && step > 0) {
    r.a = w[0];
    r.b = w[1];
    r.flag = w[2 + ((step - 1) & 1)];
  }
  return r;
}

// Step - 1's flag folded into a Silent's (`silent`) or a NonFinite's words
// and cleared for step + 1.
__device__ __forceinline__ void watch_fold(int* w, int step, const WatchWords& r,
                                           bool silent) {
  if (w == nullptr || step == 0) return;
  const int prev = step - 1;
  if (r.flag != 0) {
    if (silent) {
      if (prev > 0) w[1] = max(r.b, prev - r.a - 1);  // a closing step 0 adds no run
      w[0] = prev;
    } else {
      w[0] = r.a + 1;
    }
  }
  w[2 + (prev & 1)] = 0;
}

// Step `step`'s marks, for the warp that calls it (every thread of the
// warp, each with its neuron's spike and whether its stored membrane is
// non-finite; a thread past the last neuron passes false for both).
__device__ __forceinline__ void watch_mark(int* silent, int* bad, bool spike, bool nonfinite,
                                           int step) {
  const unsigned fired = __ballot_sync(0xffffffffu, spike);
  const unsigned poisoned = __ballot_sync(0xffffffffu, nonfinite);
  if ((threadIdx.x & 31) != 0) return;
  if (silent != nullptr && fired != 0u) silent[2 + (step & 1)] = 1;
  if (bad != nullptr && poisoned != 0u) bad[2 + (step & 1)] = 1;
}

REPRO_EXPORT const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
