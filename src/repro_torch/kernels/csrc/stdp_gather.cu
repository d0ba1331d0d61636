// Pair-based STDP on CSR fan-in rows for Hopper (sm_90a): one launch per
// tick over every CSR pair-STDP projection of a run, the trace steps folded
// in.
//
// Replaces the Pallas TPU kernel src/repro/kernels/stdp_gather.py
// (stdp_gather -> _stdp_gather_kernel): for every cell (q, k) of the
// [Q, F] fan-in rows, with j = idx[q, k],
//   w' = clip((w + a+ * (pre_t[j] * post_s[q])) - a- * (pre_s[j] * post_t[q]),
//             w_min, w_max)
// then +0.0 where valid is false, stored back in the storage type. idx is
// int16 or int32; padded cells carry index 0 and valid false.
//
// One device function (common.cuh:stdp_cell, shared with stdp_update)
// serves two callers. The single checked call (ops.stdp_gather,
// stdp_gather_<i>_<w>) takes the stepped traces and writes a new [Q, F]
// table. The run launcher (ops.StdpGatherRun, stdp_gather_run) takes a
// table of projection descriptors built once per run and, each tick, one
// f32 spike row: every projection's weights are updated in place, and each
// trace advances one step,
//   trace' = trace * decay + spike       (__fmul_rn then __fadd_rn,
// common.cuh:trace_step). The traces are ping-pong
// buffers: tick parity p reads buffer p and writes buffer 1 - p. A cell
// recomputes the new trace of its pre and of its post from buffer p, and
// one item per pre and per post neuron writes the new trace into buffer
// 1 - p, so no thread reads what the launch writes.
//
// What bounds it: launch latency, then bytes. Per cell it reads the weight,
// the index and the validity byte and writes the weight: 7 B per cell at
// fp16 with int16 indices. A plastic Synfire4 sparse tick updates four
// chain projections (P = Q = 200, F about 80: about 64,000 cells, 0.45 MB,
// about 0.14 us at 3.35 TB/s); four single calls cost four launches, and
// their trace steps four elementwise ops each. The run launcher makes it
// one launch. One thread per item (cells of every projection in
// descriptor order, then each projection's pre and post trace items),
// consecutive threads along a row (coalesced weight, index and validity
// rows); the gathered traces and spikes are read through the read-only
// cache, with no shared-memory staging and so no limit on P.
//
// Lanes: the run launcher also takes B independent lanes of a run (a
// batched run, a LaneScheduler's chunk) in the same launch: grid.y is the
// lane, and lane b reads its weights at w + b * w_lane, its traces at
// b * P and b * Q and its spike row at b * n, the index and validity rows
// shared. Each lane's items are the one-lane launch's, so a lane equals
// its one-lane launch bit for bit.
//
// Rounding: every multiply, add and subtract is __fmul_rn / __fadd_rn /
// __fsub_rn in the plain version's association (kernels/ref.py:
// stdp_gather_ref, stdp_gather_run_ref), the mask +0.0: bit for bit equal
// to the plain version. The clip (common.cuh:clip_keep_nan) keeps a NaN, as
// torch.clamp and jnp.clip do.
//
// Out-of-range indices follow the reference's jnp.take: an index in
// [-P, -1] counts from the end of the pre row, any other index outside
// [0, P) reads NaN for the pre trace and the pre spike, so the cell is NaN
// before the valid mask, and +0.0 where valid is false.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float nan_f32() { return __int_as_float(0x7fc00000); }

// The pre index of a cell, wrapped as jnp.take wraps it; -1 when it is
// outside [-P, P).
__device__ __forceinline__ int pre_index(int j, int P) {
  if (j < 0) j += P;
  return (j >= 0 && j < P) ? j : -1;
}

// -- the single checked call -------------------------------------------------

template <typename I, typename T>
__global__ void stdp_gather_kernel(const T* __restrict__ w, const I* __restrict__ idx,
                                   const uint8_t* __restrict__ valid,
                                   const float* __restrict__ pre_t,
                                   const float* __restrict__ post_t,
                                   const float* __restrict__ pre_s,
                                   const float* __restrict__ post_s, T* __restrict__ out,
                                   int P, int Q, int F, StdpCoeffs c) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(Q) * F) return;
  const int q = static_cast<int>(i / F);
  const int j = pre_index(static_cast<int>(idx[i]), P);
  const float pt = j >= 0 ? __ldg(pre_t + j) : nan_f32();
  const float ps = j >= 0 ? __ldg(pre_s + j) : nan_f32();
  out[i] = from_f32<T>(stdp_cell(to_f32(w[i]), pt, ps, __ldg(post_t + q), __ldg(post_s + q),
                                 valid[i] != 0, c));
}

template <typename I, typename T>
int launch(const void* w, const void* idx, const void* valid, const void* pre_t,
           const void* post_t, const void* pre_s, const void* post_s, void* out, int P,
           int Q, int F, StdpCoeffs c, void* stream) {
  const long long cells = static_cast<long long>(Q) * F;
  if (cells <= 0) return 0;
  const long long blocks = (cells + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  stdp_gather_kernel<I, T><<<static_cast<unsigned>(blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(w), static_cast<const I*>(idx),
      static_cast<const uint8_t*>(valid), static_cast<const float*>(pre_t),
      static_cast<const float*>(post_t), static_cast<const float*>(pre_s),
      static_cast<const float*>(post_s), static_cast<T*>(out), P, Q, F, c);
  return static_cast<int>(cudaGetLastError());
}

// -- the run launcher ----------------------------------------------------------

// One plastic projection of a run (kernels/stdp_gather.py:_Proj, field
// for field). Its items are [begin, begin + Q*F + P + Q): the cells row by
// row, then the P pre-trace items, then the Q post-trace items.
struct StdpProj {
  void* w;  // [B, Q, F] storage type, lane stride w_lane, updated in place
  const void* idx;  // [Q, F] int16 (itype 0) or int32 (itype 1), shared by the lanes
  const uint8_t* valid;  // [Q, F], shared
  float* pre_tr[2];  // [B, P] ping-pong
  float* post_tr[2];  // [B, Q] ping-pong
  long long w_lane;  // the weights' lane stride in entries
  long long begin;
  int P, Q, F, pre_start, post_start, itype, wtype;  // wtype 0 f32, 1 fp16, 2 bf16
  float a_plus, a_minus, w_min, w_max, decay_pre, decay_post;
};

struct StdpPlan {
  const StdpProj* projs;  // [n_projs] in device memory
  void* stream;
  long long n_items;
  int n_projs;
  int lanes, n;  // lanes (grid.y) and the spike row's length (its lane stride)
};

// One cell's weight, in storage type T, updated in place.
template <typename T>
__device__ __forceinline__ void update_cell(T* w, float pt, float ps, float qt, float qs,
                                            bool ok, const StdpCoeffs& c) {
  *w = from_f32<T>(stdp_cell(to_f32(*w), pt, ps, qt, qs, ok, c));
}

__global__ void __launch_bounds__(kThreads)
    stdp_run_kernel(StdpPlan plan, const float* __restrict__ spikes, int parity) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= plan.n_items) return;
  int k = 0;
  while (k + 1 < plan.n_projs && i >= plan.projs[k + 1].begin) ++k;
  const StdpProj& p = plan.projs[k];
  const long long lane = blockIdx.y;
  const long long local = i - p.begin;
  const long long cells = static_cast<long long>(p.Q) * p.F;
  const float* pre_sp = spikes + lane * plan.n + p.pre_start;
  const float* post_sp = spikes + lane * plan.n + p.post_start;
  const float* pre_old = p.pre_tr[parity] + lane * p.P;
  const float* post_old = p.post_tr[parity] + lane * p.Q;
  if (local >= cells) {  // a trace item: the new trace into the other buffer
    const int j = static_cast<int>(local - cells);
    if (j < p.P) {
      p.pre_tr[1 - parity][lane * p.P + j] =
          trace_step(__ldg(pre_old + j), p.decay_pre, __ldg(pre_sp + j));
    } else {
      const int q = j - p.P;
      p.post_tr[1 - parity][lane * p.Q + q] =
          trace_step(__ldg(post_old + q), p.decay_post, __ldg(post_sp + q));
    }
    return;
  }
  const int q = static_cast<int>(local / p.F);
  const int raw = p.itype ? static_cast<const int32_t*>(p.idx)[local]
                          : static_cast<const int16_t*>(p.idx)[local];
  const int j = pre_index(raw, p.P);
  float pt = nan_f32(), ps = nan_f32();
  if (j >= 0) {
    ps = __ldg(pre_sp + j);
    pt = trace_step(__ldg(pre_old + j), p.decay_pre, ps);
  }
  const float qs = __ldg(post_sp + q);
  const float qt = trace_step(__ldg(post_old + q), p.decay_post, qs);
  const StdpCoeffs c{p.a_plus, p.a_minus, p.w_min, p.w_max};
  const bool ok = p.valid[local] != 0;
  const long long at = lane * p.w_lane + local;
  if (p.wtype == 1) {
    update_cell(static_cast<__half*>(p.w) + at, pt, ps, qt, qs, ok, c);
  } else if (p.wtype == 2) {
    update_cell(static_cast<__nv_bfloat16*>(p.w) + at, pt, ps, qt, qs, ok, c);
  } else {
    update_cell(static_cast<float*>(p.w) + at, pt, ps, qt, qs, ok, c);
  }
}

}  // namespace

REPRO_EXPORT int stdp_gather_run_sizes(int* out) {
  out[0] = static_cast<int>(sizeof(StdpProj));
  out[1] = static_cast<int>(sizeof(StdpPlan));
  return 0;
}

// One tick of a run (kernels/stdp_gather.py:StdpLauncher): `spikes` is the
// tick's [B, N] f32 spike rows, `parity` the trace buffer holding the traces.
REPRO_EXPORT int stdp_gather_run(const StdpPlan* plan, const void* spikes, int parity) {
  if (plan->n_items <= 0 || plan->lanes <= 0) return 0;
  const long long blocks = (plan->n_items + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL || plan->lanes > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  stdp_run_kernel<<<dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(plan->lanes)),
                    kThreads, 0,
                    static_cast<cudaStream_t>(plan->stream)>>>(
      *plan, static_cast<const float*>(spikes), parity);
  return static_cast<int>(cudaGetLastError());
}

#define REPRO_STDP_GATHER(NAME, I, T)                                                   \
  REPRO_EXPORT int NAME(const void* w, const void* idx, const void* valid,             \
                        const void* pre_t, const void* post_t, const void* pre_s,      \
                        const void* post_s, void* out, int P, int Q, int F,            \
                        float a_plus, float a_minus, float w_min, float w_max,         \
                        void* stream) {                                                \
    return launch<I, T>(w, idx, valid, pre_t, post_t, pre_s, post_s, out, P, Q, F,     \
                        StdpCoeffs{a_plus, a_minus, w_min, w_max}, stream);                  \
  }

REPRO_STDP_GATHER(stdp_gather_i16_f32, int16_t, float)
REPRO_STDP_GATHER(stdp_gather_i16_f16, int16_t, __half)
REPRO_STDP_GATHER(stdp_gather_i16_bf16, int16_t, __nv_bfloat16)
REPRO_STDP_GATHER(stdp_gather_i32_f32, int32_t, float)
REPRO_STDP_GATHER(stdp_gather_i32_f16, int32_t, __half)
REPRO_STDP_GATHER(stdp_gather_i32_bf16, int32_t, __nv_bfloat16)
