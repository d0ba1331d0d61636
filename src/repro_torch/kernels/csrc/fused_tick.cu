// The whole Synfire tick in one launch for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_tick.py
// (fused_tick -> _tick_kernel, payload from assemble_kernel). One launch
// computes what kernels/ref.py:fused_tick_ref computes:
//
//   phase 1, per neuron: read ring slot t % L into i_syn and zero it; the
//     IZH4 update (common.cuh's izh4_tick, rounding pinned); the generator
//     override in the reference's order, v = is_gen ? c : v', u = is_gen ?
//     0 : u', spike = is_gen ? gen_row : spiked, each stored in the storage
//     type; the spike row goes to shared memory and to `spikes`;
//   phase 2, per post column: every bucket's drive in plan order into one
//     f32 accumulator per distinct delay, then one ring commit per delay in
//     ascending order, ring[(t+d) % L] = ring + store(acc), in the ring's
//     type (for fp16: round(float(r) + float(round(acc))), which is what
//     torch's half add gives on the CPU and the card).
//
// Layout: one CTA of kThreads threads; __syncthreads() separates the two
// phases. Ring, v/u, weights and CSR tables stay in device memory (Synfire4's
// payload is about 1.2 MB, Synfire4x10 sparse 5.4 MB: both sit in the 50 MB
// L2); the spike row (N bytes) and the bucket descriptors sit in shared
// memory. Limits, checked by the launcher before any tick: N <= kMaxN
// (47,104: the spike row and descriptors fit the default 48 KB of shared
// memory), at most kMaxDelays (4) distinct delays, at most kMaxBuckets (64)
// buckets, any ring length L, any P, Q, F.
//
// Order and rounding: no atomics. A thread owns a post column and adds the
// drives of the buckets covering it in plan order; a dense drive sums the
// rows of W in ascending p, a CSR drive the fan-in entries in ascending k.
// Spikes are 0 or 1, so a spiking pre adds its weight exactly (1 * w = w)
// and a silent one would add a signed zero: the sums start at +0.0 and are
// never -0.0, so skipping silent pres is bitwise neutral (weights finite),
// as the reference's event gating asserts. With Synfire's exactly
// representable weight tables every sum is exact, so the result equals the
// plain version's bit for bit; with arbitrary weights it differs only by
// summation order.
//
// What bounds it: at Synfire4 size, latency. The bytes a tick must move
// (the f32 images, the ring and the neuron state, about 1.1 MB packed) take
// 0.35 us at 3.35 TB/s; one CTA on one SM walks them in a few microseconds,
// and the launch itself costs about as much. The Hopper form (state in
// shared memory, clusters with distributed shared memory, TMA-streamed
// weight tiles) is later work.
#include "common.cuh"

constexpr int kThreads = 1024;
constexpr int kMaxDelays = 4;
constexpr int kMaxBuckets = 64;
constexpr int kDescInts = 8;  // kind, pre_start, post_start, p, q, f, kpos, offset
constexpr int kMaxN = 48 * 1024 - kMaxBuckets * kDescInts * 4;

// Everything that stays fixed for a run; the Python launcher fills it once.
// Field order and types match kernels/fused_tick.py:_Plan.
struct TickPlan {
  void* v;            // [N] storage type, updated in place
  void* u;            // [N] storage type, updated in place
  void* ring;         // [L, N] storage type, updated in place
  const uint8_t* is_gen;  // [N] bool
  const float* a;
  const float* b;
  const float* c;
  const float* d;
  const int* desc;    // [n_buckets, kDescInts] in plan order
  const float* wd;    // dense images, concatenated [P, Q] row-major
  const float* wc;    // CSR weight rows, concatenated [Q, F]
  const int* ic;      // CSR global pre indices, laid out as wc
  void* stream;
  int delays[kMaxDelays];  // ascending
  int n;
  int ring_len;
  int n_buckets;
  int n_delays;
  int substeps;
  float h;
};

namespace {

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_tick_kernel(const TickPlan P, const int t, const uint8_t* gen_row,
                  uint8_t* spikes, float* v_rec, float* isyn_rec) {
  extern __shared__ uint8_t s_spk[];  // [n]
  __shared__ int s_desc[kMaxBuckets * kDescInts];
  const int n = P.n;
  for (int i = threadIdx.x; i < P.n_buckets * kDescInts; i += blockDim.x) {
    s_desc[i] = P.desc[i];
  }
  T* ring = static_cast<T*>(P.ring);

  // Phase 1: delivery, neurons, generators.
  T* slot = ring + static_cast<size_t>(t) * n;  // t < ring_len (reduced by the launcher)
  T* vv = static_cast<T*>(P.v);
  T* uu = static_cast<T*>(P.u);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float cur = to_f32(slot[i]);
    slot[i] = from_f32<T>(0.0f);
    float v = to_f32(vv[i]);
    float u = to_f32(uu[i]);
    const float c = P.c[i];
    const bool spk = izh4_tick(v, u, cur, P.a[i], P.b[i], c, P.d[i], P.h, P.substeps);
    const bool gen = P.is_gen[i] != 0;
    const T vs = gen ? from_f32<T>(c) : from_f32<T>(v);
    const T us = gen ? from_f32<T>(0.0f) : from_f32<T>(u);
    const uint8_t s = gen ? (gen_row[i] != 0 ? 1 : 0) : (spk ? 1 : 0);
    vv[i] = vs;
    uu[i] = us;
    s_spk[i] = s;
    spikes[i] = s;  // may alias gen_row: the same thread read it above
    if (v_rec != nullptr) v_rec[i] = to_f32(vs);
    if (isyn_rec != nullptr) isyn_rec[i] = cur;
  }
  __syncthreads();

  // Phase 2: propagation and the ring commits, one post column per thread.
  for (int q = threadIdx.x; q < n; q += blockDim.x) {
    float acc[kMaxDelays];
#pragma unroll
    for (int k = 0; k < kMaxDelays; ++k) acc[k] = 0.0f;
    for (int bi = 0; bi < P.n_buckets; ++bi) {
      const int* dsc = s_desc + bi * kDescInts;
      const int col = q - dsc[2];
      const int qn = dsc[4];
      if (col < 0 || col >= qn) continue;
      float drive = 0.0f;
      if (dsc[0] == 0) {  // dense [P, Q] image, pre span [pre_start, pre_start + P)
        const uint8_t* pre = s_spk + dsc[1];
        const float* w = P.wd + dsc[7] + col;
        const int pn = dsc[3];
        for (int p = 0; p < pn; ++p) {
          if (pre[p]) drive = __fadd_rn(drive, w[static_cast<size_t>(p) * qn]);
        }
      } else {  // CSR fan-in row of width F, global pre indices
        const int f = dsc[5];
        const size_t row = static_cast<size_t>(dsc[7]) + static_cast<size_t>(col) * f;
        const int* idx = P.ic + row;
        const float* w = P.wc + row;
        for (int k = 0; k < f; ++k) {
          const int j = idx[k];
          if (j < 0 || j >= n) {
            drive = __int_as_float(0x7fc00000);  // a corrupt table shows as NaN
          } else if (s_spk[j]) {
            drive = __fadd_rn(drive, w[k]);
          }
        }
      }
      const int kpos = dsc[6];
#pragma unroll
      for (int k = 0; k < kMaxDelays; ++k) {
        if (k == kpos) acc[k] = __fadd_rn(acc[k], drive);
      }
    }
#pragma unroll
    for (int k = 0; k < kMaxDelays; ++k) {
      if (k < P.n_delays) {
        int s = t + P.delays[k];
        if (s >= P.ring_len) s -= P.ring_len;
        T* r = ring + static_cast<size_t>(s) * n + q;
        *r = from_f32<T>(__fadd_rn(to_f32(*r), to_f32(from_f32<T>(acc[k]))));
      }
    }
  }
}

template <typename T>
int launch(const TickPlan* plan, int t, const void* gen_row, void* spikes, void* v_rec,
           void* isyn_rec) {
  if (plan->n <= 0) return 0;
  if (plan->n > kMaxN || plan->n_buckets > kMaxBuckets || plan->n_delays > kMaxDelays ||
      t < 0 || t >= plan->ring_len) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  fused_tick_kernel<T><<<1, kThreads, static_cast<size_t>(plan->n),
                         static_cast<cudaStream_t>(plan->stream)>>>(
      *plan, t, static_cast<const uint8_t*>(gen_row), static_cast<uint8_t*>(spikes),
      static_cast<float*>(v_rec), static_cast<float*>(isyn_rec));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

REPRO_EXPORT int fused_tick_limits(int* out) {
  out[0] = kMaxN;
  out[1] = kMaxDelays;
  out[2] = kMaxBuckets;
  out[3] = static_cast<int>(sizeof(TickPlan));
  return 0;
}

#define REPRO_FUSED(NAME, T)                                                       \
  REPRO_EXPORT int NAME(const TickPlan* plan, int t, const void* gen_row,          \
                        void* spikes, void* v_rec, void* isyn_rec) {               \
    return launch<T>(plan, t, gen_row, spikes, v_rec, isyn_rec);                   \
  }

REPRO_FUSED(fused_tick_f32, float)
REPRO_FUSED(fused_tick_f16, __half)
