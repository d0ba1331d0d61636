// IZH4 neuron update for Hopper (sm_90a): the single call, and a run's
// whole neuron phase of a tick in one launch.
//
// Replaces the Pallas TPU kernel src/repro/kernels/izh_update.py
// (izh4_update -> _izh4_kernel): `substeps` Euler steps of the Izhikevich
// model with simultaneous (dv, du), spike at v >= 30, reset v <- c,
// u <- u + d; f32 math, v and u stored back in their storage type.
//
// Two entries. izh4_update_<t> is the kernel's Pallas signature: v, u,
// i_syn, a-d in, v', u', spiked out (ops.izh4_update). izh4_run_<t> is one
// tick of a run's neuron phase (ops.NeuronRun), with the run's plan
// (NeuronPlan) filled once: per neuron it reads ring slot t % L into i_syn
// and zeroes it, adds the tick's external current, runs the update, masks
// the spike (generators, a running refractory countdown), holds
// generators at v = c, u = +0.0, counts the refractory countdown down,
// takes a generator's spike from the tick's generator row, and writes the
// f32 spike row the propagation reads, and, where asked, the raster row,
// the v and i_syn rows, the homeostasis counts and the in-run monitors'
// two accumulators (a SpikeCount's int32 count, a GroupRate's f32 filter
// level c <- c + alpha * (inst - c), every operation rounded on its own)
// and the in-run watches' three (a RateBand's int32 count, a Silent's and
// a NonFinite's per-lane words: common.cuh's watch_mark and watch_fold, a
// warp vote and a flag store per warp, the previous step's flag folded by
// one thread per lane, on the stored membrane; no atomics).
// That is the work of about 19 device ops per tick of the per-op phase
// (engine._neuron_phase, backend.update_neurons_dispatch), 6 more of the
// monitors' plain fold (telemetry/monitors.py:update) and about 8 of the
// watches' (kernels/ref.py:watch_fold_ref), each stored in the same type
// and so bit for bit the same.
//
// Lanes: izh4_run_<t> also takes B independent copies of the state (a
// batched run, a LaneScheduler's chunk), lane b at its own tick and ring
// slot, with the parameters and generator columns shared: one launch over
// a grid of (neuron block, lane), every lane's arithmetic that of the
// single-lane launch, so a lane equals its solo run bit for bit.
//
// Conductance-based (COBA) nets have a two-channel ring, excitatory and
// inhibitory magnitudes side by side, and four conductances per neuron
// (AMPA, NMDA, GABAa, GABAb) on the run's copies in the storage type. A
// COBA tick reads and zeroes both channels of the slot, decays each
// conductance and adds its share of the delivery (g * decay + frac * in,
// core/conductance.py:decay_and_deliver), stores it back, and takes the
// current from the stored values and the v from before the update
// (coba_current): the same launch, the same one thread per neuron. The
// decay factors arrive as f32 arguments computed on the host with f32
// exp, so the kernel calls no expf; the division is __fdiv_rn, the IEEE
// division eager PyTorch does by a tensor.
//
// What bounds it: launch latency. The run entry moves about 42 B per
// neuron at fp16 (ring slot read and zeroed, v, u and refrac read and
// written, a-d, is_gen, the generator column, the f32 spike row and the
// raster byte): about 50 KB at Synfire4's N = 1,200 (15 ns at 3.35 TB/s),
// 5 MB at Synfire4x100's N = 120,000 (1.5 us). COBA adds the second ring
// channel and the four conductances read and written: 20 B more per
// neuron at fp16. The design is the leanest
// launch: one thread per neuron, no shared memory, each thread's loads
// independent of the others'. Over B lanes the bytes scale by B (about
// 3.2 MB at Synfire4's 64 lanes, 1 us at 3.35 TB/s) under one launch.
//
// Rounding: the update is common.cuh's izh4_tick, which spells every
// multiply, add and subtract with __fmul_rn / __fadd_rn / __fsub_rn in the
// reference's term order, so nvcc never contracts it into an FMA. The kernel
// therefore rounds exactly as the plain PyTorch version
// (kernels/ref.py:izh4_ref) does on the CPU and the card, and the two agree
// bit for bit; fused_tick shares the same function.
#include "common.cuh"

template <typename T>
__global__ void izh4_kernel(const T* __restrict__ v_in, const T* __restrict__ u_in,
                            const float* __restrict__ i_syn,
                            const float* __restrict__ a, const float* __restrict__ b,
                            const float* __restrict__ c, const float* __restrict__ d,
                            T* __restrict__ v_out, T* __restrict__ u_out,
                            uint8_t* __restrict__ spiked, int n, float h, int substeps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = to_f32(v_in[i]);
  float u = to_f32(u_in[i]);
  const bool spk = izh4_tick(v, u, i_syn[i], a[i], b[i], c[i], d[i], h, substeps);
  v_out[i] = from_f32<T>(v);
  u_out[i] = from_f32<T>(u);
  spiked[i] = spk ? 1 : 0;
}

template <typename T>
static int launch(const void* v, const void* u, const void* i_syn, const void* a,
                  const void* b, const void* c, const void* d, void* v_out,
                  void* u_out, void* spiked, int n, float h, int substeps,
                  void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  izh4_kernel<T><<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(v), static_cast<const T*>(u),
      static_cast<const float*>(i_syn), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<const float*>(c),
      static_cast<const float*>(d), static_cast<T*>(v_out), static_cast<T*>(u_out),
      static_cast<uint8_t*>(spiked), n, h, substeps);
  return static_cast<int>(cudaGetLastError());
}

// One run's neuron phase (kernels/izh_update.py:_Plan, field for
// field): the run's own state, updated in place every tick. A run over B
// lanes (a batched run or a LaneScheduler's chunk) keeps every per-neuron
// array as [B, N] (lane stride N), the ring as [B, L, N, C] and the rows
// per lane at their own strides; lane b's ring slot is (t0[b] + shift) % L
// with t0 the lanes' first ticks mod L, uploaded once per run, so lanes at
// different ticks share the launch and the kernel never reads t back.
struct NeuronPlan {
  void* v;  // [B, N] storage type
  void* u;  // [B, N] storage type
  int16_t* refrac;  // [B, N]
  void* ring;  // [B, L, N, C] storage type
  const float* a;  // [N], shared by the lanes, as is everything up to spikes
  const float* b;
  const float* c;
  const float* d;
  const uint8_t* is_gen;  // [N] bool
  const int* gen_col;  // [N]: column in the tick's generator row, -1 for none
  float* spikes;  // [B, N] f32 spike rows (0.0 / 1.0), written every tick
  int* counts;  // [B, N] int32 spike counts, or null
  void* stream;
  void* g[4];  // COBA: AMPA, NMDA, GABAa, GABAb [B, N] storage type; null for CUBA
  const int* t0;  // [B] first tick of each lane mod L; null: `slot` is the slot
  int n, substeps;
  int channels;  // ring channels: 1 (CUBA) or 2 (COBA: exc, inh)
  int lanes, ring_len;
  float h;
  float decay[4];  // COBA: per-tick decay factors of g[0..3]
  float frac[4];  // COBA: 1 - nmda_frac, nmda_frac, 1 - gabab_frac, gabab_frac
  float e_exc, e_gabaa, e_gabab;  // COBA: reversal potentials (mV)
  long long gen_stride;  // lane stride of the generator rows (entries)
  long long row_stride;  // lane stride of the i_ext, raster, v and i_syn rows
  int* tel_count;  // [B, N] int32 SpikeCount accumulator, or null
  float* tel_rate;  // [B, N] f32 GroupRate filter level, or null
  float tel_alpha;  // GroupRate: float32(dt / tau_ms)
  float tel_inst;  // GroupRate: float32(1000 / dt), a spike's rate
  int* w_count;  // [B, N] int32 RateBand watch counts, or null
  int* w_silent;  // [B, 4] int32 Silent watch words {last, gap, flags}, or null
  int* w_bad;  // [B, 4] int32 NonFinite watch words {ticks, 0, flags}, or null
};

// One COBA neuron's conductances decayed and delivered, stored back in the
// storage type, and its current from the stored values at the pre-update
// v: core/conductance.py's decay_and_deliver and coba_current, every
// operation in their term order and rounding.
template <typename T>
__device__ __forceinline__ float coba_tick(const NeuronPlan& p, size_t i, float exc,
                                           float inh, float v) {
  float g[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    T* gp = static_cast<T*>(p.g[k]);
    const float in = k < 2 ? exc : inh;
    const T stored = from_f32<T>(
        __fadd_rn(__fmul_rn(to_f32(gp[i]), p.decay[k]), __fmul_rn(p.frac[k], in)));
    gp[i] = stored;
    g[k] = to_f32(stored);
  }
  const float nv = __fdiv_rn(__fadd_rn(v, 80.0f), 60.0f);
  const float nv2 = __fmul_rn(nv, nv);
  const float gate = __fdiv_rn(nv2, __fadd_rn(nv2, 1.0f));
  const float d_exc = __fsub_rn(v, p.e_exc);
  float sum = __fmul_rn(g[0], d_exc);
  sum = __fadd_rn(sum, __fmul_rn(__fmul_rn(g[1], gate), d_exc));
  sum = __fadd_rn(sum, __fmul_rn(g[2], __fsub_rn(v, p.e_gabaa)));
  sum = __fadd_rn(sum, __fmul_rn(g[3], __fsub_rn(v, p.e_gabab)));
  return -sum;
}

template <typename T>
__global__ void izh4_run_kernel(NeuronPlan p, int slot, int step,
                                const uint8_t* __restrict__ gen_row,
                                const float* __restrict__ i_ext,
                                uint8_t* __restrict__ raster, float* __restrict__ v_rec,
                                float* __restrict__ i_rec) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = blockIdx.y;
  // The lane's watch words, folded by its first thread at the end.
  const bool folds = blockIdx.x == 0 && threadIdx.x == 0;
  int* const w_silent = p.w_silent ? p.w_silent + 4 * lane : nullptr;
  int* const w_bad = p.w_bad ? p.w_bad + 4 * lane : nullptr;
  const WatchWords ws = folds ? watch_load(w_silent, step) : WatchWords();
  const WatchWords wb = folds ? watch_load(w_bad, step) : WatchWords();
  bool s = false;
  bool nonfinite = false;
  if (i < p.n) {
    if (p.t0) slot = (p.t0[lane] + slot) % p.ring_len;
    const size_t at = static_cast<size_t>(lane) * p.n + i;  // this neuron of this lane
    const size_t rows = static_cast<size_t>(lane) * p.row_stride + i;
    T* ring = static_cast<T*>(p.ring) +
              (static_cast<size_t>(lane) * p.ring_len + slot) * p.n * p.channels;
    T* vp = static_cast<T*>(p.v);
    T* up = static_cast<T*>(p.u);
    float v = to_f32(vp[at]);
    float u = to_f32(up[at]);
    // The monitors' and watches' accumulators are loaded with the state, so
    // their latency overlaps the update's instead of following the spike
    // (the plan's pointers may alias, so a load after a store would wait
    // for it).
    const float level = p.tel_rate ? p.tel_rate[at] : 0.0f;
    const int count0 = p.tel_count ? p.tel_count[at] : 0;
    const int wcount0 = p.w_count ? p.w_count[at] : 0;
    float cur;
    if (p.channels == 2) {
      const float exc = to_f32(ring[2 * i]);
      const float inh = to_f32(ring[2 * i + 1]);
      ring[2 * i] = from_f32<T>(0.0f);
      ring[2 * i + 1] = from_f32<T>(0.0f);
      cur = coba_tick<T>(p, at, exc, inh, v);
    } else {
      cur = to_f32(ring[i]);
      ring[i] = from_f32<T>(0.0f);
    }
    if (i_ext) cur = __fadd_rn(cur, i_ext[rows]);
    const float c = p.c[i];
    const bool spk = izh4_tick(v, u, cur, p.a[i], p.b[i], c, p.d[i], p.h, p.substeps);
    const bool gen = p.is_gen[i] != 0;
    const int16_t r = p.refrac[at];
    const int col = p.gen_col[i];
    s = col >= 0 ? gen_row[static_cast<size_t>(lane) * p.gen_stride + col] != 0
                 : (spk && !gen && !(r > 0));
    const T v2 = from_f32<T>(gen ? c : v);
    nonfinite = !stored_finite(v2);
    vp[at] = v2;
    up[at] = from_f32<T>(gen ? 0.0f : u);
    const int16_t r1 = static_cast<int16_t>(r - 1);  // int16 arithmetic, as torch's
    p.refrac[at] = r1 > 0 ? r1 : static_cast<int16_t>(0);
    p.spikes[at] = s ? 1.0f : 0.0f;
    if (raster) raster[rows] = s ? 1 : 0;
    if (v_rec) v_rec[rows] = to_f32(v2);
    if (i_rec) i_rec[rows] = cur;
    if (p.counts && s) p.counts[at] += 1;
    if (p.tel_count && s) p.tel_count[at] = count0 + 1;
    if (p.tel_rate) p.tel_rate[at] = rate_fold(level, s, p.tel_alpha, p.tel_inst);
    if (p.w_count && s) p.w_count[at] = wcount0 + 1;
  }
  // Every thread of the block reaches the watches' warp vote (a block's
  // warps lie in one lane).
  if (w_silent || w_bad) watch_mark(w_silent, w_bad, s, nonfinite, step);
  if (folds) {
    watch_fold(w_silent, step, ws, true);
    watch_fold(w_bad, step, wb, false);
  }
}

template <typename T>
static int launch_run(const NeuronPlan* p, int slot, int step, const void* gen_row,
                      const void* i_ext, void* raster, void* v_rec, void* i_rec) {
  if (p->n <= 0 || p->lanes <= 0) return 0;
  const int threads = 256;
  const dim3 blocks((p->n + threads - 1) / threads, p->lanes);
  izh4_run_kernel<T><<<blocks, threads, 0, static_cast<cudaStream_t>(p->stream)>>>(
      *p, slot, step, static_cast<const uint8_t*>(gen_row), static_cast<const float*>(i_ext),
      static_cast<uint8_t*>(raster), static_cast<float*>(v_rec), static_cast<float*>(i_rec));
  return static_cast<int>(cudaGetLastError());
}

REPRO_EXPORT int izh4_run_plan_size() { return static_cast<int>(sizeof(NeuronPlan)); }

// One tick of a run (kernels/izh_update.py:NeuronLauncher): ring slot
// `slot` (over lanes, with t0 set: the shift i % L of every lane's slot),
// `step` the tick's local index in the run (the watches' tick); the tick's
// rows of lane 0 as device pointers, null for none.
REPRO_EXPORT int izh4_run_f32(const NeuronPlan* p, int slot, int step, const void* gen_row,
                              const void* i_ext, void* raster, void* v_rec, void* i_rec) {
  return launch_run<float>(p, slot, step, gen_row, i_ext, raster, v_rec, i_rec);
}

REPRO_EXPORT int izh4_run_f16(const NeuronPlan* p, int slot, int step, const void* gen_row,
                              const void* i_ext, void* raster, void* v_rec, void* i_rec) {
  return launch_run<__half>(p, slot, step, gen_row, i_ext, raster, v_rec, i_rec);
}

REPRO_EXPORT int izh4_run_bf16(const NeuronPlan* p, int slot, int step, const void* gen_row,
                               const void* i_ext, void* raster, void* v_rec, void* i_rec) {
  return launch_run<__nv_bfloat16>(p, slot, step, gen_row, i_ext, raster, v_rec, i_rec);
}

REPRO_EXPORT int izh4_update_f32(const void* v, const void* u, const void* i_syn,
                                 const void* a, const void* b, const void* c,
                                 const void* d, void* v_out, void* u_out,
                                 void* spiked, int n, float h, int substeps,
                                 void* stream) {
  return launch<float>(v, u, i_syn, a, b, c, d, v_out, u_out, spiked, n, h,
                       substeps, stream);
}

REPRO_EXPORT int izh4_update_f16(const void* v, const void* u, const void* i_syn,
                                 const void* a, const void* b, const void* c,
                                 const void* d, void* v_out, void* u_out,
                                 void* spiked, int n, float h, int substeps,
                                 void* stream) {
  return launch<__half>(v, u, i_syn, a, b, c, d, v_out, u_out, spiked, n, h,
                        substeps, stream);
}

REPRO_EXPORT int izh4_update_bf16(const void* v, const void* u, const void* i_syn,
                                  const void* a, const void* b, const void* c,
                                  const void* d, void* v_out, void* u_out,
                                  void* spiked, int n, float h, int substeps,
                                  void* stream) {
  return launch<__nv_bfloat16>(v, u, i_syn, a, b, c, d, v_out, u_out, spiked, n, h,
                               substeps, stream);
}
