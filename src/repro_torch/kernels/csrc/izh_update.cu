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
// the v and i_syn rows and the homeostasis counts. That is the work of
// about 19 device ops per tick of the per-op phase (engine._neuron_phase,
// backend.update_neurons_dispatch), each stored in the same type and so
// bit for bit the same.
//
// What bounds it: launch latency. The run entry moves about 42 B per
// neuron at fp16 (ring slot read and zeroed, v, u and refrac read and
// written, a-d, is_gen, the generator column, the f32 spike row and the
// raster byte): about 50 KB at Synfire4's N = 1,200 (15 ns at 3.35 TB/s),
// 5 MB at Synfire4x100's N = 120,000 (1.5 us). The design is the leanest
// launch: one thread per neuron, no shared memory, each thread's loads
// independent of the others'.
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
// field): the run's own state, updated in place every tick.
struct NeuronPlan {
  void* v;  // [N] storage type
  void* u;  // [N] storage type
  int16_t* refrac;  // [N]
  void* ring;  // [L, N] storage type
  const float* a;
  const float* b;
  const float* c;
  const float* d;
  const uint8_t* is_gen;  // [N] bool
  const int* gen_col;  // [N]: column in the tick's generator row, -1 for none
  float* spikes;  // [N] f32 spike row (0.0 / 1.0), written every tick
  int* counts;  // [N] int32 spike counts, or null
  void* stream;
  int n, substeps;
  float h;
};

template <typename T>
__global__ void izh4_run_kernel(NeuronPlan p, int slot, const uint8_t* __restrict__ gen_row,
                                const float* __restrict__ i_ext,
                                uint8_t* __restrict__ raster, float* __restrict__ v_rec,
                                float* __restrict__ i_rec) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n) return;
  T* ring = static_cast<T*>(p.ring) + static_cast<size_t>(slot) * p.n;
  float cur = to_f32(ring[i]);
  ring[i] = from_f32<T>(0.0f);
  if (i_ext) cur = __fadd_rn(cur, i_ext[i]);
  T* vp = static_cast<T*>(p.v);
  T* up = static_cast<T*>(p.u);
  float v = to_f32(vp[i]);
  float u = to_f32(up[i]);
  const float c = p.c[i];
  const bool spk = izh4_tick(v, u, cur, p.a[i], p.b[i], c, p.d[i], p.h, p.substeps);
  const bool gen = p.is_gen[i] != 0;
  const int16_t r = p.refrac[i];
  const int col = p.gen_col[i];
  const bool s = col >= 0 ? gen_row[col] != 0 : (spk && !gen && !(r > 0));
  const T v2 = from_f32<T>(gen ? c : v);
  vp[i] = v2;
  up[i] = from_f32<T>(gen ? 0.0f : u);
  const int16_t r1 = static_cast<int16_t>(r - 1);  // int16 arithmetic, as torch's
  p.refrac[i] = r1 > 0 ? r1 : static_cast<int16_t>(0);
  p.spikes[i] = s ? 1.0f : 0.0f;
  if (raster) raster[i] = s ? 1 : 0;
  if (v_rec) v_rec[i] = to_f32(v2);
  if (i_rec) i_rec[i] = cur;
  if (p.counts && s) p.counts[i] += 1;
}

template <typename T>
static int launch_run(const NeuronPlan* p, int slot, const void* gen_row, const void* i_ext,
                      void* raster, void* v_rec, void* i_rec) {
  if (p->n <= 0) return 0;
  const int threads = 256;
  const int blocks = (p->n + threads - 1) / threads;
  izh4_run_kernel<T><<<blocks, threads, 0, static_cast<cudaStream_t>(p->stream)>>>(
      *p, slot, static_cast<const uint8_t*>(gen_row), static_cast<const float*>(i_ext),
      static_cast<uint8_t*>(raster), static_cast<float*>(v_rec), static_cast<float*>(i_rec));
  return static_cast<int>(cudaGetLastError());
}

REPRO_EXPORT int izh4_run_plan_size() { return static_cast<int>(sizeof(NeuronPlan)); }

// One tick of a run (kernels/izh_update.py:NeuronLauncher): ring slot
// `slot`; the tick's rows as device pointers, null for none.
REPRO_EXPORT int izh4_run_f32(const NeuronPlan* p, int slot, const void* gen_row,
                              const void* i_ext, void* raster, void* v_rec, void* i_rec) {
  return launch_run<float>(p, slot, gen_row, i_ext, raster, v_rec, i_rec);
}

REPRO_EXPORT int izh4_run_f16(const NeuronPlan* p, int slot, const void* gen_row,
                              const void* i_ext, void* raster, void* v_rec, void* i_rec) {
  return launch_run<__half>(p, slot, gen_row, i_ext, raster, v_rec, i_rec);
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
