// IZH4 neuron update for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/izh_update.py
// (izh4_update -> _izh4_kernel): `substeps` Euler steps of the Izhikevich
// model with simultaneous (dv, du), spike at v >= 30, reset v <- c,
// u <- u + d; f32 math, v and u stored back in their storage type.
//
// What bounds it: bytes. Per neuron it reads v and u (storage type) and
// i_syn, a, b, c, d (f32), and writes v, u and a spike byte: 29 B at fp16,
// 37 B at fp32. At Synfire4's N = 1,200 that is 35 KB, about 10 ns at
// 3.35 TB/s, so one launch (a few microseconds) dominates. The design is
// therefore the leanest launch: one thread per neuron, no shared memory,
// each thread's loads independent of the others'.
//
// Rounding: every multiply, add and subtract goes through __fmul_rn /
// __fadd_rn / __fsub_rn in the reference's term order, which nvcc never
// contracts into an FMA. The kernel therefore rounds exactly as the plain
// PyTorch version (kernels/ref.py:izh4_ref) does on the CPU and the card,
// and the two agree bit for bit.
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
  const float cur = i_syn[i];
  const float ai = a[i];
  const float bi = b[i];
  for (int s = 0; s < substeps; ++s) {
    // dv = 0.04*v*v + 5.0*v + 140.0 - u + i_syn, left to right
    const float dv = __fadd_rn(
        __fsub_rn(__fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(0.04f, v), v),
                                      __fmul_rn(5.0f, v)),
                            140.0f),
                  u),
        cur);
    // du = a*(b*v - u)
    const float du = __fmul_rn(ai, __fsub_rn(__fmul_rn(bi, v), u));
    v = __fadd_rn(v, __fmul_rn(h, dv));
    u = __fadd_rn(u, __fmul_rn(h, du));
  }
  const bool spk = v >= 30.0f;
  if (spk) {
    v = c[i];
    u = __fadd_rn(u, d[i]);
  }
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
