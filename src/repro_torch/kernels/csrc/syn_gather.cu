// CSR fan-in gather + row sum for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/syn_gather.py
// (syn_gather -> _gather_kernel): out[q] = sum_k spikes[idx[q, k]] * w[q, k]
// over fixed-width fan-in rows; idx int16 or int32, w fp16, bf16 or f32
// decoded to f32 where it is loaded. Padding is index 0 with weight +0.0.
//
// What bounds it: bytes and latency. Each call reads the Q x F index and
// weight rows once (Synfire4: Q 200 or 50, F 34-81, about 100 KB of f32
// weights and int16 indices per tick over 13 calls), which is far from
// the card's memory rate, so launch latency and the gather's dependent
// loads decide. The spike row is staged once per block into shared
// memory, so the data-dependent reads spikes[idx] hit shared memory, not
// device memory. One warp owns one post row: lane l sums k = l, l+32, ...
// (coalesced reads of the index and weight rows), then the 32 partial sums
// meet in a fixed shuffle tree, so every run gives the same bits.
// An index outside [0, P) contributes NaN: a corrupt table shows in the
// output instead of reading out of bounds (the plain version raises).
//
// Any P: the spike row is staged in dynamic shared memory, above the
// default 48 KB after opting in up to what the device allows per block
// (cudaDevAttrMaxSharedMemoryPerBlockOptin: 232,448 B on the H100, so
// P <= 58,112 f32; Synfire4x100's longest pre group is 20,000). A longer
// row is read from device memory through the read-only path instead
// (kStaged false); the sum is the same either way.
#include "common.cuh"

namespace {

constexpr int kRowsPerBlock = 16;  // 16 warps, 512 threads
constexpr size_t kDefaultSharedBytes = 48 * 1024;

template <typename I, typename W, bool kStaged>
__global__ void gather_kernel(const float* __restrict__ spikes, const I* __restrict__ idx,
                              const W* __restrict__ w, float* __restrict__ out, int P,
                              int Q, int F) {
  extern __shared__ float staged[];
  const float* sp = spikes;
  if (kStaged) {
    for (int j = threadIdx.x; j < P; j += blockDim.x) staged[j] = spikes[j];
    __syncthreads();
    sp = staged;
  }
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (q >= Q) return;  // whole warps leave together: the shuffles stay full
  const I* irow = idx + static_cast<size_t>(q) * F;
  const W* wrow = w + static_cast<size_t>(q) * F;
  float acc = 0.0f;
  for (int k = lane; k < F; k += 32) {
    const int j = static_cast<int>(irow[k]);
    const float s = (j >= 0 && j < P) ? (kStaged ? sp[j] : __ldg(sp + j))
                                      : __int_as_float(0x7fc00000);
    acc = fmaf(s, to_f32(wrow[k]), acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) out[q] = acc;
}

// The most dynamic shared memory one block may opt into on the current
// device, read once per process.
size_t optin_shared_bytes() {
  static size_t bytes = 0;
  if (bytes == 0) {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    bytes = v > 0 ? static_cast<size_t>(v) : kDefaultSharedBytes;
  }
  return bytes;
}

template <typename I, typename W>
int launch(const void* spikes, const void* idx, const void* w, void* out, int P, int Q,
           int F, void* stream) {
  if (Q <= 0) return 0;
  const size_t smem = static_cast<size_t>(P) * sizeof(float);
  const int blocks = (Q + kRowsPerBlock - 1) / kRowsPerBlock;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sp = static_cast<const float*>(spikes);
  const I* ip = static_cast<const I*>(idx);
  const W* wp = static_cast<const W*>(w);
  float* op = static_cast<float*>(out);
  if (smem <= optin_shared_bytes()) {
    if (smem > kDefaultSharedBytes) {
      // Opted in once per instance, to the longest row seen so far.
      static size_t opted = 0;
      if (smem > opted) {
        const cudaError_t err = cudaFuncSetAttribute(
            gather_kernel<I, W, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
        opted = smem;
      }
    }
    gather_kernel<I, W, true><<<blocks, kRowsPerBlock * 32, smem, s>>>(sp, ip, wp, op, P, Q, F);
  } else {
    gather_kernel<I, W, false><<<blocks, kRowsPerBlock * 32, 0, s>>>(sp, ip, wp, op, P, Q, F);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define REPRO_GATHER(NAME, I, W)                                                      \
  REPRO_EXPORT int NAME(const void* spikes, const void* idx, const void* w, void* out, \
                        int P, int Q, int F, void* stream) {                          \
    return launch<I, W>(spikes, idx, w, out, P, Q, F, stream);                       \
  }

REPRO_GATHER(syn_gather_i16_f32, int16_t, float)
REPRO_GATHER(syn_gather_i16_f16, int16_t, __half)
REPRO_GATHER(syn_gather_i16_bf16, int16_t, __nv_bfloat16)
REPRO_GATHER(syn_gather_i32_f32, int32_t, float)
REPRO_GATHER(syn_gather_i32_f16, int32_t, __half)
REPRO_GATHER(syn_gather_i32_bf16, int32_t, __nv_bfloat16)
