// GQA online-softmax attention (forward), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attn.py
// (flash_attention -> _flash_kernel), in the form of its XLA mirror
// src/repro/models/attention.py:chunked_attention, which the model runs:
// q [B, Sq, Hq, D] f32, k/v [B, Sk, Hkv, D] in f32, fp16 or bf16 (decoded
// to f32 where they are staged), qpos int32 [B, Sq], kpos int32 [Sk] with
// kpos < 0 an invalid slot, out [B, Sq, Hq, D] f32. Query head h reads KV
// head h / (Hq / Hkv) (kv-major groups). A key is allowed iff it is valid,
// kpos <= qpos when causal, and kpos > qpos - window when window > 0.
// Scores are masked with -1e30 as in the reference, masked keys add an
// exact 0 to the sums, and the output divides by (l > 0 ? l : 1), so a
// row with no allowed key is 0 (as kernels/ref.py:chunked_attention_ref).
//
// Layout: one CTA of 8 warps per (query tile of 32 rows, query head,
// batch row); each warp owns 4 query rows. The q tile sits in shared
// memory, scaled by 1/sqrt(D) in f32. KV advances in blocks of 32 keys,
// staged through shared memory as f32; lane j scores key j against the
// warp's 4 rows, the running max and denominator of each row live in
// registers (warp shuffles reduce across the block's keys), and each lane
// accumulates D/32 output columns of its 4 rows in registers. A block
// none of whose keys any row of the CTA may see (past the causal
// frontier, before the window, or invalid) is skipped, which changes no
// bit. D is at most 256 (8 columns a lane); the wrapper raises above.
//
// What bounds it: on the serving path, decode (Sq = 1 over a 544-slot
// fp16 cache) is a few MB of KV per call, bytes-bound, and prefill
// (Sq = Sk = 512, causal) is 2-3 GFLOP, operations-bound. This simple
// form runs on the CUDA cores from shared memory, with one key block in
// flight per CTA; wgmma, TMA double buffering and split-K for decode are
// later work. Built without --use_fast_math: expf and IEEE division.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per CTA
constexpr int kKeys = 32;                     // keys per staged block, one a lane
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const float* q;
  const void* k;
  const void* v;
  const int* qpos;
  const int* kpos;
  float* out;
  int B, Sq, Sk, Hq, Hkv, D;
  int causal, window;
  float scale;
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ bool allowed(int kp, int qp, int causal, int window) {
  return kp >= 0 && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
}

size_t smem_bytes(int D) {
  return sizeof(float) * (static_cast<size_t>(kRows) * D + kKeys * (D + 1) + kKeys * D) +
         sizeof(int) * (kKeys + kRows);
}

template <typename KV, int NI>
__global__ void __launch_bounds__(kWarps * 32) flash_attn_kernel(Args a) {
  extern __shared__ float smem[];
  __shared__ int qlo, qhi;
  const int D = a.D;
  float* qs = smem;                  // [kRows][D], scaled queries
  float* ks = qs + kRows * D;        // [kKeys][D + 1], padded against bank conflicts
  float* vs = ks + kKeys * (D + 1);  // [kKeys][D]
  int* kp = reinterpret_cast<int*>(vs + kKeys * D);  // [kKeys]
  int* qp = kp + kKeys;                              // [kRows]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * kRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const int rows = min(kRows, a.Sq - row0);
  const KV* kg = static_cast<const KV*>(a.k);
  const KV* vg = static_cast<const KV*>(a.v);

  for (int e = tid; e < kRows * D; e += blockDim.x) {
    const int r = e / D, d = e - r * D;
    qs[e] = r < rows
                ? a.q[(static_cast<size_t>(b) * a.Sq + row0 + r) * a.Hq * D +
                      static_cast<size_t>(h) * D + d] * a.scale
                : 0.0f;
  }
  for (int r = tid; r < kRows; r += blockDim.x)
    qp[r] = r < rows ? a.qpos[static_cast<size_t>(b) * a.Sq + row0 + r] : 0;
  __syncthreads();
  if (tid == 0) {
    int lo = INT_MAX, hi = INT_MIN;
    for (int r = 0; r < rows; ++r) {
      lo = min(lo, qp[r]);
      hi = max(hi, qp[r]);
    }
    qlo = lo;
    qhi = hi;
  }
  __syncthreads();

  const int wrow = warp * kRowsPerWarp;
  const bool active = wrow < rows;  // warp-uniform
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][NI];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNeg;
    l[r] = 0.0f;
#pragma unroll
    for (int i = 0; i < NI; ++i) acc[r][i] = 0.0f;
  }

  for (int j0 = 0; j0 < a.Sk; j0 += kKeys) {
    int maybe = 0;
    if (tid < kKeys) {
      const int j = j0 + tid;
      const int p = j < a.Sk ? a.kpos[j] : -1;
      kp[tid] = p;
      maybe = p >= 0 && (!a.causal || p <= qhi) && (a.window <= 0 || p > qlo - a.window);
    }
    if (!__syncthreads_or(maybe)) continue;  // no row of the CTA sees this block
    for (int e = tid; e < kKeys * D; e += blockDim.x) {
      const int jj = e / D, d = e - jj * D;
      const int j = j0 + jj;
      float kf = 0.0f, vf = 0.0f;
      if (j < a.Sk) {
        const size_t off = (static_cast<size_t>(b) * a.Sk + j) * a.Hkv * D +
                           static_cast<size_t>(hk) * D + d;
        kf = to_f32(kg[off]);
        vf = to_f32(vg[off]);
      }
      ks[jj * (D + 1) + d] = kf;
      vs[jj * D + d] = vf;
    }
    __syncthreads();
    if (active) {
      const int kpos = kp[lane];
      float s[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.0f;
      const float* krow = ks + lane * (D + 1);
      const float* qrow = qs + wrow * D;
      for (int d = 0; d < D; ++d) {
        const float kd = krow[d];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) s[r] = fmaf(qrow[r * D + d], kd, s[r]);
      }
      float p[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const bool ok = allowed(kpos, qp[wrow + r], a.causal, a.window);
        const float sv = ok ? s[r] : kNeg;
        const float m_new = fmaxf(m[r], warp_max(sv));
        const float alpha = expf(m[r] - m_new);
        p[r] = ok ? expf(sv - m_new) : 0.0f;
        l[r] = l[r] * alpha + warp_sum(p[r]);
        m[r] = m_new;
#pragma unroll
        for (int i = 0; i < NI; ++i) acc[r][i] *= alpha;
      }
      for (int jj = 0; jj < kKeys; ++jj) {
        float pj[kRowsPerWarp];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) pj[r] = __shfl_sync(kFull, p[r], jj);
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          const int d = lane + 32 * i;
          if (d < D) {
            const float vv = vs[jj * D + d];
#pragma unroll
            for (int r = 0; r < kRowsPerWarp; ++r) acc[r][i] = fmaf(pj[r], vv, acc[r][i]);
          }
        }
      }
    }
    __syncthreads();
  }

  if (!active) return;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    if (wrow + r >= rows) break;
    const float den = l[r] > 0.0f ? l[r] : 1.0f;
    float* o = a.out + (static_cast<size_t>(b) * a.Sq + row0 + wrow + r) * a.Hq * D +
               static_cast<size_t>(h) * D;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int d = lane + 32 * i;
      if (d < D) o[d] = acc[r][i] / den;
    }
  }
}

template <typename KV, int NI>
int launch_ni(const Args& a, cudaStream_t s) {
  const size_t smem = smem_bytes(a.D);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attn_kernel<KV, NI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((a.Sq + kRows - 1) / kRows, a.Hq, a.B);
  flash_attn_kernel<KV, NI><<<grid, kWarps * 32, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename KV>
int launch(const void* q, const void* k, const void* v, const void* qpos,
           const void* kpos, void* out, int B, int Sq, int Sk, int Hq, int Hkv,
           int D, int causal, int window, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Hq <= 0 || D <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || D > 32 * 8) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(q), k, v, static_cast<const int*>(qpos),
               static_cast<const int*>(kpos), static_cast<float*>(out),
               B, Sq, Sk, Hq, Hkv, D, causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((D + 31) / 32) {
    case 1: return launch_ni<KV, 1>(a, s);
    case 2: return launch_ni<KV, 2>(a, s);
    case 3: return launch_ni<KV, 3>(a, s);
    case 4: return launch_ni<KV, 4>(a, s);
    case 5: return launch_ni<KV, 5>(a, s);
    case 6: return launch_ni<KV, 6>(a, s);
    case 7: return launch_ni<KV, 7>(a, s);
    default: return launch_ni<KV, 8>(a, s);
  }
}

}  // namespace

#define FLASH_ATTN_EXPORT(NAME, KV)                                                   \
  REPRO_EXPORT int NAME(const void* q, const void* k, const void* v, const void* qpos, \
                        const void* kpos, void* out, int B, int Sq, int Sk, int Hq,   \
                        int Hkv, int D, int causal, int window, float scale,          \
                        void* stream) {                                               \
    return launch<KV>(q, k, v, qpos, kpos, out, B, Sq, Sk, Hq, Hkv, D, causal,       \
                      window, scale, stream);                                         \
  }

FLASH_ATTN_EXPORT(flash_attn_f32, float)
FLASH_ATTN_EXPORT(flash_attn_f16, __half)
FLASH_ATTN_EXPORT(flash_attn_bf16, __nv_bfloat16)
