// GQA attention backward, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference trains through XLA's autodiff of
// src/repro/models/attention.py:chunked_attention (it has no Pallas
// backward). The port's forward is the hand-written flash_attn.cu, whose
// output carries no autograd graph, so its gradient is this kernel, bound
// with the forward under ops.AttentionFn.
//
// q, out, dout, dq [B, Sq, Hq, D] f32; k, v, dk, dv [B, Sk, Hkv, D] f32;
// lse, delta [B, Hq, Sq] f32 (lse from the forward: m + log(l) of the
// scaled scores, -1e30 on a row with no allowed key); qpos int32 [B, Sq],
// kpos int32 [Sk]. The masks are the forward's (causal, window, kpos < 0).
//   P = exp(scale q.k - lse) on allowed keys, 0 elsewhere;
//   dV = P^T dO,  dP = dO V^T,  dS = P (dP - delta),  delta = rowsum(dO O),
//   dQ = scale dS K,  dK = scale dS^T Q.
// A row with no allowed key is sum_{j<Sk} v_j / pad_den in the forward
// (chunked_attention's p = 1 on every key, padding included), so it gives
// dQ = 0, nothing to dK, and dO / pad_den to every dv_j, as autograd of the
// reference gives.
//
// Deterministic, no float atomics: three kernels in one call.
//  1. delta: a warp per (batch, query, head) row.
//  2. dK/dV: a CTA of four warps per (64 keys, KV head, batch row, column
//     chunk), each warp 16 keys; it loops over the GQA group's query heads
//     and their query tiles of 32, so the group's sum stays in registers.
//     Head dims above 128 accumulate in two column chunks of 128, each CTA
//     recomputing the tile's scores.
//  3. dQ: a CTA of four warps per (64 query rows, query head, batch row),
//     each warp 16 rows; it loops over the key tiles of 32.
// Tiles no row of the CTA may see (the causal frontier, the window,
// invalid slots) are skipped after their positions are read. Products run
// on the tensor cores as split-TF32 mma.sync (tf32_mma.cuh, as the
// forward's prefill), near f32's accuracy: scores and dP in the dQ kernel
// (Q K^T, dO V^T), their transposes in the dK/dV kernel (K Q^T, V dO^T),
// and dQ += dS K, dV += P^T dO, dK += dS^T Q from the score fragments in
// registers (keys or queries of each 8-step permuted as in the forward's PV
// product). Seven products of the causal work against the five a fused
// kernel needs; tiles staged by plain loads, one CTA per SM at head dim
// 256. What bounds it: operations (five f32 products); wgmma with TMA is
// later work. Built without --use_fast_math: expf and IEEE division.
#include <climits>
#include <math.h>

#include "common.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 128;  // four warps
constexpr int kRows = 64;      // dQ: query rows per CTA; dK/dV: keys per CTA
constexpr int kTile = 32;      // dQ: keys per tile; dK/dV: query rows per tile
constexpr int kChunk = 128;    // dK/dV: accumulated columns per CTA

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const float* out;
  const float* dout;
  const float* lse;
  const int* qpos;
  const int* kpos;
  float* delta;
  float* dq;
  float* dk;
  float* dv;
  int B, Sq, Sk, Hq, Hkv, D;
  int causal, window;
  float scale, pad_den;
};

__device__ __forceinline__ bool allowed(int kp, int qp, int causal, int window) {
  return kp >= 0 && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
}

// Some query in [qlo, qhi] may see a key at kp.
__device__ __forceinline__ bool live(const Args& a, int kp, int qlo, int qhi) {
  return kp >= 0 && (!a.causal || kp <= qhi) && (a.window <= 0 || kp > qlo - a.window);
}

__device__ __forceinline__ size_t q_off(const Args& a, int b, int i, int h) {
  return (static_cast<size_t>(b) * a.Sq + i) * a.Hq * a.D + static_cast<size_t>(h) * a.D;
}
__device__ __forceinline__ size_t k_off(const Args& a, int b, int j, int hk) {
  return (static_cast<size_t>(b) * a.Sk + j) * a.Hkv * a.D + static_cast<size_t>(hk) * a.D;
}
__device__ __forceinline__ size_t row_off(const Args& a, int b, int h, int i) {
  return (static_cast<size_t>(b) * a.Hq + h) * a.Sq + i;
}

__device__ __forceinline__ void zero_smem(unsigned char* smem, size_t bytes) {
  uint4* w = reinterpret_cast<uint4*>(smem);
  for (size_t e = threadIdx.x; e < bytes / 16; e += kThreads) w[e] = make_uint4(0u, 0u, 0u, 0u);
}

// A operand (16 rows of a row-major [.][st] f32 tile from row r0, columns
// kk * 8 ..), split.
__device__ __forceinline__ void load_a(const float* x, int st, int r0, int kk, int g, int t,
                                       unsigned hi[4], unsigned lo[4]) {
  const float* p0 = x + (r0 + g) * st + kk * 8 + t;
  const float* p1 = p0 + 8 * st;
  split_tf32(p0[0], hi[0], lo[0]);
  split_tf32(p1[0], hi[1], lo[1]);
  split_tf32(p0[4], hi[2], lo[2]);
  split_tf32(p1[4], hi[3], lo[3]);
}

// A operand from a C fragment (16 x 8, rows x the 8-step's columns), the
// columns permuted: column 2t -> k t, column 2t + 1 -> k t + 4.
__device__ __forceinline__ void frag_a(const float c[4], unsigned hi[4], unsigned lo[4]) {
  split_tf32(c[0], hi[0], lo[0]);  // (g, 2t)         -> k = t
  split_tf32(c[2], hi[1], lo[1]);  // (g + 8, 2t)     -> k = t
  split_tf32(c[1], hi[2], lo[2]);  // (g, 2t + 1)     -> k = t + 4
  split_tf32(c[3], hi[3], lo[3]);  // (g + 8, 2t + 1) -> k = t + 4
}

// ---------------------------------------------------------------- delta

__global__ void __launch_bounds__(kThreads) delta_kernel(Args a) {
  const int row = (blockIdx.x * kThreads + threadIdx.x) >> 5;  // (b * Sq + i) * Hq + h
  const int lane = threadIdx.x & 31;
  if (row >= a.B * a.Sq * a.Hq) return;  // warp-uniform
  const int h = row % a.Hq, bi = row / a.Hq;
  const int i = bi % a.Sq, b = bi / a.Sq;
  const float* o = a.out + static_cast<size_t>(row) * a.D;
  const float* g = a.dout + static_cast<size_t>(row) * a.D;
  float s = 0.0f;
  for (int d = lane; d < a.D; d += 32) s = fmaf(o[d], g[d], s);
#pragma unroll
  for (int x = 16; x > 0; x >>= 1) s += __shfl_xor_sync(kFull, s, x);
  if (lane == 0) a.delta[row_off(a, b, h, i)] = s;
}

// ---------------------------------------------------------------- dK, dV

template <int DP>
__host__ __device__ constexpr int chunk_cols() {
  return DP < kChunk ? DP : kChunk;
}

template <int DP>
__host__ __device__ constexpr size_t dkv_smem() {
  return sizeof(float) * ((2 * kRows + 2 * kTile) * (DP + 4) + 2 * kTile + chunk_cols<DP>()) +
         sizeof(int) * (kRows + kTile);
}

template <int DP>
__global__ void __launch_bounds__(kThreads) dkv_kernel(Args a) {
  constexpr int st = DP + 4;
  constexpr int DC = chunk_cols<DP>();
  constexpr int NCH = DP / DC;  // column chunks
  constexpr int ND = DP / 8, NC = DC / 8, NT = kTile / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);  // [kRows][st]
  float* vs = ks + kRows * st;                 // [kRows][st]
  float* qs = vs + kRows * st;                 // [kTile][st], scaled
  float* gs = qs + kTile * st;                 // [kTile][st], dO
  float* ls = gs + kTile * st;                 // [kTile] lse
  float* dl = ls + kTile;                      // [kTile] delta
  float* ex = dl + kTile;                      // [DC] the no-key rows' dv term
  int* kp = reinterpret_cast<int*>(ex + DC);   // [kRows]
  int* qp = kp + kRows;                        // [kTile]
  const int D = a.D, G = a.Hq / a.Hkv;
  const int chunk = blockIdx.x % NCH, key0 = (blockIdx.x / NCH) * kRows;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int keys = min(kRows, a.Sk - key0);
  const int c0 = chunk * DC;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  zero_smem(smem, dkv_smem<DP>());
  __syncthreads();
  for (int e = tid; e < keys * D; e += kThreads) {
    const int r = e / D, d = e - r * D;
    const size_t off = k_off(a, b, key0 + r, hk) + d;
    ks[r * st + d] = a.k[off];
    vs[r * st + d] = a.v[off];
  }
  if (tid < kRows) kp[tid] = tid < keys ? a.kpos[key0 + tid] : -1;

  // Rows with no allowed key in the group's heads: their dO / pad_den
  // lands on every key (summed in row order, per column).
  bool nokey = false;
  for (int e = tid; e < G * a.Sq; e += kThreads)
    nokey |= a.lse[row_off(a, b, hk * G + e / a.Sq, e % a.Sq)] == kNeg;
  if (__syncthreads_or(nokey)) {
    for (int d = tid; d < DC; d += kThreads) {
      float s = 0.0f;
      if (c0 + d < D)
        for (int hh = hk * G; hh < (hk + 1) * G; ++hh)
          for (int i = 0; i < a.Sq; ++i)
            if (a.lse[row_off(a, b, hh, i)] == kNeg) s += a.dout[q_off(a, b, i, hh) + c0 + d] / a.pad_den;
      ex[d] = s;
    }
  }
  __syncthreads();

  const int r0 = warp * 16;  // the warp's keys r0 + g, r0 + g + 8
  const int kp0 = kp[r0 + g], kp1 = kp[r0 + g + 8];
  float dv[NC][4], dk[NC][4];
#pragma unroll
  for (int n = 0; n < NC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv[n][e] = dk[n][e] = 0.0f;

  const int nq = (a.Sq + kTile - 1) / kTile;
  for (int hh = hk * G; hh < (hk + 1) * G; ++hh) {
    for (int qt = 0; qt < nq; ++qt) {
      const int i0 = qt * kTile;
      const int nrow = min(kTile, a.Sq - i0);
      __syncthreads();  // the last tile is consumed
      if (tid < kTile) {
        const bool ok = tid < nrow;
        qp[tid] = ok ? a.qpos[static_cast<size_t>(b) * a.Sq + i0 + tid] : 0;
        ls[tid] = ok ? a.lse[row_off(a, b, hh, i0 + tid)] : INFINITY;
        dl[tid] = ok ? a.delta[row_off(a, b, hh, i0 + tid)] : 0.0f;
      }
      __syncthreads();
      int qlo = INT_MAX, qhi = INT_MIN;
      for (int r = 0; r < nrow; ++r) {
        qlo = min(qlo, qp[r]);
        qhi = max(qhi, qp[r]);
      }
      const bool mine = tid < keys && live(a, kp[tid], qlo, qhi);
      if (!__syncthreads_or(mine)) continue;  // uniform: no key of the CTA is seen
      for (int e = tid; e < kTile * D; e += kThreads) {
        const int r = e / D, d = e - r * D;
        float qv = 0.0f, gv = 0.0f;
        if (r < nrow) {
          const size_t off = q_off(a, b, i0 + r, hh) + d;
          qv = a.q[off] * a.scale;
          gv = a.dout[off];
        }
        qs[r * st + d] = qv;
        gs[r * st + d] = gv;
      }
      __syncthreads();

      // S^T = K Qs^T and dP^T = V dO^T for the warp's 16 keys and the
      // tile's 32 queries.
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
#pragma unroll 4
      for (int kk = 0; kk < ND; ++kk) {
        unsigned kh[4], kl[4], vh[4], vl[4];
        load_a(ks, st, r0, kk, g, t, kh, kl);
        load_a(vs, st, r0, kk, g, t, vh, vl);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const float* qr = qs + (n * 8 + g) * st + kk * 8 + t;
          const float* gr = gs + (n * 8 + g) * st + kk * 8 + t;
          mma3<true>(s[n], kh, kl, qr[0], qr[4]);
          mma3<true>(dp[n], vh, vl, gr[0], gr[4]);
        }
      }
      // P^T and dS^T on the fragments: (key, query) entries.
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n * 8 + 2 * t + (e & 1);
          const int kpos = e < 2 ? kp0 : kp1;
          const bool ok = col < nrow && allowed(kpos, qp[col], a.causal, a.window);
          const float p = ok ? expf(s[n][e] - ls[col]) : 0.0f;
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - dl[col]);
        }
      }
      // dV += P^T dO, dK += dS^T Qs over the chunk's columns.
#pragma unroll
      for (int kk = 0; kk < NT; ++kk) {
        unsigned ph[4], pl[4], sh[4], sl[4];
        frag_a(s[kk], ph, pl);
        frag_a(dp[kk], sh, sl);
        const float* g0 = gs + (kk * 8 + 2 * t) * st + c0 + g;
        const float* q0 = qs + (kk * 8 + 2 * t) * st + c0 + g;
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          mma3<true>(dv[n], ph, pl, g0[n * 8], g0[st + n * 8]);
          mma3<true>(dk[n], sh, sl, q0[n * 8], q0[st + n * 8]);
        }
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + g + 8 * half;
    if (r >= keys) continue;
    float* dkr = a.dk + k_off(a, b, key0 + r, hk);
    float* dvr = a.dv + k_off(a, b, key0 + r, hk);
#pragma unroll
    for (int n = 0; n < NC; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = n * 8 + 2 * t + e;
        if (c0 + c < D) {
          dkr[c0 + c] = dk[n][2 * half + e];
          dvr[c0 + c] = dv[n][2 * half + e] + ex[c];
        }
      }
    }
  }
}

// ---------------------------------------------------------------- dQ

template <int DP>
__host__ __device__ constexpr size_t dq_smem() {
  return sizeof(float) * (2 * kRows + 2 * kTile) * (DP + 4) + sizeof(int) * (kTile + kRows);
}

template <int DP>
__global__ void __launch_bounds__(kThreads) dq_kernel(Args a) {
  constexpr int st = DP + 4;
  constexpr int ND = DP / 8, NT = kTile / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // [kRows][st], scaled
  float* gs = qs + kRows * st;                 // [kRows][st], dO
  float* ks = gs + kRows * st;                 // [kTile][st]
  float* vs = ks + kTile * st;                 // [kTile][st]
  int* kp = reinterpret_cast<int*>(vs + kTile * st);  // [kTile]
  int* qp = kp + kTile;                               // [kRows]
  const int D = a.D;
  const int row0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const int rows = min(kRows, a.Sq - row0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  zero_smem(smem, dq_smem<DP>());
  __syncthreads();
  for (int e = tid; e < rows * D; e += kThreads) {
    const int r = e / D, d = e - r * D;
    const size_t off = q_off(a, b, row0 + r, h) + d;
    qs[r * st + d] = a.q[off] * a.scale;
    gs[r * st + d] = a.dout[off];
  }
  if (tid < rows) qp[tid] = a.qpos[static_cast<size_t>(b) * a.Sq + row0 + tid];
  __syncthreads();
  int qlo = INT_MAX, qhi = INT_MIN;
  for (int r = 0; r < rows; ++r) {
    qlo = min(qlo, qp[r]);
    qhi = max(qhi, qp[r]);
  }
  const int r0 = warp * 16 + g, r1 = r0 + 8;
  const bool v0 = r0 < rows, v1 = r1 < rows;
  const int qp0 = qp[r0], qp1 = qp[r1];
  const float lse0 = v0 ? a.lse[row_off(a, b, h, row0 + r0)] : 0.0f;
  const float lse1 = v1 ? a.lse[row_off(a, b, h, row0 + r1)] : 0.0f;
  const float dl0 = v0 ? a.delta[row_off(a, b, h, row0 + r0)] : 0.0f;
  const float dl1 = v1 ? a.delta[row_off(a, b, h, row0 + r1)] : 0.0f;

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;

  const int ntiles = (a.Sk + kTile - 1) / kTile;
  for (int tile = 0; tile < ntiles; ++tile) {
    const int j0 = tile * kTile;
    __syncthreads();  // the last tile is consumed
    bool mine = false;
    if (tid < kTile) {
      const int j = j0 + tid;
      const int p = j < a.Sk ? a.kpos[j] : -1;
      kp[tid] = p;
      mine = live(a, p, qlo, qhi);
    }
    if (!__syncthreads_or(mine)) continue;  // uniform: no row of the CTA sees the tile
    for (int e = tid; e < kTile * D; e += kThreads) {
      const int jj = e / D, d = e - jj * D;
      const int j = j0 + jj;
      float kv = 0.0f, vv = 0.0f;
      if (j < a.Sk) {
        const size_t off = k_off(a, b, j, hk) + d;
        kv = a.k[off];
        vv = a.v[off];
      }
      ks[jj * st + d] = kv;
      vs[jj * st + d] = vv;
    }
    __syncthreads();

    // S = Qs K^T and dP = dO V^T for the warp's 16 rows and the tile's keys.
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
#pragma unroll 4
    for (int kk = 0; kk < ND; ++kk) {
      unsigned qh[4], ql[4], gh[4], gl[4];
      load_a(qs, st, warp * 16, kk, g, t, qh, ql);
      load_a(gs, st, warp * 16, kk, g, t, gh, gl);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float* kr = ks + (n * 8 + g) * st + kk * 8 + t;
        const float* vr = vs + (n * 8 + g) * st + kk * 8 + t;
        mma3<true>(s[n], qh, ql, kr[0], kr[4]);
        mma3<true>(dp[n], gh, gl, vr[0], vr[4]);
      }
    }
    // dS on the fragments: (row, key) entries.
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = kp[n * 8 + 2 * t + (e & 1)];
        const bool up = e < 2;
        const bool ok = (up ? v0 : v1) && allowed(kpos, up ? qp0 : qp1, a.causal, a.window);
        const float p = ok ? expf(s[n][e] - (up ? lse0 : lse1)) : 0.0f;
        s[n][e] = p * (dp[n][e] - (up ? dl0 : dl1));
      }
    }
    // dQ += dS K.
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      unsigned sh[4], sl[4];
      frag_a(s[kk], sh, sl);
      const float* k0 = ks + (kk * 8 + 2 * t) * st + g;
#pragma unroll
      for (int n = 0; n < ND; ++n) mma3<true>(acc[n], sh, sl, k0[n * 8], k0[st + n * 8]);
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? r1 : r0;
    if (r >= rows) continue;
    float* dqr = a.dq + q_off(a, b, row0 + r, h);
#pragma unroll
    for (int n = 0; n < ND; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = n * 8 + 2 * t + e;
        if (d < D) dqr[d] = acc[n][2 * half + e] * a.scale;
      }
    }
  }
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(bytes)));
}

template <int DP>
int launch_dp(const Args& a, cudaStream_t s) {
  const long rows = static_cast<long>(a.B) * a.Sq * a.Hq;
  delta_kernel<<<static_cast<unsigned>((rows * 32 + kThreads - 1) / kThreads), kThreads, 0, s>>>(a);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  constexpr size_t kv_bytes = dkv_smem<DP>();
  if ((err = set_smem(dkv_kernel<DP>, kv_bytes))) return err;
  const int kv_ctas = (a.Sk + kRows - 1) / kRows * (DP / chunk_cols<DP>());
  dkv_kernel<DP><<<dim3(kv_ctas, a.Hkv, a.B), kThreads, kv_bytes, s>>>(a);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  constexpr size_t q_bytes = dq_smem<DP>();
  if ((err = set_smem(dq_kernel<DP>, q_bytes))) return err;
  dq_kernel<DP><<<dim3((a.Sq + kRows - 1) / kRows, a.Hq, a.B), kThreads, q_bytes, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int launch(const Args& a, cudaStream_t s) {
  if (a.B <= 0 || a.Sq <= 0 || a.Sk <= 0 || a.Hq <= 0 || a.D <= 0) return 0;
  if (a.Hkv <= 0 || a.Hq % a.Hkv != 0 || a.D > 256 || a.Hq > 65535 || a.B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.D <= 32) return launch_dp<32>(a, s);
  if (a.D <= 64) return launch_dp<64>(a, s);
  if (a.D <= 128) return launch_dp<128>(a, s);
  return launch_dp<256>(a, s);
}

}  // namespace

REPRO_EXPORT int flash_attn_bwd_f32(const void* q, const void* k, const void* v, const void* out,
                                    const void* dout, const void* lse, const void* qpos,
                                    const void* kpos, void* delta, void* dq, void* dk, void* dv,
                                    int B, int Sq, int Sk, int Hq, int Hkv, int D, int causal,
                                    int window, float scale, float pad_den, void* stream) {
  const Args a{static_cast<const float*>(q),    static_cast<const float*>(k),
               static_cast<const float*>(v),    static_cast<const float*>(out),
               static_cast<const float*>(dout), static_cast<const float*>(lse),
               static_cast<const int*>(qpos),   static_cast<const int*>(kpos),
               static_cast<float*>(delta),      static_cast<float*>(dq),
               static_cast<float*>(dk),         static_cast<float*>(dv),
               B, Sq, Sk, Hq, Hkv, D, causal, window, scale, pad_den};
  return launch(a, static_cast<cudaStream_t>(stream));
}
