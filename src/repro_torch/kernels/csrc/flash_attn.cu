// GQA online-softmax attention (forward), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attn.py
// (flash_attention -> _flash_kernel), in the form of its XLA mirror
// src/repro/models/attention.py:chunked_attention, which the model runs:
// q [B, Sq, Hq, D] f32, k/v [B, Sk, Hkv, D] in f32, fp16 or bf16, qpos
// int32 [B, Sq], kpos int32 [Sk] with kpos < 0 an invalid slot, out
// [B, Sq, Hq, D] f32. Query head h reads KV head h / (Hq / Hkv). A key is
// allowed iff it is valid, kpos <= qpos when causal, and kpos > qpos -
// window when window > 0. Allowed keys take p = exp(s - m) with the
// running max m, masked keys an exact 0; the output is acc / l. A row
// with no allowed key gets the reference's value: chunked_attention keeps
// m = -1e30 there, so every key, its padding included, takes p = 1, and
// the row is sum_{j<Sk} v_j / (Sk + pad), pad = -Sk mod min(1024, Sk)
// (pad_den below); the kernel sums v over every slot for such a row.
//
// Both paths stream K/V in tiles through a ring in shared memory (three
// stages for decode, two for prefill, where a third stage measured slower
// by costing CTAs per SM), filled by cp.async (16-byte copies where D *
// sizeof(KV) allows, the tile's kpos beside them), so the next tiles are
// in flight while one is computed. Which tiles any row of a CTA may see is found up front, 32
// tiles per pass over kpos (one latency), and the others are never
// copied (the causal frontier, the window, invalid slots), except the
// first ones the ring holds, whose copies start with q's, before the
// pass; a dead one of those is skipped.
//
// Decode (Sq * Hq/Hkv <= 16 rows per KV head; the launcher in
// kernels/flash_attn.py chooses from the shapes): split-K. One CTA of four
// warps per (KV split, KV head, batch row) holds every query row of the
// GQA group, so each K/V byte is read once per call. A split is a
// contiguous range of at most 1,024 slots in tiles of 32 keys. Lane j
// scores key j against the warp's rows (CUDA-core f32 FMAs; rows padded
// by 16 bytes so the lanes' vector reads of their key rows hit distinct
// banks), a warp updates its rows' running max and sum, and each thread
// accumulates its outputs over the tile's values. Each split writes its
// partial (m, l, acc[D]) per row to run scratch; the last CTA of a (batch
// row, KV head) to take a ticket combines the splits in split order
// (deterministic) and resets the ticket, so a call is one launch. What
// bounds it: bytes (the serve's decode reads 2.8 MB of fp16 K/V, 0.83 us
// at 3.35 TB/s), and at short caches the latency of the chain: q and
// kpos, the K/V tiles, the partials, the combine.
//
// Prefill (everything else): one CTA of four warps per (64 query rows,
// query head, batch row), each warp 16 rows. QK^T and PV run on the
// tensor cores as mma.sync.m16n8k8 TF32 with split operands: an f32 x is
// hi + lo, hi x rounded to TF32 by integer add and mask (no cvt), lo = x -
// hi exactly, and a product takes a_lo*b_hi + a_hi*b_lo + a_hi*b_hi in f32
// accumulators, about f32's accuracy (one pass of TF32 keeps three
// digits). fp16 and bf16 values are exact in TF32, so with such K/V only
// Q and P split: two MMAs a product. P feeds the PV product from the
// QK^T accumulators in registers, with the keys of each 8-key step
// permuted to match (key 2t <-> k t, key 2t+1 <-> k t+4), and V read in
// that order. Tiles are 64 keys, 32 or 16 where the K/V ring would
// crowd the SM (f32 or D above 64). The running max and
// sum stay in f32 registers per row. mma.sync is the form built here;
// wgmma with TMA would need V transposed while staged (TF32 wgmma takes
// both operands K-major) and is later work. What bounds it: operations
// (the serve's prefill is 2.0 GFLOP of f32 work, 30 us at 67 TFLOP/s; as
// split TF32 it is three tensor-core passes).
//
// With an lse pointer (training; the launcher then takes the prefill path)
// each row also writes lse = m + log(l), or -1e30 for a row with no allowed
// key, which the backward (flash_attn_bwd.cu) reads; serving passes null.
//
// Head dims up to 256 on both paths. Built without --use_fast_math:
// expf and IEEE division.
#include <climits>
#include <type_traits>

#include "common.cuh"
#include "cp_async.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 128;    // both paths: four warps
constexpr int kDecStages = 3;    // decode K/V tiles in the ring
constexpr int kPreStages = 2;    // prefill's: a third would cost a CTA per SM
constexpr int kWindow = 32;      // tiles one liveness pass covers
constexpr int kDecTile = 32;     // decode keys per tile, one a lane
constexpr int kDecMaxRows = 16;  // query rows per decode CTA
constexpr int kPreRows = 64;     // prefill query rows per CTA

struct Args {
  const float* q;
  const void* k;
  const void* v;
  const int* qpos;
  const int* kpos;
  float* out;
  float* lse;    // [B, Hq, Sq] m + log(l) per row (kNeg: no allowed key), or null
  float* part;   // decode: [B * Hkv * splits][rows][D + 2 rounded up to 4] partials
  int* tickets;  // decode: [B * Hkv], zero between calls
  int B, Sq, Sk, Hq, Hkv, D;
  int causal, window;
  float scale, pad_den;
  int splits, kps;  // decode: KV splits and keys per split (<= kWindow * kDecTile)
  int vec;          // 16-byte copies allowed (D * sizeof(KV) % 16 == 0, aligned)
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

template <typename KV>
using Bits = typename std::conditional<sizeof(KV) == 2, unsigned short, unsigned>::type;

// Queue the copy of tile t (keys [j0 + t * tile, + tile), none past jend)
// of (batch b, KV head hk): K and V rows into kt/vt (rows of rs elements,
// D used; keys past jend zero rows) and kpos into kp (-1 past jend).
template <typename KV>
__device__ __forceinline__ void queue_tile(const Args& a, int t, int tile, int j0, int jend,
                                           int b, int hk, KV* kt, KV* vt, int rs, int* kp) {
  const int D = a.D;
  const int first = j0 + t * tile;
  const KV* kg = static_cast<const KV*>(a.k);
  const KV* vg = static_cast<const KV*>(a.v);
  if (threadIdx.x < tile) {
    const int j = first + threadIdx.x;
    if (j < jend) cp_async4(kp + threadIdx.x, a.kpos + j);
    else kp[threadIdx.x] = -1;
  }
  if (a.vec) {
    constexpr int E = 16 / sizeof(KV);
    const int cpr = D / E;
    for (int c = threadIdx.x; c < tile * cpr; c += kThreads) {
      const int jj = c / cpr, ch = c - jj * cpr;
      const int j = first + jj;
      const size_t off = (static_cast<size_t>(b) * a.Sk + j) * a.Hkv * D +
                         static_cast<size_t>(hk) * D + ch * E;
      KV* dk = kt + jj * rs + ch * E;
      KV* dv = vt + jj * rs + ch * E;
      if (j < jend) {
        cp_async16(dk, kg + off);
        cp_async16(dv, vg + off);
      } else {
        *reinterpret_cast<uint4*>(dk) = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(dv) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  } else {
    const Bits<KV>* kb = reinterpret_cast<const Bits<KV>*>(kg);
    const Bits<KV>* vb = reinterpret_cast<const Bits<KV>*>(vg);
    Bits<KV>* dk = reinterpret_cast<Bits<KV>*>(kt);
    Bits<KV>* dv = reinterpret_cast<Bits<KV>*>(vt);
    for (int e = threadIdx.x; e < tile * D; e += kThreads) {
      const int jj = e / D, d = e - jj * D;
      const int j = first + jj;
      const size_t off = (static_cast<size_t>(b) * a.Sk + j) * a.Hkv * D +
                         static_cast<size_t>(hk) * D + d;
      dk[jj * rs + d] = j < jend ? kb[off] : Bits<KV>(0);
      dv[jj * rs + d] = j < jend ? vb[off] : Bits<KV>(0);
    }
  }
}

// The liveness of tiles [w0, w0 + kWindow): kpos loaded in one pass
// (kPer keys a thread), then a bit per tile that some row in [qlo, qhi]
// may see, or-ed into *mask (zeroed by the caller before its last
// barrier). The caller publishes *mask with a barrier.
template <int kPer>
__device__ __forceinline__ void window_load(const Args& a, int w0, int ntiles, int tile, int j0,
                                            int jend, int (&v)[kPer]) {
  const int n = min(kWindow, ntiles - w0) * tile;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int k = threadIdx.x + i * kThreads;
    const int j = j0 + w0 * tile + k;
    v[i] = (k < n && j < jend) ? a.kpos[j] : -1;
  }
}

template <int kPer>
__device__ __forceinline__ void window_mask(const Args& a, int tile, const int (&v)[kPer],
                                            int qlo, int qhi, unsigned* mask) {
  unsigned bits = 0u;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int p = v[i];
    if (p >= 0 && (!a.causal || p <= qhi) && (a.window <= 0 || p > qlo - a.window))
      bits |= 1u << ((threadIdx.x + i * kThreads) / tile);
  }
  if (bits) atomicOr(mask, bits);
}

// The first live tile at or after `from` (ntiles if none): from the mask
// of the window starting at w0, a new pass where `from` leaves it. Every
// thread of the CTA calls it with the same arguments.
template <int kPer>
__device__ int next_live(const Args& a, int from, int ntiles, int tile, int j0, int jend,
                         int qlo, int qhi, int& w0, unsigned* mask) {
  while (from < ntiles) {
    if (from >= w0 + kWindow) {
      int v[kPer];
      window_load<kPer>(a, from, ntiles, tile, j0, jend, v);
      __syncthreads();  // every thread has read the old mask
      if (threadIdx.x == 0) *mask = 0u;
      __syncthreads();
      window_mask<kPer>(a, tile, v, qlo, qhi, mask);
      __syncthreads();
      w0 = from;
    }
    const unsigned m = *mask >> (from - w0);
    if (m) return from + __ffs(m) - 1;
    from = w0 + kWindow;
  }
  return ntiles;
}

// sum_{j<Sk} v[b, j, hk, d] / pad_den: a row with no allowed key.
template <typename KV>
__device__ float empty_row(const Args& a, int b, int hk, int d) {
  const KV* vg = static_cast<const KV*>(a.v);
  float s = 0.0f;
  for (int j = 0; j < a.Sk; ++j)
    s += to_f32(vg[(static_cast<size_t>(b) * a.Sk + j) * a.Hkv * a.D +
                   static_cast<size_t>(hk) * a.D + d]);
  return s / a.pad_den;
}

// ---------------------------------------------------------------- decode

template <typename KV>
size_t decode_smem(int R, int D) {
  const int rs = D + 16 / static_cast<int>(sizeof(KV));
  return 2 * kDecStages * kDecTile * rs * sizeof(KV) +                  // K, V tiles
         sizeof(float) * (R * D + R * kDecTile + 3 * kDecMaxRows) +  // q, p, m, l, alpha
         sizeof(int) * (kDecStages * kDecTile + kDecMaxRows);            // kpos, qpos
}

template <typename KV, int NO>
__global__ void __launch_bounds__(kThreads) decode_kernel(Args a) {
  constexpr int kPer = kWindow * kDecTile / kThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned mask;
  __shared__ int last;
  const int D = a.D, G = a.Hq / a.Hkv, R = a.Sq * G;
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rs = D + 16 / static_cast<int>(sizeof(KV));
  KV* kt = reinterpret_cast<KV*>(smem);  // [kDecStages][kDecTile][rs]
  KV* vt = kt + kDecStages * kDecTile * rs;
  float* qs = reinterpret_cast<float*>(vt + kDecStages * kDecTile * rs);  // [R][D]
  float* ps = qs + R * D;         // [R][kDecTile]
  float* ms = ps + R * kDecTile;  // [kDecMaxRows]
  float* ls = ms + kDecMaxRows;
  float* al = ls + kDecMaxRows;
  int* kp = reinterpret_cast<int*>(al + kDecMaxRows);  // [kDecStages][kDecTile]
  int* qp = kp + kDecStages * kDecTile;                    // [kDecMaxRows]

  // q, qpos (row r is query r / G of head hk * G + r % G), this split's
  // kpos and its first tiles (before their liveness is known: a dead
  // tile's pass changes no bit, and it is skipped), all in flight at once.
  for (int e = tid; e < R * D; e += kThreads) {
    const int r = e / D, d = e - r * D;
    cp_async4(qs + e, a.q + (static_cast<size_t>(b) * a.Sq + r / G) * a.Hq * D +
                          static_cast<size_t>(hk * G + r % G) * D + d);
  }
  if (tid < R) cp_async4(qp + tid, a.qpos + static_cast<size_t>(b) * a.Sq + tid / G);
  cp_async_commit();
  const int j0 = split * a.kps, jend = min(a.Sk, j0 + a.kps);
  const int ntiles = jend > j0 ? (jend - j0 + kDecTile - 1) / kDecTile : 0;
  const int spec = min(kDecStages - 1, ntiles);
#pragma unroll
  for (int s = 0; s < kDecStages - 1; ++s) {
    if (s < spec)
      queue_tile(a, s, kDecTile, j0, jend, b, hk, kt + s * kDecTile * rs,
                 vt + s * kDecTile * rs, rs, kp + s * kDecTile);
    cp_async_commit();
  }
  int v[kPer];
  window_load<kPer>(a, 0, ntiles, kDecTile, j0, jend, v);
  if (tid == 0) mask = 0u;
  if (tid < R) {
    ms[tid] = kNeg;
    ls[tid] = 0.0f;
  }
  cp_async_wait<kDecStages - 1>();  // q and qpos
  __syncthreads();
  for (int e = tid; e < R * D; e += kThreads) qs[e] *= a.scale;
  int qlo = INT_MAX, qhi = INT_MIN;
  for (int r = 0; r < R; ++r) {
    qlo = min(qlo, qp[r]);
    qhi = max(qhi, qp[r]);
  }
  window_mask<kPer>(a, kDecTile, v, qlo, qhi, &mask);
  __syncthreads();

  int w0 = 0;  // kps <= kWindow * kDecTile: one window
  unsigned live = mask & ((1u << spec) - 1u);  // bit s: stage s holds a live tile
  int nxt = next_live<kPer>(a, spec, ntiles, kDecTile, j0, jend, qlo, qhi, w0, &mask);
  int pending = spec;

  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.0f;
  for (int stage = 0; pending > 0; --pending, stage = (stage + 1) % kDecStages) {
    cp_async_wait<kDecStages - 2>();
    __syncthreads();  // this tile landed; the stage computed last is free
    if (nxt < ntiles) {
      const int s = (stage + kDecStages - 1) % kDecStages;
      queue_tile(a, nxt, kDecTile, j0, jend, b, hk, kt + s * kDecTile * rs,
                 vt + s * kDecTile * rs, rs, kp + s * kDecTile);
      live |= 1u << s;
      ++pending;
      nxt = next_live<kPer>(a, nxt + 1, ntiles, kDecTile, j0, jend, qlo, qhi, w0, &mask);
    }
    cp_async_commit();
    if (!(live >> stage & 1u)) continue;  // uniform: a speculative tile no row sees
    live &= ~(1u << stage);

    // Scores: lane = key, the warp's rows warp, warp + 4, ...
    const KV* krow = kt + (stage * kDecTile + lane) * rs;
    float sc[kDecMaxRows / 4];
#pragma unroll
    for (int rr = 0; rr < kDecMaxRows / 4; ++rr) sc[rr] = 0.0f;
    if (a.vec) {
      constexpr int E = 16 / sizeof(KV);
      for (int d0 = 0; d0 < D; d0 += E) {
        const uint4 raw = *reinterpret_cast<const uint4*>(krow + d0);
        const KV* x = reinterpret_cast<const KV*>(&raw);
#pragma unroll
        for (int rr = 0; rr < kDecMaxRows / 4; ++rr) {
          const int r = warp + 4 * rr;
          if (r < R) {
#pragma unroll
            for (int e = 0; e < E; ++e) sc[rr] = fmaf(qs[r * D + d0 + e], to_f32(x[e]), sc[rr]);
          }
        }
      }
    } else {
      for (int d = 0; d < D; ++d) {
        const float kd = to_f32(krow[d]);
#pragma unroll
        for (int rr = 0; rr < kDecMaxRows / 4; ++rr) {
          const int r = warp + 4 * rr;
          if (r < R) sc[rr] = fmaf(qs[r * D + d], kd, sc[rr]);
        }
      }
    }
    const int kpos = kp[stage * kDecTile + lane];
#pragma unroll
    for (int rr = 0; rr < kDecMaxRows / 4; ++rr) {
      const int r = warp + 4 * rr;
      if (r < R) {  // warp-uniform
        const bool ok = allowed(kpos, qp[r], a.causal, a.window);
        const float sv = ok ? sc[rr] : kNeg;
        const float m_old = ms[r];
        const float m_new = fmaxf(m_old, warp_max(sv));
        const float alpha = expf(m_old - m_new);
        const float p = ok ? expf(sv - m_new) : 0.0f;
        const float l = ls[r] * alpha + warp_sum(p);
        ps[r * kDecTile + lane] = p;
        __syncwarp();
        if (lane == 0) {
          ms[r] = m_new;
          ls[r] = l;
          al[r] = alpha;
        }
      }
    }
    __syncthreads();
    // Values: thread tid owns outputs o = tid + 128 i of the [R][D] rows.
    const KV* vs = vt + stage * kDecTile * rs;
#pragma unroll
    for (int i = 0; i < NO; ++i) {
      const int o = tid + kThreads * i;
      if (o < R * D) {
        const int r = o / D, d = o - r * D;
        float s = acc[i] * al[r];
        const float* pr = ps + r * kDecTile;
#pragma unroll 8
        for (int jj = 0; jj < kDecTile; ++jj) s = fmaf(pr[jj], to_f32(vs[jj * rs + d]), s);
        acc[i] = s;
      }
    }
  }
  __syncthreads();  // ms, ls final

  // This split's partial, then the ticket.
  const int pair = b * a.Hkv + hk;
  const int stride = (D + 2 + 3) / 4 * 4;  // (m, l, acc[D]), 16-byte rows
  float* part = a.part + (static_cast<size_t>(pair) * a.splits + split) * R * stride;
#pragma unroll
  for (int i = 0; i < NO; ++i) {
    const int o = tid + kThreads * i;
    if (o < R * D) {
      const int r = o / D, d = o - r * D;
      part[r * stride + 2 + d] = acc[i];
    }
  }
  if (tid < R) {
    part[tid * stride] = ms[tid];
    part[tid * stride + 1] = ls[tid];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = a.splits == 1 || atomicAdd(a.tickets + pair, 1) == a.splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (tid == 0 && a.splits > 1) a.tickets[pair] = 0;  // ready for the next call

  // Combine the splits in split order, from shared memory (the K/V ring,
  // done with) where the pair's partials fit, in one round of 16-byte
  // copies from L2; else straight from L2.
  const float* base = a.part + static_cast<size_t>(pair) * a.splits * R * stride;
  const int n4 = a.splits * R * stride / 4;
  const bool staged = n4 * 16 <= 2 * kDecStages * kDecTile * rs * static_cast<int>(sizeof(KV));
  float* pst = reinterpret_cast<float*>(smem);
  cp_async_wait<0>();
  __syncthreads();
  if (staged) {
    for (int c = tid; c < n4; c += kThreads) cp_async16(pst + 4 * c, base + 4 * c);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }
  auto ld = [&](int i) { return staged ? pst[i] : __ldcg(base + i); };
  for (int o = tid; o < R * D; o += kThreads) {
    const int r = o / D, d = o - r * D;
    float m = kNeg;
#pragma unroll 8
    for (int s = 0; s < a.splits; ++s) m = fmaxf(m, ld((s * R + r) * stride));
    float y;
    if (m == kNeg) {
      y = empty_row<KV>(a, b, hk, d);
    } else {
      float l = 0.0f, num = 0.0f;
#pragma unroll 8
      for (int s = 0; s < a.splits; ++s) {
        const int i = (s * R + r) * stride;
        const float w = expf(ld(i) - m);
        l += ld(i + 1) * w;
        num += ld(i + 2 + d) * w;
      }
      y = num / l;
    }
    a.out[(static_cast<size_t>(b) * a.Sq + r / G) * a.Hq * D +
          static_cast<size_t>(hk * G + r % G) * D + d] = y;
  }
}

// --------------------------------------------------------------- prefill

// Keys per prefill tile: 64, or fewer where the ring of K/V tiles would
// crowd out a second and third CTA per SM (about 64 KB and 104 KB).
template <typename KV>
__host__ __device__ constexpr size_t ring_bytes(int DP, int BN) {
  return 2 * kPreStages * BN * (DP + 16 / sizeof(KV)) * sizeof(KV);
}
template <typename KV>
__host__ __device__ constexpr int pre_keys(int DP) {
  return ring_bytes<KV>(DP, 64) <= 64 * 1024 ? 64 : ring_bytes<KV>(DP, 32) <= 104 * 1024 ? 32 : 16;
}

template <typename KV, int DP>
__host__ __device__ constexpr size_t prefill_smem() {
  return sizeof(float) * kPreRows * (DP + 4) + ring_bytes<KV>(DP, pre_keys<KV>(DP)) +
         sizeof(int) * (kPreStages * pre_keys<KV>(DP) + kPreRows);
}

template <typename KV, int DP>
__global__ void __launch_bounds__(kThreads) prefill_kernel(Args a) {
  constexpr int BN = pre_keys<KV>(DP);
  constexpr int NT = BN / 8;  // 8-key steps of a tile
  constexpr int ND = DP / 8;  // 8-column steps of the head dim
  constexpr int rs = DP + 16 / sizeof(KV);
  constexpr int qstride = DP + 4;
  constexpr int kPer = kWindow * BN / kThreads;
  constexpr bool kSplitB = sizeof(KV) == 4;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned mask;
  float* qs = reinterpret_cast<float*>(smem);  // [kPreRows][DP + 4], scaled
  KV* kt = reinterpret_cast<KV*>(qs + kPreRows * qstride);  // [kPreStages][BN][rs]
  KV* vt = kt + kPreStages * BN * rs;
  int* kp = reinterpret_cast<int*>(vt + kPreStages * BN * rs);  // [kPreStages][BN]
  int* qp = kp + kPreStages * BN;                               // [kPreRows]
  const int D = a.D;
  const int row0 = blockIdx.x * kPreRows, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const int rows = min(kPreRows, a.Sq - row0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  // Zero everything once: the columns past D stay zero in q, K and V.
  {
    constexpr int words = static_cast<int>(prefill_smem<KV, DP>() / 16);
    uint4* w = reinterpret_cast<uint4*>(smem);
    for (int e = tid; e < words; e += kThreads) w[e] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  // q, qpos, the first window's kpos and the first tiles (before their
  // liveness is known; a dead one is skipped), all in flight at once.
  for (int e = tid; e < rows * D; e += kThreads) {
    const int r = e / D, d = e - r * D;
    cp_async4(qs + r * qstride + d, a.q + (static_cast<size_t>(b) * a.Sq + row0 + r) * a.Hq * D +
                                        static_cast<size_t>(h) * D + d);
  }
  if (tid < rows) cp_async4(qp + tid, a.qpos + static_cast<size_t>(b) * a.Sq + row0 + tid);
  cp_async_commit();
  const int ntiles = (a.Sk + BN - 1) / BN;
  const int spec = min(kPreStages - 1, ntiles);
#pragma unroll
  for (int s = 0; s < kPreStages - 1; ++s) {
    if (s < spec)
      queue_tile(a, s, BN, 0, a.Sk, b, hk, kt + s * BN * rs, vt + s * BN * rs, rs, kp + s * BN);
    cp_async_commit();
  }
  int v[kPer];
  window_load<kPer>(a, 0, ntiles, BN, 0, a.Sk, v);
  if (tid == 0) mask = 0u;
  cp_async_wait<kPreStages - 1>();  // q and qpos
  __syncthreads();
  for (int e = tid; e < rows * D; e += kThreads) {
    const int r = e / D, d = e - r * D;
    qs[r * qstride + d] *= a.scale;
  }
  int qlo = INT_MAX, qhi = INT_MIN;
  for (int r = 0; r < rows; ++r) {
    qlo = min(qlo, qp[r]);
    qhi = max(qhi, qp[r]);
  }
  window_mask<kPer>(a, BN, v, qlo, qhi, &mask);
  __syncthreads();

  const int r0 = warp * 16 + g, r1 = r0 + 8;
  const int qp0 = qp[r0], qp1 = qp[r1];
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m0 = kNeg, m1 = kNeg, l0 = 0.0f, l1 = 0.0f;

  int w0 = 0;
  unsigned live = mask & ((1u << spec) - 1u);  // bit s: stage s holds a live tile
  int nxt = next_live<kPer>(a, spec, ntiles, BN, 0, a.Sk, qlo, qhi, w0, &mask);
  for (int stage = 0, pending = spec; pending > 0; --pending, stage = (stage + 1) % kPreStages) {
    cp_async_wait<kPreStages - 2>();
    __syncthreads();  // this tile landed; the stage computed last is free
    if (nxt < ntiles) {
      const int s = (stage + kPreStages - 1) % kPreStages;
      queue_tile(a, nxt, BN, 0, a.Sk, b, hk, kt + s * BN * rs, vt + s * BN * rs, rs,
                 kp + s * BN);
      live |= 1u << s;
      ++pending;
      nxt = next_live<kPer>(a, nxt + 1, ntiles, BN, 0, a.Sk, qlo, qhi, w0, &mask);
    }
    cp_async_commit();
    if (!(live >> stage & 1u)) continue;  // uniform: a speculative tile no row sees
    live &= ~(1u << stage);

    const KV* ks = kt + stage * BN * rs;
    const KV* vs = vt + stage * BN * rs;
    const int* kps = kp + stage * BN;
    // S = Q K^T for the warp's 16 rows and the tile's BN keys.
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) {
      unsigned ahi[4], alo[4];
      split_tf32(qs[r0 * qstride + kk * 8 + t], ahi[0], alo[0]);
      split_tf32(qs[r1 * qstride + kk * 8 + t], ahi[1], alo[1]);
      split_tf32(qs[r0 * qstride + kk * 8 + t + 4], ahi[2], alo[2]);
      split_tf32(qs[r1 * qstride + kk * 8 + t + 4], ahi[3], alo[3]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const KV* kr = ks + (n * 8 + g) * rs + kk * 8 + t;
        mma3<kSplitB>(s[n], ahi, alo, to_f32(kr[0]), to_f32(kr[4]));
      }
    }
    // Online softmax on the fragments: entries (r0, 2t), (r0, 2t+1),
    // (r1, 2t), (r1, 2t+1) of each 8-key step.
    float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kpos = kps[n * 8 + 2 * t + e];
        s[n][e] = allowed(kpos, qp0, a.causal, a.window) ? s[n][e] : kNeg;
        s[n][2 + e] = allowed(kpos, qp1, a.causal, a.window) ? s[n][2 + e] : kNeg;
        mx0 = fmaxf(mx0, s[n][e]);
        mx1 = fmaxf(mx1, s[n][2 + e]);
      }
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, x));
      mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, x));
    }
    const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
    const float al0 = expf(m0 - n0), al1 = expf(m1 - n1);
    m0 = n0;
    m1 = n1;
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float mm = e < 2 ? n0 : n1;
        const float p = s[n][e] == kNeg ? 0.0f : expf(s[n][e] - mm);
        s[n][e] = p;
        if (e < 2) sum0 += p;
        else sum1 += p;
      }
    }
    l0 = l0 * al0 + sum0;  // per-thread partial sums; the quad adds them at the end
    l1 = l1 * al1 + sum1;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= al0;
      o[n][1] *= al0;
      o[n][2] *= al1;
      o[n][3] *= al1;
    }
    // O += P V: P's accumulator fragment is the A operand, keys permuted.
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      unsigned ahi[4], alo[4];
      split_tf32(s[kk][0], ahi[0], alo[0]);  // (r0, key 2t)     -> k = t
      split_tf32(s[kk][2], ahi[1], alo[1]);  // (r1, key 2t)     -> k = t
      split_tf32(s[kk][1], ahi[2], alo[2]);  // (r0, key 2t + 1) -> k = t + 4
      split_tf32(s[kk][3], ahi[3], alo[3]);  // (r1, key 2t + 1) -> k = t + 4
      const KV* v0 = vs + (kk * 8 + 2 * t) * rs + g;
#pragma unroll
      for (int n = 0; n < ND; ++n)
        mma3<kSplitB>(o[n], ahi, alo, to_f32(v0[n * 8]), to_f32(v0[rs + n * 8]));
    }
  }

#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l0 += __shfl_xor_sync(kFull, l0, x);
    l1 += __shfl_xor_sync(kFull, l1, x);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? r1 : r0;
    if (r >= rows) continue;
    const float m = half ? m1 : m0, l = half ? l1 : l0;
    if (a.lse != nullptr && t == 0)
      a.lse[(static_cast<size_t>(b) * a.Hq + h) * a.Sq + row0 + r] = m == kNeg ? kNeg : m + logf(l);
    float* out = a.out + (static_cast<size_t>(b) * a.Sq + row0 + r) * a.Hq * D +
                 static_cast<size_t>(h) * D;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = n * 8 + 2 * t + e;
        if (d < D) out[d] = m == kNeg ? empty_row<KV>(a, b, hk, d) : o[n][2 * half + e] / l;
      }
    }
  }
}

template <typename KV, int NO>
int launch_decode(const Args& a, cudaStream_t s) {
  const size_t smem = decode_smem<KV>(a.Sq * (a.Hq / a.Hkv), a.D);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_kernel<KV, NO>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  decode_kernel<KV, NO><<<dim3(a.splits, a.Hkv, a.B), kThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename KV, int DP>
int launch_prefill(const Args& a, cudaStream_t s) {
  constexpr size_t smem = prefill_smem<KV, DP>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        prefill_kernel<KV, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((a.Sq + kPreRows - 1) / kPreRows, a.Hq, a.B);
  prefill_kernel<KV, DP><<<grid, kThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename KV>
int launch(const Args& a, cudaStream_t s) {
  if (a.B <= 0 || a.Sq <= 0 || a.Hq <= 0 || a.D <= 0 || a.Sk <= 0) return 0;
  if (a.Hkv <= 0 || a.Hq % a.Hkv != 0 || a.D > 256) return static_cast<int>(cudaErrorInvalidValue);
  if (a.splits > 0) {
    if (a.lse != nullptr) return static_cast<int>(cudaErrorInvalidValue);  // prefill only
    const int out = a.Sq * (a.Hq / a.Hkv) * a.D;  // outputs of a CTA
    if (a.Sq * (a.Hq / a.Hkv) > kDecMaxRows || out > 16 * kThreads ||
        a.kps > kWindow * kDecTile)
      return static_cast<int>(cudaErrorInvalidValue);
    if (out <= kThreads) return launch_decode<KV, 1>(a, s);
    if (out <= 2 * kThreads) return launch_decode<KV, 2>(a, s);
    if (out <= 4 * kThreads) return launch_decode<KV, 4>(a, s);
    if (out <= 8 * kThreads) return launch_decode<KV, 8>(a, s);
    return launch_decode<KV, 16>(a, s);
  }
  if (a.D <= 32) return launch_prefill<KV, 32>(a, s);
  if (a.D <= 64) return launch_prefill<KV, 64>(a, s);
  if (a.D <= 128) return launch_prefill<KV, 128>(a, s);
  return launch_prefill<KV, 256>(a, s);
}

}  // namespace

#define FLASH_ATTN_EXPORT(NAME, KV)                                                       \
  REPRO_EXPORT int NAME(const void* q, const void* k, const void* v, const void* qpos,     \
                        const void* kpos, void* out, void* lse, void* part, void* tickets, \
                        int B, int Sq, int Sk, int Hq, int Hkv, int D, int causal,        \
                        int window, float scale, float pad_den, int splits, int kps,      \
                        int vec, void* stream) {                                          \
    const Args a{static_cast<const float*>(q), k, v, static_cast<const int*>(qpos),       \
                 static_cast<const int*>(kpos), static_cast<float*>(out),                 \
                 static_cast<float*>(lse), static_cast<float*>(part),                     \
                 static_cast<int*>(tickets), B, Sq, Sk, Hq, Hkv, D, causal, window,       \
                 scale, pad_den, splits, kps, vec};                                       \
    return launch<KV>(a, static_cast<cudaStream_t>(stream));                               \
  }

FLASH_ATTN_EXPORT(flash_attn_f32, float)
FLASH_ATTN_EXPORT(flash_attn_f16, __half)
FLASH_ATTN_EXPORT(flash_attn_bf16, __nv_bfloat16)
