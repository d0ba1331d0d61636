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
// Deterministic, no float atomics: up to five kernels in one call.
//  1. delta: a warp per (batch, query, head) row.
//  2. dK/dV: a CTA per (32 keys, query head, batch row, split), so the card
//     fills at short sequences (Sk/32 x Hq x B x splits CTAs, where one CTA
//     per KV head once walked the whole GQA group serially). With Hq > Hkv
//     each head's and split's partial dK/dV goes to an f32 workspace
//     [splits, B, Sk, Hq, D], and
//  3. reduce sums the group's partials in head order, each head's splits
//     in split order (with one query head per KV head and no splits, the
//     dK/dV kernel writes dk and dv itself).
//  4. dQ: a CTA per (32 query rows, query head, batch row, split), and
//  5. with splits, reduce_q sums the splits' partial dQ in split order.
// A GQA call whose dK/dV grid is under two CTAs an SM splits each block of
// fixed rows over up to 4 CTAs, each taking a contiguous slice of the
// block's live tiles (kernels/flash_attn_bwd.py:plan): the causal blocks
// that see the most tiles set the time, and a slice shortens them. dQ (4,
// 5) runs on a second stream of the card beside dK/dV (2, 3): the caller's
// stream forks after delta and joins before the launcher returns, so the
// two fill each other's idle SMs. dQ stays its own kernel: measured before
// this layout it took 15-37 % of a call at every GQA training shape and
// 45-52 % only at the MHA ones (PERF.md), whose grids already fill the
// card; fusing it into dK/dV without atomics needs a partial dQ per block
// of 32 keys (16 x dQ's bytes at 512 keys), summed in a fixed order.
//
// Both tile kernels share one body. A CTA holds 32 fixed rows (dK/dV:
// keys; dQ: query rows) and streams the other side (dK/dV: the head's
// query rows; dQ: the KV head's keys) in tiles of 16. Its warps are 2 row
// groups of 16 fixed rows x D/32 column groups of 32 columns; an instance
// per padded head dim DP = 32, 64, 128, 160, 256 (2, 4, 8, 10, 16 warps),
// so D 160 runs five column groups and no column of 256's. Each warp
//  - holds its 16 fixed rows x 32 columns of both fixed operands (dK/dV: K
//    and V; dQ: scale Q and dO) as split-TF32 A fragments in registers,
//    split once when the CTA starts;
//  - takes its 32 columns' share of the two score products (S and dP, or
//    their transposes) for the tile and writes the partial sums to shared
//    memory; no warp recomputes another's columns;
//  - after a barrier, takes every CW-th of its lane's 8 score entries (CW
//    column groups): sums the row group's partials there in column-group
//    order, forms P and dS, splits them once and shares them through
//    shared memory, so every warp of a row group uses the same bits;
//  - accumulates its 32 columns of the outputs (dV += P^T dO and dK +=
//    dS^T Q; or dQ += dS K) in registers, the tile's rows as the depth,
//    permuted as in the forward (row 2t <-> k t, 2t + 1 <-> k t + 4).
// Streamed tiles pass through a ring of two stages in shared memory, filled
// by cp.async (16-byte copies where D % 4 == 0 and the tensors are 16-byte
// aligned, 4-byte ones otherwise), so tile i + 1 is in flight while tile i
// is computed. When a tile lands, its elements are split once into TF32 hi
// (in place) and lo tiles (scaled by the softmax scale first where the tile
// is q), and every product reads both halves from there: the score
// products' B fragments by ldmatrix (one x4 gives two 8-wide tiles' b0 and
// b1), the accumulating ones' by 32-bit loads (rows 2t and 2t + 1 of a
// column, which ldmatrix cannot transpose for 32-bit data). Tiles no row of
// the CTA may see (the causal frontier, the window, invalid slots) are
// found up front, 512 tiles per pass, and never copied. Shared memory:
// 77 KB at DP 128 (two CTAs of 8 warps on an SM), 142 KB at DP 256 (one
// CTA of 16 warps). ptxas caps registers for 16 warps an SM (128 a
// thread; DP 160's 10 warps take what they need, one CTA an SM): the
// spills are the price, and relaxing the cap measured no faster.
//
// Products: mma.sync.m16n8k8 TF32 with both operands split, three passes
// small terms first (tf32_mma.cuh), near f32's accuracy. Not wgmma: TF32
// wgmma reads both operands K-major from shared memory, which fits the score
// products as staged, but the accumulating ones read dO, Q (dK/dV) and K
// (dQ) along the other axis and would need a second, transposed, split copy
// of each staged tile, and a wgmma tile's 64 rows per warpgroup would halve
// the grid at the short sequences this layout is built to fill. Seven
// products of the causal work against the five a fused kernel needs (S and
// dP in both tile kernels). What bounds it: operations (five f32 products,
// three tensor-core passes each); as built, the tile loop's instruction
// count and shared-memory traffic (each mma's B halves, the split, the
// exchange) and its four barriers a tile hold it at about 8-18 x that
// bound at the training shapes (PERF.md). Built without --use_fast_math:
// expf and IEEE division.
#include <climits>
#include <math.h>

#include "common.cuh"
#include "cp_async.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kCols = 32;       // columns of D per warp
constexpr int kFix = 32;        // fixed rows per CTA: two row groups of 16
constexpr int kTile = 16;       // streamed rows per tile
constexpr int kNT = kTile / 8;  // 8-wide tiles of a score fragment
static_assert(kNT == 2, "one ldmatrix.x4 holds the B fragments of two 8-wide tiles");
constexpr int kKK = kCols / 8;  // 8-steps over a warp's columns
constexpr int kSlots = 4 * kNT;  // a lane's entries of a score fragment
constexpr int kWin = 512;       // tiles one liveness pass covers
constexpr int kDeltaThreads = 128;
constexpr int kRedThreads = 256;
constexpr int kRedBatch = 8;   // partials a reducing thread loads at once
constexpr int kMaxSplits = 4;  // CTAs sharing a block of fixed rows

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
  float* wk;  // [splits, B, Sk, Hq, D] each head's and split's dK (Hq > Hkv), else null
  float* wv;  // the same for dV
  float* wq;  // [splits, B, Sq, Hq, D] each split's dQ (splits > 1), else null
  int B, Sq, Sk, Hq, Hkv, D;
  int causal, window;
  float scale, pad_den;
  int vec;     // 16-byte copies allowed
  int splits;  // CTAs sharing one block of fixed rows, each a slice of its live tiles
};

// The layout of one instance's shared memory, in floats.
template <int DP>
struct Cfg {
  static constexpr int kWarps = 2 * (DP / kCols);
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kMinBlocks = 512 / kThreads > 1 ? 512 / kThreads : 1;  // 16 warps an SM
  static constexpr int kSt = DP + 4;  // row stride: the fragments' reads hit distinct banks
  static constexpr int kMat = kTile * kSt;                   // one matrix of a tile
  static constexpr int kPartW = 2 * kNT * 4 * 32;            // one warp's two partials
  static constexpr int kRing = 0;                            // [2 stages][2 mats][kTile][kSt]
  static constexpr int kLo = kRing + 4 * kMat;               // [2 mats][kTile][kSt]
  static constexpr int kPart = kLo + 2 * kMat;               // [kWarps][kPartW]
  static constexpr int kPds = kPart + kWarps * kPartW;       // [2 row groups][4][kSlots][32]
  static constexpr int kEx = kPds + 2 * 4 * kSlots * 32;     // [DP] the no-key rows' dv term
  static constexpr int kSPos = kEx + DP;                     // int [2 stages][kTile]
  static constexpr int kSLse = kSPos + 2 * kTile;            // [2][kTile] (dK/dV)
  static constexpr int kSDel = kSLse + 2 * kTile;            // [2][kTile] (dK/dV)
  static constexpr int kFPos = kSDel + 2 * kTile;            // int [kFix]
  static constexpr int kList = kFPos + kFix;                 // int [kWin] live tiles
  static constexpr int kCount = kList + kWin;                // int, 3 floats of padding
  static constexpr int kFlag = kCount + 4;                   // unsigned char [kWin]
  static constexpr size_t kBytes = sizeof(float) * kFlag + kWin;
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
__device__ __forceinline__ size_t w_off(const Args& a, int b, int j, int h) {
  return (static_cast<size_t>(b) * a.Sk + j) * a.Hq * a.D + static_cast<size_t>(h) * a.D;
}
__device__ __forceinline__ size_t row_off(const Args& a, int b, int h, int i) {
  return (static_cast<size_t>(b) * a.Hq + h) * a.Sq + i;
}

// Four 8 x 4 blocks of 32-bit words from shared memory, each lane's row
// address in p: r[m] holds block m's word (lane / 4, lane % 4), the
// m16n8k8 B fragment's (k = t, n = g) when a block's rows are n and its
// words k.
__device__ __forceinline__ void ldsm4(unsigned r[4], const unsigned* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// A operand (rows g and g + 8 at offsets o0, o1 of x, valid where ok0, ok1;
// columns c and c + 4, zero from D on), times mul, split.
__device__ __forceinline__ void load_fixed(const float* x, size_t o0, size_t o1, bool ok0,
                                           bool ok1, int c, int D, float mul, unsigned hi[4],
                                           unsigned lo[4]) {
  const float a0 = ok0 && c < D ? x[o0 + c] * mul : 0.0f;
  const float a1 = ok1 && c < D ? x[o1 + c] * mul : 0.0f;
  const float a2 = ok0 && c + 4 < D ? x[o0 + c + 4] * mul : 0.0f;
  const float a3 = ok1 && c + 4 < D ? x[o1 + c + 4] * mul : 0.0f;
  split_tf32(a0, hi[0], lo[0]);
  split_tf32(a1, hi[1], lo[1]);
  split_tf32(a2, hi[2], lo[2]);
  split_tf32(a3, hi[3], lo[3]);
}

// ---------------------------------------------------------------- delta

__global__ void __launch_bounds__(kDeltaThreads) delta_kernel(Args a) {
  const int row = (blockIdx.x * kDeltaThreads + threadIdx.x) >> 5;  // (b * Sq + i) * Hq + h
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

// ---------------------------------------------------------------- tiles

// Queue the copies of streamed tile `tile` into ring stage `stage`: matrix
// 0 (dK/dV: q; dQ: k) and 1 (dO; v), rows past the end zeroed, and the
// rows' positions (dK/dV: qpos, lse and delta of head h; dQ: kpos).
template <int DP, bool kDQ>
__device__ __forceinline__ void queue_tile(const Args& a, int tile, int stage, int b, int h,
                                           int hk, float* sm) {
  using C = Cfg<DP>;
  const int i0 = tile * kTile;
  const int rows = min(kTile, (kDQ ? a.Sk : a.Sq) - i0);
  float* x0 = sm + C::kRing + stage * 2 * C::kMat;
  float* x1 = x0 + C::kMat;
  const float* s0 = kDQ ? a.k : a.q;
  const float* s1 = kDQ ? a.v : a.dout;
  if (a.vec) {
    constexpr int kCh = DP / 4;  // 16-byte chunks of a padded row
    for (int e = threadIdx.x; e < kTile * kCh; e += C::kThreads) {
      const int r = e / kCh, c = (e - r * kCh) * 4;
      float* d0 = x0 + r * C::kSt + c;
      float* d1 = x1 + r * C::kSt + c;
      if (r < rows) {
        if (c < a.D) {
          const size_t off = (kDQ ? k_off(a, b, i0 + r, hk) : q_off(a, b, i0 + r, h)) + c;
          cp_async16(d0, s0 + off);
          cp_async16(d1, s1 + off);
        }
      } else {
        *reinterpret_cast<float4*>(d0) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        *reinterpret_cast<float4*>(d1) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
  } else {
    for (int e = threadIdx.x; e < kTile * DP; e += C::kThreads) {
      const int r = e / DP, c = e - r * DP;
      float* d0 = x0 + r * C::kSt + c;
      float* d1 = x1 + r * C::kSt + c;
      if (r < rows) {
        if (c < a.D) {
          const size_t off = (kDQ ? k_off(a, b, i0 + r, hk) : q_off(a, b, i0 + r, h)) + c;
          cp_async4(d0, s0 + off);
          cp_async4(d1, s1 + off);
        }
      } else {
        *d0 = 0.0f;
        *d1 = 0.0f;
      }
    }
  }
  if (threadIdx.x < kTile) {
    const int r = threadIdx.x;
    int* pos = reinterpret_cast<int*>(sm + C::kSPos) + stage * kTile + r;
    if (kDQ) {
      if (r < rows)
        cp_async4(pos, a.kpos + i0 + r);
      else
        *pos = -1;
    } else {
      float* ls = sm + C::kSLse + stage * kTile + r;
      float* dl = sm + C::kSDel + stage * kTile + r;
      if (r < rows) {
        cp_async4(pos, a.qpos + static_cast<size_t>(b) * a.Sq + i0 + r);
        cp_async4(ls, a.lse + row_off(a, b, h, i0 + r));
        cp_async4(dl, a.delta + row_off(a, b, h, i0 + r));
      } else {  // p = exp(s - inf) = 0
        *pos = 0;
        *ls = INFINITY;
        *dl = 0.0f;
      }
    }
  }
}

// Split the landed tile of `stage` once: hi in place, lo into the lo tile
// (dK/dV: q scaled first).
template <int DP, bool kDQ>
__device__ __forceinline__ void split_tile(const Args& a, int stage, float* sm) {
  using C = Cfg<DP>;
  uint4* x = reinterpret_cast<uint4*>(sm + C::kRing + stage * 2 * C::kMat);
  uint4* lo = reinterpret_cast<uint4*>(sm + C::kLo);
  constexpr int kN = C::kMat / 4;  // float4s of one matrix, padding included
  for (int e = threadIdx.x; e < 2 * kN; e += C::kThreads) {
    float4 v = reinterpret_cast<const float4*>(x)[e];
    if (!kDQ && e < kN) {
      v.x *= a.scale;
      v.y *= a.scale;
      v.z *= a.scale;
      v.w *= a.scale;
    }
    uint4 hi, l;
    split_tf32(v.x, hi.x, l.x);
    split_tf32(v.y, hi.y, l.y);
    split_tf32(v.z, hi.z, l.z);
    split_tf32(v.w, hi.w, l.w);
    x[e] = hi;
    lo[e] = l;
  }
}

template <int DP, bool kDQ>
__device__ __forceinline__ void tiles(const Args& a) {
  using C = Cfg<DP>;
  constexpr int st = C::kSt;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sm = reinterpret_cast<float*>(smem);
  int* fpos = reinterpret_cast<int*>(sm + C::kFPos);
  int* list = reinterpret_cast<int*>(sm + C::kList);
  int* count = reinterpret_cast<int*>(sm + C::kCount);
  unsigned char* flag = smem + sizeof(float) * C::kFlag;
  float* part = sm + C::kPart;
  unsigned* pds = reinterpret_cast<unsigned*>(sm + C::kPds);  // P, dS: hi, lo
  float* ex = sm + C::kEx;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp & 1, cg = warp >> 1;  // row group, column group
  constexpr int kCW = DP / kCols;  // column groups
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (a.Hq / a.Hkv);
  const int nfb = ((kDQ ? a.Sq : a.Sk) + kFix - 1) / kFix;  // blocks of fixed rows
  const int f0 = (blockIdx.x % nfb) * kFix, split = blockIdx.x / nfb;
  const int nstr = kDQ ? a.Sk : a.Sq;
  const int nf = min(kFix, (kDQ ? a.Sq : a.Sk) - f0);
  const int ntiles = (nstr + kTile - 1) / kTile;
  const int D = a.D;

  {
    uint4* w = reinterpret_cast<uint4*>(smem);
    for (size_t e = tid; e < C::kBytes / 16; e += C::kThreads) w[e] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  if (tid < kFix)
    fpos[tid] = tid < nf ? (kDQ ? a.qpos[static_cast<size_t>(b) * a.Sq + f0 + tid]
                               : a.kpos[f0 + tid])
                         : (kDQ ? 0 : -1);
  if (!kDQ) {
    // Rows of head h with no allowed key: their dO / pad_den lands on every
    // key (summed in row order, per column).
    bool nokey = false;
    for (int i = tid; i < a.Sq; i += C::kThreads) nokey |= a.lse[row_off(a, b, h, i)] == kNeg;
    if (__syncthreads_or(nokey)) {
      for (int d = tid; d < D; d += C::kThreads) {
        float s = 0.0f;
        for (int i = 0; i < a.Sq; ++i)
          if (a.lse[row_off(a, b, h, i)] == kNeg) s += a.dout[q_off(a, b, i, h) + d] / a.pad_den;
        ex[d] = s;
      }
    }
  }
  __syncthreads();

  // The warp's fixed rows r0, r1 and its 32 columns of both fixed operands.
  const int r0 = rg * 16 + g, r1 = r0 + 8;
  const bool v0 = r0 < nf, v1 = r1 < nf;
  unsigned f0h[kKK][4], f0l[kKK][4], f1h[kKK][4], f1l[kKK][4];
  {
    const float* x0 = kDQ ? a.q : a.k;
    const float* x1 = kDQ ? a.dout : a.v;
    const size_t o0 = v0 ? (kDQ ? q_off(a, b, f0 + r0, h) : k_off(a, b, f0 + r0, hk)) : 0;
    const size_t o1 = v1 ? (kDQ ? q_off(a, b, f0 + r1, h) : k_off(a, b, f0 + r1, hk)) : 0;
    const float mul = kDQ ? a.scale : 1.0f;
#pragma unroll
    for (int kk = 0; kk < kKK; ++kk) {
      const int c = cg * kCols + kk * 8 + t;
      load_fixed(x0, o0, o1, v0, v1, c, D, mul, f0h[kk], f0l[kk]);
      load_fixed(x1, o0, o1, v0, v1, c, D, 1.0f, f1h[kk], f1l[kk]);
    }
  }
  const int p0 = fpos[r0], p1 = fpos[r1];  // dK/dV: key positions; dQ: query positions
  float lse0 = 0.0f, lse1 = 0.0f, dl0 = 0.0f, dl1 = 0.0f;
  int qlo = INT_MAX, qhi = INT_MIN;  // dQ: the CTA's query positions
  if (kDQ) {
    if (v0) {
      lse0 = a.lse[row_off(a, b, h, f0 + r0)];
      dl0 = a.delta[row_off(a, b, h, f0 + r0)];
    }
    if (v1) {
      lse1 = a.lse[row_off(a, b, h, f0 + r1)];
      dl1 = a.delta[row_off(a, b, h, f0 + r1)];
    }
    for (int r = 0; r < nf; ++r) {
      qlo = min(qlo, fpos[r]);
      qhi = max(qhi, fpos[r]);
    }
  }

  float acc0[kKK][4], acc1[kKK][4];  // dK/dV: dK, dV; dQ: dQ, unused
#pragma unroll
  for (int n = 0; n < kKK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc0[n][e] = acc1[n][e] = 0.0f;

  for (int w0 = 0; w0 < ntiles; w0 += kWin) {
    // Which tiles any fixed row of the CTA may see, in order.
    const int cnt = min(kWin, ntiles - w0);
    for (int i = tid; i < cnt; i += C::kThreads) {
      const int j0 = (w0 + i) * kTile, rows = min(kTile, nstr - j0);
      bool any = false;
      int lo = INT_MAX, hi = INT_MIN;
#pragma unroll
      for (int r = 0; r < kTile; ++r) {  // unrolled: the row loads are in flight together
        if (r < rows) {
          if (kDQ) {
            any |= live(a, a.kpos[j0 + r], qlo, qhi);
          } else {
            const int p = a.qpos[static_cast<size_t>(b) * a.Sq + j0 + r];
            lo = min(lo, p);
            hi = max(hi, p);
          }
        }
      }
      if (!kDQ)
        for (int r = 0; r < nf; ++r) any |= live(a, fpos[r], lo, hi);
      flag[i] = any;
    }
    __syncthreads();
    if (warp == 0) {
      int n = 0;
      for (int base = 0; base < cnt; base += 32) {
        const bool f = base + lane < cnt && flag[base + lane];
        const unsigned m = __ballot_sync(kFull, f);
        if (f) list[n + __popc(m & ((1u << lane) - 1u))] = w0 + base + lane;
        n += __popc(m);
      }
      if (lane == 0) *count = n;
    }
    __syncthreads();  // also: every warp is done with the last window's tiles
    // This CTA's slice of the live tiles.
    const int i0 = *count * split / a.splits, n = *count * (split + 1) / a.splits;
    if (i0 < n) queue_tile<DP, kDQ>(a, list[i0], 0, b, h, hk, sm);
    cp_async_commit();

    for (int it = i0; it < n; ++it) {
      const int s = (it - i0) & 1;
      cp_async_wait<0>();  // this thread's copies of tile it have landed
      __syncthreads();     // ... everyone's; and tile it - 1 is consumed
      if (it + 1 < n) queue_tile<DP, kDQ>(a, list[it + 1], s ^ 1, b, h, hk, sm);
      cp_async_commit();
      split_tile<DP, kDQ>(a, s, sm);
      __syncthreads();

      // The tile's hi and lo halves: matrix 0, then 1 at + kMat.
      const unsigned* xh = reinterpret_cast<const unsigned*>(sm + C::kRing + s * 2 * C::kMat);
      const unsigned* xl = reinterpret_cast<const unsigned*>(sm + C::kLo);

      // The warp's columns of S and dP (dK/dV: S^T = K Qs^T, dP^T = V dO^T;
      // dQ: S = Qs K^T, dP = dO V^T): fixed rows x the tile's 16 rows.
      float sc[kNT][4], dp[kNT][4];
#pragma unroll
      for (int n2 = 0; n2 < kNT; ++n2)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n2][e] = dp[n2][e] = 0.0f;
      // Lane l addresses row l % 8 of 8 x 4 block l / 8: (8-wide tile l / 16,
      // columns + 4 (l / 8) % 2), so one ldmatrix gives b0, b1 of both tiles.
      const int lm = ((lane >> 4) * 8 + (lane & 7)) * st + 4 * ((lane >> 3) & 1);
#pragma unroll
      for (int kk = 0; kk < kKK; ++kk) {
        const int o = lm + cg * kCols + kk * 8;
        unsigned b0h[4], b0l[4], b1h[4], b1l[4];
        ldsm4(b0h, xh + o);
        ldsm4(b0l, xl + o);
        ldsm4(b1h, xh + C::kMat + o);
        ldsm4(b1l, xl + C::kMat + o);
#pragma unroll
        for (int n2 = 0; n2 < kNT; ++n2) {
          mma3s(sc[n2], f0h[kk], f0l[kk], b0h[2 * n2], b0h[2 * n2 + 1], b0l[2 * n2],
                b0l[2 * n2 + 1]);
          mma3s(dp[n2], f1h[kk], f1l[kk], b1h[2 * n2], b1h[2 * n2 + 1], b1l[2 * n2],
                b1l[2 * n2 + 1]);
        }
      }
      {
        float* mine = part + warp * C::kPartW + lane;
#pragma unroll
        for (int n2 = 0; n2 < kNT; ++n2)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            mine[(n2 * 4 + e) * 32] = sc[n2][e];
            mine[((kNT + n2) * 4 + e) * 32] = dp[n2][e];
          }
      }
      __syncthreads();
      // Each warp of a row group takes every CW-th of the lane's 8 fragment
      // entries: sums the group's partials in column-group order, forms P
      // and dS (fixed row, streamed row), splits them once and shares them.
      {
        const int* spos = reinterpret_cast<const int*>(sm + C::kSPos) + s * kTile;
        const float* slse = sm + C::kSLse + s * kTile;
        const float* sdel = sm + C::kSDel + s * kTile;
        unsigned* mypds = pds + rg * 4 * kSlots * 32 + lane;
        for (int q = cg; q < kSlots; q += kCW) {
          float x = 0.0f, y = 0.0f;
#pragma unroll
          for (int c = 0; c < kCW; ++c) {
            const float* p = part + (c * 2 + rg) * C::kPartW + lane;
            x = c ? x + p[q * 32] : p[q * 32];
            y = c ? y + p[(kNT * 4 + q) * 32] : p[(kNT * 4 + q) * 32];
          }
          const int e = q & 3, col = (q >> 2) * 8 + 2 * t + (e & 1);
          const bool up = e < 2;
          bool ok;
          float l, d;
          if (kDQ) {
            ok = (up ? v0 : v1) && allowed(spos[col], up ? p0 : p1, a.causal, a.window);
            l = up ? lse0 : lse1;
            d = up ? dl0 : dl1;
          } else {
            ok = allowed(up ? p0 : p1, spos[col], a.causal, a.window);
            l = slse[col];
            d = sdel[col];
          }
          const float pv = ok ? expf(x - l) : 0.0f;
          unsigned hi, lo;
          split_tf32(pv * (y - d), hi, lo);
          mypds[(2 * kSlots + q) * 32] = hi;
          mypds[(3 * kSlots + q) * 32] = lo;
          if (!kDQ) {
            split_tf32(pv, hi, lo);
            mypds[q * 32] = hi;
            mypds[(kSlots + q) * 32] = lo;
          }
        }
      }
      __syncthreads();
      // dK/dV: dV += P^T dO, dK += dS^T Qs; dQ: dQ += dS K; over the warp's
      // columns, the tile's rows as the depth (row 2t <-> k t, 2t + 1 <-> t + 4;
      // the A operand from the C fragment's entries 0, 2, 1, 3).
      const unsigned* rd = pds + rg * 4 * kSlots * 32 + lane;
#pragma unroll
      for (int kk = 0; kk < kNT; ++kk) {
        unsigned sh[4], sl[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int q = kk * 4 + ((j & 1) << 1 | j >> 1);  // entries 0, 2, 1, 3
          sh[j] = rd[(2 * kSlots + q) * 32];
          sl[j] = rd[(3 * kSlots + q) * 32];
        }
        const int o = (kk * 8 + 2 * t) * st + cg * kCols + g;
        if (kDQ) {
#pragma unroll
          for (int n2 = 0; n2 < kKK; ++n2) {
            const int x = o + n2 * 8;
            mma3s(acc0[n2], sh, sl, xh[x], xh[x + st], xl[x], xl[x + st]);
          }
        } else {
          unsigned ph[4], pl[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int q = kk * 4 + ((j & 1) << 1 | j >> 1);  // entries 0, 2, 1, 3
            ph[j] = rd[q * 32];
            pl[j] = rd[(kSlots + q) * 32];
          }
#pragma unroll
          for (int n2 = 0; n2 < kKK; ++n2) {
            const int x = o + n2 * 8, x1 = C::kMat + x;
            mma3s(acc1[n2], ph, pl, xh[x1], xh[x1 + st], xl[x1], xl[x1 + st]);
            mma3s(acc0[n2], sh, sl, xh[x], xh[x + st], xl[x], xl[x + st]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? r1 : r0;
    if (r >= nf) continue;
    const int row = f0 + r;
#pragma unroll
    for (int n2 = 0; n2 < kKK; ++n2)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = cg * kCols + n2 * 8 + 2 * t + e;
        if (c >= D) continue;
        const float x0 = acc0[n2][2 * half + e];
        if (kDQ) {
          const size_t o = q_off(a, b, row, h) + c;
          if (a.wq)
            a.wq[static_cast<size_t>(split) * a.B * a.Sq * a.Hq * D + o] = x0 * a.scale;
          else
            a.dq[o] = x0 * a.scale;
        } else {
          const float x1 = acc1[n2][2 * half + e] + (split ? 0.0f : ex[c]);
          if (a.wk) {
            const size_t o = static_cast<size_t>(split) * a.B * a.Sk * a.Hq * D +
                             w_off(a, b, row, h) + c;
            a.wk[o] = x0;
            a.wv[o] = x1;
          } else {
            const size_t o = k_off(a, b, row, hk) + c;
            a.dk[o] = x0;
            a.dv[o] = x1;
          }
        }
      }
  }
}

template <int DP>
__global__ void __launch_bounds__(Cfg<DP>::kThreads, Cfg<DP>::kMinBlocks) dkv_kernel(Args a) {
  tiles<DP, false>(a);
}

template <int DP>
__global__ void __launch_bounds__(Cfg<DP>::kThreads, Cfg<DP>::kMinBlocks) dq_kernel(Args a) {
  tiles<DP, true>(a);
}

// ---------------------------------------------------------------- reduce

// dk, dv [B, Sk, Hkv, D]: each KV head's partials summed in head order,
// each head's splits in split order.
__global__ void __launch_bounds__(kRedThreads) reduce_kernel(Args a) {
  const int G = a.Hq / a.Hkv;
  const size_t n = static_cast<size_t>(a.B) * a.Sk * a.Hkv * a.D;
  const size_t split = static_cast<size_t>(a.B) * a.Sk * a.Hq * a.D;
  for (size_t e = static_cast<size_t>(blockIdx.x) * kRedThreads + threadIdx.x; e < n;
       e += static_cast<size_t>(gridDim.x) * kRedThreads) {
    const int d = static_cast<int>(e % a.D);
    const size_t r = e / a.D;
    const int hk = static_cast<int>(r % a.Hkv);
    const size_t bj = r / a.Hkv;  // b * Sk + j
    const size_t o = (bj * a.Hq + static_cast<size_t>(hk) * G) * a.D + d;
    const int n_in = G * a.splits;  // partial i: head i / splits, split i % splits
    float sk = 0.0f, sv = 0.0f;
    for (int i0 = 0; i0 < n_in; i0 += kRedBatch) {  // a batch of loads in flight, summed in order
      float xk[kRedBatch], xv[kRedBatch];
#pragma unroll
      for (int j = 0; j < kRedBatch; ++j) {
        const int i = i0 + j;
        const size_t w = o + static_cast<size_t>(i / a.splits) * a.D + (i % a.splits) * split;
        xk[j] = i < n_in ? a.wk[w] : 0.0f;
        xv[j] = i < n_in ? a.wv[w] : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < kRedBatch; ++j)
        if (i0 + j < n_in) {
          sk += xk[j];
          sv += xv[j];
        }
    }
    a.dk[e] = sk;
    a.dv[e] = sv;
  }
}

// dq [B, Sq, Hq, D]: the splits' partials summed in split order.
__global__ void __launch_bounds__(kRedThreads) reduce_q_kernel(Args a) {
  const size_t n = static_cast<size_t>(a.B) * a.Sq * a.Hq * a.D;
  for (size_t e = static_cast<size_t>(blockIdx.x) * kRedThreads + threadIdx.x; e < n;
       e += static_cast<size_t>(gridDim.x) * kRedThreads) {
    float x[kMaxSplits];
#pragma unroll
    for (int y = 0; y < kMaxSplits; ++y) x[y] = y < a.splits ? a.wq[e + y * n] : 0.0f;
    float s = 0.0f;
#pragma unroll
    for (int y = 0; y < kMaxSplits; ++y)
      if (y < a.splits) s += x[y];
    a.dq[e] = s;
  }
}

unsigned red_blocks(size_t n) {
  const size_t blocks = (n + kRedThreads - 1) / kRedThreads;
  return static_cast<unsigned>(blocks < 65535 ? blocks : 65535);
}

// Once per kernel and device (bit d of done: set on device d; setting it
// twice from two threads is harmless).
template <typename K>
int set_smem(K kernel, size_t bytes, unsigned& done) {
  if (bytes <= 48 * 1024) return 0;
  int dev = 0;
  int err = static_cast<int>(cudaGetDevice(&dev));
  if (err || (dev < 32 && (done >> dev & 1u))) return err;
  err = static_cast<int>(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              static_cast<int>(bytes)));
  if (!err && dev < 32) done |= 1u << dev;
  return err;
}

// dK/dV and their reduction on s; dQ and its splits' sum on sq.
template <int DP>
int launch_dp(const Args& a, cudaStream_t s, cudaStream_t sq) {
  using C = Cfg<DP>;
  int err = 0;
  {
    static unsigned kv_set = 0;
    if ((err = set_smem(dkv_kernel<DP>, C::kBytes, kv_set))) return err;
    const unsigned kb = (a.Sk + kFix - 1) / kFix;
    dkv_kernel<DP><<<dim3(kb * a.splits, a.Hq, a.B), C::kThreads, C::kBytes, s>>>(a);
    if ((err = static_cast<int>(cudaGetLastError()))) return err;
    if (a.wk) {
      reduce_kernel<<<red_blocks(static_cast<size_t>(a.B) * a.Sk * a.Hkv * a.D), kRedThreads,
                      0, s>>>(a);
      if ((err = static_cast<int>(cudaGetLastError()))) return err;
    }
  }
  {
    static unsigned q_set = 0;
    if ((err = set_smem(dq_kernel<DP>, C::kBytes, q_set))) return err;
    const unsigned qb = (a.Sq + kFix - 1) / kFix;
    dq_kernel<DP><<<dim3(qb * a.splits, a.Hq, a.B), C::kThreads, C::kBytes, sq>>>(a);
    if ((err = static_cast<int>(cudaGetLastError()))) return err;
    if (a.wq) {
      reduce_q_kernel<<<red_blocks(static_cast<size_t>(a.B) * a.Sq * a.Hq * a.D), kRedThreads,
                        0, sq>>>(a);
      err = static_cast<int>(cudaGetLastError());
    }
  }
  return err;
}

// delta on s; then dK/dV on s and dQ on side (when given: forked after
// delta through the event fork, joined back into s through join).
int launch(const Args& a, int dp, cudaStream_t s, cudaStream_t side, cudaEvent_t fork,
           cudaEvent_t join) {
  if (a.B <= 0 || a.Sq <= 0 || a.Sk <= 0 || a.Hq <= 0 || a.D <= 0) return 0;
  if (a.Hkv <= 0 || a.Hq % a.Hkv != 0 || a.D > dp || a.Hq > 65535 || a.B > 65535 ||
      a.splits < 1 || a.splits > kMaxSplits || (a.splits > 1 && a.Hq == a.Hkv) ||
      ((a.wk == nullptr) != (a.Hq == a.Hkv)) || (a.wk != nullptr) != (a.wv != nullptr) ||
      ((a.wq == nullptr) != (a.splits == 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dp != 32 && dp != 64 && dp != 128 && dp != 160 && dp != 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const long rows = static_cast<long>(a.B) * a.Sq * a.Hq;
  delta_kernel<<<static_cast<unsigned>((rows * 32 + kDeltaThreads - 1) / kDeltaThreads),
                 kDeltaThreads, 0, s>>>(a);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  cudaStream_t sq = s;
  if (side) {
    if ((err = static_cast<int>(cudaEventRecord(fork, s)))) return err;
    if ((err = static_cast<int>(cudaStreamWaitEvent(side, fork, 0)))) return err;
    sq = side;
  }
  switch (dp) {
    case 32: err = launch_dp<32>(a, s, sq); break;
    case 64: err = launch_dp<64>(a, s, sq); break;
    case 128: err = launch_dp<128>(a, s, sq); break;
    case 160: err = launch_dp<160>(a, s, sq); break;
    default: err = launch_dp<256>(a, s, sq); break;
  }
  if (side) {  // joined even after a failed launch, so s never runs ahead of side
    const int e1 = static_cast<int>(cudaEventRecord(join, side));
    const int e2 = static_cast<int>(cudaStreamWaitEvent(s, join, 0));
    if (!err) err = e1 ? e1 : e2;
  }
  return err;
}

}  // namespace

REPRO_EXPORT int flash_attn_bwd_f32(const void* q, const void* k, const void* v, const void* out,
                                    const void* dout, const void* lse, const void* qpos,
                                    const void* kpos, void* delta, void* dq, void* dk, void* dv,
                                    void* wk, void* wv, void* wq, int B, int Sq, int Sk, int Hq,
                                    int Hkv, int D, int causal, int window, float scale,
                                    float pad_den, int dp, int vec, int splits, void* stream,
                                    void* side, void* fork, void* join) {
  const Args a{static_cast<const float*>(q),    static_cast<const float*>(k),
               static_cast<const float*>(v),    static_cast<const float*>(out),
               static_cast<const float*>(dout), static_cast<const float*>(lse),
               static_cast<const int*>(qpos),   static_cast<const int*>(kpos),
               static_cast<float*>(delta),      static_cast<float*>(dq),
               static_cast<float*>(dk),         static_cast<float*>(dv),
               static_cast<float*>(wk),         static_cast<float*>(wv),
               static_cast<float*>(wq),         B,
               Sq,                              Sk,
               Hq,                              Hkv,
               D,                               causal,
               window,                          scale,
               pad_den,                         vec,
               splits};
  return launch(a, dp, static_cast<cudaStream_t>(stream), static_cast<cudaStream_t>(side),
                static_cast<cudaEvent_t>(fork), static_cast<cudaEvent_t>(join));
}
