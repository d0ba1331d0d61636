// Storage-type matmul with the decode in the tile, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/syn_matmul.py
// (syn_matmul -> _matmul_kernel): out[M, N] = x[M, K] @ w[K, N] with w in
// fp16, bf16 or f32, decoded to f32 where it is loaded, f32 accumulation.
//
// What bounds it: bytes, and at the engine's shapes latency. The engine
// calls it with M = 1, the tick's spike row against a hoisted f32 bucket
// image ([200, 250] and [50, 200] on Synfire4): 2·K·N operations on
// 4·K·N bytes of weights, two orders of magnitude below the card's
// operations-per-byte balance, and a few hundred KB at most, so the time
// is the launch and the longest dependent chain of loads and adds. The
// M = 1 case is a GEMV spread over the card: the grid is (C, column
// tiles); every lane owns VEC neighbouring columns, read with one 16-byte
// (or, where N or the pointer's alignment does not allow it, 8-, 4- or
// 2-byte) load per weight row, and the warps of a CTA split its K slice.
// Partial sums meet in a fixed order: the warps through shared memory in
// warp order, then, where K is split over a thread-block cluster of C
// CTAs, the C ranks through distributed shared memory
// (cluster.map_shared_rank) into rank 0 in rank order, so every run gives
// the same bits. A cluster launch costs about 1.3 us more on the device
// than a plain one, even with one rank (scripts/bench_gemv_layouts.py on
// an H100 80GB HBM3 at 700 W), so K up to
// kClusterMinK runs as one CTA of 16 warps per column tile without a
// cluster (2.05 us at [200, 250] against 3.6 us with a cluster), and
// longer K on a cluster of C = min(8, ceil(K / 512)) CTAs of 8 warps
// (29.3 us at [4096, 4096] against 58.1 us without). Every weight is
// multiplied by its x[k] (no gating on x[k] != 0): a zero row times an
// infinite weight stays NaN, as the TPU kernel's dot leaves it. M > 1
// (batched rows) takes a plain 16 x 16 shared-memory tiled product;
// tensor cores (wgmma) and TMA come with the batched serving lanes, where
// M grows.
//
// Lanes (a batched run, a LaneScheduler's chunk): B spike rows against one
// shared image or B per-lane images in one launch, each lane summed in the
// M = 1 GEMV's order (gemv_lanes_kernel), so a lane equals its solo launch
// bit for bit on any weights. The bytes: one image (shared) or B images
// (per lane) and B rows; at Synfire4's 64 lanes and [200, 250] f32 images
// 200 KB or 12.8 MB, 0.06 or 3.8 us at 3.35 TB/s.
//
// Three entries: syn_matmul_<w>(x, w, out, M, K, N, stream) for one checked
// call, syn_matmul_run(plan, x), the per-run launcher's (ops.MatmulRun):
// the bucket image, its output buffer, the shape and the stream sit in a
// GemvPlan filled once per run, so a tick's call passes only the spike row,
// and syn_matmul_lanes(plan, x, x_stride), the same over lanes.
//
// Exactness: 0/1 spikes times Synfire4's weight table (1.0, 3.5, -2.0)
// give half-integer partial sums, exact in f32 in any order, so the kernel
// equals the plain version bit for bit there; for arbitrary weights it
// differs from it by summation order only.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCluster = 8;
constexpr int kRowsPerRank = 512;   // K per cluster rank before another rank joins
constexpr int kClusterMinK = 1024;  // shorter K runs without a cluster
constexpr int kTile = 16;

// VEC weights of one row, loaded as one aligned vector.
template <typename W, int VEC>
struct alignas(sizeof(W) * VEC) Pack {
  W v[VEC];
};

template <typename W, int VEC, int WARPS, bool CLUSTER>
__global__ void __launch_bounds__(WARPS * 32)
gemv_kernel(const float* __restrict__ x, const W* __restrict__ w, float* __restrict__ out,
            int K, int N, int rows_per_rank) {
  constexpr int kCols = 32 * VEC;
  __shared__ float part[WARPS][kCols];
  __shared__ float total[kCols];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rank = CLUSTER ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  const int col0 = blockIdx.y * kCols + lane * VEC;  // N % VEC == 0: all VEC in range
  const int k0 = rank * rows_per_rank;
  const int per_warp = (rows_per_rank + WARPS - 1) / WARPS;
  const int wk0 = k0 + warp * per_warp;
  const int wk1 = min(min(K, k0 + rows_per_rank), wk0 + per_warp);
  float acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.0f;
  if (col0 < N) {
    const W* wp = w + col0;
#pragma unroll 4
    for (int k = wk0; k < wk1; ++k) {
      const float xk = x[k];
      const Pack<W, VEC> p = *reinterpret_cast<const Pack<W, VEC>*>(
          wp + static_cast<size_t>(k) * N);
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] = fmaf(xk, to_f32(p.v[j]), acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j) part[warp][lane * VEC + j] = acc[j];
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float s = part[0][lane * VEC + j];
#pragma unroll
      for (int wi = 1; wi < WARPS; ++wi) s += part[wi][lane * VEC + j];
      total[lane * VEC + j] = s;
    }
  }
  if constexpr (CLUSTER) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every rank's total is written
    if (rank == 0 && warp == 0 && col0 < N) {
      const int ranks = static_cast<int>(cluster.num_blocks());
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        float s = total[lane * VEC + j];
        for (int r = 1; r < ranks; ++r) s += cluster.map_shared_rank(total, r)[lane * VEC + j];
        out[col0 + j] = s;
      }
    }
    cluster.sync();  // rank 0 has read every rank's shared memory before it is freed
  } else if (warp == 0 && col0 < N) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) out[col0 + j] = total[lane * VEC + j];
  }
}

template <typename W, int VEC>
cudaError_t launch_gemv_vec(const float* x, const W* w, float* out, int K, int N,
                            cudaStream_t s) {
  const dim3 tiles(1, (N + 32 * VEC - 1) / (32 * VEC), 1);
  if (K <= kClusterMinK) {
    gemv_kernel<W, VEC, 16, false><<<tiles, 16 * 32, 0, s>>>(x, w, out, K, N, K);
    return cudaSuccess;
  }
  const int ranks = min(kMaxCluster, (K + kRowsPerRank - 1) / kRowsPerRank);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ranks, tiles.y, 1);
  cfg.blockDim = dim3(8 * 32, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, gemv_kernel<W, VEC, 8, true>, x, w, out, K, N,
                            (K + ranks - 1) / ranks);
}

// The widest load (16 bytes down to one element) that N and w's alignment
// allow for every row.
template <typename W>
cudaError_t launch_gemv(const float* x, const W* w, float* out, int K, int N,
                        cudaStream_t s) {
  int vec = 16 / static_cast<int>(sizeof(W));
  while (vec > 1 && (N % vec != 0 ||
                     reinterpret_cast<uintptr_t>(w) % (vec * sizeof(W)) != 0)) {
    vec /= 2;
  }
  switch (vec) {
    case 8:
      if constexpr (sizeof(W) == 2) return launch_gemv_vec<W, 8>(x, w, out, K, N, s);
      return cudaErrorInvalidValue;
    case 4: return launch_gemv_vec<W, 4>(x, w, out, K, N, s);
    case 2: return launch_gemv_vec<W, 2>(x, w, out, K, N, s);
    default: return launch_gemv_vec<W, 1>(x, w, out, K, N, s);
  }
}

// B lanes' products x_b @ w_b, each lane's columns summed in the order
// gemv_kernel sums them: within a rank's K slice each warp takes its rows
// in order (one fmaf per row into a register from +0.0), the warps' sums
// meet in warp order, and the ranks' sums (a cluster's CTAs there) in rank
// order, here within one CTA. So lane b equals the M = 1 launch on (x_b,
// w_b) bit for bit, on any weights. With shared weights (w_stride 0) a
// CTA takes LB lanes and applies each loaded weight pack to all of them
// from registers: the weights are read once per LB lanes. With per-lane
// weights (a scheduler's lanes each hold their own) LB is 1 and the grid
// walks the lanes' images at w_stride.
template <typename W, int VEC, int WARPS, int LB>
__global__ void __launch_bounds__(WARPS * 32)
gemv_lanes_kernel(const float* __restrict__ x, long long x_stride, const W* __restrict__ w,
                  long long w_stride, float* __restrict__ out, int B, int K, int N,
                  int rows_per_rank, int ranks) {
  constexpr int kCols = 32 * VEC;
  __shared__ float part[WARPS][kCols];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b0 = blockIdx.x * LB;
  const int col0 = blockIdx.y * kCols + lane * VEC;  // N % VEC == 0: all VEC in range
  const int per_warp = (rows_per_rank + WARPS - 1) / WARPS;
  const W* wp = w + static_cast<size_t>(b0) * w_stride + col0;
  float run[LB][VEC];  // warp 0: each lane's sum over the ranks so far
  for (int r = 0; r < ranks; ++r) {
    const int k0 = r * rows_per_rank;
    const int wk0 = k0 + warp * per_warp;
    const int wk1 = min(min(K, k0 + rows_per_rank), wk0 + per_warp);
    float acc[LB][VEC];
#pragma unroll
    for (int l = 0; l < LB; ++l)
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[l][j] = 0.0f;
    if (col0 < N) {
#pragma unroll 4
      for (int k = wk0; k < wk1; ++k) {
        const Pack<W, VEC> p = *reinterpret_cast<const Pack<W, VEC>*>(
            wp + static_cast<size_t>(k) * N);
#pragma unroll
        for (int l = 0; l < LB; ++l) {
          const float xk = b0 + l < B ? x[static_cast<size_t>(b0 + l) * x_stride + k] : 0.0f;
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc[l][j] = fmaf(xk, to_f32(p.v[j]), acc[l][j]);
        }
      }
    }
#pragma unroll
    for (int l = 0; l < LB; ++l) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) part[warp][lane * VEC + j] = acc[l][j];
      __syncthreads();
      if (warp == 0) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          float s = part[0][lane * VEC + j];
#pragma unroll
          for (int wi = 1; wi < WARPS; ++wi) s += part[wi][lane * VEC + j];
          run[l][j] = r == 0 ? s : run[l][j] + s;
        }
      }
      __syncthreads();
    }
  }
  if (warp == 0 && col0 < N) {
#pragma unroll
    for (int l = 0; l < LB; ++l) {
      if (b0 + l >= B) break;
#pragma unroll
      for (int j = 0; j < VEC; ++j) out[static_cast<size_t>(b0 + l) * N + col0 + j] = run[l][j];
    }
  }
}

constexpr int kSharedLanes = 4;  // lanes per CTA on shared weights

template <typename W, int VEC>
cudaError_t launch_lanes_vec(const float* x, long long x_stride, const W* w,
                             long long w_stride, float* out, int B, int K, int N,
                             cudaStream_t s) {
  const int tiles = (N + 32 * VEC - 1) / (32 * VEC);
  // gemv_kernel's split of K: one CTA of 16 warps up to kClusterMinK, else
  // ranks of 8 warps over ceil(K / ranks) rows each.
  const bool one = K <= kClusterMinK;
  const int ranks = one ? 1 : min(kMaxCluster, (K + kRowsPerRank - 1) / kRowsPerRank);
  const int rows = one ? K : (K + ranks - 1) / ranks;
  if (w_stride == 0) {
    const dim3 grid((B + kSharedLanes - 1) / kSharedLanes, tiles);
    if (one) {
      gemv_lanes_kernel<W, VEC, 16, kSharedLanes><<<grid, 16 * 32, 0, s>>>(
          x, x_stride, w, 0, out, B, K, N, rows, ranks);
    } else {
      gemv_lanes_kernel<W, VEC, 8, kSharedLanes><<<grid, 8 * 32, 0, s>>>(
          x, x_stride, w, 0, out, B, K, N, rows, ranks);
    }
  } else if (one) {
    gemv_lanes_kernel<W, VEC, 16, 1><<<dim3(B, tiles), 16 * 32, 0, s>>>(
        x, x_stride, w, w_stride, out, B, K, N, rows, ranks);
  } else {
    gemv_lanes_kernel<W, VEC, 8, 1><<<dim3(B, tiles), 8 * 32, 0, s>>>(
        x, x_stride, w, w_stride, out, B, K, N, rows, ranks);
  }
  return cudaSuccess;
}

// The widest load that N, w's alignment and the lane stride allow.
template <typename W>
cudaError_t launch_lanes(const float* x, long long x_stride, const W* w, long long w_stride,
                         float* out, int B, int K, int N, cudaStream_t s) {
  int vec = 16 / static_cast<int>(sizeof(W));
  while (vec > 1 && (N % vec != 0 || w_stride % vec != 0 ||
                     reinterpret_cast<uintptr_t>(w) % (vec * sizeof(W)) != 0)) {
    vec /= 2;
  }
  switch (vec) {
    case 8:
      if constexpr (sizeof(W) == 2)
        return launch_lanes_vec<W, 8>(x, x_stride, w, w_stride, out, B, K, N, s);
      return cudaErrorInvalidValue;
    case 4: return launch_lanes_vec<W, 4>(x, x_stride, w, w_stride, out, B, K, N, s);
    case 2: return launch_lanes_vec<W, 2>(x, x_stride, w, w_stride, out, B, K, N, s);
    default: return launch_lanes_vec<W, 1>(x, x_stride, w, w_stride, out, B, K, N, s);
  }
}

template <typename W>
__global__ void tiled_kernel(const float* __restrict__ x, const W* __restrict__ w,
                             float* __restrict__ out, int M, int K, int N) {
  __shared__ float xs[kTile][kTile];
  __shared__ float ws[kTile][kTile + 1];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int row = blockIdx.y * kTile + ty;
  const int col = blockIdx.x * kTile + tx;
  float acc = 0.0f;
  for (int k0 = 0; k0 < K; k0 += kTile) {
    const int kx = k0 + tx;
    const int kw = k0 + ty;
    xs[ty][tx] = (row < M && kx < K) ? x[static_cast<size_t>(row) * K + kx] : 0.0f;
    ws[ty][tx] = (kw < K && col < N) ? to_f32(w[static_cast<size_t>(kw) * N + col]) : 0.0f;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTile; ++kk) acc = fmaf(xs[ty][kk], ws[kk][tx], acc);
    __syncthreads();
  }
  if (row < M && col < N) out[static_cast<size_t>(row) * N + col] = acc;
}

template <typename W>
int launch(const void* x, const void* w, void* out, int M, int K, int N, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const W* wp = static_cast<const W*>(w);
  float* op = static_cast<float*>(out);
  if (M == 1) {
    const cudaError_t err = launch_gemv<W>(xp, wp, op, K, N, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {
    dim3 block(kTile, kTile);
    dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile);
    tiled_kernel<W><<<grid, block, 0, s>>>(xp, wp, op, M, K, N);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One bucket's M = 1 product for a run; field order and types match
// kernels/syn_matmul.py:GemvPlan.
struct GemvPlan {
  const void* w;  // [K, N] in the type wtype names
  void* out;      // [N] f32
  void* stream;
  int K;
  int N;
  int wtype;  // 0 f32, 1 fp16, 2 bf16
};

REPRO_EXPORT int syn_matmul_f32(const void* x, const void* w, void* out, int M,
                                int K, int N, void* stream) {
  return launch<float>(x, w, out, M, K, N, stream);
}

REPRO_EXPORT int syn_matmul_f16(const void* x, const void* w, void* out, int M,
                                int K, int N, void* stream) {
  return launch<__half>(x, w, out, M, K, N, stream);
}

REPRO_EXPORT int syn_matmul_bf16(const void* x, const void* w, void* out, int M,
                                 int K, int N, void* stream) {
  return launch<__nv_bfloat16>(x, w, out, M, K, N, stream);
}

REPRO_EXPORT int syn_matmul_run(const GemvPlan* plan, const void* x) {
  switch (plan->wtype) {
    case 0: return launch<float>(x, plan->w, plan->out, 1, plan->K, plan->N, plan->stream);
    case 1: return launch<__half>(x, plan->w, plan->out, 1, plan->K, plan->N, plan->stream);
    case 2:
      return launch<__nv_bfloat16>(x, plan->w, plan->out, 1, plan->K, plan->N, plan->stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

REPRO_EXPORT int syn_matmul_plan_size() { return static_cast<int>(sizeof(GemvPlan)); }

// One bucket's products over B lanes for a run; field order and types
// match kernels/syn_matmul.py:LanesPlan.
struct LanesPlan {
  const void* w;  // [K, N] shared, or [B, K, N] per lane, in the type wtype names
  void* out;      // [B, N] f32
  void* stream;
  long long w_stride;  // 0: shared; else K * N
  int K, N, wtype, lanes;
};

template <typename W>
static int launch_lanes_plan(const LanesPlan* p, const void* x, long long x_stride) {
  if (p->lanes <= 0 || p->N <= 0) return 0;
  const cudaError_t err = launch_lanes<W>(
      static_cast<const float*>(x), x_stride, static_cast<const W*>(p->w), p->w_stride,
      static_cast<float*>(p->out), p->lanes, p->K, p->N, static_cast<cudaStream_t>(p->stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// B lanes' products on the rows x[b * x_stride .. + K] (ops.MatmulRun over
// lanes).
REPRO_EXPORT int syn_matmul_lanes(const LanesPlan* plan, const void* x, long long x_stride) {
  switch (plan->wtype) {
    case 0: return launch_lanes_plan<float>(plan, x, x_stride);
    case 1: return launch_lanes_plan<__half>(plan, x, x_stride);
    case 2: return launch_lanes_plan<__nv_bfloat16>(plan, x, x_stride);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

REPRO_EXPORT int syn_matmul_lanes_plan_size() { return static_cast<int>(sizeof(LanesPlan)); }
