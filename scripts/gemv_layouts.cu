// GEMV layouts for the M = 1 syn_matmul on Hopper, side by side (a
// measurement aid for csrc/syn_matmul.cu's choice of layout; not part of
// the port). Built and run by scripts/bench_gemv_layouts.py. Variants:
// 0 the one-CTA-per-32-columns layout of the first port (8 K slices,
// scalar loads); 1 a thread-block cluster splitting K over `ranks` CTAs of
// 8 warps (vector loads, partial sums through distributed shared memory);
// 2-4 no cluster, one CTA of 8, 32 or 16 warps per column tile; 5 an
// empty kernel (the launch alone); 6 a cluster of CTAs of 32 warps.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

template <int VEC>
struct alignas(sizeof(float) * VEC) Pack {
  float v[VEC];
};

template <int VEC, int WARPS, bool CLUSTER>
__global__ void __launch_bounds__(WARPS * 32)
gemv(const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ out,
     int K, int N, int rows_per_rank) {
  constexpr int kCols = 32 * VEC;
  __shared__ float part[WARPS][kCols];
  __shared__ float total[kCols];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rank = CLUSTER ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  const int col0 = blockIdx.y * kCols + lane * VEC;
  const int k0 = rank * rows_per_rank;
  const int per_warp = (rows_per_rank + WARPS - 1) / WARPS;
  const int wk0 = k0 + warp * per_warp;
  const int wk1 = min(min(K, k0 + rows_per_rank), wk0 + per_warp);
  float acc[VEC];
  for (int j = 0; j < VEC; ++j) acc[j] = 0.0f;
  if (col0 < N) {
#pragma unroll 4
    for (int k = wk0; k < wk1; ++k) {
      const float xk = x[k];
      const Pack<VEC> p =
          *reinterpret_cast<const Pack<VEC>*>(w + static_cast<size_t>(k) * N + col0);
      for (int j = 0; j < VEC; ++j) acc[j] = fmaf(xk, p.v[j], acc[j]);
    }
  }
  for (int j = 0; j < VEC; ++j) part[warp][lane * VEC + j] = acc[j];
  __syncthreads();
  if (warp == 0) {
    for (int j = 0; j < VEC; ++j) {
      float s = part[0][lane * VEC + j];
      for (int wi = 1; wi < WARPS; ++wi) s += part[wi][lane * VEC + j];
      total[lane * VEC + j] = s;
    }
  }
  if constexpr (CLUSTER) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    if (rank == 0 && warp == 0 && col0 < N) {
      for (int j = 0; j < VEC; ++j) {
        float s = total[lane * VEC + j];
        for (int r = 1; r < static_cast<int>(cluster.num_blocks()); ++r) {
          s += cluster.map_shared_rank(total, r)[lane * VEC + j];
        }
        out[col0 + j] = s;
      }
    }
    cluster.sync();
  } else if (warp == 0 && col0 < N) {
    for (int j = 0; j < VEC; ++j) out[col0 + j] = total[lane * VEC + j];
  }
}

__global__ void first_port_gemv(const float* __restrict__ x, const float* __restrict__ w,
                                float* __restrict__ out, int K, int N) {
  __shared__ float part[8][33];
  const int col = blockIdx.x * 32 + threadIdx.x;
  const int slice = threadIdx.y;
  const int chunk = (K + 7) / 8;
  const int k0 = slice * chunk;
  const int k1 = min(K, k0 + chunk);
  float acc = 0.0f;
  if (col < N) {
    for (int k = k0; k < k1; ++k) acc = fmaf(x[k], w[static_cast<size_t>(k) * N + col], acc);
  }
  part[slice][threadIdx.x] = acc;
  __syncthreads();
  if (slice == 0 && col < N) {
    float s = part[0][threadIdx.x];
    for (int j = 1; j < 8; ++j) s += part[j][threadIdx.x];
    out[col] = s;
  }
}

__global__ void empty_kernel() {}

template <int VEC, int WARPS, bool CLUSTER>
int launch(const float* x, const float* w, float* out, int K, int N, int ranks,
           cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ranks, (N + 32 * VEC - 1) / (32 * VEC), 1);
  cfg.blockDim = dim3(WARPS * 32, 1, 1);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = CLUSTER ? 1 : 0;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, gemv<VEC, WARPS, CLUSTER>, x, w, out, K,
                                             N, (K + ranks - 1) / ranks));
}

template <int WARPS, bool CLUSTER>
int launch_vec(const float* x, const float* w, float* out, int K, int N, int ranks,
               cudaStream_t s) {
  if (N % 4 == 0) return launch<4, WARPS, CLUSTER>(x, w, out, K, N, ranks, s);
  if (N % 2 == 0) return launch<2, WARPS, CLUSTER>(x, w, out, K, N, ranks, s);
  return launch<1, WARPS, CLUSTER>(x, w, out, K, N, ranks, s);
}

extern "C" int variant(int v, const float* x, const float* w, float* out, int K, int N,
                       int ranks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (v) {
    case 0:
      first_port_gemv<<<(N + 31) / 32, dim3(32, 8), 0, s>>>(x, w, out, K, N);
      return static_cast<int>(cudaGetLastError());
    case 1: return launch_vec<8, true>(x, w, out, K, N, ranks, s);
    case 2: return launch_vec<8, false>(x, w, out, K, N, 1, s);
    case 3: return launch_vec<32, false>(x, w, out, K, N, 1, s);
    case 4: return launch_vec<16, false>(x, w, out, K, N, 1, s);
    case 5:
      empty_kernel<<<1, 32, 0, s>>>();
      return static_cast<int>(cudaGetLastError());
    case 6: return launch_vec<32, true>(x, w, out, K, N, ranks, s);
    default: return -1;
  }
}
