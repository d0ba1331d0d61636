// Dense pair-based STDP weight update for Hopper (sm_90a): one launch per
// tick over every dense-stored pair-STDP projection of a run, the trace
// steps folded in.
//
// Replaces the Pallas TPU kernel src/repro/kernels/stdp_update.py
// (stdp_update -> _stdp_kernel): for every cell of a [P, Q] weight block,
//   w' = clip((w + a+ * (pre_t[p] * post_s[q])) - a- * (pre_s[p] * post_t[q]),
//             w_min, w_max)
// then +0.0 where the mask is false, stored back in the storage type.
//
// One device function (common.cuh:stdp_cell, shared with stdp_gather)
// serves two callers. The single checked call (ops.stdp_update,
// stdp_update_<w>) takes the stepped traces and writes a new [P, Q] block:
// one thread per cell. The run launcher (ops.StdpUpdateRun,
// stdp_update_run) takes a table of projection descriptors built once per
// run and, each tick, one f32 spike row: every projection's weights are
// updated in place, and each trace advances one step (trace * decay +
// spike, common.cuh:trace_step, which is what the two eager kernels of
// core/plasticity.py:_trace_step give). The traces are ping-pong buffers:
// tick parity p reads buffer p and writes buffer 1 - p, so no thread reads
// what the launch writes.
//
// Lanes: the run launcher also takes B independent lanes of a run (a
// batched run, a LaneScheduler's chunk) in the same launch: grid.y is the
// lane, and lane b reads its weights at w + b * w_lane (each lane the start
// of its own zero-ended [P*Q + 1] buffer), its traces at b * P and b * Q
// and its spike row at b * n, the mask shared. Each lane's tile is the
// one-lane tile, so a lane equals its one-lane launch bit for bit.
//
// The run launcher's layout: the work is a dense rectangle per projection,
// so one CTA takes a tile of kRows rows by kThreads columns, one thread per
// column. Its first kRows threads step the tile rows' pre traces into
// shared memory (and, in the projection's first column tile, write them to
// buffer 1 - p); each thread steps its column's post trace once (written
// by the first row tile) and updates its kRows cells. Each thread issues
// every load it needs (weights, mask, spikes, traces) before it waits on
// any, so a CTA waits on memory three times in a row: the projection
// starts, its descriptor, then all of its data. Tiles are numbered projection
// by projection; a CTA finds its projection by counting the projection
// starts at or below its tile (__syncthreads_count over a compact array of
// starts, one load round trip for up to kThreads projections).
//
// What bounds it: launch latency, then bytes. Per cell it reads the weight
// and the mask byte and writes the weight: 5 B per cell at fp16. A plastic
// Synfire4 packed tick updates four [200, 200] chain blocks (160,000 cells,
// about 0.82 MB with the traces and spikes, about 0.24 us at 3.35 TB/s);
// an empty launch is about 0.9 us.
//
// Rounding: every multiply, add and subtract is __fmul_rn / __fadd_rn /
// __fsub_rn in the plain version's association (kernels/ref.py:
// stdp_update_ref, stdp_update_run_ref), which nvcc never contracts into an
// FMA; the clip keeps a NaN (common.cuh:clip_keep_nan, as torch.clamp and
// jnp.clip do) and the mask writes +0.0. The coefficients arrive as float,
// the f32 rounding of the configuration's doubles, as the plain version
// applies them. The kernel is therefore bit for bit equal to its plain
// version on the CPU and on the card.
#include "common.cuh"

namespace {

// -- the single checked call -------------------------------------------------

constexpr int kCellThreads = 256;

template <typename T>
__global__ void stdp_update_kernel(const T* __restrict__ w, const uint8_t* __restrict__ mask,
                                   const float* __restrict__ pre_t,
                                   const float* __restrict__ post_t,
                                   const float* __restrict__ pre_s,
                                   const float* __restrict__ post_s, T* __restrict__ out,
                                   int P, int Q, StdpCoeffs c) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(P) * Q) return;
  const int p = static_cast<int>(i / Q);
  const int q = static_cast<int>(i - static_cast<long long>(p) * Q);
  out[i] = from_f32<T>(stdp_cell(to_f32(w[i]), __ldg(pre_t + p), __ldg(pre_s + p),
                                 __ldg(post_t + q), __ldg(post_s + q), mask[i] != 0, c));
}

template <typename T>
int launch(const void* w, const void* mask, const void* pre_t, const void* post_t,
           const void* pre_s, const void* post_s, void* out, int P, int Q, StdpCoeffs c,
           void* stream) {
  const long long cells = static_cast<long long>(P) * Q;
  if (cells <= 0) return 0;
  const long long blocks = (cells + kCellThreads - 1) / kCellThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  stdp_update_kernel<T><<<static_cast<unsigned>(blocks), kCellThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(w), static_cast<const uint8_t*>(mask),
      static_cast<const float*>(pre_t), static_cast<const float*>(post_t),
      static_cast<const float*>(pre_s), static_cast<const float*>(post_s),
      static_cast<T*>(out), P, Q, c);
  return static_cast<int>(cudaGetLastError());
}

// -- the run launcher ----------------------------------------------------------

// Measured on Synfire4's four [200, 200] fp16 blocks (scripts/
// bench_stdp_update_tiles.py): 2 to 8 rows by 128 or 256 columns lie within
// 0.5 us of each other, 1 or 16 rows about 0.9 us above; 4 by 256 was
// among the fastest in every run.
constexpr int kThreads = 256;  // columns per tile, one thread each
constexpr int kRows = 4;  // rows per tile

// One dense pair-STDP projection of a run (kernels/stdp_update.py:_Proj,
// field for field). Its tiles are [begin, begin + row_tiles * col_tiles),
// row tile major, with row_tiles = max(1, ceil(P / kRows)) and col_tiles =
// max(1, ceil(Q / kThreads)): a projection with no cells still steps its
// traces.
struct StdpDenseProj {
  void* w;  // [B, P, Q] storage type, lane stride w_lane, updated in place
  const uint8_t* mask;  // [P, Q], shared by the lanes
  float* pre_tr[2];  // [B, P] ping-pong
  float* post_tr[2];  // [B, Q] ping-pong
  long long w_lane;  // the weights' lane stride in entries
  int begin, P, Q, col_tiles, pre_start, post_start, wtype;  // wtype 0 f32, 1 fp16, 2 bf16
  float a_plus, a_minus, w_min, w_max, decay_pre, decay_post;
};

struct StdpDensePlan {
  const StdpDenseProj* projs;  // [n_projs] in device memory
  const int* begins;  // [n_projs] each projection's first tile, ascending from 0
  void* stream;
  int n_tiles, n_projs;
  int lanes, n;  // lanes (grid.y) and the spike row's length (its lane stride)
};

// One CTA's tile of projection p in storage type T. Every weight and mask
// load of the thread's kRows cells is issued before anything waits on one:
// rows past P and columns past Q load the tile's last row or column again
// (in bounds, never stored), so the loads need no branch, and they are
// decoded only after the barrier.
template <typename T>
__device__ __forceinline__ void update_tile(const StdpDenseProj& p, int tile,
                                            const float* __restrict__ spikes, int parity,
                                            int lane) {
  const int x = threadIdx.x;
  // Constant indices only: a runtime index into the descriptor's pairs would
  // put the descriptor on the stack.
  const long long pre_at = static_cast<long long>(lane) * p.P;
  const long long post_at = static_cast<long long>(lane) * p.Q;
  const float* pre_old = (parity ? p.pre_tr[1] : p.pre_tr[0]) + pre_at;
  float* pre_new = (parity ? p.pre_tr[0] : p.pre_tr[1]) + pre_at;
  const float* post_old = (parity ? p.post_tr[1] : p.post_tr[0]) + post_at;
  float* post_new = (parity ? p.post_tr[0] : p.post_tr[1]) + post_at;
  void* const w_base = static_cast<T*>(p.w) + static_cast<long long>(lane) * p.w_lane;
  const int r0 = (tile / p.col_tiles) * kRows;
  const int col_tile = tile % p.col_tiles;
  const int c = col_tile * kThreads + x;
  const int rows = min(kRows, p.P - r0);
  const bool col = c < p.Q;
  T raw[kRows];
  uint8_t keep[kRows];
  if (rows > 0 && p.Q > 0) {  // the same for the whole CTA
    const long long at = static_cast<long long>(r0) * p.Q + min(c, p.Q - 1);
    const T* w = static_cast<const T*>(w_base) + at;
    const uint8_t* mask = p.mask + at;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const long long off = static_cast<long long>(min(r, rows - 1)) * p.Q;
      raw[r] = w[off];
      keep[r] = mask[off];
    }
  }
  // The trace loads next, all of them before the first use of any.
  const int j = r0 + x;
  float ps = 0.0f, pt = 0.0f, qs = 0.0f, qt = 0.0f;
  if (x < rows) {
    ps = __ldg(spikes + p.pre_start + j);
    pt = __ldg(pre_old + j);
  }
  if (col) {
    qs = __ldg(spikes + p.post_start + c);
    qt = __ldg(post_old + c);
  }
  __shared__ float pre_t[kRows], pre_s[kRows];
  if (x < rows) {
    pt = trace_step(pt, p.decay_pre, ps);
    pre_s[x] = ps;
    pre_t[x] = pt;
    if (col_tile == 0) pre_new[j] = pt;
  }
  if (col) {
    qt = trace_step(qt, p.decay_post, qs);
    if (r0 == 0) post_new[c] = qt;
  }
  __syncthreads();
  if (!col) return;
  const StdpCoeffs coeffs{p.a_plus, p.a_minus, p.w_min, p.w_max};
  T* w = static_cast<T*>(w_base) + static_cast<long long>(r0) * p.Q + c;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r < rows) {
      w[static_cast<long long>(r) * p.Q] = from_f32<T>(
          stdp_cell(to_f32(raw[r]), pre_t[r], pre_s[r], qt, qs, keep[r] != 0, coeffs));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    stdp_update_run_kernel(StdpDensePlan plan, const float* __restrict__ spikes, int parity) {
  const int tile_id = static_cast<int>(blockIdx.x);
  int k = -1;  // the number of projections starting at or below this tile, less one
  for (int base = 0; base < plan.n_projs; base += kThreads) {
    const int j = base + static_cast<int>(threadIdx.x);
    k += __syncthreads_count(j < plan.n_projs && __ldg(plan.begins + j) <= tile_id);
  }
  const StdpDenseProj p = plan.projs[k];  // a copy: the stores below alias nothing in it
  const int lane = static_cast<int>(blockIdx.y);
  const float* row = spikes + static_cast<long long>(lane) * plan.n;
  if (p.wtype == 1) {  // the same for the whole CTA, as is the barrier inside
    update_tile<__half>(p, tile_id - p.begin, row, parity, lane);
  } else if (p.wtype == 2) {
    update_tile<__nv_bfloat16>(p, tile_id - p.begin, row, parity, lane);
  } else {
    update_tile<float>(p, tile_id - p.begin, row, parity, lane);
  }
}

}  // namespace

REPRO_EXPORT int stdp_update_run_sizes(int* out) {
  out[0] = static_cast<int>(sizeof(StdpDenseProj));
  out[1] = static_cast<int>(sizeof(StdpDensePlan));
  out[2] = kRows;
  out[3] = kThreads;
  return 0;
}

// One tick of a run (kernels/stdp_update.py:StdpUpdateLauncher): `spikes`
// is the tick's [B, N] f32 spike rows, `parity` the trace buffer holding the
// traces.
REPRO_EXPORT int stdp_update_run(const StdpDensePlan* plan, const void* spikes, int parity) {
  if (plan->n_tiles <= 0 || plan->lanes <= 0) return 0;
  if (plan->lanes > 65535) return static_cast<int>(cudaErrorInvalidValue);
  stdp_update_run_kernel<<<dim3(static_cast<unsigned>(plan->n_tiles),
                                static_cast<unsigned>(plan->lanes)), kThreads, 0,
                           static_cast<cudaStream_t>(plan->stream)>>>(
      *plan, static_cast<const float*>(spikes), parity);
  return static_cast<int>(cudaGetLastError());
}

#define REPRO_STDP_UPDATE(NAME, T)                                                     \
  REPRO_EXPORT int NAME(const void* w, const void* mask, const void* pre_t,           \
                        const void* post_t, const void* pre_s, const void* post_s,    \
                        void* out, int P, int Q, float a_plus, float a_minus,         \
                        float w_min, float w_max, void* stream) {                     \
    return launch<T>(w, mask, pre_t, post_t, pre_s, post_s, out, P, Q,                \
                     StdpCoeffs{a_plus, a_minus, w_min, w_max}, stream);              \
  }

REPRO_STDP_UPDATE(stdp_update_f32, float)
REPRO_STDP_UPDATE(stdp_update_f16, __half)
REPRO_STDP_UPDATE(stdp_update_bf16, __nv_bfloat16)
