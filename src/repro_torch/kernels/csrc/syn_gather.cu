// CSR fan-in gathers for Hopper (sm_90a): one launch per tick over every
// CSR bucket of a run.
//
// Replaces the Pallas TPU kernel src/repro/kernels/syn_gather.py
// (syn_gather -> _gather_kernel): out[q] = sum_k spikes[idx[q, k]] * w[q, k]
// over fixed-width fan-in rows; idx int16 or int32, w fp16, bf16 or f32
// decoded to f32 where it is loaded. Padding is index 0 with weight +0.0.
//
// One kernel serves two callers. The run launcher (GatherPlan with items,
// kernels/syn_gather.py:GatherPlan) gives one warp per (delay, post
// column) item: the warp walks the item's (bucket, row) contributions in
// plan order, sums each row with lane l taking k = l, l+32, ... (fmaf
// into +0.0) and a fixed shuffle tree, and adds the row sums in plan
// order into a register that starts at +0.0 (or, for a later launch
// group, at the accumulator's current entry); it then writes the entry.
// Zero-fill items write 0.0 into up to 32 entries no bucket of the group
// covers, so every entry of the accumulator rows, one per (delay, ring
// channel), is written every tick and nothing clears them. On a COBA
// (two-channel) ring each contribution lands as its absolute value: the
// warp applies fabsf to each (bucket, row) sum before it adds it to the
// entry's register, as the reference takes |drive| of each bucket's drive
// before the per-delay sum (never of the entry's total). The indices are the tick's global
// spike ids (composed once per run), so one launch reads the [N] spike
// row directly. The single call (ops.syn_gather, items null) is the same
// kernel over one table, one item per row. Row sums and per-entry sums
// keep the order of a per-bucket path that adds each bucket's drive into
// zeros in plan order, so Synfire's rasters stay bit for bit.
//
// What bounds it: latency. A Synfire4 tick reads about 100 KB of int16
// indices and f32 weights (x100: about 64 MB, beyond the 50 MB L2), far
// from the card's memory rate at Synfire4's size; the launch and the
// gather's dependent loads (index, then spike) decide. The spike row
// (4.8 KB at Synfire4, 480 KB at x100) is read through the read-only
// path, where L2 keeps it; staging the whole row in shared memory in
// every CTA (kStaged, a measurement option: P f32 must fit the device's
// opt-in limit) gives the same sums.
//
// Lanes: a run over B lanes (a batched run, a LaneScheduler's chunk) gives
// the kernel B spike rows and B accumulator row blocks, and the weight
// tables either once (w_stride 0: shared weights, run_batch) or once per
// lane (each lane's own weights, as a scheduler's lanes hold them). The
// index plan is shared. The grid gains a lane dimension, so a tick of every
// lane is still one launch, and each lane's sums keep the single-lane
// order: a lane equals its solo run bit for bit.
//
// Out-of-range indices follow the reference's jnp.take: an index in
// [-P, -1] counts from the end of the row, any other index outside
// [0, P) reads NaN (the run launcher's tables are checked at build).
#include "common.cuh"

namespace {

constexpr int kWarps = 8;  // 256 threads a CTA
constexpr size_t kDefaultSharedBytes = 48 * 1024;

struct GatherPlan {
  const int* items;     // [n_items][3] (out, begin, end); null: item q is row q
  const int* contribs;  // [.][2] (offset, F); null: row q at q * F
  const void* idx;
  const void* w;
  float* rows;
  void* stream;
  int n_items, P, F, itype, wtype, accumulate, staged;
  int absolute;  // 1: add |row sum| (COBA), 0: the signed sum
  int lanes;  // B: spike rows [B, P], accumulator rows [B, .] at rows_stride
  long long w_stride;  // lane stride of w: 0 when the lanes share the tables
  long long rows_stride;  // lane stride of rows (entries)
};

template <typename I, typename W, bool kStaged>
__global__ void __launch_bounds__(kWarps * 32)
    gather_kernel(GatherPlan p, const float* __restrict__ spikes) {
  extern __shared__ float staged[];
  const int b = blockIdx.y;  // the lane
  spikes += static_cast<size_t>(b) * p.P;
  float* const rows = p.rows + static_cast<size_t>(b) * p.rows_stride;
  const float* sp = spikes;
  if (kStaged) {
    for (int j = threadIdx.x; j < p.P; j += blockDim.x) staged[j] = spikes[j];
    __syncthreads();
    sp = staged;
  }
  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (item >= p.n_items) return;  // whole warps leave together: the shuffles stay full
  int out = item, begin = item, end = item + 1;
  if (p.items) {
    out = p.items[3 * item];
    begin = p.items[3 * item + 1];
    end = p.items[3 * item + 2];
    if (begin < 0) {  // zero fill of -begin entries
      if (lane < -begin) rows[out + lane] = 0.0f;
      return;
    }
  }
  const I* idx = static_cast<const I*>(p.idx);
  const W* w = static_cast<const W*>(p.w) + static_cast<size_t>(b) * p.w_stride;
  float acc = p.accumulate ? rows[out] : 0.0f;
  for (int c = begin; c < end; ++c) {
    size_t off;
    int F;
    if (p.contribs) {
      off = static_cast<size_t>(static_cast<unsigned>(p.contribs[2 * c]));
      F = p.contribs[2 * c + 1];
    } else {
      off = static_cast<size_t>(c) * p.F;
      F = p.F;
    }
    const I* irow = idx + off;
    const W* wrow = w + off;
    float s = 0.0f;
    for (int k = lane; k < F; k += 32) {
      int j = static_cast<int>(irow[k]);
      if (j < 0) j += p.P;
      const float x = (j >= 0 && j < p.P) ? (kStaged ? sp[j] : __ldg(sp + j))
                                          : __int_as_float(0x7fc00000);
      s = fmaf(x, to_f32(wrow[k]), s);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    acc += p.absolute ? fabsf(s) : s;  // lane 0 holds the row sum and the entry's sum
  }
  if (lane == 0) rows[out] = acc;
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
int launch_typed(const GatherPlan& p, const float* spikes) {
  if (p.n_items <= 0 || p.lanes <= 0) return 0;
  const dim3 blocks((p.n_items + kWarps - 1) / kWarps, p.lanes);
  const cudaStream_t s = static_cast<cudaStream_t>(p.stream);
  if (!p.staged) {
    gather_kernel<I, W, false><<<blocks, kWarps * 32, 0, s>>>(p, spikes);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = static_cast<size_t>(p.P) * sizeof(float);
  if (smem > optin_shared_bytes()) return static_cast<int>(cudaErrorInvalidValue);
  static size_t opted = kDefaultSharedBytes;  // per instance, the longest row so far
  if (smem > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        gather_kernel<I, W, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = smem;
  }
  gather_kernel<I, W, true><<<blocks, kWarps * 32, smem, s>>>(p, spikes);
  return static_cast<int>(cudaGetLastError());
}

template <typename I>
int launch_index(const GatherPlan& p, const float* spikes) {
  switch (p.wtype) {
    case 0: return launch_typed<I, float>(p, spikes);
    case 1: return launch_typed<I, __half>(p, spikes);
    case 2: return launch_typed<I, __nv_bfloat16>(p, spikes);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int launch(const GatherPlan& p, const void* spikes) {
  const float* sp = static_cast<const float*>(spikes);
  switch (p.itype) {
    case 0: return launch_index<int16_t>(p, sp);
    case 1: return launch_index<int32_t>(p, sp);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

REPRO_EXPORT int syn_gather_plan_size() { return static_cast<int>(sizeof(GatherPlan)); }

// One launch group of a run (kernels/syn_gather.py:GatherLauncher).
REPRO_EXPORT int syn_gather_run(const GatherPlan* plan, const void* spikes) {
  return launch(*plan, spikes);
}

// The single checked call over one [Q, F] table (ops.syn_gather).
#define REPRO_GATHER(NAME, ITYPE, WTYPE)                                              \
  REPRO_EXPORT int NAME(const void* spikes, const void* idx, const void* w, void* out, \
                        int P, int Q, int F, void* stream) {                          \
    const GatherPlan p{nullptr, nullptr, idx, w, static_cast<float*>(out), stream,    \
                       Q, P, F, ITYPE, WTYPE, 0, 0, 0, 1, 0, 0};                      \
    return launch(p, spikes);                                                         \
  }

REPRO_GATHER(syn_gather_i16_f32, 0, 0)
REPRO_GATHER(syn_gather_i16_f16, 0, 1)
REPRO_GATHER(syn_gather_i16_bf16, 0, 2)
REPRO_GATHER(syn_gather_i32_f32, 1, 0)
REPRO_GATHER(syn_gather_i32_f16, 1, 1)
REPRO_GATHER(syn_gather_i32_bf16, 1, 2)
