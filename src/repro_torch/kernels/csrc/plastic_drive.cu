// The plastic and STP projections' fan-in drive for Hopper (sm_90a): every
// projection of a tick, every lane, in one launch.
//
// Replaces no TPU kernel: the reference computes this drive in XLA (an
// index gather, a product and a row reduce per projection,
// src/repro/core/engine.py's fan-in path), and the port's plain version is
// kernels/ref.py:plastic_drive_ref. For each projection and row q,
//   drive[q] = sum_k pre_row[pre[q, k]] * w_row[q, k]
// with pre_row the tick's spike row (global ids, the sentinel id N reading
// +0.0) for a plastic projection, or its pre group's spikes scaled by u * x
// (local ids) for an STP projection; w_row the CSR fan-in weights [Q, F],
// or the rows of a dense [P, Q] weight read through the flat index table
// `rows` (the sentinel P * Q reading +0.0). The drive lands, as its
// absolute value on a conductance-based net, in the per-delay f32
// accumulator entries the host names (kernels/plastic_drive.py:
// DriveLauncher), projection by projection in order, as
// core/backend.propagate_packed lands it: `acc += drive`.
//
// Sum order: each row sums in the order XLA's CPU backend gives the
// reference's compiled f32 reduce (kernels/ref.py:xla_cpu_row_sum): the
// row cut into windows of 32 with pad // 2 skipped slots in front (pad =
// -F mod 32), each window summed left to right from +0.0, the window sums
// reduced the same way until 32 or fewer remain, which sum left to right
// from +0.0. The kernel takes those adds in that order (a reduce over
// window sums skips the +0.0 slots in front and behind, which add nothing
// to a sum from +0.0: it cannot be -0.0), so the card's drive equals the
// CPU port's, and the reference's, bit for bit. Every product and add is
// __fmul_rn / __fadd_rn; an STP row's u * x rounds to the state's storage
// type first, as torch's half multiply does.
//
// Layout: one warp per accumulator entry and group of lanes, kWarps warps
// a block, grid (ceil(entries / kWarps), ceil(lanes / group)); an entry is
// one post column of one (delay, channel) accumulator, and lists the
// (projection, row) pairs landing there in projection order, so two
// projections on one column add in order without atomics. Thread l of the
// warp takes slot l of every window of 32: the warp loads kBatch windows'
// pre ids (and flat rows) in one coalesced access each, once for all the
// group's lanes, then each lane's spike-row and weight gathers, every load
// unconditional at a clamped index so that a batch's loads are in flight
// together, and stages the products in shared memory (a slot outside the
// row stages +0.0, XLA's padding). Thread i then sums staged window i's 32
// slots left to right from +0.0 (16-byte reads), so up to 32 windows sum
// side by side: the host picks `group`, the lanes a warp takes, so that
// the group's windows fill the warp (group * ceil(F / 32) <= 32: ten lanes
// of an 80-entry row), and thread g reduces lane g's window sums in order
// (__shfl_sync). A row past 1,024 entries runs lane by lane, 32 windows at
// a time, each deeper level's partial window carried in one register per
// level (indexed by unrolled constants) and pushed up once per finished
// window. No array is indexed at run time, and an STP row batches two
// windows, not four, so ptxas reports 96 registers and no stack frame.
// The weights, STP state and their lane strides arrive with every launch
// (DriveTick, by value, __grid_constant__ so that the projection's entry is
// read in place): DA-STDP, homeostasis and the STP update make new tensors
// every tick. scripts/bench_drive_layouts.py weighs the other layouts.
//
// What bounds it: launch latency and a chain of dependent loads. On an
// NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py), a plastic Synfire4 fp16
// sparse tick's four chain projections (800 rows of up to 81 entries,
// 389,200 bytes: a 0.116 us byte bound at 3.35 TB/s) take 2.53 us on the
// device, 0.96 us of it the same grid's bare launch, the rest one warp's
// chain (entry, descriptor, pre ids, spike row, weights, the window adds,
// the reduce); embedding_bag over the same rows takes 12.56 us. Over 64
// lanes (each lane's own weights, 9.0 MB: a 2.70 us bound) it takes 14.47
// us: 5,600 warps at 20 an SM (96 registers), each gathering its ten
// lanes' rows one lane after another.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;  // warps a block, one accumulator entry (and lane group) each
constexpr int kMaxProjs = 32;
constexpr int kMaxLevels = 7;  // windows of 32: F up to 32^7
constexpr int kWindow = 32;
constexpr int kBatch = 4;  // windows whose loads are in flight together
constexpr int kBatchStp = 2;  // the same on an STP row (two more loads a window)
constexpr int kStride = 36;  // a staged window's floats: 16-byte rows, no bank conflict

// One projection (kernels/plastic_drive.py:_Proj, field for field).
struct DriveProj {
  const int* pre;  // [Q, F] ids into the pre row
  const int* rows;  // [Q, F] flat ids into the dense [P, Q] weight; null: CSR [Q, F]
  int Q, F;
  int stp;  // 1: pre ids are local, the pre row scaled by u * x
  int pre_start, n_pre;  // STP: the pre group in the spike row
  int wtype, stype;  // weight and STP state storage types: 0 f32, 1 fp16, 2 bf16
  int sentinel;  // dense: the flat id that reads +0.0 (P * Q)
  int levels;  // window levels of the XLA order (0: F <= 32)
  int off[kMaxLevels];  // per level, the skipped slots in front of its first window
};

struct DriveEntry {
  int proj, q;
};

// One accumulator entry: lane b's is dst + b * lane_stride.
struct DriveTarget {
  float* dst;
  long long lane_stride;
  int begin, end;  // its entries, in projection order
};

struct DrivePlan {
  const DriveProj* projs;
  const DriveTarget* targets;
  const DriveEntry* entries;
  void* stream;
  int n_targets, n_projs, lanes, n;  // n: the spike row's length (its lane stride)
  int coba;  // land |drive|
  int group;  // lanes a warp takes (windows of its rows side by side: group * n1 <= 32)
};

// What changes from tick to tick: each projection's weights and STP state.
struct DriveTick {
  const void* w[kMaxProjs];
  long long w_lane[kMaxProjs];
  const void* u[kMaxProjs];
  const void* x[kMaxProjs];
  long long stp_lane[kMaxProjs];
};

__device__ __forceinline__ float load(const void* p, long long i, int type) {
  return type == 1   ? __half2float(__ldg(static_cast<const __half*>(p) + i))
         : type == 2 ? __bfloat162float(__ldg(static_cast<const __nv_bfloat16*>(p) + i))
                     : __ldg(static_cast<const float*>(p) + i);
}

// The warp's x summed over threads [lo, hi) in order from +0.0; every
// thread gets the sum.
__device__ __forceinline__ float warp_chain(float x, int lo, int hi) {
  float s = 0.0f;
  for (int i = lo; i < hi; ++i) s = __fadd_rn(s, __shfl_sync(~0u, x, i));
  return s;
}

// One (projection, row), as the whole warp sees it, for any lane.
struct Row {
  DriveProj p;
  long long base;  // the row's first entry in pre, rows and CSR weights
  const float* spikes;  // lane 0's spike row; lane b's is n floats further
  const void* w;
  long long w_lane, s_lane;  // the weights' and STP state's lane strides
  const void* u;
  const void* x;
  int n;

  // Stages level-0 windows first .. first + nv - 1 (slots [32 v, 32 v +
  // 32), off[0] skipped in front of the row) of lanes b0 .. b0 + lanes - 1
  // into `stage`, window v of lane b0 + g in row row0 + g * nv + v - first,
  // thread `lane` taking slot `lane` of each. A slot outside the row stages
  // +0.0.
  __device__ __forceinline__ void stage_windows(float* stage, int first, int nv, long long b0,
                                                int lanes, int row0, int lane) const {
    if (p.stp) {
      if (p.rows) stage_batches<true, true>(stage, first, nv, b0, lanes, row0, lane);
      else stage_batches<true, false>(stage, first, nv, b0, lanes, row0, lane);
    } else {
      if (p.rows) stage_batches<false, true>(stage, first, nv, b0, lanes, row0, lane);
      else stage_batches<false, false>(stage, first, nv, b0, lanes, row0, lane);
    }
  }

  // stage_windows for one kind of row, kBatch windows at a time: their pre
  // ids and flat rows once for all the lanes, then each lane's spike-row
  // and weight gathers. Every load is unconditional, at a clamped index
  // whose value is then selected away, so that a batch's loads are in
  // flight together.
  template <bool kStp, bool kDense>
  __device__ __forceinline__ void stage_batches(float* stage, int first, int nv, long long b0,
                                                int lanes, int row0, int lane) const {
    constexpr int kB = kStp ? kBatchStp : kBatch;
    const int o0 = p.levels > 0 ? p.off[0] : 0;
    for (int v0 = 0; v0 < nv; v0 += kB) {
      int k[kB], j[kB], r[kB];
      bool ok[kB];
#pragma unroll
      for (int a = 0; a < kB; ++a) {
        k[a] = (first + min(v0 + a, nv - 1)) * kWindow + lane - o0;
        ok[a] = v0 + a < nv && k[a] >= 0 && k[a] < p.F;
        if (!ok[a]) k[a] = 0;
        j[a] = __ldg(p.pre + base + k[a]);
        r[a] = kDense ? __ldg(p.rows + base + k[a]) : 0;
      }
      for (int g = 0; g < lanes; ++g) {
        const long long b = b0 + g;
        const float* row = spikes + b * n;
        float sp[kB], wv[kB], ux[kB];
#pragma unroll
        for (int a = 0; a < kB; ++a) {
          if (kStp) {
            const long long s0 = b * s_lane + j[a];
            sp[a] = __ldg(row + p.pre_start + j[a]);
            ux[a] = __fmul_rn(load(u, s0, p.stype), load(x, s0, p.stype));
          } else {
            sp[a] = __ldg(row + min(j[a], n - 1));  // id n, the sentinel, reads +0.0 below
          }
          const long long at = kDense ? min(r[a], p.sentinel - 1) : base + k[a];
          wv[a] = load(w, b * w_lane + at, p.wtype);
        }
#pragma unroll
        for (int a = 0; a < kB; ++a) {
          float ga;
          if (kStp) {
            ga = __fmul_rn(sp[a], round_to(p.stype, ux[a]));
          } else {
            ga = j[a] == n ? 0.0f : sp[a];
          }
          const float wa = kDense && r[a] == p.sentinel ? 0.0f : wv[a];
          if (v0 + a < nv) {
            stage[(row0 + g * nv + v0 + a) * kStride + lane] = ok[a] ? __fmul_rn(ga, wa) : 0.0f;
          }
        }
      }
    }
  }

  // Thread `lane`'s staged row summed left to right from +0.0: one level-0
  // window's sum.
  __device__ __forceinline__ float window_sum(const float* stage, int lane) const {
    __syncwarp();
    const float4* mine = reinterpret_cast<const float4*>(stage + lane * kStride);
    float s = 0.0f;
#pragma unroll
    for (int h = 0; h < kWindow / 4; h += kWindow / 8) {  // two halves of 16 floats
      float4 c[kWindow / 8];
#pragma unroll
      for (int i = 0; i < kWindow / 8; ++i) c[i] = mine[h + i];
#pragma unroll
      for (int i = 0; i < kWindow / 8; ++i) {
        s = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(s, c[i].x), c[i].y), c[i].z), c[i].w);
      }
    }
    __syncwarp();  // the next staging overwrites the rows
    return s;
  }

  // The row's drive on lanes b0 .. b0 + lanes - 1: thread g returns lane
  // b0 + g's. Where the lanes' level-0 windows fit the warp side by side (a
  // row of at most 32 windows, lanes * n1 <= 32), one staging takes them
  // all and thread g sums lane g's window sums in order; otherwise the
  // lanes take their turns (deep_sum, any depth). The launcher's group
  // fits every row of one level, but plastic_drive_run takes any group up
  // to 32, so the kernel tests the fit itself; without that test ptxas
  // spills (scripts/bench_drive_layouts.py's `fit-unchecked`).
  __device__ __forceinline__ float drive(float* stage, long long b0, int lanes,
                                         int lane) const {
    const int n1 = (p.F + kWindow - 1) / kWindow;  // level-0 windows
    float d = 0.0f;
    if (p.levels <= 1 && lanes * n1 <= kWindow) {
      stage_windows(stage, 0, n1, b0, lanes, 0, lane);
      const float s = window_sum(stage, lane);
      const int from = min(lane, lanes - 1) * n1;  // thread g: rows g * n1 ..
      for (int i = 0; i < n1; ++i) d = __fadd_rn(d, __shfl_sync(~0u, s, from + i));
      return d;
    }
#pragma unroll 1
    for (int g = 0; g < lanes; ++g) {
      const float s = deep_sum(stage, b0 + g, n1, lane);
      if (lane == g) d = s;
    }
    return d;
  }

  // The row's sum on lane b, any depth (every thread gets it): 32 level-0
  // windows at a time (a level-1 window), their sums reduced over the
  // threads and carried up the deeper levels.
  __device__ __forceinline__ float deep_sum(float* stage, long long b, int n1, int lane) const {
    const int levels = p.levels;
    const int o1 = levels > 1 ? p.off[1] : 0;
    const int n2 = levels > 1 ? (n1 + kWindow - 1) / kWindow : 1;  // level-1 windows
    float carry[kMaxLevels + 1];  // level i's window: thread s holds slot s
#pragma unroll
    for (int i = 0; i <= kMaxLevels; ++i) carry[i] = 0.0f;
    float total = 0.0f;
    for (int v = 0; v < n2; ++v) {
      // Level-1 window v: slot s is level-0 window wb + s.
      const int wb = v * kWindow - o1;
      const int lo = max(wb, 0), hi = min(wb + kWindow, n1);
      stage_windows(stage, lo, hi - lo, b, 1, lo - wb, lane);
      const float s = window_sum(stage, lane);
      const bool in = wb + lane >= lo && wb + lane < hi;
      float up = warp_chain(in ? s : 0.0f, lo - wb, hi - wb);
      if (levels <= 1) return up;
      // Levels 2 and deeper: item `at` of level i lands in slot (at + off)
      // % 32 of its window; a window full or holding the level's last item
      // is summed and goes up a level.
      int at = v, items = n2;
      bool go = true;
#pragma unroll
      for (int i = 2; i <= kMaxLevels; ++i) {
        if (go && i <= levels) {
          const int pos = at + (i < levels ? p.off[i < kMaxLevels ? i : 0] : 0);
          const int slot = pos % kWindow;
          if (lane == slot) carry[i] = up;
          if (slot == kWindow - 1 || at == items - 1) {
            up = warp_chain(carry[i], 0, slot + 1);
            carry[i] = 0.0f;
            if (i == levels) total = up;
            at = pos / kWindow;
          } else {
            go = false;
          }
        }
        items = (items + kWindow - 1) / kWindow;
      }
    }
    return total;
  }
};

// Warp t % kWarps of block (t / kWarps, y) takes accumulator entry t on
// lanes y * group .. (at most group of them); thread g holds lane g's sum.
__global__ void __launch_bounds__(kWarps * 32)
    plastic_drive_kernel(const __grid_constant__ DrivePlan plan,
                         const float* __restrict__ spikes,
                         const __grid_constant__ DriveTick tick) {
  __shared__ __align__(16) float stage_all[kWarps][kWindow * kStride];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = blockIdx.x * kWarps + warp;
  if (t >= plan.n_targets) return;  // the whole warp
  float* stage = stage_all[warp];
  const long long b0 = static_cast<long long>(blockIdx.y) * plan.group;
  const int lanes = min(plan.group, static_cast<int>(plan.lanes - b0));
  const DriveTarget tg = plan.targets[t];
  float* dst = tg.dst + (b0 + min(lane, lanes - 1)) * tg.lane_stride;
  float acc = *dst;
  for (int e = tg.begin; e < tg.end; ++e) {
    const DriveEntry en = plan.entries[e];
    Row row;
    row.p = plan.projs[en.proj];
    row.base = static_cast<long long>(en.q) * row.p.F;
    row.spikes = spikes;
    row.n = plan.n;
    row.w = tick.w[en.proj];
    row.w_lane = tick.w_lane[en.proj];
    row.u = tick.u[en.proj];
    row.x = tick.x[en.proj];
    row.s_lane = tick.stp_lane[en.proj];
    float d = row.p.F > 0 ? row.drive(stage, b0, lanes, lane) : 0.0f;
    if (plan.coba) d = fabsf(d);
    acc = __fadd_rn(acc, d);
  }
  if (lane < lanes) *dst = acc;
}

}  // namespace

REPRO_EXPORT int plastic_drive_sizes(int* out) {
  out[0] = static_cast<int>(sizeof(DriveProj));
  out[1] = static_cast<int>(sizeof(DriveTarget));
  out[2] = static_cast<int>(sizeof(DrivePlan));
  out[3] = static_cast<int>(sizeof(DriveTick));
  out[4] = kMaxProjs;
  out[5] = kMaxLevels;
  return 0;
}

// plastic_drive_kernel's registers a thread and local memory a thread
// (bytes: its stack frame, spills included), as the runtime reports them
// for this library.
REPRO_EXPORT int plastic_drive_attributes(int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, plastic_drive_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  return 0;
}

// One tick (kernels/plastic_drive.py:DriveLauncher): `spikes` the [B, N]
// f32 spike rows, `tick` the weights and STP state.
REPRO_EXPORT int plastic_drive_run(const DrivePlan* plan, const void* spikes,
                                   const DriveTick* tick) {
  if (plan->n_targets <= 0 || plan->lanes <= 0) return 0;
  if (plan->lanes > 65535 || plan->n_projs > kMaxProjs || plan->group < 1 ||
      plan->group > kWindow) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned blocks = static_cast<unsigned>((plan->n_targets + kWarps - 1) / kWarps);
  const unsigned groups = static_cast<unsigned>((plan->lanes + plan->group - 1) / plan->group);
  plastic_drive_kernel<<<dim3(blocks, groups), kWarps * 32, 0,
                         static_cast<cudaStream_t>(plan->stream)>>>(
      *plan, static_cast<const float*>(spikes), *tick);
  return static_cast<int>(cudaGetLastError());
}
