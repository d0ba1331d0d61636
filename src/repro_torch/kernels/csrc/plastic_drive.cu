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
// from +0.0. A thread streams its row's products through one accumulator
// per level of that tree, so the card's drive equals the CPU port's, and
// the reference's, bit for bit. Every product and add is __fmul_rn /
// __fadd_rn; an STP row's u * x rounds to the state's storage type first,
// as torch's half multiply does.
//
// Layout: one thread per (accumulator entry, lane); an entry is one post
// column of one (delay, channel) accumulator, and lists the (projection,
// row) pairs landing there in projection order, so two projections on one
// column add in order without atomics. The weights, STP state and their
// lane strides arrive with every launch (DriveTick, by value): DA-STDP,
// homeostasis and the STP update make new tensors every tick.
//
// What bounds it: launch latency, then a latency chain. A plastic Synfire4
// tick reads four chain projections' fan-in rows (about 80 entries each
// over 200 rows: 64,000 weights, indices and flat rows, about 0.6 MB at
// fp16 with int32 tables) and each thread walks its row serially (F adds):
// about 0.2 us at 3.35 TB/s, and a few hundred dependent adds per thread.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxProjs = 32;
constexpr int kMaxLevels = 7;  // windows of 32: F up to 32^7
constexpr int kWindow = 32;

// One projection (kernels/plastic_drive.py:_Proj, field for field).
struct DriveProj {
  const int* pre;  // [Q, F] ids into the pre row
  const int* rows;  // [Q, F] flat ids into the dense [P, Q] weight; null: CSR [Q, F]
  int Q, F;
  int stp;  // 1: pre ids are local, the pre row scaled by u * x
  int pre_start, n_pre;  // STP: the pre group in the spike row
  int wtype, stype;  // weight and STP state storage types: 0 f32, 1 fp16
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
  return type ? __half2float(static_cast<const __half*>(p)[i]) : static_cast<const float*>(p)[i];
}

// A row sum in XLA CPU's window order, fed one product at a time.
struct XlaSum {
  float acc[kMaxLevels + 1];
  int cur[kMaxLevels];
  int levels;
  const int* off;

  __device__ __forceinline__ void init(const DriveProj& p) {
    levels = p.levels;
    off = p.off;
    for (int i = 0; i <= kMaxLevels; ++i) acc[i] = 0.0f;
    for (int i = 0; i < kMaxLevels; ++i) cur[i] = -1;
  }

  // Item `idx` of level `i` (a product at level 0, a window sum above).
  __device__ __forceinline__ void push(int i, float v, int idx) {
    while (i < levels) {
      const int w = (idx + off[i]) / kWindow;
      if (cur[i] == w) {
        acc[i] = __fadd_rn(acc[i], v);
        return;
      }
      const float done = acc[i];
      const int done_at = cur[i];
      cur[i] = w;
      acc[i] = __fadd_rn(0.0f, v);
      if (done_at < 0) return;
      v = done;  // the finished window goes up a level, in order
      idx = done_at;
      ++i;
    }
    acc[levels] = __fadd_rn(acc[levels], v);
  }

  __device__ __forceinline__ float finish() {
    for (int i = 0; i < levels; ++i) {
      if (cur[i] >= 0) {
        const float done = acc[i];
        const int at = cur[i];
        cur[i] = -1;
        push(i + 1, done, at);
      }
    }
    return acc[levels];
  }
};

__global__ void __launch_bounds__(kThreads)
    plastic_drive_kernel(DrivePlan plan, const float* __restrict__ spikes, DriveTick tick) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= plan.n_targets) return;
  const long long lane = blockIdx.y;
  const float* row = spikes + lane * plan.n;
  const DriveTarget tg = plan.targets[t];
  float* dst = tg.dst + lane * tg.lane_stride;
  float acc = *dst;
  for (int e = tg.begin; e < tg.end; ++e) {
    const DriveEntry en = plan.entries[e];
    const DriveProj& p = plan.projs[en.proj];
    const void* w = tick.w[en.proj];
    const long long w0 = lane * tick.w_lane[en.proj];
    const long long s0 = lane * tick.stp_lane[en.proj];
    const void* u = tick.u[en.proj];
    const void* x = tick.x[en.proj];
    const long long base = static_cast<long long>(en.q) * p.F;
    XlaSum sum;
    sum.init(p);
    for (int k = 0; k < p.F; ++k) {
      const int j = __ldg(p.pre + base + k);
      float g;
      if (p.stp) {
        float ux = __fmul_rn(load(u, s0 + j, p.stype), load(x, s0 + j, p.stype));
        if (p.stype) ux = __half2float(__float2half_rn(ux));
        g = __fmul_rn(__ldg(row + p.pre_start + j), ux);
      } else {
        g = j == plan.n ? 0.0f : __ldg(row + j);
      }
      float wv;
      if (p.rows) {
        const int r = __ldg(p.rows + base + k);
        wv = r == p.sentinel ? 0.0f : load(w, w0 + r, p.wtype);
      } else {
        wv = load(w, w0 + base + k, p.wtype);
      }
      sum.push(0, __fmul_rn(g, wv), k);
    }
    float d = sum.finish();
    if (plan.coba) d = fabsf(d);
    acc = __fadd_rn(acc, d);
  }
  *dst = acc;
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

// One tick (kernels/plastic_drive.py:DriveLauncher): `spikes` the [B, N]
// f32 spike rows, `tick` the weights and STP state.
REPRO_EXPORT int plastic_drive_run(const DrivePlan* plan, const void* spikes,
                                   const DriveTick* tick) {
  if (plan->n_targets <= 0 || plan->lanes <= 0) return 0;
  if (plan->lanes > 65535 || plan->n_projs > kMaxProjs) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned blocks = static_cast<unsigned>((plan->n_targets + kThreads - 1) / kThreads);
  plastic_drive_kernel<<<dim3(blocks, static_cast<unsigned>(plan->lanes)), kThreads, 0,
                         static_cast<cudaStream_t>(plan->stream)>>>(
      *plan, static_cast<const float*>(spikes), *tick);
  return static_cast<int>(cudaGetLastError());
}
