// The whole Synfire tick in one launch for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_tick.py
// (fused_tick -> _tick_kernel, payload from assemble_kernel). One launch
// computes what kernels/ref.py:fused_tick_ref computes:
//
//   phase 1, per neuron: read ring slot t % L into i_syn and zero it; the
//     IZH4 update (common.cuh's izh4_tick, rounding pinned); the generator
//     override in the reference's order, v = is_gen ? c : v', u = is_gen ?
//     0 : u', spike = is_gen ? gen_row : spiked, each stored in the storage
//     type; the spike goes to `spikes` and, one bit per neuron, to the
//     run's bitmask scratch (`words`), and, where the run keeps in-run
//     monitors, into a SpikeCount's int32 count and a GroupRate's f32
//     filter level (common.cuh's rate_fold: the plain fold's rounding),
//     and, where the run keeps in-run watches, into a RateBand's int32
//     count and, once per warp (common.cuh's watch_mark: a warp vote and
//     a flag store), a Silent's and a NonFinite's per-lane flags of the
//     tick's local step, the membrane tested as stored; one thread per lane
//     folds the previous step's flags into the lane's words at the end
//     (watch_fold: plain loads and stores, no atomics);
//   phase 2, per post column: every bucket's drive in plan order into one
//     f32 accumulator per distinct delay, then one ring commit per delay in
//     ascending order, ring[(t+d) % L] = ring + store(acc), in the ring's
//     type (for fp16: round(float(r) + float(round(acc))), which is what
//     torch's half add gives on the CPU and the card).
//
// Layout: a cooperative grid of CTAs of kThreads threads, sized by the
// work (one CTA per kThreads neurons or per 16 CSR rows, whichever needs
// more: the 186-neuron mini runs on one CTA, Synfire4 sparse on 116) and
// capped at what the card can hold resident at once; the launcher picks
// the grid once per run, and a grid that cannot be resident makes the
// launch fail (the wrapper raises). Phase 1: each warp updates 32
// consecutive neurons and writes their spike word with __ballot_sync;
// every word has one owner and is overwritten every tick, so there are no
// atomics and no clearing pass. A grid-wide barrier
// (cooperative_groups::this_grid().sync(); __syncthreads() for a one-CTA
// grid) separates the phases. Phase 2: each CTA stages the bitmask (N/8
// bytes: 150 B at Synfire4, 15 KB at x100) in shared memory; (a) every CSR
// row's drive, one warp per row over the whole grid (two rows in flight
// per warp; lanes over k, four coalesced index loads in flight per lane
// and row, the bit tested in shared memory, the spiking entries' weights
// loaded together, a fixed shuffle tree) into the run's CSR-drive scratch (`cdrive`), then a second
// grid-wide barrier (only where there are CSR buckets); (b) one thread
// per post column adds the buckets covering it in plan order, a dense
// bucket by walking the set bits of its pre span in ascending p (the
// spiking rows only, eight weight loads in flight), a CSR bucket by
// reading its row's drive. Ring, v/u, weights and CSR tables stay in
// device memory. Limits, checked by the launcher before any tick:
// N <= kMaxN (262,144: the bitmask fits 32 KB of shared memory), at most
// kMaxDelays (4) distinct delays, at most kMaxBuckets (64) buckets, any
// ring length L, any P, Q, F.
//
// Order and rounding: no atomics. Spikes are 0 or 1, so a spiking pre adds
// its weight exactly (1 * w = w) and a silent one would add a signed
// zero: the sums start at +0.0 and are never -0.0, so skipping silent
// pres is bitwise neutral (weights finite), as the reference's event
// gating asserts. A dense drive adds its spiking rows in ascending p, as
// the plain version's product would with the silent rows left out; a CSR
// drive adds each lane's entries in ascending k, then the lanes in the
// shuffle tree's fixed order. With Synfire's exactly representable weight
// tables every sum is exact, so the result equals the plain version's bit for bit; with arbitrary
// weights it differs only by summation order. A CSR index follows the
// reference's jnp.take: one in [-N, -1] counts from the end of the spike
// row, any other outside [0, N) makes its row's drive NaN, so a corrupt
// table shows in the output.
//
// Lanes: the same launch also ticks B independent lanes of one net (a
// batched run, a LaneScheduler's chunk), lane b at its own ring slot
// (t0[b] + shift) % L, with its own v, u, ring, rows and, where the lanes
// do not share them, weights (a lane stride of 0 shares them). The grid
// stays the resident cooperative grid: it cannot grow by a lane
// dimension, since the grid-wide barrier needs every CTA resident. Each
// phase instead walks (lane, item) pairs, so a tick still has two grid
// barriers whatever B is. Each lane stages its own bitmask (150 B at
// Synfire4); where B of them exceed the 32 KB the kernel stages, lanes go
// through shared memory in groups. Every lane's sums are the one-lane
// launch's, in the same order, so a lane equals its solo run bit for bit.
//
// What bounds it: bytes. At Synfire4 size a tick must move about 0.1 MB
// (state, ring rows, the weight rows of the pres that spiked): latency
// and the barrier decide. At x100 sparse the CSR index tables (about 13.5
// M entries, 54 MB of int32) are read every tick, beyond the 50 MB L2; a
// storage-typed (int16/fp16) payload would halve that.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kCsrUnroll = 4;   // index loads in flight per lane of a CSR row
constexpr int kRowsInFlight = 2;  // CSR rows a warp works on at once
constexpr int kDenseBatch = 8;  // weight loads in flight per dense column walk
constexpr int kMaxDelays = 4;
constexpr int kMaxBuckets = 64;
constexpr int kDescInts = 8;  // kind, pre_start, post_start, p, q, f, kpos, offset
constexpr int kWordsBytes = 32 * 1024;  // shared memory for the staged bitmasks
constexpr int kMaxN = kWordsBytes * 8;  // one lane's bitmask in 32 KB

// Everything that stays fixed for a run; the Python launcher fills it once.
// Field order and types match kernels/fused_tick.py:_Plan.
struct TickPlan {
  void* v;            // [B, N] storage type, updated in place
  void* u;            // [B, N] storage type, updated in place
  void* ring;         // [B, L, N] storage type, updated in place
  const uint8_t* is_gen;  // [N] bool
  const float* a;
  const float* b;
  const float* c;
  const float* d;
  const int* desc;    // [n_buckets, kDescInts] in plan order
  const float* wd;    // dense images, concatenated [P, Q] row-major (per lane: wd_lane)
  const float* wc;    // CSR weight rows, concatenated [Q, F] (per lane: wc_lane)
  const int* ic;      // CSR global pre indices, laid out as wc, shared
  uint32_t* words;    // [B, ceil(N / 32)] scratch: the tick's spike bitmasks
  float* cdrive;      // [B, sum of the CSR buckets' Q] scratch: CSR row drives
  void* stream;
  const int* t0;      // [B] each lane's first tick mod L; null: one lane at slot `t`
  long long wd_lane, wc_lane;  // the weights' lane strides (0: shared)
  long long row_stride;  // lane stride of the gen/spike/record rows (entries)
  int delays[kMaxDelays];  // ascending
  int n;
  int ring_len;
  int n_buckets;
  int n_delays;
  int substeps;
  float h;
  int grid;           // CTAs, at most what the card holds resident
  int lanes;
  int group;          // lanes whose bitmasks are staged in shared memory at once
  int* tel_count;     // [B, N] int32 SpikeCount accumulator, or null
  float* tel_rate;    // [B, N] f32 GroupRate filter level, or null
  float tel_alpha;    // GroupRate: float32(dt / tau_ms)
  float tel_inst;     // GroupRate: float32(1000 / dt), a spike's rate
  int* w_count;       // [B, N] int32 RateBand watch counts, or null
  int* w_silent;      // [B, 4] int32 Silent watch words {last, gap, flags}, or null
  int* w_bad;         // [B, 4] int32 NonFinite watch words {ticks, 0, flags}, or null
};

namespace {

__device__ __forceinline__ bool spiked(const uint32_t* words, int j) {
  return (words[j >> 5] >> (j & 31)) & 1u;
}

__device__ __forceinline__ void grid_sync() {
  if (gridDim.x > 1) {
    cg::this_grid().sync();
  } else {
    __syncthreads();
  }
}

// Lane `lane`'s ring slot at `shift`.
__device__ __forceinline__ int lane_slot(const TickPlan& P, int lane, int shift) {
  return P.t0 ? (P.t0[lane] + shift) % P.ring_len : shift;
}

// Stage the bitmasks of lanes [l0, l1) in shared memory (all threads).
__device__ __forceinline__ void stage_words(const TickPlan& P, uint32_t* s_words, int n_words,
                                            int l0, int l1) {
  __syncthreads();  // the previous group's readers are done
  const int total = (l1 - l0) * n_words;
  const uint32_t* src = P.words + static_cast<size_t>(l0) * n_words;
  for (int i = threadIdx.x; i < total; i += kThreads) s_words[i] = src[i];
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_tick_kernel(const TickPlan P, const int t, const int step, const uint8_t* gen_row,
                  uint8_t* spikes, float* v_rec, float* isyn_rec) {
  extern __shared__ uint32_t s_words[];  // [group, ceil(n / 32)]
  __shared__ int s_desc[kMaxBuckets * kDescInts];
  // Each CSR bucket's first row in cdrive; [kMaxBuckets] holds their total.
  __shared__ int s_cbase[kMaxBuckets + 1];
  const int n = P.n;
  const int n_words = (n + 31) >> 5;
  const int lane_id = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < P.n_buckets * kDescInts; i += kThreads) {
    s_desc[i] = P.desc[i];
  }
  if (threadIdx.x == 0) {
    int base = 0;
    for (int bi = 0; bi < P.n_buckets; ++bi) {
      s_cbase[bi] = base;
      if (P.desc[bi * kDescInts] == 1) base += P.desc[bi * kDescInts + 4];
    }
    s_cbase[kMaxBuckets] = base;
  }
  T* const ring0 = static_cast<T*>(P.ring);
  const size_t lane_ring = static_cast<size_t>(P.ring_len) * n;
  // The watches' words of lane `gt` (one thread per lane), loaded now and
  // folded at the end, so their latency overlaps the tick.
  const int gt = blockIdx.x * kThreads + threadIdx.x;
  const WatchWords ws0 =
      gt < P.lanes && P.w_silent != nullptr ? watch_load(P.w_silent + 4 * gt, step)
                                            : WatchWords();
  const WatchWords wb0 =
      gt < P.lanes && P.w_bad != nullptr ? watch_load(P.w_bad + 4 * gt, step) : WatchWords();

  // Phase 1: delivery, neurons, generators; one warp per 32 neurons of a lane.
  for (int wi = blockIdx.x * kWarps + warp; wi < P.lanes * n_words;
       wi += gridDim.x * kWarps) {
    const int ln = wi / n_words;
    const int w = wi - ln * n_words;
    const int i = (w << 5) + lane_id;
    bool s = false;
    bool nonfinite = false;
    if (i < n) {
      const size_t at = static_cast<size_t>(ln) * n + i;
      const size_t row = static_cast<size_t>(ln) * P.row_stride + i;
      T* slot = ring0 + ln * lane_ring + static_cast<size_t>(lane_slot(P, ln, t)) * n;
      T* vv = static_cast<T*>(P.v);
      T* uu = static_cast<T*>(P.u);
      const float cur = to_f32(slot[i]);
      slot[i] = from_f32<T>(0.0f);
      float v = to_f32(vv[at]);
      float u = to_f32(uu[at]);
      // The accumulators are loaded early: their latency overlaps the update's.
      const float level = P.tel_rate != nullptr ? P.tel_rate[at] : 0.0f;
      const int count0 = P.tel_count != nullptr ? P.tel_count[at] : 0;
      const int wcount0 = P.w_count != nullptr ? P.w_count[at] : 0;
      const float c = P.c[i];
      const bool spk = izh4_tick(v, u, cur, P.a[i], P.b[i], c, P.d[i], P.h, P.substeps);
      const bool gen = P.is_gen[i] != 0;
      const T vs = gen ? from_f32<T>(c) : from_f32<T>(v);
      const T us = gen ? from_f32<T>(0.0f) : from_f32<T>(u);
      s = gen ? gen_row[row] != 0 : spk;
      nonfinite = !stored_finite(vs);
      vv[at] = vs;
      uu[at] = us;
      spikes[row] = s ? 1 : 0;  // may alias gen_row: the same thread read it above
      if (P.tel_count != nullptr && s) P.tel_count[at] = count0 + 1;
      if (P.tel_rate != nullptr) {
        P.tel_rate[at] = rate_fold(level, s, P.tel_alpha, P.tel_inst);
      }
      if (v_rec != nullptr) v_rec[row] = to_f32(vs);
      if (isyn_rec != nullptr) isyn_rec[row] = cur;
      if (P.w_count != nullptr && s) P.w_count[at] = wcount0 + 1;
    }
    const uint32_t word = __ballot_sync(0xffffffffu, s);
    if (lane_id == 0) P.words[wi] = word;
    if (P.w_silent != nullptr || P.w_bad != nullptr) {  // the in-run watches' marks
      watch_mark(P.w_silent != nullptr ? P.w_silent + 4 * ln : nullptr,
                 P.w_bad != nullptr ? P.w_bad + 4 * ln : nullptr, s, nonfinite, step);
    }
  }
  grid_sync();

  // Phase 2a: every CSR row's drive, one warp per (lane, row) over the
  // whole grid, into cdrive (lane by lane; in a lane, bucket by bucket,
  // row by row). A warp keeps kRowsInFlight rows in flight (rows R and
  // R + all warps), so their loads overlap; each row still sums its
  // lanes' entries in ascending k, then the lanes in the fixed shuffle
  // tree.
  const int n_csr = s_cbase[kMaxBuckets];
  if (n_csr > 0) {
    const int all_warps = gridDim.x * kWarps;
    for (int l0 = 0; l0 < P.lanes; l0 += P.group) {
      const int l1 = min(l0 + P.group, P.lanes);
      stage_words(P, s_words, n_words, l0, l1);
      const int first = l0 * n_csr;
      const int last = l1 * n_csr;
      for (int base = first + blockIdx.x * kWarps + warp; base < last;
           base += kRowsInFlight * all_warps) {
        const int* idx[kRowsInFlight];
        const float* wrow[kRowsInFlight];
        const uint32_t* bits[kRowsInFlight];
        int f[kRowsInFlight];
        float acc[kRowsInFlight];
        int f_max = 0;
#pragma unroll
        for (int r = 0; r < kRowsInFlight; ++r) {
          const int row_id = base + r * all_warps;
          acc[r] = 0.0f;
          f[r] = 0;
          idx[r] = P.ic;
          wrow[r] = P.wc;
          bits[r] = s_words;
          if (row_id < last) {
            const int ln = row_id / n_csr;
            const int rr = row_id - ln * n_csr;
            int bi = 0;
            while (s_desc[bi * kDescInts] != 1 ||
                   rr >= s_cbase[bi] + s_desc[bi * kDescInts + 4]) {
              ++bi;
            }
            const int* dsc = s_desc + bi * kDescInts;
            f[r] = dsc[5];
            const size_t row = static_cast<size_t>(dsc[7]) +
                               static_cast<size_t>(rr - s_cbase[bi]) * f[r];
            idx[r] = P.ic + row;
            wrow[r] = P.wc + static_cast<size_t>(ln) * P.wc_lane + row;
            bits[r] = s_words + static_cast<size_t>(ln - l0) * n_words;
            f_max = max(f_max, f[r]);
          }
        }
        for (int k0 = lane_id; k0 < f_max; k0 += 32 * kCsrUnroll) {
          // All index loads first, then the spiking entries' weights, then
          // the adds in ascending k (a silent entry adds +0.0: neutral).
          int j[kRowsInFlight][kCsrUnroll];
          float wv[kRowsInFlight][kCsrUnroll];
#pragma unroll
          for (int r = 0; r < kRowsInFlight; ++r) {
#pragma unroll
            for (int u = 0; u < kCsrUnroll; ++u) {
              const int k = k0 + 32 * u;
              const int jj = k < f[r] ? idx[r][k] : 0;
              j[r][u] = jj < 0 ? jj + n : jj;  // [-N, -1] counts from the row's end
            }
          }
#pragma unroll
          for (int r = 0; r < kRowsInFlight; ++r) {
#pragma unroll
            for (int u = 0; u < kCsrUnroll; ++u) {
              const int k = k0 + 32 * u;
              const bool valid = j[r][u] >= 0 && j[r][u] < n;
              wv[r][u] = k >= f[r] ? 0.0f
                         : !valid ? __int_as_float(0x7fc00000)  // a corrupt table shows as NaN
                         : spiked(bits[r], j[r][u]) ? wrow[r][k] : 0.0f;
            }
          }
#pragma unroll
          for (int r = 0; r < kRowsInFlight; ++r) {
#pragma unroll
            for (int u = 0; u < kCsrUnroll; ++u) acc[r] = __fadd_rn(acc[r], wv[r][u]);
          }
        }
#pragma unroll
        for (int r = 0; r < kRowsInFlight; ++r) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            acc[r] = __fadd_rn(acc[r], __shfl_down_sync(0xffffffffu, acc[r], off));
          }
          const int row_id = base + r * all_warps;
          if (lane_id == 0 && row_id < last) P.cdrive[row_id] = acc[r];
        }
      }
    }
    grid_sync();
  }

  // Phase 2b: one thread per (lane, post column) adds the buckets covering
  // it in plan order and commits the lane's ring.
  for (int l0 = 0; l0 < P.lanes; l0 += P.group) {
    const int l1 = min(l0 + P.group, P.lanes);
    stage_words(P, s_words, n_words, l0, l1);
    const int last = l1 * n;
    for (int qg = l0 * n + blockIdx.x * kThreads + threadIdx.x; qg < last;
         qg += gridDim.x * kThreads) {
      const int ln = qg / n;
      const int q = qg - ln * n;
      const uint32_t* bits = s_words + static_cast<size_t>(ln - l0) * n_words;
      const float* wd = P.wd + static_cast<size_t>(ln) * P.wd_lane;
      const float* cdrive = P.cdrive + static_cast<size_t>(ln) * n_csr;
      float acc[kMaxDelays];
#pragma unroll
      for (int k = 0; k < kMaxDelays; ++k) acc[k] = 0.0f;
      for (int bi = 0; bi < P.n_buckets; ++bi) {
        const int* dsc = s_desc + bi * kDescInts;
        const int col = q - dsc[2];
        const int qn = dsc[4];
        if (col < 0 || col >= qn) continue;
        float drive = 0.0f;
        if (dsc[0] == 0) {  // dense [P, Q] image, pre span [ps, pe)
          const int ps = dsc[1];
          const int pe = ps + dsc[3];
          const float* w = wd + dsc[7] + col;
          if (pe > ps) {
            const int w0 = ps >> 5;
            const int w1 = (pe - 1) >> 5;
            for (int wi = w0; wi <= w1; ++wi) {
              uint32_t m = bits[wi];
              if (wi == w0) m &= 0xffffffffu << (ps & 31);
              if (wi == w1) m &= 0xffffffffu >> (31 - ((pe - 1) & 31));
              while (m != 0u) {  // the spiking rows, ascending, kDenseBatch loads at once
                float wv[kDenseBatch];
                int cnt = 0;
#pragma unroll
                for (int u = 0; u < kDenseBatch; ++u) {
                  if (m != 0u) {
                    const int p = (wi << 5) + __ffs(m) - 1 - ps;
                    m &= m - 1u;
                    wv[u] = w[static_cast<size_t>(p) * qn];
                    cnt = u + 1;
                  }
                }
#pragma unroll
                for (int u = 0; u < kDenseBatch; ++u) {
                  if (u < cnt) drive = __fadd_rn(drive, wv[u]);
                }
              }
            }
          }
        } else {
          drive = cdrive[s_cbase[bi] + col];
        }
        const int kpos = dsc[6];
#pragma unroll
        for (int k = 0; k < kMaxDelays; ++k) {
          if (k == kpos) acc[k] = __fadd_rn(acc[k], drive);
        }
      }
      T* ring = ring0 + ln * lane_ring;
      const int t_lane = lane_slot(P, ln, t);
#pragma unroll
      for (int k = 0; k < kMaxDelays; ++k) {
        if (k < P.n_delays) {
          int s = t_lane + P.delays[k];
          if (s >= P.ring_len) s -= P.ring_len;
          T* r = ring + static_cast<size_t>(s) * n + q;
          *r = from_f32<T>(__fadd_rn(to_f32(*r), to_f32(from_f32<T>(acc[k]))));
        }
      }
    }
  }

  // The watches' fold of the previous step's flags, one thread per lane
  // (lanes past the grid's threads load theirs here).
  for (int ln = gt; ln < P.lanes; ln += gridDim.x * kThreads) {
    int* const w_s = P.w_silent != nullptr ? P.w_silent + 4 * ln : nullptr;
    int* const w_b = P.w_bad != nullptr ? P.w_bad + 4 * ln : nullptr;
    watch_fold(w_s, step, ln == gt ? ws0 : watch_load(w_s, step), true);
    watch_fold(w_b, step, ln == gt ? wb0 : watch_load(w_b, step), false);
  }
}

size_t words_bytes(int n, int group) {
  return static_cast<size_t>(group) * ((n + 31) / 32) * sizeof(uint32_t);
}

template <typename T>
int launch(const TickPlan* plan, int t, int step, const void* gen_row, void* spikes,
           void* v_rec, void* isyn_rec) {
  if (plan->n <= 0) return 0;
  if (plan->n > kMaxN || plan->n_buckets > kMaxBuckets || plan->n_delays > kMaxDelays ||
      plan->grid < 1 || t < 0 || t >= plan->ring_len || plan->lanes < 1 || plan->group < 1 ||
      words_bytes(plan->n, plan->group) > kWordsBytes ||
      static_cast<long long>(plan->lanes) * ((plan->n + 31) / 32) > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int tt = t;
  int ss = step;
  const uint8_t* g = static_cast<const uint8_t*>(gen_row);
  uint8_t* sp = static_cast<uint8_t*>(spikes);
  float* vr = static_cast<float*>(v_rec);
  float* ir = static_cast<float*>(isyn_rec);
  void* args[] = {const_cast<TickPlan*>(plan), &tt, &ss, &g, &sp, &vr, &ir};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(fused_tick_kernel<T>), dim3(plan->grid), dim3(kThreads),
      args, words_bytes(plan->n, plan->group), static_cast<cudaStream_t>(plan->stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// `reps` grid-wide barriers and nothing else: the barrier's cost at a grid.
__global__ void __launch_bounds__(kThreads) barrier_probe_kernel(int reps) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < reps; ++i) grid.sync();
}

}  // namespace

REPRO_EXPORT int fused_tick_limits(int* out) {
  out[5] = kWordsBytes;
  out[0] = kMaxN;
  out[1] = kMaxDelays;
  out[2] = kMaxBuckets;
  out[3] = static_cast<int>(sizeof(TickPlan));
  out[4] = kThreads;
  return 0;
}

// The kernel's resident CTAs per SM at N neurons with `group` lanes'
// bitmasks staged (storage type `code`: 0 f32, 1 fp16, 2 bf16), the
// device's SM count, and whether it takes cooperative launches.
REPRO_EXPORT int fused_tick_occupancy(int code, int n, int group, int* out) {
  int per_sm = 0, dev = 0, sms = 0, coop = 0;
  const size_t smem = words_bytes(n, group);
  cudaError_t err =
      code == 1   ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                        &per_sm, fused_tick_kernel<__half>, kThreads, smem)
      : code == 2 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                        &per_sm, fused_tick_kernel<__nv_bfloat16>, kThreads, smem)
                  : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                        &per_sm, fused_tick_kernel<float>, kThreads, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  out[0] = per_sm;
  out[1] = sms;
  out[2] = coop;
  return static_cast<int>(err);
}

REPRO_EXPORT int fused_tick_barrier_probe(int grid, int reps, void* stream) {
  void* args[] = {&reps};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(barrier_probe_kernel), dim3(grid), dim3(kThreads), args, 0,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

#define REPRO_FUSED(NAME, T)                                                       \
  REPRO_EXPORT int NAME(const TickPlan* plan, int t, int step, const void* gen_row,\
                        void* spikes, void* v_rec, void* isyn_rec) {               \
    return launch<T>(plan, t, step, gen_row, spikes, v_rec, isyn_rec);             \
  }

REPRO_FUSED(fused_tick_f32, float)
REPRO_FUSED(fused_tick_f16, __half)
REPRO_FUSED(fused_tick_bf16, __nv_bfloat16)
