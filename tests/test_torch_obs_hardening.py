"""Hardening tests for the port's observability primitives
(``repro_torch.obs``), mirroring ``tests/test_obs_hardening.py``:

* **Histogram quantile properties** (hypothesis) — the quantile estimate
  the health checks and bench artifacts stand on must behave at the
  edges: empty family → None, single sample → in-bucket interpolation,
  all-overflow → last finite edge, monotone in q, bounded by the edge
  set, and label-merged quantiles ≡ single-series quantiles over the
  same samples. Plus the non-finite regression this PR fixed:
  ``observe(nan)`` used to land in the SMALLEST bucket (bisect on NaN)
  and poison the running sum forever; it now files under overflow and
  leaves the sum finite.
* **Tracer thread safety** — concurrent span stacks are per-thread,
  the ring + ``dropped`` accounting is lock-protected; hammering one
  tracer from many threads must conserve events (retained + dropped ==
  emitted), keep tids stable per thread, and never corrupt an event.

And the port's quantiles equal the reference's on the same samples.
"""
import math
import threading

import pytest

from repro.obs.metrics import Histogram as RefHistogram
from repro_torch.obs.metrics import Histogram
from repro_torch.obs.trace import Tracer

# ---------------------------------------------------------------------------
# Histogram.quantile — deterministic edges (run even without hypothesis)
# ---------------------------------------------------------------------------

EDGES = (1.0, 5.0, 10.0, 50.0)


class TestQuantileEdges:
    def test_empty_family_is_none(self):
        h = Histogram("h", buckets=EDGES)
        assert h.quantile(0.5) is None
        assert h.quantile(0.0) is None
        assert h.quantile(1.0) is None

    def test_empty_labeled_series_is_none(self):
        h = Histogram("h", buckets=EDGES)
        h.observe(2.0, rung="a")
        assert h.quantile(0.5, labels={"rung": "b"}) is None

    def test_single_sample_interpolates_within_landing_bucket(self):
        h = Histogram("h", buckets=EDGES)
        h.observe(3.0)  # lands in (1, 5]
        assert h.quantile(0.0) == pytest.approx(1.0)
        assert h.quantile(0.5) == pytest.approx(3.0)  # 1 + (5-1)*0.5
        assert h.quantile(1.0) == pytest.approx(5.0)

    def test_single_sample_first_bucket_interpolates_from_zero(self):
        h = Histogram("h", buckets=EDGES)
        h.observe(0.5)
        assert h.quantile(0.5) == pytest.approx(0.5)  # 0 + (1-0)*0.5

    def test_all_overflow_reports_last_finite_edge(self):
        h = Histogram("h", buckets=EDGES)
        for _ in range(5):
            h.observe(1e9)
        assert h.quantile(0.01) == EDGES[-1]
        assert h.quantile(0.99) == EDGES[-1]

    def test_q_out_of_range_raises(self):
        h = Histogram("h", buckets=EDGES)
        with pytest.raises(ValueError):
            h.quantile(-0.1)
        with pytest.raises(ValueError):
            h.quantile(1.1)

    def test_nan_observation_lands_in_overflow_not_smallest(self):
        # Regression: bisect_left on NaN returns 0, which filed NaN under
        # the smallest bucket and drove sum (hence mean exports) to NaN.
        h = Histogram("h", buckets=EDGES)
        h.observe(float("nan"))
        h.observe(float("inf"))
        h.observe(float("-inf"))
        s = h._series_map()[()]
        assert s[0][0] == 0  # nothing in the smallest bucket
        assert s[0][-1] == 3  # all three in overflow
        assert h.count() == 3
        assert math.isfinite(h.sum())
        assert h.quantile(0.5) == EDGES[-1]

    def test_nan_does_not_poison_later_samples(self):
        h = Histogram("h", buckets=EDGES)
        h.observe(float("nan"))
        h.observe(3.0)
        assert h.sum() == pytest.approx(3.0)
        # one real sample + one overflow: p25 is inside the real bucket
        assert h.quantile(0.25) <= EDGES[-1]


# ---------------------------------------------------------------------------
# Histogram.quantile — hypothesis properties
# ---------------------------------------------------------------------------

try:
    from hypothesis import given, settings, strategies as st
    _HAS_HYPOTHESIS = True
except ImportError:  # the deterministic edges above still run
    _HAS_HYPOTHESIS = False

if _HAS_HYPOTHESIS:

    samples = st.lists(
        st.floats(min_value=0.0, max_value=200.0,
                  allow_nan=False, allow_infinity=False),
        min_size=0, max_size=60)

    class TestQuantileProperties:
        @given(xs=samples, q=st.floats(min_value=0.0, max_value=1.0))
        @settings(max_examples=120, deadline=None)
        def test_bounded_by_edges(self, xs, q):
            h = Histogram("h", buckets=EDGES)
            for x in xs:
                h.observe(x)
            p = h.quantile(q)
            if not xs:
                assert p is None
            else:
                assert 0.0 <= p <= EDGES[-1]

        @given(xs=samples,
               q1=st.floats(min_value=0.0, max_value=1.0),
               q2=st.floats(min_value=0.0, max_value=1.0))
        @settings(max_examples=120, deadline=None)
        def test_monotone_in_q(self, xs, q1, q2):
            h = Histogram("h", buckets=EDGES)
            for x in xs:
                h.observe(x)
            if not xs:
                return
            lo, hi = sorted((q1, q2))
            assert h.quantile(lo) <= h.quantile(hi) + 1e-12

        @given(xs=st.lists(st.floats(min_value=0.0, max_value=200.0,
                                     allow_nan=False, allow_infinity=False),
                           min_size=1, max_size=40),
               q=st.floats(min_value=0.0, max_value=1.0))
        @settings(max_examples=80, deadline=None)
        def test_label_merge_equals_single_series(self, xs, q):
            # Fleet-wide (labels=None) quantile over samples scattered
            # across label series == the same samples in one series.
            merged = Histogram("m", buckets=EDGES)
            single = Histogram("s", buckets=EDGES)
            for i, x in enumerate(xs):
                merged.observe(x, rung=f"r{i % 3}")
                single.observe(x)
            assert merged.quantile(q) == pytest.approx(
                single.quantile(q, labels={}))

        @given(xs=st.lists(st.floats(min_value=0.0, max_value=200.0,
                                     allow_nan=False, allow_infinity=False),
                           min_size=1, max_size=40))
        @settings(max_examples=80, deadline=None)
        def test_count_sum_conserved(self, xs):
            h = Histogram("h", buckets=EDGES)
            for x in xs:
                h.observe(x)
            assert h.count() == len(xs)
            assert h.sum() == pytest.approx(sum(xs))
            s = h._series_map()[()]
            assert sum(s[0]) == len(xs)  # every sample in exactly 1 bucket

        @given(xs=st.lists(st.floats(allow_nan=True, allow_infinity=True,
                                     width=32), min_size=0, max_size=40),
               q=st.floats(min_value=0.0, max_value=1.0))
        @settings(max_examples=80, deadline=None)
        def test_equals_reference_histogram(self, xs, q):
            # The port's histogram is the reference's, sample for sample:
            # the same buckets, sums and quantile estimates.
            mine, ref = Histogram("h", buckets=EDGES), RefHistogram("h", buckets=EDGES)
            for i, x in enumerate(xs):
                mine.observe(x, rung=f"r{i % 2}")
                ref.observe(x, rung=f"r{i % 2}")
            assert mine.series() == ref.series()
            assert mine.quantile(q) == ref.quantile(q)


# ---------------------------------------------------------------------------
# Tracer thread safety
# ---------------------------------------------------------------------------

class TestTracerThreadSafety:
    N_THREADS = 8
    PER_THREAD = 300  # 8*300*2 events >> capacity: overflow is exercised

    def _hammer(self, tracer, barrier, tids_seen, idx):
        barrier.wait()
        for i in range(self.PER_THREAD):
            with tracer.span("step_chunk", thread=idx, i=i):
                tracer.event("flush", thread=idx, i=i)
        # tid must be stable across calls within one thread
        tids_seen[idx] = {tracer._tid() for _ in range(4)}

    def test_ring_conserves_events_under_contention(self):
        tracer = Tracer(capacity=256)
        barrier = threading.Barrier(self.N_THREADS)
        tids_seen = [None] * self.N_THREADS
        threads = [threading.Thread(target=self._hammer,
                                    args=(tracer, barrier, tids_seen, i))
                   for i in range(self.N_THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

        emitted = self.N_THREADS * self.PER_THREAD * 2  # span + instant
        assert len(tracer) == 256  # ring is full
        assert len(tracer) + tracer.dropped == emitted

        # per-thread tids: stable within a thread, distinct across threads
        assert all(len(s) == 1 for s in tids_seen)
        tids = {s.pop() for s in tids_seen}
        assert len(tids) == self.N_THREADS

        events = tracer.snapshot()
        assert len(events) == 256
        for e in events:
            assert e.ph in ("X", "i")
            assert e.ts_us >= 0.0
            assert e.dur_us >= 0.0
            assert e.depth >= 0
            assert e.tid in tids
            # the instant sits inside its span: depth 1 under depth 0
            assert e.depth == (1 if e.ph == "i" else 0)

    def test_span_stacks_are_per_thread(self):
        tracer = Tracer(capacity=4096)
        depths = {}

        def nested(idx):
            with tracer.span("outer", t=idx):
                with tracer.span("inner", t=idx):
                    depths[idx] = len(tracer._stack())

        threads = [threading.Thread(target=nested, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        # each thread saw ONLY its own two frames, never a neighbour's
        assert set(depths.values()) == {2}
        for e in tracer.snapshot():
            assert e.depth in (0, 1)

    def test_dropped_resets_with_clear(self):
        tracer = Tracer(capacity=2)
        for i in range(5):
            tracer.event("flush", i=i)
        assert len(tracer) == 2 and tracer.dropped == 3
        tracer.clear()
        assert len(tracer) == 0 and tracer.dropped == 0
