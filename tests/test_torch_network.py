"""The port's compile against the reference's, table for table: bucket
plans field for field, and weights, masks, CSR index tables, neuron
parameters, generator tables and initial state bit for bit with their
dtypes, plus the memory ledger's bytes per stage."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import synfire4 as rsyn  # noqa: E402
from repro.core import network as rnet  # noqa: E402
from repro.obs import watch as rwatch  # noqa: E402
from repro.telemetry import monitors as rtel  # noqa: E402
from repro_torch.configs import synfire4 as tsyn  # noqa: E402
from repro_torch.core import COBAConfig, NetworkBuilder, izh4  # noqa: E402
from repro_torch.core.plasticity import HomeostasisConfig, STDPConfig  # noqa: E402
from repro_torch.core.synapses import STPConfig  # noqa: E402
from repro_torch.core import network as tnet  # noqa: E402
from repro_torch.core import partition as tpart  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tensors are tiny: one intra-op thread keeps PyTorch's thread
    pool from spinning against the other test workers' cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def assert_same(t, ref, what):
    """A port tensor equals a reference array bit for bit, dtype included."""
    ref = np.asarray(ref)
    assert str(t.dtype).removeprefix("torch.") == str(ref.dtype), (
        f"{what}: dtype {t.dtype} vs {ref.dtype}")
    got = t.cpu()
    if got.dtype == torch.bfloat16:
        got = got.float()
    np.testing.assert_array_equal(got.numpy(), ref, err_msg=what)


def build_both(cfg_name, policy, propagation):
    ref = rsyn.build_synfire(getattr(rsyn, cfg_name), policy=policy,
                             propagation=propagation)
    port = tsyn.build_synfire(getattr(tsyn, cfg_name), policy=policy,
                              propagation=propagation, device="cpu")
    return ref, port


def assert_same_fields(port_obj, ref_obj, what):
    for f in dataclasses.fields(port_obj):
        assert getattr(port_obj, f.name) == getattr(ref_obj, f.name), (
            f"{what}.{f.name}: {getattr(port_obj, f.name)!r} vs "
            f"{getattr(ref_obj, f.name)!r}")


def assert_same_network(ref, port):
    rs, ps = ref.static, port.static
    for f in ("n", "ring_len", "dt", "substeps", "method", "policy_name",
              "propagation", "izh4_only", "gen_spans", "n_gen", "csr_projs"):
        assert getattr(ps, f) == getattr(rs, f), f
    assert len(ps.groups) == len(rs.groups)
    for pg, rg in zip(ps.groups, rs.groups):
        assert_same_fields(pg, rg, f"group {rg.name}")
    assert len(ps.projections) == len(rs.projections)
    for pp, rp in zip(ps.projections, rs.projections):
        assert_same_fields(pp, rp, f"projection {rp.name}")
    assert len(ps.buckets) == len(rs.buckets)
    for bi, (pb, rb) in enumerate(zip(ps.buckets, rs.buckets)):
        assert_same_fields(pb, rb, f"bucket {bi}")

    pp, rp = port.params, ref.params
    for f in pp.neuron._fields:
        assert_same(getattr(pp.neuron, f), getattr(rp.neuron, f), f"neuron.{f}")
    assert [m is None for m in pp.masks] == [m is None for m in rp.masks]
    for j, (pm, rm) in enumerate(zip(pp.masks, rp.masks)):
        if pm is not None:
            assert_same(pm, rm, f"masks.{j}")
    for f in ("gen_rate", "gen_until", "gen_rate_after"):
        assert_same(getattr(pp, f), getattr(rp, f), f)
    for bi in range(len(ps.buckets)):
        assert_same(pp.bucket_pre_ids[bi], rp.bucket_pre_ids[bi], f"pre_ids.{bi}")
        assert_same(pp.bucket_post_ids[bi], rp.bucket_post_ids[bi], f"post_ids.{bi}")
        if rp.bucket_csr_idx[bi] is None:
            assert pp.bucket_csr_idx[bi] is None
        else:
            assert_same(pp.bucket_csr_idx[bi], rp.bucket_csr_idx[bi], f"csr_idx.{bi}")

    p0, r0 = port.state0, ref.state0
    assert p0.t == int(r0.t) == 0
    assert p0.key.dtype == torch.int32
    np.testing.assert_array_equal(p0.key.cpu().numpy().view(np.uint32),
                                  np.asarray(jax.random.key_data(r0.key)))
    for f in ("v", "u", "refrac"):
        assert_same(getattr(p0.neurons, f), getattr(r0.neurons, f), f"neurons.{f}")
    assert_same(p0.ring, r0.ring, "ring")
    assert len(p0.weights) == len(r0.weights)
    for j, (pw, rw) in enumerate(zip(p0.weights, r0.weights)):
        assert_same(pw, rw, f"weights.{j}")

    assert port.ledger.stage_bytes() == ref.ledger.stage_bytes()
    assert port.ledger.name_bytes() == ref.ledger.name_bytes()
    assert port.ledger.synapse_bytes() == ref.ledger.synapse_bytes()
    assert port.n_synapses == ref.n_synapses


@pytest.mark.parametrize("propagation", ["packed", "sparse", "auto"])
@pytest.mark.parametrize("policy", ["fp32", "fp16"])
@pytest.mark.parametrize("cfg_name", ["SYNFIRE4_MINI", "SYNFIRE4"])
def test_synfire_compiles_like_reference(cfg_name, policy, propagation):
    assert_same_network(*build_both(cfg_name, policy, propagation))


def test_mini_stage_bytes_match_paper_accounting():
    """Stage 2 counts the 8-byte RNG key plus three f32 generator tables;
    stage 1 the reference's len(groups)·16 int32 static tables."""
    _, port = build_both("SYNFIRE4_MINI", "fp16", "packed")
    sb = port.ledger.stage_bytes()
    assert sb["2. Random Gen."] == 3 * 186 * 4 + 8 == 2240
    assert sb["1. CARLsim Init."] == 9 * 16 * 4


def test_direct_csr_builder_matches_reference(monkeypatch):
    """Projections past the dense-build threshold sample CSR rows straight
    from the seed; lowering the threshold in both packages routes the
    mini's projections there and the tables still agree bit for bit."""
    monkeypatch.setattr(rnet, "_DENSE_BUILD_CELLS", 100)
    monkeypatch.setattr(tnet, "_DENSE_BUILD_CELLS", 100)
    assert_same_network(*build_both("SYNFIRE4_MINI", "fp16", "sparse"))
    with pytest.raises(ValueError, match="dense build threshold"):
        tsyn.build_synfire(tsyn.SYNFIRE4_MINI, propagation="packed", device="cpu")


def _two_source_net(lib_builder, lib_izh4, **compile_kw):
    net = lib_builder(seed=7)
    net.add_group("a", lib_izh4(30, a=0.02, b=0.2, c=-65.0, d=8.0))
    net.add_group("b", lib_izh4(20, a=0.1, b=0.2, c=-65.0, d=2.0))
    net.add_group("c", lib_izh4(25, a=0.02, b=0.2, c=-65.0, d=8.0))
    net.connect("a", "b", fanin=6, weight=2.0, delay_ms=3)
    net.connect("c", "b", fanin=5, weight=1.5, delay_ms=3)
    net.connect("b", "a", fanin=4, weight=-1.0, delay_ms=2)
    net.connect("b", "c", fanin=4, weight=-1.0, delay_ms=2)
    return net.compile(**compile_kw)


def test_non_contiguous_bucket_spans_match_reference():
    """Two sources with a gap between them fuse into one bucket whose pre
    union is not contiguous (gathered through bucket_pre_ids), and two
    targets likewise on the post side."""
    from repro.core import NetworkBuilder as RBuilder, izh4 as rizh4
    ref = _two_source_net(RBuilder, rizh4, policy="fp32")
    port = _two_source_net(NetworkBuilder, izh4, policy="fp32", device="cpu")
    assert any(b.pre_start == -1 for b in port.static.buckets)
    assert any(b.post_start == -1 for b in port.static.buckets)
    assert_same_network(ref, port)


class TestUnportedFeaturesRaise:
    def _net(self):
        net = NetworkBuilder(seed=1)
        net.add_group("a", izh4(10, a=0.02, b=0.2, c=-65.0, d=8.0))
        return net

    # Plasticity (ROADMAP A7) is ported: the keywords these cases once
    # refused now compile into plastic and STP projections. The ids keep
    # the cases' names.
    @pytest.mark.parametrize("kw,item", [
        pytest.param({"stdp": STDPConfig()}, "A7", id="kw0-A7"),
        pytest.param({"plastic": True}, "A7", id="kw1-A7"),
        pytest.param({"stp": STPConfig()}, "A7", id="kw2-A7"),
        pytest.param({"homeostasis": HomeostasisConfig()}, "A7", id="kw3-A7"),
    ])
    def test_connect(self, kw, item):
        net = self._net()
        net.connect("a", "a", fanin=2, weight=1.0, delay_ms=1, **kw)
        period = 10 if "homeostasis" in kw else 0
        c = net.compile(device="cpu", homeostasis_period=period)
        spec = c.static.projections[0]
        assert spec.plastic == ("stp" not in kw)
        assert (spec.stp is not None) == ("stp" in kw)
        assert c.static.buckets == ()
        assert c.params.proj_csr_idx[0].shape == (10, spec.fanin)

    # The loop oracle (ROADMAP A5), conductances (A7, COBA), in-run
    # monitors (A6), watches (A10) and partitioning (A11) are ported: their
    # cases (error None) now compile, the monitors and watches resolved as
    # the reference resolves its defaults, the partition cut as the
    # reference cuts it; the ids keep the cases' names.
    @pytest.mark.parametrize("kw,item,error", [
        pytest.param({"propagation": "loop"}, "loop", None, id="kw0-A5"),
        pytest.param({"conductances": COBAConfig()}, "coba", None, id="kw1-A7"),
        pytest.param({"monitors": "default"}, "A6", None, id="kw2-A6"),
        pytest.param({"watches": "default"}, "A10", None, id="kw3-A10"),
        pytest.param({"partition": tpart.PartitionSpec(n_cores=2)}, "A11", None,
                     id="kw4-A11"),
        # Ported with A7: a period without a homeostasis config is the
        # reference's ValueError.
        pytest.param({"homeostasis_period": 10}, "HomeostasisConfig", ValueError,
                     id="kw5-A7"),
    ])
    def test_compile(self, kw, item, error):
        if error is None:
            c = self._net().compile(device="cpu", **kw)
            if item == "loop":
                assert c.static.propagation == "loop"
            elif item == "A6":  # in-run monitors, ported with A6
                assert [(type(m).__name__, dataclasses.asdict(m)) for m in c.static.monitors] \
                    == [(type(m).__name__, dataclasses.asdict(m))
                        for m in rtel.resolve("default", n=10, n_projections=0)]
                assert c.ledger.name_bytes()["monitor.telemetry"] == 8 * 10
            elif item == "A10":  # in-run watches, ported with A10
                assert [(type(w).__name__, dataclasses.asdict(w)) for w in c.static.watches] \
                    == [(type(w).__name__, dataclasses.asdict(w))
                        for w in rwatch.resolve("default", n=10, n_projections=0)]
                assert c.ledger.name_bytes()["monitor.watch"] == 8 + 4 * 10 + 4 + 8
                with pytest.raises(ValueError, match="partitioned"):
                    self._net().compile(device="cpu", watches="default",
                                        partition=tpart.PartitionSpec(n_cores=2))
            elif item == "A11":  # core partitioning, ported with A11
                from repro.core import partition as rpart
                from repro.core.neurons import izh4 as rizh4

                ref = rnet.NetworkBuilder(seed=1)
                ref.add_group("a", rizh4(10, a=0.02, b=0.2, c=-65.0, d=8.0))
                rplan = ref.compile(partition=rpart.PartitionSpec(n_cores=2)).partition
                plan = c.partition
                assert [(cp.lo, cp.hi, cp.bytes_total) for cp in plan.cores] == [
                    (cp.lo, cp.hi, cp.bytes_total) for cp in rplan.cores]
                assert [(cp.lo, cp.hi) for cp in plan.cores] == [(0, 5), (5, 10)]
                assert plan.exchange.edges == rplan.exchange.edges == ()
            else:
                assert c.static.ring_channels == 2 and c.static.coba == kw["conductances"]
                assert tuple(c.state0.ring.shape[1:]) == (10, 2)
                assert all(g.shape == (10,) for g in c.state0.cond)
            return
        with pytest.raises(error, match=item):
            self._net().compile(device="cpu", **kw)

    def test_unknown_backend_is_a_value_error(self):
        with pytest.raises(ValueError, match="dispatches by device"):
            self._net().compile(device="cpu", backend="pallas")
