"""The paper's Synfire4 claims (§III, Tables III-V), held against the port
on the CPU with its own ``torch.Generator`` stimulus stream: every check
of ``tests/test_synfire.py``."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.synfire4 import SYNFIRE4, SYNFIRE4_MINI, build_synfire  # noqa: E402
from repro_torch.core import Engine  # noqa: E402
from repro_torch.memory import MCU_BUDGET_BYTES, MemoryBudgetError  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tensors are tiny: one intra-op thread keeps PyTorch's thread
    pool from spinning against the other test workers' cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _build(cfg, **kw):
    return build_synfire(cfg, device="cpu", **kw)


@pytest.fixture(scope="module")
def synfire_runs():
    """Full Synfire4 for 1 s of model time under both precision policies."""
    out = {}
    for pol in ("fp32", "fp16"):
        net = _build(SYNFIRE4, policy=pol)
        _, o = Engine(net).run(1000)
        out[pol] = (net, o["spikes"])
    return out


class TestSynfire4:
    def test_network_size_matches_paper(self):
        net = _build(SYNFIRE4, policy="fp16")
        assert net.n_neurons == 1200  # paper: 1,200 neurons
        assert 78_000 <= net.n_synapses <= 95_000  # paper: roughly 81k

    def test_wave_propagates_all_segments(self, synfire_runs):
        net, sp = synfire_runs["fp16"]
        for g in net.static.groups:
            if g.name.startswith("Cexc"):
                rate = sp[:, g.start:g.start + g.size].float().mean() * 1000.0
                assert rate > 10.0, f"{g.name} silent: {rate:.1f} Hz"

    def test_mean_rate_near_paper(self, synfire_runs):
        _, sp = synfire_runs["fp16"]  # paper: 22.8 Hz
        assert 17.0 <= float(sp.float().mean()) * 1000.0 <= 29.0

    def test_total_spikes_near_paper(self, synfire_runs):
        # paper: 27,364 (fp16) / 26,694 (fp32) spikes in 1 s
        for pol in ("fp16", "fp32"):
            assert 20_000 <= int(synfire_runs[pol][1].sum()) <= 33_000

    def test_fp16_accuracy_at_least_97_percent(self, synfire_runs):
        c16 = int(synfire_runs["fp16"][1].sum())
        c32 = int(synfire_runs["fp32"][1].sum())
        assert min(c16, c32) / max(c16, c32) >= 0.97

    def test_fits_mcu_memory_budget(self):
        net = _build(SYNFIRE4, policy="fp16", budget=MCU_BUDGET_BYTES)
        assert net.ledger.total_used < MCU_BUDGET_BYTES

    def test_budget_is_enforced(self):
        with pytest.raises(MemoryBudgetError):
            _build(SYNFIRE4, policy="fp16", budget=1_000_000)

    def test_fp16_halves_synaptic_bytes(self):
        s16 = _build(SYNFIRE4, policy="fp16").ledger.stage_bytes()["4. Syn. State"]
        s32 = _build(SYNFIRE4, policy="fp32").ledger.stage_bytes()["4. Syn. State"]
        assert abs(s16 * 2 - s32) / s32 < 0.05


class TestSynfire4Mini:
    def test_size_matches_paper(self):
        net = _build(SYNFIRE4_MINI, policy="fp16")
        assert net.n_neurons == 186  # paper: 186 neurons
        assert 2_200 <= net.n_synapses <= 2_700  # paper: 2,430

    def test_wave_dies_out(self):
        # paper: 412 spikes over 30 s, a few laps, then silence.
        _, o = Engine(_build(SYNFIRE4_MINI, policy="fp16")).run(5000)
        sp = o["spikes"]
        assert 150 <= int(sp.sum()) <= 900
        assert int(sp[-1000:].sum()) == 0  # silent in the last second

    def test_memory_far_below_budget(self):
        net = _build(SYNFIRE4_MINI, policy="fp16", monitor_ms_hint=1000)
        assert net.ledger.total_used < 0.5 * MCU_BUDGET_BYTES


def test_default_device_is_the_card(monkeypatch):
    """Without ``device`` the entry points run on the card, and raise
    where there is none rather than falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_synfire(SYNFIRE4_MINI)
