"""Synfire4 benchmark: the paper's workload, Tables I & II verbatim.

Four recurrently-connected segments; each has 200 regular-spiking
excitatory IZH4 neurons (a=0.02, b=0.2, c=-65, d=8) and 50 fast-spiking
inhibitory neurons (a=0.1, b=0.2, c=-65, d=2), driven by a 200-neuron
Poisson group. Connections (Table II): Bernoulli connect at the table's
fan-in per post neuron, delays 10/8 ms.

Full network: 1,200 neurons, ~90k synapses from the binomial draw (paper:
"roughly 81k"). Mini network (paper §III-B): 186 neurons = 30 stim +
4×(30 exc + 9 inh), ≈2,430 synapses, the paper's real-time configuration.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.network import CompiledNetwork, NetworkBuilder
from repro_torch.core.neurons import izh4
from repro_torch.core.plasticity import HomeostasisConfig, STDPConfig
from repro_torch.memory import MCU_BUDGET_BYTES, MemoryLedger

__all__ = ["SynfireConfig", "SYNFIRE4", "SYNFIRE4_MINI", "SYNFIRE4_X10",
           "CHAIN_STDP", "build_synfire", "scale_synfire"]


@dataclasses.dataclass(frozen=True)
class SynfireConfig:
    name: str
    n_segments: int = 4
    n_exc: int = 200  # RS neurons per segment
    n_inh: int = 50  # FS neurons per segment
    n_stim: int = 200  # Poisson generators
    fanin_exc: int = 60  # Table II "Connections per neuron" (exc sources)
    fanin_inh: int = 25  # inh -> exc fan-in
    w_exc: float = 1.0
    w_inh_drive: float = 3.5  # exc -> inh weight
    w_inh: float = -2.0
    delay_ff: int = 10  # ms, feed-forward
    delay_inh: int = 8  # ms, inhibitory
    # Stimulus: an igniting Poisson pulse, then sustained background drive.
    stim_pulse_hz: float = 300.0
    stim_pulse_ms: float = 15.0
    stim_rate_hz: float = 8.0  # sustained after the pulse
    # CARLsim's random connect is Bernoulli per pair with E[fanin] as given.
    connect_mode: str = "prob"


SYNFIRE4 = SynfireConfig(name="synfire4")

# Paper §III-B: 186 neurons, ≈2,430 synapses; the wave runs a couple of
# laps and dies out (412 spikes over 30 s).
SYNFIRE4_MINI = SynfireConfig(
    name="synfire4_mini",
    n_exc=30, n_inh=9, n_stim=30,
    fanin_exc=10, fanin_inh=5,
    w_exc=4.0, w_inh_drive=14.0, w_inh=-6.667,
    stim_pulse_hz=300.0, stim_pulse_ms=15.0, stim_rate_hz=0.0,
)


def scale_synfire(cfg: SynfireConfig, k: int, name: str | None = None) -> SynfireConfig:
    """Scale group sizes ×k at constant fan-in (Table II's per-neuron
    connection counts): per-neuron drive, hence the wave, is unchanged;
    dense storage grows ×k², CSR fan-in rows ×k."""
    return dataclasses.replace(
        cfg, name=name or f"{cfg.name}_x{k}",
        n_exc=cfg.n_exc * k, n_inh=cfg.n_inh * k, n_stim=cfg.n_stim * k,
    )


# Synfire4×10: 12k neurons, ~900k synapses at paper fan-in; fits the MCU
# budget only with sparse (CSR) propagation.
SYNFIRE4_X10 = scale_synfire(SYNFIRE4, 10)

# STDP of the plastic Synfire variant: mild pair-based learning on the
# feed-forward chain. a± sit an order below the weights, so 1 s of volleys
# moves weights measurably without detonating the wave; w_max caps runaway
# LTP on the recurrent closure.
CHAIN_STDP = STDPConfig(a_plus=0.004, a_minus=0.0033, w_max=4.0)


def _synfire_builder(cfg: SynfireConfig, *, seed: int = 42,
                     stdp_chain: STDPConfig | None = None,
                     homeo_chain: HomeostasisConfig | None = None) -> NetworkBuilder:
    """Synfire's Table II network, declared and not yet compiled: what
    :func:`build_synfire` compiles (a caller may compile it with other
    arguments, such as ``conductances=``)."""
    net = NetworkBuilder(seed=seed)
    net.add_spike_generator(
        "Cstim", cfg.n_stim, cfg.stim_pulse_hz,
        until_ms=cfg.stim_pulse_ms, rate_after_hz=cfg.stim_rate_hz,
    )
    for i in range(cfg.n_segments):
        net.add_group(f"Cexc{i}", izh4(cfg.n_exc, a=0.02, b=0.2, c=-65.0, d=8.0))
        net.add_group(f"Cinh{i}", izh4(cfg.n_inh, a=0.1, b=0.2, c=-65.0, d=2.0))

    # Table II rows.
    net.connect("Cstim", "Cexc0", fanin=cfg.fanin_exc, weight=cfg.w_exc,
                delay_ms=cfg.delay_ff, mode=cfg.connect_mode)
    net.connect("Cstim", "Cinh0", fanin=cfg.fanin_exc, weight=cfg.w_inh_drive,
                delay_ms=cfg.delay_ff, mode=cfg.connect_mode)
    for i in range(cfg.n_segments - 1):
        net.connect(f"Cexc{i}", f"Cexc{i + 1}", fanin=cfg.fanin_exc,
                    weight=cfg.w_exc, delay_ms=cfg.delay_ff, mode=cfg.connect_mode,
                    stdp=stdp_chain, homeostasis=homeo_chain)
        net.connect(f"Cexc{i}", f"Cinh{i + 1}", fanin=cfg.fanin_exc,
                    weight=cfg.w_inh_drive, delay_ms=cfg.delay_ff,
                    mode=cfg.connect_mode)
        net.connect(f"Cinh{i + 1}", f"Cexc{i + 1}", fanin=cfg.fanin_inh,
                    weight=cfg.w_inh, delay_ms=cfg.delay_inh, mode=cfg.connect_mode)
    # Recurrent closure: segment 3 -> segment 0.
    last = cfg.n_segments - 1
    net.connect(f"Cexc{last}", "Cexc0", fanin=cfg.fanin_exc, weight=cfg.w_exc,
                delay_ms=cfg.delay_ff, mode=cfg.connect_mode, stdp=stdp_chain,
                homeostasis=homeo_chain)
    net.connect(f"Cexc{last}", "Cinh0", fanin=cfg.fanin_exc,
                weight=cfg.w_inh_drive, delay_ms=cfg.delay_ff, mode=cfg.connect_mode)
    return net


def build_synfire(
    cfg: SynfireConfig = SYNFIRE4,
    *,
    policy: str = "fp16",
    seed: int = 42,
    budget: int | None = MCU_BUDGET_BYTES,
    monitor_ms_hint: int = 1000,
    monitors="default",
    watches=None,
    method: str = "euler",
    backend: str | None = None,
    propagation: str = "packed",
    stdp_chain: STDPConfig | None = None,
    homeo_chain: HomeostasisConfig | None = None,
    homeostasis_period: int = 0,
    partition=None,
    device: str | torch.device | None = None,
) -> CompiledNetwork:
    """Build the Synfire benchmark under a precision policy on ``device``
    (the card when ``None``).

    ``policy='fp16'`` is the paper's MCU configuration, ``'fp32'`` its
    single-precision reference; ``'bf16'`` stores state, ring and weights
    in bf16, and ``'fp16_opt'`` and ``'fp16_sr'`` compile the fp16 net (the
    storage dtypes are all the SNN reads of a policy). ``propagation`` selects ``packed`` dense
    bucket matmuls, ``sparse`` CSR gathers or the per-projection ``auto``
    cost model. The ledger enforces ``budget`` (the paper's 8.477 MB by
    default) and counts a ``monitor_ms_hint``-tick raster buffer and the
    in-run ``monitors``' storage (``"default"``: SpikeCount and GroupRate,
    the reference's default; ``None`` for none).

    ``stdp_chain`` makes the exc→exc feed-forward chain (Cexc{i}→Cexc{i+1}
    and the recurrent closure) plastic with that pair-based STDP
    (:data:`CHAIN_STDP` is the benchmarked setting); under ``"sparse"``
    those projections store CSR fan-in rows, which keeps a plastic
    ``SYNFIRE4_X10`` inside the 8.477 MB budget. ``homeo_chain`` with
    ``homeostasis_period`` adds CARLsim's slow-timer synaptic scaling to
    the same projections, applied every ``homeostasis_period`` ticks.

    ``partition`` (a ``core.partition.PartitionSpec``) cuts the net into
    cores; the paper's ceiling then holds per core, on each core's ledger,
    so the default global budget is dropped (kept, it would refuse exactly
    the nets that partitioning exists for).
    """
    net = _synfire_builder(cfg, seed=seed, stdp_chain=stdp_chain, homeo_chain=homeo_chain)
    if partition is not None and budget == MCU_BUDGET_BYTES:
        budget = None
    ledger = MemoryLedger(budget=budget, name=f"{cfg.name}/{policy}")
    return net.compile(policy=policy, ledger=ledger,
                       monitor_ms_hint=monitor_ms_hint, monitors=monitors,
                       watches=watches, method=method, backend=backend,
                       propagation=propagation,
                       homeostasis_period=homeostasis_period, partition=partition,
                       device=device)
