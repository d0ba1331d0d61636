"""Paper-metrics layer — §III's headline numbers from telemetry output.

The reference's ``repro.telemetry.metrics``, function for function (pure
Python, so every value equals the reference's). Turns streamed monitor
results plus a :class:`repro_torch.core.sizing.HardwareSpec`
into the three quantities the paper's evaluation rests on:

* **Accuracy** — fp16-vs-fp32 total-spike-count ratio
  (:func:`spike_count_accuracy`; the abstract's 97.5%).
* **Real-time factor** — model time over wall time
  (:func:`realtime_factor` for measured runs,
  :func:`device_tick_seconds` for the roofline-modeled projection onto a
  target device; the paper's "186 neurons in real time").
* **Energy** — a joules-per-synaptic-event model
  (:func:`energy_report` / :func:`energy_comparison`) reproducing the
  20 mW RP2350 vs Raspberry Pi Zero 2 W comparison: 5× more efficient for
  the SNN itself, an order of magnitude for the complete SoC.

``chip_smoke.py`` (phase 9) drives this layer for Synfire4 and the
186-neuron scaled-down configuration on the card.
"""
from __future__ import annotations

import dataclasses
import math
from typing import TYPE_CHECKING

if TYPE_CHECKING:  # imported lazily at call sites to avoid import cycles
    from repro_torch.core.sizing import HardwareSpec

__all__ = [
    "rate_from_count",
    "spike_count_accuracy",
    "realtime_factor",
    "synaptic_events",
    "device_tick_seconds",
    "EnergyReport",
    "energy_report",
    "energy_comparison",
]


def rate_from_count(count, size: int, n_ticks: int, dt_ms: float = 1.0) -> float:
    """Mean firing rate (Hz) from an integer spike count.

    The ONE rate expression shared by the streaming telemetry summary and
    the post-hoc raster path (``repro_torch.core.monitors.group_rates``): both
    feed an exact integer count through the identical float computation, so
    the two paths agree bit-for-bit.
    """
    t_s = n_ticks * dt_ms / 1000.0
    return float(count / (size * t_s))


def spike_count_accuracy(count_a, count_b) -> float:
    """Paper §III-A accuracy: min/max ratio of two total spike counts.

    The paper reports 97.5% for fp16 vs fp32 on Synfire4; our engine's
    Synfire weight tables are exactly representable in fp16, so same-seed
    runs typically score 100%.
    """
    a, b = float(count_a), float(count_b)
    if a == 0.0 and b == 0.0:
        return 1.0
    return min(a, b) / max(a, b)


def realtime_factor(model_time_s: float, wall_time_s: float) -> float:
    """> 1 means faster than real time (1 ms of model time per wall ms)."""
    return model_time_s / wall_time_s


def synaptic_events(static, group_counts) -> float:
    """Total synaptic events (spike deliveries) over a run, from per-group
    spike counts (the :class:`~repro_torch.telemetry.monitors.SpikeCount` output,
    ordered like ``static.groups``).

    Each spike of a presynaptic neuron is delivered to every outgoing
    synapse, so per projection the event count is (pre-group spikes) ×
    (mean out-degree ``n_syn / pre_size``). Exact when out-degree is
    uniform; this is the quantity the energy model normalizes by —
    CARLsim's definition of propagation work.
    """
    by_span = {(g.start, g.size): i for i, g in enumerate(static.groups)}
    total = 0.0
    for spec in static.projections:
        gi = by_span.get((spec.pre_start, spec.pre_size))
        if gi is None:
            raise KeyError(
                f"projection {spec.name!r} pre span is not a single group")
        total += float(group_counts[gi]) * (spec.n_syn / spec.pre_size)
    return total


def device_tick_seconds(
    hw: "HardwareSpec",
    *,
    n_neurons: int,
    fanin: float,
    active_fraction: float,
    bytes_per_weight: int = 2,
    dense_traversal: bool = False,
) -> float:
    """Modeled wall seconds per 1 ms tick on ``hw`` — the same roofline
    terms as :func:`repro_torch.core.sizing.realtime_sizing`, solved for time at
    a fixed N instead of for N at a fixed deadline.

    ``active_fraction`` is the measured firing probability per neuron per
    tick (mean rate × dt); event-driven traversal (the MCU/CARLsim
    discipline) only walks the synapses of firing neurons.
    """
    from repro_torch.core.sizing import NEURON_FLOPS

    act = 1.0 if dense_traversal else active_fraction
    flops = n_neurons * (NEURON_FLOPS + 2.0 * fanin * act)
    byte_traffic = n_neurons * (fanin * act * bytes_per_weight + 16)
    return max(flops / hw.flops, byte_traffic / hw.hbm_bw)


@dataclasses.dataclass(frozen=True)
class EnergyReport:
    """Energy accounting for one (workload, device) pair."""

    hardware: str
    n_neurons: int
    model_time_s: float
    realtime_factor: float  # modeled: 1 ms tick / device tick wall time
    busy_s: float  # device time actually computing ticks
    powered_s: float  # wall time the device is on (≥ model time if RT app)
    snn_power_w: float
    snn_energy_j: float
    soc_energy_j: float
    synaptic_events: float
    joules_per_synaptic_event: float

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["snn_power_mw"] = round(self.snn_power_w * 1e3, 3)
        return d


def energy_report(
    hw: "HardwareSpec",
    *,
    n_neurons: int,
    fanin: float,
    synaptic_events: float,
    model_time_s: float,
    mean_rate_hz: float,
    dt_ms: float = 1.0,
    bytes_per_weight: int = 2,
    dense_traversal: bool = False,
) -> EnergyReport:
    """Joules-per-synaptic-event energy model for running a workload on
    ``hw`` (paper §III-C).

    The device draws ``hw.active_power_w`` for the SNN itself and
    ``hw.soc_power_w`` for the complete SoC/board. An edge deployment is a
    *real-time* application: the device is powered for the full model
    duration even when each tick finishes early (this is exactly what the
    paper's 20 mW × 30 s wall-socket measurement integrates); a device
    slower than real time stays busy — and powered — proportionally longer.
    """
    tick_s = dt_ms / 1000.0
    tick_wall = device_tick_seconds(
        hw, n_neurons=n_neurons, fanin=fanin,
        active_fraction=mean_rate_hz * dt_ms / 1000.0,
        bytes_per_weight=bytes_per_weight, dense_traversal=dense_traversal,
    )
    rtf = tick_s / tick_wall
    busy = (model_time_s / tick_s) * tick_wall
    powered = max(model_time_s, busy)
    snn_energy = hw.active_power_w * powered
    jpe = snn_energy / synaptic_events if synaptic_events > 0 else math.inf
    return EnergyReport(
        hardware=hw.name,
        n_neurons=n_neurons,
        model_time_s=model_time_s,
        realtime_factor=rtf,
        busy_s=busy,
        powered_s=powered,
        snn_power_w=hw.active_power_w,
        snn_energy_j=snn_energy,
        soc_energy_j=hw.soc_power_w * powered,
        synaptic_events=synaptic_events,
        joules_per_synaptic_event=jpe,
    )


def energy_comparison(mcu: EnergyReport, other: EnergyReport) -> dict:
    """Efficiency ratios other/mcu — the paper's headline framing ("five
    times more energy efficient for the SNN itself, an order of magnitude
    better for the complete SoC")."""
    return {
        "baseline": other.hardware,
        "snn_energy_ratio": other.snn_energy_j / mcu.snn_energy_j,
        "soc_energy_ratio": other.soc_energy_j / mcu.soc_energy_j,
        "jpe_ratio": (other.joules_per_synaptic_event
                      / mcu.joules_per_synaptic_event),
    }
