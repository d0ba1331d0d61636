"""Real-time sizing — paper §III-B, generalized to a device roofline.

The reference's ``repro.core.sizing``, with the card's spec in place of
the reference's accelerator. The paper downsizes Synfire4 until the M33
meets the 1 ms/tick wall-clock deadline (186 neurons real-time, 372 with
the second core, ~1k with ISA tricks). The same question on another
device: how many neurons fit under the deadline given the three roofline
terms? The answer is analytic because the per-tick work is regular:

  compute:    ~C_N flops/neuron (IZH4 Euler×2) + 2·fanin flops/neuron (MAC)
  memory:     weight bytes dominate: fanin · bytes_per_weight per neuron/tick
  collective: the spike all-gather: N bits per device per tick over the
              device link

fp16 halves the memory term — the paper's technique is what moves the
real-time boundary when memory-bound.
"""
from __future__ import annotations

import dataclasses

__all__ = ["HardwareSpec", "H100", "M33", "PI_ZERO_2W", "RealtimeSizing",
           "realtime_sizing"]


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str
    flops: float  # peak FLOP/s (f32-equivalent for scalar cores)
    hbm_bw: float  # bytes/s
    link_bw: float  # bytes/s per device link (0 = single device)
    chips: int = 1
    # Energy model terms (repro_torch.telemetry.metrics.energy_report): power
    # drawn while the SNN computes, attributable to the cores themselves
    # vs. the complete SoC/board (regulators, RAM, radios). 0 = unknown.
    active_power_w: float = 0.0
    soc_power_w: float = 0.0


# NVIDIA H100 80GB HBM3 (SXM) at its 700.00 W power limit: 67 TFLOP/s
# float32 outside the tensor cores and 3.35 TB/s of device memory, the
# peaks every bound in PERF.md uses. No link (one card); the power terms
# stay 0.0 (unknown): no power figure of the card is measured yet.
H100 = HardwareSpec(name="h100_sxm", flops=67e12, hbm_bw=3.35e12, link_bw=0.0)
# RP2350 Cortex-M33 @150 MHz: softfp f32 costs ~20 cycles/op ⇒ ≈7.5 MFLOP/s
# effective; PSRAM QSPI @133 MHz × 4 bits ≈ 66 MB/s. With these constants the
# compute term caps real-time at ≈190 neurons (fanin 60, event-driven) —
# matching the paper's measured 186 and its statement that the mini SNN is
# processing- not memory-bound. Power: the paper measures 20 mW for the SNN
# computation itself; the complete SparkFun Pro Micro board (regulator,
# PSRAM, LED) draws ~95 mW from the socket.
M33 = HardwareSpec(name="rp2350_m33", flops=7.5e6, hbm_bw=66e6, link_bw=0.0,
                   active_power_w=0.020, soc_power_w=0.095)
# Raspberry Pi Zero 2 W (quad Cortex-A53 @1 GHz, 512 MB LPDDR2) — the
# paper's energy baseline. CARLsim runs single-threaded: ~2 sustained f32
# FLOP/cycle on one core; one LPDDR2 channel streams ~2 GB/s. Power terms
# calibrated to the paper's measured comparison: ~100 mW of core power
# attributable to the SNN process (5× the MCU's 20 mW) and ~1.1 W for the
# complete SoC + board under load (an order of magnitude over the MCU
# board) — the abstract's "five times / order of magnitude" claims.
PI_ZERO_2W = HardwareSpec(name="pi_zero_2w", flops=2.0e9, hbm_bw=2.0e9,
                          link_bw=0.0, active_power_w=0.100, soc_power_w=1.1)


@dataclasses.dataclass(frozen=True)
class RealtimeSizing:
    hardware: str
    chips: int
    fanin: int
    bytes_per_weight: int
    max_neurons_compute: float
    max_neurons_memory: float
    max_neurons_collective: float

    @property
    def max_neurons(self) -> int:
        return int(min(self.max_neurons_compute, self.max_neurons_memory,
                       self.max_neurons_collective))

    @property
    def bottleneck(self) -> str:
        vals = {
            "compute": self.max_neurons_compute,
            "memory": self.max_neurons_memory,
            "collective": self.max_neurons_collective,
        }
        return min(vals, key=vals.get)


NEURON_FLOPS = 36.0  # IZH4, 2 Euler substeps (13 flops + spike/reset) × 2
SPIKE_RATE = 0.025  # active fraction per tick at ~25 Hz (synfire regime)


def realtime_sizing(
    hw: HardwareSpec,
    *,
    chips: int = 1,
    fanin: int = 60,
    bytes_per_weight: int = 2,  # fp16 — the paper's policy
    tick_s: float = 1e-3,
    dense_traversal: bool = True,
) -> RealtimeSizing:
    """Max neurons N that meet the real-time deadline per roofline term.

    ``dense_traversal=True`` models the batched engine (every weight is
    touched every tick — dense matmul/gather); ``False`` models event-driven
    CARLsim on the MCU (only firing neurons' synapses walked).
    """
    # compute: N·(NEURON_FLOPS + 2·fanin·act) / (chips·flops) = tick
    act = 1.0 if dense_traversal else SPIKE_RATE
    n_compute = tick_s * chips * hw.flops / (NEURON_FLOPS + 2.0 * fanin * act)
    # memory: N·fanin·act·bytes_w (+ ~16B state) / (chips·bw) = tick
    n_memory = tick_s * chips * hw.hbm_bw / (fanin * act * bytes_per_weight + 16)
    # collective: all-gather N/8 bytes per tick over one link
    if hw.link_bw > 0 and chips > 1:
        n_collective = tick_s * hw.link_bw * 8.0
    else:
        n_collective = float("inf")
    return RealtimeSizing(
        hardware=hw.name, chips=chips, fanin=fanin,
        bytes_per_weight=bytes_per_weight,
        max_neurons_compute=n_compute,
        max_neurons_memory=n_memory,
        max_neurons_collective=n_collective,
    )
