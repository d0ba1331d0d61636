"""Streaming telemetry: in-run monitors and the paper's metrics layer.

``repro_torch.telemetry.monitors`` keeps declarative monitor specs'
accumulators through a run (constant-memory runs, ``Engine.run(n,
record="monitors")``); ``repro_torch.telemetry.metrics`` turns monitor
output and a ``HardwareSpec`` into the paper's accuracy, real-time and
energy numbers. The reference's ``repro.telemetry``.
"""
from repro_torch.telemetry.monitors import (
    CUMULATIVE,
    DEFAULT_MONITORS,
    GroupRate,
    MonitorSpec,
    SpikeCount,
    VoltageProbe,
    WeightNorm,
    carry_struct,
    chunk_carry,
    collect,
    flush_carry,
    init_carry,
    resolve,
    summarize,
    update,
)
from repro_torch.telemetry import metrics

__all__ = [
    "CUMULATIVE",
    "DEFAULT_MONITORS",
    "GroupRate",
    "MonitorSpec",
    "SpikeCount",
    "VoltageProbe",
    "WeightNorm",
    "carry_struct",
    "chunk_carry",
    "collect",
    "flush_carry",
    "init_carry",
    "metrics",
    "resolve",
    "summarize",
    "update",
]
