"""Utility tier: host-side data containers and batching; the device an entry
point runs on; timing, tracing and roofline accounting."""

from .data_utils import GraphData, batch_graphs, batch_graphs_padded
from .device import pick_device
from .profiling import CHIP_SPECS, Roofline, timed_steps, trace

__all__ = [
    "GraphData",
    "batch_graphs",
    "batch_graphs_padded",
    "pick_device",
    "CHIP_SPECS",
    "Roofline",
    "timed_steps",
    "trace",
]
