"""Utility tier: host-side data containers and batching; timing, tracing and
roofline accounting."""

from .data_utils import GraphData, batch_graphs, batch_graphs_padded
from .profiling import CHIP_SPECS, Roofline, timed_steps, trace

__all__ = [
    "GraphData",
    "batch_graphs",
    "batch_graphs_padded",
    "CHIP_SPECS",
    "Roofline",
    "timed_steps",
    "trace",
]
