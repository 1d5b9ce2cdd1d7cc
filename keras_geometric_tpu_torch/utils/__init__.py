"""Utility tier: timing, tracing and roofline accounting."""

from .profiling import CHIP_SPECS, Roofline, timed_steps, trace

__all__ = ["CHIP_SPECS", "Roofline", "timed_steps", "trace"]
