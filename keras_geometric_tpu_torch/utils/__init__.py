"""Utility tier: timing and roofline accounting."""

from .profiling import Roofline, timed_steps

__all__ = ["Roofline", "timed_steps"]
