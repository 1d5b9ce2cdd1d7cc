"""Timing and roofline accounting on the card.

Counterpart of the JAX package's ``utils/profiling.py``:

- :func:`timed_steps`: milliseconds per call from CUDA events around a run of
  calls, after a warm-up;
- :class:`Roofline`: byte/operation accounting for the framework's core ops
  against one card's published peaks.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

__all__ = [
    "timed_steps",
    "Roofline",
    "H100_BYTES_PER_S",
    "H100_F32_OPS_PER_S",
    "H100_BF16_TENSOR_OPS_PER_S",
]

# Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates at
# the full 700 W power limit): device memory, f32 outside the tensor cores,
# bf16 in the tensor cores.
H100_BYTES_PER_S = 3.35e12
H100_F32_OPS_PER_S = 67e12
H100_BF16_TENSOR_OPS_PER_S = 989e12


def timed_steps(
    fn: Callable[[], object], *, warmup: int = 3, iters: int = 20
) -> float:
    """Milliseconds per call of ``fn`` on the current CUDA device.

    Events are recorded on the current stream around ``iters`` back-to-back
    calls and read after a synchronise, so the figure is device time per call
    including any gaps the host leaves. Raises without a CUDA device: a host
    clock around unsynchronised launches would time the enqueue.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("timed_steps needs a CUDA device")
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


@dataclasses.dataclass
class Roofline:
    """Accumulates operation/byte counts and reports the least time one H100
    could take for them."""

    flops: float = 0.0
    bytes: float = 0.0

    def add_matmul(self, m: int, k: int, n: int, dtype_bytes: int = 2):
        self.flops += 2.0 * m * k * n
        self.bytes += dtype_bytes * (m * k + k * n + m * n)
        return self

    def add_spmm(self, e: int, f: int, n: int, dtype_bytes: int = 2,
                 weight_bytes: int = 4):
        """Fused gather + weighted scatter over E edges into N rows of F: the
        node array once, the output once, index and weight streams, row
        pointers; two operations per (edge, feature)."""
        self.flops += 2.0 * e * f
        self.bytes += (
            2 * dtype_bytes * n * f + (4 + weight_bytes) * e + 4 * (n + 1)
        )
        return self

    def add_elementwise(self, elems: int, dtype_bytes: int = 2, passes: int = 2):
        self.bytes += dtype_bytes * elems * passes
        return self

    def report(self, seconds: float, *, tensor_cores: bool = False) -> dict:
        peak_ops = (
            H100_BF16_TENSOR_OPS_PER_S if tensor_cores else H100_F32_OPS_PER_S
        )
        t_ops = self.flops / peak_ops
        t_bytes = self.bytes / H100_BYTES_PER_S
        bound = max(t_ops, t_bytes)
        return {
            "seconds": seconds,
            "bound_s": bound,
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "roofline_share": bound / seconds if seconds > 0 else 0.0,
            "achieved_tflops": self.flops / seconds / 1e12 if seconds else 0.0,
            "achieved_gbps": self.bytes / seconds / 1e9 if seconds else 0.0,
        }
