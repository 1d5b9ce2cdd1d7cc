"""Timing, tracing and roofline accounting on the card.

Counterpart of the JAX package's ``utils/profiling.py``, under the same names:

- :func:`trace`: context manager around ``torch.profiler`` that writes a
  trace of the enclosed block into a directory (the reference's default
  ``/tmp/kgt_trace``);
- :func:`timed_steps`: seconds per call, from the difference of two runs of
  back-to-back calls of different lengths, each timed by CUDA events;
- :class:`Roofline`: byte/operation accounting for the framework's core ops
  against one card's published peaks (``CHIP_SPECS``), under the
  reference's names and report keys but with the fused kernel's byte model
  and the card's defaults (divergence D19 in ``ROADMAP.md``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Callable

import torch

__all__ = [
    "trace",
    "timed_steps",
    "Roofline",
    "CHIP_SPECS",
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

# (peak bf16 TFLOP/s, peak f32 TFLOP/s, device memory GB/s) per card, in the
# reference's layout.
CHIP_SPECS = {
    "h100": (H100_BF16_TENSOR_OPS_PER_S / 1e12, H100_F32_OPS_PER_S / 1e12,
             H100_BYTES_PER_S / 1e9),
}


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/kgt_trace"):
    """Trace the enclosed block with ``torch.profiler`` (host operators, and
    the card's kernels where there is a card) and write it into ``log_dir``
    as ``trace.json`` (Chrome's trace format). Yields ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # the block's kernels end in the trace
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def timed_steps(
    fn: Callable[[], object],
    *,
    k_lo: int = 2,
    k_hi: int = 22,
    trials: int = 3,
) -> float:
    """Seconds per call of ``fn`` on the current CUDA device.

    After one call to warm up, each of ``trials`` trials times a run of
    ``k_lo`` and a run of ``k_hi`` back-to-back calls with CUDA events
    recorded on the current stream; the result is the difference of the best
    (shortest) runs of each length over ``k_hi - k_lo``, which cancels what a
    run pays once (its first launch, the events). It is device time per call
    including any gaps the host leaves between calls. Should noise make the
    difference not positive, it is measured again with ``k_lo`` doubled and
    ``k_hi`` quadrupled, at most three times (the reference's rule), and a
    difference that is still not positive raises. ``fn`` is called
    ``1 + trials * (k_lo + k_hi)`` times, more on a retry. Raises without a
    CUDA device: a host clock around unsynchronised launches would time the
    enqueue.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("timed_steps needs a CUDA device")
    if not 0 <= k_lo < k_hi or trials < 1:
        raise ValueError(f"need 0 <= k_lo < k_hi and trials >= 1, got "
                         f"{k_lo}, {k_hi}, {trials}")
    fn()  # warm

    def run_ms(k: int) -> float:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(k):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop)

    def slope_ms(k_lo: int, k_hi: int) -> float:
        lo = hi = float("inf")
        for _ in range(trials):
            lo = min(lo, run_ms(k_lo))
            hi = min(hi, run_ms(k_hi))
        return (hi - lo) / (k_hi - k_lo)

    slope = slope_ms(k_lo, k_hi)
    for _ in range(3):
        if slope > 0:
            break
        k_lo, k_hi = 2 * k_lo, 4 * k_hi
        slope = slope_ms(k_lo, k_hi)
    if slope <= 0:
        raise RuntimeError(
            f"timed_steps: the {k_hi}-call run took no longer than the "
            f"{k_lo}-call run; the calls are too short to time this way")
    return slope / 1e3


@dataclasses.dataclass
class Roofline:
    """Accumulates operation/byte counts and reports the least time the card
    (``chip``, a key of ``CHIP_SPECS``) could take for them.

    D19, where it differs from the reference's: ``chip`` defaults to
    ``"h100"`` (the reference's ``"v5e"`` is a TPU) and ``dtype_bytes`` to 2
    (the port's bf16 IO; the reference's 4); :meth:`add_spmm` counts what the
    fused gather-scatter kernel moves, each node row once: ``2·e·f``
    operations and ``2·b·n·f + (4 + w)·e + 4·(n + 1)`` bytes, where the
    reference counts no operations and ``b·(2·e·f + n·f) + 4·e`` bytes, an
    ``[E, F]`` gather."""

    chip: str = "h100"
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

    def report(self, seconds: float, *, use_bf16_peak: bool = False,
               tensor_cores: bool | None = None) -> dict:
        """The reference's keys (``speed_of_light_s``, ``efficiency``,
        ``bound`` in {"compute", "memory"}, ``achieved_tflops``,
        ``achieved_gbps``, ``hbm_utilization``) and the port's names of the
        same figures beside them (``bound_s``, ``roofline_share``,
        ``bound_by`` in {"operations", "bytes"}). ``use_bf16_peak`` (alias
        ``tensor_cores``) takes the bf16 tensor-core peak for the
        operations, else the f32 one."""
        if tensor_cores is not None:
            use_bf16_peak = tensor_cores
        peak_bf16, peak_f32, peak_gbps = CHIP_SPECS[self.chip]
        peak_ops = (peak_bf16 if use_bf16_peak else peak_f32) * 1e12
        peak_bytes = peak_gbps * 1e9
        t_ops = self.flops / peak_ops
        t_bytes = self.bytes / peak_bytes
        sol = max(t_ops, t_bytes)
        by_ops = t_ops > t_bytes
        share = sol / seconds if seconds > 0 else 0.0
        return {
            "seconds": seconds,
            "speed_of_light_s": sol,
            "efficiency": share,
            "bound": "compute" if by_ops else "memory",
            "bound_s": sol,
            "roofline_share": share,
            "bound_by": "operations" if by_ops else "bytes",
            "achieved_tflops": self.flops / seconds / 1e12 if seconds else 0.0,
            "achieved_gbps": self.bytes / seconds / 1e9 if seconds else 0.0,
            "hbm_utilization": (
                self.bytes / seconds / peak_bytes if seconds else 0.0
            ),
        }
