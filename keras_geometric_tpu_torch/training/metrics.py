"""Lightweight metrics logging for training loops.

Counterpart of the JAX package's ``training/metrics.py``: one record per
logged step, ``{"step", "time", <metric>: float, ...}``, kept in ``history``
and appended to a JSONL file and / or printed.
"""

from __future__ import annotations

import json
import time
from typing import Any

__all__ = ["MetricLogger"]


class MetricLogger:
    """Collects scalar metrics per step and emits JSONL or stdout lines.

    ``float(v)`` of a tensor on the card waits for it: log every few steps
    where the loop must not synchronise.
    """

    def __init__(self, path: str | None = None, print_every: int = 0) -> None:
        self.path = path
        self.print_every = print_every
        self.history: list[dict[str, Any]] = []
        self._file = open(path, "a") if path else None
        self._start = time.time()

    def log(self, step: int, **metrics: float) -> None:
        rec = {"step": int(step), "time": time.time() - self._start}
        rec.update({k: float(v) for k, v in metrics.items()})
        self.history.append(rec)
        if self._file:
            self._file.write(json.dumps(rec) + "\n")
            self._file.flush()
        if self.print_every and step % self.print_every == 0:
            parts = "  ".join(f"{k} {v:.4f}" for k, v in metrics.items())
            print(f"step {step:6d}  {parts}")

    def close(self) -> None:
        if self._file:
            self._file.close()
