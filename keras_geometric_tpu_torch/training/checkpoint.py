"""Checkpointing: a train state and the model's config in one directory.

Counterpart of the JAX package's ``training/checkpoint.py``, which writes the
``TrainState`` pytree with orbax: here ``torch.save`` writes ``state.pt``
(the state's ``state_dict()``: the model's parameters, the optimizer's
moments, the step and the generator's state) and ``model_config.json`` sits
beside it. The file holds only tensors, ints, floats, strings, lists and
dicts, so it loads under ``torch.load(weights_only=True)``.
"""

from __future__ import annotations

import json
import os
from typing import Any

import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "save_config", "load_config"]

STATE_FILE = "state.pt"


def save_checkpoint(path: str, state: Any, *, config: dict | None = None) -> None:
    """Write a :class:`TrainState` (anything with ``state_dict()``) or a
    nested dict of tensors to the directory ``path``."""
    os.makedirs(path, exist_ok=True)
    payload = state.state_dict() if hasattr(state, "state_dict") else state
    torch.save(payload, os.path.join(path, STATE_FILE))
    if config is not None:
        save_config(os.path.join(path, "model_config.json"), config)


def restore_checkpoint(path: str, target: Any | None = None) -> Any:
    """Read a checkpoint written by :func:`save_checkpoint`.

    With a ``target`` (a :class:`TrainState` of the same model and optimizer
    types) the state is loaded into it, on its devices, and returned;
    without one the saved dict comes back, its tensors on the CPU.
    """
    payload = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                         weights_only=True)
    if target is None:
        return payload
    target.load_state_dict(payload)
    return target


def save_config(path: str, config: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(config, f, indent=2, default=str)


def load_config(path: str) -> dict:
    with open(path) as f:
        return json.load(f)
