"""Building blocks of the layers: initializers, activations, dropout, Dense, MLP.

Counterpart of the JAX package's ``nn/module.py`` in PyTorch's idiom: layers
are ``torch.nn.Module``s that own their parameters, randomness comes from an
explicit ``torch.Generator``, and training mode is the module's own
``train()``/``eval()`` state. Modules create their parameters on the CUDA
device unless the caller passes another ``device``. Kernels keep the reference's ``[in, out]``
layout (``x @ kernel``), so parameter trees carry over without a transpose.
Every layer and model derives from :class:`Module`, which gives the
reference's config round-trip (``get_config`` / ``from_config``).
"""

from __future__ import annotations

import inspect
import math
from typing import Any, Callable

import torch
from torch import nn
from torch.nn import functional as F

__all__ = [
    "Module",
    "Dense",
    "MLP",
    "get_initializer",
    "get_activation",
    "dropout",
]


# Constructor arguments that say where and how a module is built, not what
# it is. The reference's ``init`` takes them (the input width, the key, the
# dtype), so its config has none of them.
_BUILD_ARGS = ("input_dim", "generator", "device", "dtype")


class Module(nn.Module):
    """Base of the port's layers and models: a ``torch.nn.Module`` whose
    constructor arguments, less the build arguments, are its config.

    A subclass calls ``self._keep_config(locals())`` right after
    ``super().__init__()``, before it binds a new local name (an argument it
    normalises first is recorded as normalised). ``get_config()`` then
    returns the reference's dict for the same
    arguments: ``class_name``, every field, tuples as lists, nested modules as
    their configs. ``from_config(config, *, input_dim, ...)`` rebuilds the
    module; the reference's config has no input width (its ``init`` takes
    one), so the caller passes it. Keys the constructor does not take are
    ignored, as the reference ignores them.
    """

    def _keep_config(self, args: dict[str, Any]) -> None:
        self._config = {k: v for k, v in args.items()
                        if k not in _BUILD_ARGS + ("self", "__class__")}

    def get_config(self) -> dict[str, Any]:
        cfg = {"class_name": type(self).__name__}
        for name, value in self._config.items():
            if isinstance(value, Module):
                value = value.get_config()
            elif isinstance(value, tuple):
                value = list(value)
            cfg[name] = value
        return cfg

    @classmethod
    def from_config(
        cls,
        config: dict[str, Any],
        *,
        input_dim: int | None = None,
        generator: torch.Generator | None = None,
        device: torch.device | str = "cuda",
        dtype: torch.dtype = torch.float32,
    ) -> "Module":
        params = inspect.signature(cls).parameters
        needs = params.get("input_dim")
        if (needs is not None and needs.default is inspect.Parameter.empty
                and input_dim is None):
            raise ValueError(f"{cls.__name__}.from_config needs input_dim=")
        kwargs = {k: v for k, v in config.items()
                  if k in params and k not in _BUILD_ARGS}
        build = {"input_dim": input_dim, "generator": generator,
                 "device": device, "dtype": dtype}
        kwargs.update({k: v for k, v in build.items() if k in params})
        return cls(**kwargs)


def _fans(shape) -> tuple[int, int]:
    if len(shape) < 2:
        return int(shape[0]), int(shape[0])
    receptive = math.prod(shape[:-2])
    return int(shape[-2] * receptive), int(shape[-1] * receptive)


def _variance_scaling(scale: float, mode: str, distribution: str):
    def init(shape, generator=None, dtype=torch.float32, device=None):
        fan_in, fan_out = _fans(shape)
        fan = {"fan_in": fan_in, "fan_out": fan_out,
               "fan_avg": (fan_in + fan_out) / 2}[mode]
        variance = scale / fan
        if distribution == "uniform":
            limit = math.sqrt(3.0 * variance)
            u = torch.rand(shape, generator=generator, dtype=dtype,
                           device=device)
            return (2.0 * u - 1.0) * limit
        # Truncated normal at two standard deviations, rescaled so the
        # variance of the truncated draw is the requested one.
        std = math.sqrt(variance) / 0.87962566103423978
        out = torch.empty(shape, dtype=dtype, device=device)
        nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=generator)
        return out * std

    return init


def _orthogonal(shape, generator=None, dtype=torch.float32, device=None):
    rows, cols = _fans(shape)
    a = torch.randn((max(rows, cols), min(rows, cols)), generator=generator,
                    dtype=torch.float32, device=device)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    if rows < cols:
        q = q.T
    return q.reshape(shape).to(dtype)


def _constant(value: float):
    def init(shape, generator=None, dtype=torch.float32, device=None):
        return torch.full(shape, value, dtype=dtype, device=device)

    return init


_INITIALIZERS: dict[str, Callable] = {
    "glorot_uniform": _variance_scaling(1.0, "fan_avg", "uniform"),
    "glorot_normal": _variance_scaling(1.0, "fan_avg", "normal"),
    "he_uniform": _variance_scaling(2.0, "fan_in", "uniform"),
    "he_normal": _variance_scaling(2.0, "fan_in", "normal"),
    "lecun_uniform": _variance_scaling(1.0, "fan_in", "uniform"),
    "lecun_normal": _variance_scaling(1.0, "fan_in", "normal"),
    "orthogonal": _orthogonal,
    "zeros": _constant(0.0),
    "ones": _constant(1.0),
}


def get_initializer(name_or_fn) -> Callable:
    """Resolve an initializer by Keras-style name, or pass a callable through.

    An initializer is ``fn(shape, generator=None, dtype=, device=) -> tensor``.
    Shapes with a zero-size dimension (a graph with 0 input features) give
    zeros instead of a division by a zero fan.
    """
    if callable(name_or_fn):
        base = name_or_fn
    else:
        name = str(name_or_fn)
        if name in _INITIALIZERS:
            base = _INITIALIZERS[name]
        elif name.startswith("constant:"):
            base = _constant(float(name.split(":", 1)[1]))
        else:
            raise ValueError(f"Unknown initializer: {name_or_fn!r}")

    def guarded(shape, generator=None, dtype=torch.float32, device=None):
        shape = tuple(int(s) for s in shape)
        if any(s == 0 for s in shape):
            return torch.zeros(shape, dtype=dtype, device=device)
        return base(shape, generator=generator, dtype=dtype, device=device)

    return guarded


_ACTIVATIONS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "relu": F.relu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "elu": F.elu,
    "selu": F.selu,
    "softplus": F.softplus,
    "swish": F.silu,
    "silu": F.silu,
    "leaky_relu": lambda x: F.leaky_relu(x, 0.01),
    "softmax": lambda x: F.softmax(x, dim=-1),
    "linear": lambda x: x,
}


def get_activation(name_or_fn):
    """Resolve an activation by Keras-style name, None -> identity."""
    if name_or_fn is None:
        return lambda x: x
    if callable(name_or_fn):
        return name_or_fn
    name = str(name_or_fn)
    if name in _ACTIVATIONS:
        return _ACTIVATIONS[name]
    raise ValueError(f"Unknown activation: {name_or_fn!r}")


def dropout(
    x: torch.Tensor,
    rate: float,
    training: bool,
    generator: torch.Generator | None = None,
    keep_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Inverted dropout: kept entries are scaled by ``1 / (1 - rate)``.

    Identity when ``training`` is false or ``rate <= 0``. The Bernoulli keep
    draw comes from ``generator`` (the default generator of ``x``'s device
    when None); ``keep_mask`` (bool, ``x``'s shape) replaces the draw, which
    lets a caller fix the randomness.
    """
    if not training or rate <= 0.0:
        return x
    keep = 1.0 - rate
    if keep_mask is None:
        keep_mask = torch.rand(
            x.shape, generator=generator, device=x.device
        ) < keep
    return torch.where(keep_mask, x / keep, torch.zeros_like(x))


class Dense(Module):
    """Affine transform ``x @ kernel (+ bias)`` with optional activation."""

    def __init__(
        self,
        units: int,
        *,
        input_dim: int,
        activation: str | None = None,
        use_bias: bool = True,
        kernel_initializer: str = "glorot_uniform",
        bias_initializer: str = "zeros",
        generator: torch.Generator | None = None,
        device: torch.device | str = "cuda",
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self._keep_config(locals())
        self.units = units
        self.input_dim = input_dim
        self.activation = activation
        self.kernel = nn.Parameter(
            get_initializer(kernel_initializer)(
                (input_dim, units), generator=generator, dtype=dtype,
                device=device,
            )
        )
        if use_bias:
            self.bias = nn.Parameter(
                get_initializer(bias_initializer)(
                    (units,), generator=generator, dtype=dtype, device=device
                )
            )
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = x @ self.kernel
        if self.bias is not None:
            out = out + self.bias
        return get_activation(self.activation)(out)


class MLP(Module):
    """Dense stack: hidden layers with activation (+dropout), linear output:
    ``[Dense(h, act) + Dropout]* + Dense(out, linear)``; sub-layers are named
    ``dense_0 .. dense_k``."""

    def __init__(
        self,
        hidden_dims: tuple[int, ...],
        output_dim: int,
        *,
        input_dim: int,
        activation: str | None = "relu",
        use_bias: bool = True,
        dropout_rate: float = 0.0,
        kernel_initializer: str = "glorot_uniform",
        bias_initializer: str = "zeros",
        generator: torch.Generator | None = None,
        device: torch.device | str = "cuda",
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self._keep_config(locals())
        self.dropout_rate = dropout_rate
        dims = tuple(hidden_dims) + (output_dim,)
        self.num_layers = len(dims)
        dim = input_dim
        for i, units in enumerate(dims):
            layer = Dense(
                units,
                input_dim=dim,
                activation=activation if i < len(dims) - 1 else None,
                use_bias=use_bias,
                kernel_initializer=kernel_initializer,
                bias_initializer=bias_initializer,
                generator=generator,
                device=device,
                dtype=dtype,
            )
            self.add_module(f"dense_{i}", layer)
            dim = units

    def forward(self, x, *, generator: torch.Generator | None = None):
        for i in range(self.num_layers):
            x = getattr(self, f"dense_{i}")(x)
            if i < self.num_layers - 1:  # dropout after hidden layers only
                x = dropout(x, self.dropout_rate, self.training, generator)
        return x
