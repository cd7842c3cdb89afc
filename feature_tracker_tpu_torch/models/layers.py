"""Flax layers the neural models share, on ``[..., C]`` tensors.

``Dense`` and ``LayerNorm`` keep Flax's numerics where PyTorch's defaults
differ: ``LayerNorm``'s epsilon is 1e-6 (torch's 1e-5), ``gelu`` is the tanh
approximation (``flax.linen.gelu``; torch's default is erf), and a division
by a constant goes through a 0-dim tensor on the data's device, which is a
true division on the card too (a division by a Python float there
multiplies by a rounded reciprocal).

Parameters are float32. ``Dense`` casts them and its input to ``dtype`` for
the product, as Flax's ``dtype`` does; the convolutions are
``models/raft.py::Conv``.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn


def divide(x, c: float):
    """``x / c`` as a true division on any device."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def gelu(x):
    """Flax's ``gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


class Dense(nn.Linear):
    """Flax ``Dense`` on ``[..., in_features]``; the product in ``dtype``."""

    def __init__(self, in_features, features, bias=True,
                 dtype=torch.float32):
        super().__init__(in_features, features, bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class LayerNorm(nn.LayerNorm):
    """Flax ``LayerNorm`` (epsilon 1e-6) over the last axis, computed in
    float32 and returned in the input's dtype."""

    def __init__(self, features):
        super().__init__(features, eps=1e-6)

    def forward(self, x):
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight,
                         self.bias, self.eps)
        return y.to(x.dtype)


@contextlib.contextmanager
def seeded_init(rng):
    """Module initialisation inside the block draws from ``rng`` (an int
    seed or a ``torch.Generator``); the global generator is restored after
    it. Build the modules on the CPU inside the block."""
    if isinstance(rng, torch.Generator):
        rng = int(torch.randint(2 ** 62, (), generator=rng))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(int(rng))
        yield
