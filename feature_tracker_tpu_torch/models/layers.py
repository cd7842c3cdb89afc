"""Flax layers the neural models share, on ``[..., C]`` tensors.

``Dense`` and ``LayerNorm`` keep Flax's numerics where PyTorch's defaults
differ: ``LayerNorm``'s epsilon is 1e-6 (torch's 1e-5), ``gelu`` is the tanh
approximation (``flax.linen.gelu``; torch's default is erf), and a division
by a constant goes through a 0-dim tensor on the data's device, which is a
true division on the card too (a division by a Python float there
multiplies by a rounded reciprocal).

Parameters are float32. ``Dense`` casts them and its input to ``dtype`` for
the product, as Flax's ``dtype`` does; the convolutions are
``models/raft.py::Conv``. For the trainers: ``flax_init_`` draws a
model's weights as Flax's default initializers do, ``flax_order`` puts a
``state_dict``'s entries in the order JAX flattens the Flax variables
tree, and ``abs_like_jax`` and ``clip_like_jax`` keep JAX's gradients at
ties.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn


def divide(x, c: float):
    """``x / c`` as a true division on any device."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def abs_like_jax(x):
    """``jnp.abs`` with JAX's gradient at 0, which is 1 (``torch.abs``
    passes 0 there)."""
    return torch.where(x >= 0, x, -x)


def clip_like_jax(x, lo: float, hi: float):
    """``jnp.clip``: ``minimum(maximum(x, lo), hi)``, which passes half the
    gradient at either bound (``torch.clamp`` passes all of it)."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


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


# Flax's lecun_normal: a normal truncated to two standard deviations, scaled
# so that the truncated draw has variance 1 / fan_in.
_TRUNCATED_STD = 0.87962566103423978


def _generator(rng) -> torch.Generator:
    if isinstance(rng, torch.Generator):
        return rng
    return torch.Generator().manual_seed(int(rng))


@torch.no_grad()
def flax_init_(module: nn.Module, rng) -> nn.Module:
    """Draw ``module``'s weights as Flax's default initializers do, from
    ``rng`` (an int seed or a CPU ``torch.Generator``), in place:
    convolution and ``Dense`` kernels from ``lecun_normal`` (a normal
    truncated at two standard deviations, variance ``1 / fan_in``), biases
    0, normalisation scales 1, running means 0 and variances 1. Kernels
    are drawn in the order of ``module.named_modules()``."""
    gen = _generator(rng)
    for sub in module.modules():
        if isinstance(sub, (nn.Conv2d, nn.Linear)):
            w = sub.weight
            fan_in = w[0].numel()          # in * kh * kw, or in
            std = math.sqrt(1.0 / fan_in) / _TRUNCATED_STD
            draw = torch.empty(w.shape, dtype=torch.float32)
            nn.init.trunc_normal_(draw, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=gen)
            w.copy_(draw)
            if sub.bias is not None:
                sub.bias.zero_()
        elif isinstance(sub, (nn.BatchNorm2d, nn.LayerNorm)):
            sub.weight.fill_(1.0)
            sub.bias.zero_()
            if isinstance(sub, nn.BatchNorm2d):
                sub.running_mean.zero_()
                sub.running_var.fill_(1.0)
    return module


def _flax_path(key: str) -> tuple:
    """The Flax path of a ``state_dict`` key: running statistics in
    ``batch_stats``, the rest in ``params`` (``weight`` sorts after
    ``bias`` as ``kernel`` and ``scale`` do)."""
    *parts, leaf = key.split(".")
    if leaf.startswith("running_"):
        return ("batch_stats", *parts, leaf[len("running_"):])
    return ("params", *parts, leaf)


def flax_order(state: dict) -> dict:
    """``state``'s entries, without ``num_batches_tracked``, in the order
    JAX flattens the matching Flax variables tree (keys sorted at every
    level, ``batch_stats`` before ``params``)."""
    keys = [k for k in state if not k.endswith("num_batches_tracked")]
    return {k: state[k] for k in sorted(keys, key=_flax_path)}
