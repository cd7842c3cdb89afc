"""Wall-clock timers.

``TickTock`` is the reference's stopwatch: construct, work, and
``tock_tick_ms`` returns the elapsed milliseconds and restarts the clock.
``time_jitted`` (the JAX package's name) times a callable on an
asynchronous device: it synchronises the CUDA devices its outputs live on,
and separates the warm-up calls (which include any kernel build) from the
steady-state calls.
"""

from __future__ import annotations

import time

import torch


class TickTock:
    """Millisecond stopwatch; construction starts the clock."""

    def __init__(self):
        self._t0 = time.perf_counter()

    def tick(self) -> None:
        self._t0 = time.perf_counter()

    def tock_ms(self) -> float:
        """Elapsed milliseconds since the last tick (the clock runs on)."""
        return (time.perf_counter() - self._t0) * 1e3

    def tock_tick_ms(self) -> float:
        """Elapsed milliseconds since the last tick, then restart."""
        now = time.perf_counter()
        ms = (now - self._t0) * 1e3
        self._t0 = now
        return ms


def _leaves(tree, path=""):
    """``(path, leaf)`` of nested dicts, lists and tuples; a path reads
    like JAX's key strings: ``['x'][0]``."""
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _leaves(value, f"{path}[{key!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            yield from _leaves(value, f"{path}[{i}]")
    else:
        yield path, tree


def _sync(out):
    """Wait for every CUDA device that holds a tensor of ``out``."""
    for dev in {leaf.device for _, leaf in _leaves(out)
                if isinstance(leaf, torch.Tensor) and leaf.is_cuda}:
        torch.cuda.synchronize(dev)
    return out


def time_jitted(fn, *args, iters: int = 10, warmup: int = 1):
    """Time a callable correctly on an asynchronous device.

    Returns (last_output, stats) where stats has ``compile_ms`` (the mean
    of the warm-up calls, which include any kernel build) and ``mean_ms``
    over ``iters`` steady-state calls, synchronised at the end.
    """
    t = TickTock()
    out = None
    for _ in range(max(warmup, 1)):
        out = _sync(fn(*args))
    compile_ms = t.tock_tick_ms() / max(warmup, 1)

    t.tick()
    for _ in range(iters):
        out = fn(*args)
    _sync(out)
    mean_ms = t.tock_ms() / iters
    return out, {"compile_ms": compile_ms, "mean_ms": mean_ms}
