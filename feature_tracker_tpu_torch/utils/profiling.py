"""Tracing, stage timing and failure detection.

``trace()`` records a ``torch.profiler`` trace (CPU and, where present,
CUDA activity) for TensorBoard; ``StageTimer`` sums per-stage wall times,
synchronising the device of a given tensor at the end of a stage so
asynchronous launches are not misattributed; ``assert_finite`` is the
NaN / Inf guard at tracker level.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from feature_tracker_tpu_torch.utils.timer import _leaves, _sync


@contextlib.contextmanager
def trace(log_dir: str):
    """Record a torch.profiler trace into ``log_dir`` (view it with
    TensorBoard's profiler plugin)."""
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


class StageTimer:
    """Accumulate per-stage wall time; ``stage(name, sync=x)`` waits at the
    end of the stage for the devices of the tensors in ``x``."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                _sync(sync)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> dict:
        return {name: {"total_ms": 1e3 * tot,
                       "mean_ms": 1e3 * tot / self.counts[name],
                       "count": self.counts[name]}
                for name, tot in self.totals.items()}


def assert_finite(tree, name: str = "value"):
    """Raise ``FloatingPointError`` naming the first leaf (a tensor or a
    numpy array, in nested dicts, lists and tuples) that holds NaN or Inf.
    Reading a CUDA tensor synchronises its device."""
    for path, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            bad = leaf.is_floating_point() and not bool(
                torch.isfinite(leaf).all())
        else:
            arr = np.asarray(leaf)
            bad = (np.issubdtype(arr.dtype, np.floating)
                   and not np.isfinite(arr).all())
        if bad:
            raise FloatingPointError(f"non-finite values in {name}{path}")
    return tree
