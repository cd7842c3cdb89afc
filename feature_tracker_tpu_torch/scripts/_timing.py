"""Timing protocol of the port's scripts, the card they ran on, and a guard
that they leave ``weights/`` as it was.

The JAX scripts time a jitted call through a scalar checksum, perturb its
input on the device so no call is memoised, and subtract a dispatch floor
measured on a trivial program. On the card, CUDA events time the device
stream between two points, so neither the perturbation nor the floor has a
meaning there: :func:`best_ms` times back-to-back calls between two events
after a warm-up call, and keeps the warm-up call's checksum, which is what
a caller holds the computation to. On the CPU it times with the host's
clock, and :func:`device_fields` says so in every result.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import subprocess
import time

import torch

from feature_tracker_tpu_torch.utils.weights import WEIGHTS_DIR


def best_ms(fn, device, iters: int = 3, rounds: int = 3):
    """``(ms, checksum)``: the least over ``rounds`` of the mean time of
    ``iters`` back-to-back ``fn()`` calls, in ms, after one warm-up call,
    and the warm-up call's checksum (``fn`` returns a 0-dim tensor). On a
    CUDA device the calls are timed by CUDA events on the current stream,
    elsewhere by the host's clock."""
    checksum = float(fn())
    best = float("inf")
    for _ in range(rounds):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            ms = (time.perf_counter() - t0) * 1e3
        best = min(best, ms / iters)
    return best, checksum


def device_fields(device) -> dict:
    """What a result names its run by: ``card``, the card's name and power
    limit as ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    gives them (``"cpu"`` off the card), and ``clock``, what
    :func:`best_ms` timed with."""
    if device.type != "cuda":
        return {"card": "cpu",
                "clock": "host clock (a CPU run: no device time)"}
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return {"card": out.strip().splitlines()[0], "clock": "cuda events"}


def weights_digest() -> dict:
    """sha256 of every file under the repository's ``weights/``."""
    out = {}
    for base, _, names in os.walk(WEIGHTS_DIR):
        for name in names:
            path = os.path.join(base, name)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, WEIGHTS_DIR)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


@contextlib.contextmanager
def weights_unchanged():
    """Raise after the block if any file under ``weights/`` was added,
    removed or changed inside it: no script of the port writes there."""
    before = weights_digest()
    yield
    after = weights_digest()
    if after != before:
        changed = sorted(set(after.items()) ^ set(before.items()))
        raise RuntimeError(f"weights/ changed during the run: {changed}")
