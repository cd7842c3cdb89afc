"""Timing of the basic-KLT kernels at the headline shape.

The port of ``scripts/time_klt_modes.py``.

``mode`` is ``fast`` (or ``identity``, the name of the TPU kernel's default
formulation) for the FAST kernel (``csrc/klt_fast.cu`` through
``ops/cuda_klt.py::track_pyramid_fast_cuda``), or ``direct`` / ``inverse``
for the DIRECT / INVERSE kernel (``csrc/klt_iter.cu`` through
``track_pyramid_iter_cuda``): 10240 features uniform 20 px inside the
752x480 pair, on 4-level pyramids, one launch per call. Prints one JSON
line: the mode, ms per call (``_timing.py``), the features tracked, the
kernel's launches per call and the card.

Departures from the JAX script:
  - ``qpf``, ``qdt``, ``qdtv`` and ``slow`` name other formulations of the
    bias term inside the TPU kernel's body; the CUDA kernel has one, so
    these names raise a ``ValueError`` instead of timing it again;
  - JAX's second argument, ``batch``, is the TPU kernel's features per grid
    step, a tile with no CUDA counterpart (one warp tracks one feature):
    given, it raises a ``ValueError``;
  - without the reference's pair (``FTK_DATA``, where the demos read it)
    the synthetic pair of ``klt_multipair.py`` stands in, and the output's
    ``source`` says which was used (the JAX script has no fallback).

    python -m feature_tracker_tpu_torch.scripts.time_klt_modes MODE \
        [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from feature_tracker_tpu_torch.core.config import KltMethod, KltOptions
from feature_tracker_tpu_torch.core.device import resolve_device
from feature_tracker_tpu_torch.ops.cuda_klt import (
    track_pyramid_fast_cuda,
    track_pyramid_iter_cuda,
)
from feature_tracker_tpu_torch.ops.pyramid import build_pyramid
from feature_tracker_tpu_torch.scripts._timing import (
    best_ms,
    device_fields,
    weights_unchanged,
)
from feature_tracker_tpu_torch.scripts.klt_multipair import reference_pair

MODES = {"fast": KltMethod.FAST, "identity": KltMethod.FAST,
         "direct": KltMethod.DIRECT, "inverse": KltMethod.INVERSE}
TPU_ONLY_MODES = ("qpf", "qdt", "qdtv", "slow")


def klt_inputs(n=10240, levels=4, device="cuda"):
    """``(ref_pyr, cur_pyr, uv, source)``: the pair's pyramids and ``n``
    float32 features uniform in [20, dim - 20], from ``default_rng(0)``."""
    dev = resolve_device(device)
    ref, cur, source = reference_pair()
    rng = np.random.default_rng(0)
    uv = np.stack([rng.uniform(20, ref.shape[1] - 20, n),
                   rng.uniform(20, ref.shape[0] - 20, n)],
                  -1).astype(np.float32)
    return (build_pyramid(ref, levels, device=dev),
            build_pyramid(cur, levels, device=dev),
            torch.as_tensor(uv, device=dev), source)


def run(mode, batch=None, *, n=10240, iters=5, rounds=3, device="cuda"):
    """Time one kernel ``mode`` at ``n`` features; returns the printed
    dict."""
    if mode in TPU_ONLY_MODES:
        raise ValueError(
            f"mode {mode!r} is a formulation of the bias term inside the TPU "
            "kernel; the CUDA kernel has one formulation, timed as 'fast'")
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {sorted(MODES)}")
    if batch is not None:
        raise ValueError(
            "batch is the TPU kernel's features per grid step, a tile the "
            "CUDA kernels do not have (one warp tracks one feature)")
    rp, cp, uv, source = klt_inputs(n, device=device)
    dev = uv.device
    skip = torch.zeros(n, dtype=torch.bool, device=dev)
    opts = KltOptions(max_track_points=n, method=MODES[mode])
    if opts.method == KltMethod.FAST:
        wrapper = track_pyramid_fast_cuda

        def track():
            return track_pyramid_fast_cuda(opts, rp, cp, uv, uv, skip)
    else:
        wrapper = track_pyramid_iter_cuda
        st0 = torch.zeros(n, dtype=torch.int8, device=dev)

        def track():
            return track_pyramid_iter_cuda(opts, rp, cp, uv, uv, st0, skip)

    def step():
        out_uv, st = track()
        return out_uv.sum() + st.sum()

    before = wrapper.launches
    _, st = track()
    launches = wrapper.launches - before
    tracked = int((st == 1).sum())
    ms, _ = best_ms(step, dev, iters, rounds)
    return {"mode": mode, "ms": ms, "tracked": tracked,
            "launches_per_call": launches, "n": n, "source": source,
            **device_fields(dev)}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("mode", help=f"one of {sorted(MODES)}; "
                        f"{', '.join(TPU_ONLY_MODES)} raise (TPU kernel "
                        "only)")
    parser.add_argument("batch", nargs="?", type=int, default=None,
                        help="refused: the TPU kernel's features per grid "
                             "step, which the CUDA kernels do not have")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda)")
    args = parser.parse_args(argv)
    with weights_unchanged():
        out = run(args.mode, args.batch, device=args.device)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
