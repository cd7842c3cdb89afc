"""Dense Farneback optical-flow demo — the port of
``demos/dense_flow_demo.py`` (reference:
test/test_dense_optical_flow.cpp:18-69): 5-level pyramid, half-patch 2, 20
iterations; flow vectors visualized on a 15-pixel grid.

    python -m feature_tracker_tpu_torch.demos.dense_flow_demo [--device cpu]
"""

from __future__ import annotations

import numpy as np

from feature_tracker_tpu_torch.core.device import resolve_device
from feature_tracker_tpu_torch.demos import _common
from feature_tracker_tpu_torch.ops.pyramid import build_pyramid
from feature_tracker_tpu_torch.trackers.dense import (
    DenseFlowOptions,
    DenseOpticalFlow,
)
from feature_tracker_tpu_torch.utils import report_info, time_jitted
from feature_tracker_tpu_torch.utils.viz import render_dense_flow


def run(ref, cur, source="synthetic", *, iters=5, device="cuda",
        out_dir=None) -> dict:
    """Farnebäck flow from ``ref`` to ``cur`` through ``time_jitted`` (one
    warm-up call and ``iters`` timed ones). Returns ``flow`` ``[2, H, W]``
    (row flow, column flow), ``mean_abs``, ``ms``, ``first_ms`` and
    ``png``."""
    dev = resolve_device(device)
    report_info(f">> Test dense optical flow ({source} imagery).")

    ref_pyr = build_pyramid(ref, 5, quantize=False, device=dev)
    cur_pyr = build_pyramid(cur, 5, quantize=False, device=dev)
    flowper = DenseOpticalFlow(DenseFlowOptions(half_patch_size=2,
                                                max_iterations=20),
                               device=dev)
    flow, stats = time_jitted(flowper.track, ref_pyr, cur_pyr, iters=iters)
    flow = flow.cpu().numpy()
    mean_abs = float(np.abs(flow).mean())
    report_info(f"Dense flow {ref.shape[1]}x{ref.shape[0]}: "
                f"{stats['mean_ms']:.2f} ms/frame steady state "
                f"({stats['compile_ms']:.0f} ms first call); "
                f"mean |flow| = {mean_abs:.3f} px.")

    png = {"dense_flow_vectors.png": render_dense_flow(cur, flow, step=15)}
    _common.save_pngs(png, out_dir)
    return {"flow": flow, "mean_abs": mean_abs, "ms": stats["mean_ms"],
            "first_ms": stats["compile_ms"], "png": png}


def main():
    args = _common.parse_args(__doc__)
    ref, cur, source = _common.load_optical_flow_pair()
    run(ref, cur, source, device=args.device, out_dir=args.out)


if __name__ == "__main__":
    main()
