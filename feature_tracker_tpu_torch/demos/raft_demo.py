"""RAFT self-test demo — the port of ``demos/raft_demo.py``, analogue of
the reference's ``python3 src/nn_optical_flow_tracker/raft/model.py`` shape
check (reference: model.py:100-121, run.sh:1): 5x64x64 gray inputs, hidden
64, feature/context 128, 3 correlation levels, radius 3, 5 iterations, with
weights drawn as Flax's initializers do from seed 0; prints every
per-iteration prediction shape. Then the compact model on the shipped
``weights/raft_small.npz``: its EPE on a fresh synthetic-flow pair against
the zero-flow baseline. Both take the all-pairs correlation route.

    python -m feature_tracker_tpu_torch.demos.raft_demo [--device cpu]
"""

from __future__ import annotations

import os

import numpy as np
import torch

from feature_tracker_tpu_torch.core.device import resolve_device
from feature_tracker_tpu_torch.demos import _common
from feature_tracker_tpu_torch.models.layers import flax_init_
from feature_tracker_tpu_torch.models.raft import Raft, RaftConfig
from feature_tracker_tpu_torch.train.raft_pretrain import (
    synthetic_flow_sample,
)
from feature_tracker_tpu_torch.utils import report_info, time_jitted
from feature_tracker_tpu_torch.utils.weights import load_raft_npz, weights_path


def inputs():
    """The demo's inputs: the random 5x64x64 pair of the shape check
    (``default_rng(0)``) and the synthetic-flow sample ``(ref, cur, flow)``
    of the EPE check (``default_rng(77)``)."""
    rng = np.random.default_rng(0)
    ref = rng.uniform(0, 255, (5, 64, 64, 1)).astype(np.float32)
    cur = rng.uniform(0, 255, (5, 64, 64, 1)).astype(np.float32)
    sample = synthetic_flow_sample(np.random.default_rng(77), 64, 64,
                                   augment=False)
    return ref, cur, sample


def run(ref, cur, sample, *, iters=5, device="cuda", out_dir=None) -> dict:
    """The shape check on ``ref`` / ``cur`` ``[B, H, W, 1]`` through
    ``time_jitted`` (one warm-up call and ``iters`` timed ones), then the
    trained compact model on ``sample``. Returns ``shapes`` (one per
    iteration), ``ms``, ``first_ms``, and ``epe``, ``zero_epe`` and
    ``flow`` (None without ``weights/raft_small.npz``). ``out_dir`` is
    accepted for the demos' common signature: this demo writes no PNG."""
    del out_dir
    dev = resolve_device(device)
    report_info(">> Test RAFT (shape self-check parity with reference).")
    cfg = RaftConfig(max_iterations=5)
    model = flax_init_(Raft(cfg, device=dev), 0)

    ref_t, cur_t = (torch.as_tensor(x, device=dev) for x in (ref, cur))
    flows, stats = time_jitted(model, ref_t, cur_t, iters=iters)
    shapes = [tuple(flows[i].shape) for i in range(flows.shape[0])]
    for i, shape in enumerate(shapes):
        report_info(f"prediction {i}: shape {shape}")
    report_info(f"RAFT forward {stats['mean_ms']:.2f} ms/call steady state "
                f"({stats['compile_ms']:.0f} ms first call).")
    out = {"shapes": shapes, "ms": stats["mean_ms"],
           "first_ms": stats["compile_ms"], "epe": None, "zero_epe": None,
           "flow": None}

    # Trained-weights accuracy check (weights/raft_small.npz from
    # train/raft_pretrain.py small=1 — the compact config that converges
    # within the short budget; the full config's run is recorded in
    # weights/metrics.json): EPE on a fresh synthetic-flow pair.
    wpath = weights_path("raft_small.npz")
    if not os.path.exists(wpath):
        report_info("No trained RAFT weights "
                    "(run train/raft_pretrain.py small=1); "
                    "skipping EPE check.")
        return out
    tcfg = RaftConfig(max_iterations=6, feature_channels=64,
                      context_channels=64, hidden_channels=32,
                      correlation_pyramid_levels=2, correlation_radius=3,
                      correlation_hidden_channels=32,
                      correlation_out_channels=16,
                      flow_hidden_channels=16, flow_out_channels=8,
                      motion_out_channels=16, mask_hidden_channels=32)
    tmodel = Raft(tcfg, device=dev)
    tmodel.load_state_dict(load_raft_npz(wpath, tcfg))
    rimg, cimg, gt = sample
    preds = tmodel(rimg[None, ..., None], cimg[None, ..., None])
    gt_t = torch.as_tensor(gt, device=dev)
    epe = float(torch.linalg.norm(preds[-1][0] - gt_t, dim=-1).mean())
    zero = float(np.linalg.norm(gt, axis=-1).mean())
    report_info(f"Trained RAFT EPE on a fresh synthetic pair: "
                f"{epe:.2f} px (zero-flow baseline "
                f"{zero:.2f} px).")
    out.update(epe=epe, zero_epe=zero, flow=preds[-1][0].cpu().numpy())
    return out


def main():
    args = _common.parse_args(__doc__)
    run(*inputs(), device=args.device, out_dir=args.out)


if __name__ == "__main__":
    main()
