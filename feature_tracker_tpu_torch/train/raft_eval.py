"""Optical-flow evaluation metrics for RAFT (and any dense-flow method) —
the counterpart of ``feature_tracker_tpu/train/raft_eval.py``.

Average end-point error (EPE), outlier fractions (>1 / >3 / >5 px) and the
KITTI Fl measure (>3 px AND >5% of the ground-truth magnitude).
"""

from __future__ import annotations

import torch


def endpoint_error(pred_flow, gt_flow, valid=None):
    """Per-pixel EPE ``[..., H, W]``; ``valid`` masks invalid gt."""
    epe = torch.sqrt(torch.sum((pred_flow - gt_flow) ** 2, dim=-1))
    if valid is not None:
        epe = torch.where(valid, epe, torch.zeros_like(epe))
    return epe


def flow_metrics(pred_flow, gt_flow, valid=None):
    """Summary metrics dict for ``[..., H, W, 2]`` flows.

    Returns epe (mean), px1/px3/px5 outlier fractions, and fl (KITTI
    outlier: >3 px and >5% of gt magnitude)."""
    epe = endpoint_error(pred_flow, gt_flow, valid)
    if valid is None:
        valid = torch.ones(epe.shape, dtype=torch.bool, device=epe.device)
    count = torch.clamp(valid.sum(), min=1)

    def frac(mask):
        return (mask & valid).sum() / count

    mag = torch.sqrt(torch.sum(gt_flow ** 2, dim=-1))
    return {
        "epe": epe.sum() / count,
        "px1": frac(epe > 1.0),
        "px3": frac(epe > 3.0),
        "px5": frac(epe > 5.0),
        "fl": frac((epe > 3.0) & (epe > 0.05 * mag)),
    }


def evaluate_raft(model, variables, ref, cur, gt_flow, valid=None):
    """Run RAFT and report :func:`flow_metrics` of the FINAL prediction (the
    RAFT protocol evaluates the last refinement iteration).

    ``model`` is a ``models.raft.Raft``; ``variables`` a ``state_dict`` that
    is loaded into it first (the model keeps it), or None for the model's
    own weights. ``gt_flow`` ``[..., H, W, 2]`` and ``valid`` ``[..., H,
    W]`` may be numpy arrays or tensors; they go to the prediction's
    device."""
    if variables is not None:
        model.load_state_dict(variables)
    with torch.no_grad():
        flow = model(ref, cur)[-1]
    gt_flow = torch.as_tensor(gt_flow, dtype=torch.float32, device=flow.device)
    if valid is not None:
        valid = torch.as_tensor(valid, dtype=torch.bool, device=flow.device)
    return flow_metrics(flow, gt_flow, valid)
