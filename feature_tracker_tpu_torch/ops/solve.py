"""Closed-form 2x2 solve for per-feature Gauss-Newton steps.

A singular H yields non-finite steps, which the iteration scaffold turns
into NUMERIC_ERROR."""

from __future__ import annotations

import torch


def solve2x2(h00, h01, h11, b0, b1):
    """Closed-form solve of the symmetric 2x2 system H v = b.

    Batched over any leading shape; returns ``[..., 2]``. The expression
    order is that of the JAX package, so ``det`` and both numerators round
    the same way."""
    det = h00 * h11 - h01 * h01
    v0 = (h11 * b0 - h01 * b1) / det
    v1 = (h00 * b1 - h01 * b0) / det
    return torch.stack([v0, v1], dim=-1)
