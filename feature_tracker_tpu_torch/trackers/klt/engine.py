"""Shared Gauss-Newton iteration scaffold for the sparse LK trackers,
batched over features.

All lanes run up to ``max_iterations`` steps with a done mask; the break,
convergence and divergence semantics are those of the JAX package's
engine, so status codes match:

fast mode (divergence counter on):
  1. no valid pixel in the step -> break, state & status unchanged
  2. NaN step               -> NUMERIC_ERROR, break, state unchanged
  3. state <- updated state
  4. step didn't shrink max_tolerance_large_step consecutive times ->
     break (state already updated, status unchanged — stays
     LARGE_RESIDUAL)
  5. squared step < max_converge_step -> TRACKED, break
     (checked after divergence: a diverging final step never marks
     TRACKED)

direct/inverse mode: same minus the divergence counter, plus an optional
per-step break status computed on the updated state."""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from feature_tracker_tpu_torch.core.config import KltOptions
from feature_tracker_tpu_torch.core.status import TrackStatus


class StepResult(NamedTuple):
    """Output of one Gauss-Newton step for a batch of features."""

    num_valid: torch.Tensor     # [N] int: valid pixels used by this step
    v: torch.Tensor             # [N, D] step driving the convergence checks
    new_state: object           # [N, ...] tensor, or a tuple of them
    break_status: torch.Tensor  # [N] int8: 0 = none; else status to set


NO_BREAK = 0


def _tree_select(pred: torch.Tensor, on_true, on_false):
    """Lane-by-lane select over a tensor or a tuple of tensors whose first
    dimension is the feature."""
    if isinstance(on_true, (tuple, list)):
        return tuple(_tree_select(pred, a, b)
                     for a, b in zip(on_true, on_false))
    return torch.where(pred.reshape(pred.shape + (1,) * (on_true.dim() - 1)),
                       on_true, on_false)


def run_klt_iterations(
    step_fn: Callable[[object], StepResult],
    state0,
    status0: torch.Tensor,
    done0: torch.Tensor,
    opts: KltOptions,
    divergence_counter: bool,
):
    """Run the batched GN loop. The state is one ``[N, ...]`` tensor or a
    tuple of them (affine: ``(uv, affine)``; LSSD: ``(rot, t)``).

    Returns ``(final_state, final_status, steps)``; ``steps`` ``[N]`` counts
    the iterations each feature computed a step in (its work)."""
    state = state0
    status = status0.to(torch.int8)
    done = done0.clone()
    n = status.shape[0]
    dev = status.device
    last_sq = torch.full((n,), torch.inf, dtype=torch.float32, device=dev)
    cnt = torch.zeros((n,), dtype=torch.int32, device=dev)
    steps = torch.zeros((n,), dtype=torch.int32, device=dev)
    for _ in range(opts.max_iterations):
        if bool(done.all()):
            break  # later iterations change nothing
        steps += (~done).to(torch.int32)
        res = step_fn(state)
        no_valid = res.num_valid == 0
        isnan = torch.isnan(res.v).any(dim=-1)
        sq = (res.v * res.v).sum(dim=-1)

        do_update = ~(done | no_valid | isnan)
        state = _tree_select(do_update, res.new_state, state)

        if divergence_counter:
            shrink = sq < last_sq
            new_last = torch.where(shrink, sq, last_sq)
            new_cnt = torch.where(shrink, torch.zeros_like(cnt), cnt + 1)
            last_sq = torch.where(do_update, new_last, last_sq)
            cnt = torch.where(do_update, new_cnt, cnt)
            diverged = do_update & (cnt >= opts.max_tolerance_large_step)
        else:
            diverged = torch.zeros_like(done)

        extra_break = do_update & (res.break_status != NO_BREAK)
        converged = (do_update & (sq < opts.max_converge_step)
                     & ~diverged & ~extra_break)

        new_status = torch.where(
            isnan & ~(done | no_valid), int(TrackStatus.NUMERIC_ERROR),
            torch.where(extra_break, res.break_status,
                        torch.where(converged, int(TrackStatus.TRACKED),
                                    status)))
        status = torch.where(done, status, new_status)
        done = done | no_valid | isnan | diverged | converged | extra_break
    return state, status, steps


def final_outside_check(uv: torch.Tensor, status: torch.Tensor, image_shape):
    """Mark features whose final position left the full-resolution image:
    bounds are cols-1 / rows-1."""
    h, w = image_shape
    x = uv[..., 0]
    y = uv[..., 1]
    outside = (x < 0) | (x > w - 1) | (y < 0) | (y > h - 1)
    return torch.where(outside, int(TrackStatus.OUTSIDE), status)
