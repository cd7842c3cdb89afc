"""Per-feature track status codes.

The same five int8 codes as ``feature_tracker_tpu.core.status``; stored as
``torch.int8`` tensors ``[N]``.
"""

import enum

import torch


class TrackStatus(enum.IntEnum):
    NOT_TRACKED = 0
    TRACKED = 1
    LARGE_RESIDUAL = 2
    OUTSIDE = 3
    NUMERIC_ERROR = 4


STATUS_DTYPE = torch.int8


def fresh_status(n: int, device=None) -> torch.Tensor:
    """Status tensor for features that have not been tracked yet."""
    return torch.full((n,), int(TrackStatus.NOT_TRACKED), dtype=STATUS_DTYPE,
                      device=device)


def is_failed(status: torch.Tensor) -> torch.Tensor:
    """Features with status > TRACKED are not re-tracked on later calls."""
    return status > int(TrackStatus.TRACKED)
