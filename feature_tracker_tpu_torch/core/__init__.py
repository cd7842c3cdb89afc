from feature_tracker_tpu_torch.core.status import TrackStatus
from feature_tracker_tpu_torch.core.config import (
    KltOptions,
    KltMethod,
)

__all__ = ["TrackStatus", "KltOptions", "KltMethod"]
