"""Neural models of the port (inference).

``__all__`` is the JAX package's; the port's own CoTracker2
(``models/cotracker2.py``, which the JAX package does not have) is
importable from here beside it."""

from feature_tracker_tpu_torch.models.cotracker2 import (
    CoTracker2,
    CoTracker2Config,
    CoTracker2Online,
)
from feature_tracker_tpu_torch.models.raft import Raft, RaftConfig

__all__ = ["Raft", "RaftConfig"]
