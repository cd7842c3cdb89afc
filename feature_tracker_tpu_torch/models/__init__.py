"""Neural models of the port (inference)."""

from feature_tracker_tpu_torch.models.raft import Raft, RaftConfig

__all__ = ["Raft", "RaftConfig"]
