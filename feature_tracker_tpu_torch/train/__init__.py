"""Training and evaluation of the port's models: RAFT's trainers
(``raft_train``, ``raft_pretrain``), the checkpoint, the SuperPoint, DISK
and LightGlue trainers, the multi-stage pretraining driver (``pretrain``),
CoTracker's pretraining (``cotracker_pretrain``), and the flow metrics
(``raft_eval``)."""

from feature_tracker_tpu_torch.train.raft_train import (
    RaftTrainConfig,
    TrainState,
    create_train_state,
    make_train_step,
    sequence_loss,
)

__all__ = [
    "RaftTrainConfig",
    "TrainState",
    "create_train_state",
    "make_train_step",
    "sequence_loss",
]
