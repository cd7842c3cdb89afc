from feature_tracker_tpu_torch.trackers.klt import BasicKlt

__all__ = ["BasicKlt"]
