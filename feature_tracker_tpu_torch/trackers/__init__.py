from feature_tracker_tpu_torch.trackers.klt import AffineKlt, BasicKlt, LssdKlt

__all__ = ["BasicKlt", "AffineKlt", "LssdKlt"]
