from feature_tracker_tpu_torch.trackers.klt import AffineKlt, BasicKlt, LssdKlt

__all__ = ["AffineKlt", "BasicKlt", "LssdKlt"]
