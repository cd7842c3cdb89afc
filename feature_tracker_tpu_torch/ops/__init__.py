from feature_tracker_tpu_torch.ops.pyramid import build_pyramid
from feature_tracker_tpu_torch.ops.solve import solve2x2

__all__ = [
    "build_pyramid",
    "solve2x2",
]
