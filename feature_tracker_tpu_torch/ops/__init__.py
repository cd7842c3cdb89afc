from feature_tracker_tpu_torch.ops.interp import (
    bilinear_sample,
    extract_const_weight_patch,
    inner_gradients,
)
from feature_tracker_tpu_torch.ops.pyramid import build_pyramid
from feature_tracker_tpu_torch.ops.solve import solve2x2, solve_sym

__all__ = [
    "bilinear_sample",
    "extract_const_weight_patch",
    "inner_gradients",
    "build_pyramid",
    "solve2x2",
    "solve_sym",
]
