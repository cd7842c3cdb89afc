from feature_tracker_tpu_torch.match.matcher import (
    MatcherOptions,
    cosine_distance_matrix,
    fill_matched_pixels,
    force_match,
    hamming_distance_matrix,
    nearby_match,
)
from feature_tracker_tpu_torch.match.brief import (
    compute_brief,
    pack_bits,
)

__all__ = [
    "MatcherOptions",
    "cosine_distance_matrix",
    "hamming_distance_matrix",
    "force_match",
    "nearby_match",
    "fill_matched_pixels",
    "compute_brief",
    "pack_bits",
]
