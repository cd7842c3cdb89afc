"""Frozen, hashable config dataclasses.

Field names and defaults are those of ``feature_tracker_tpu.core.config``,
so options cross between the two packages by field name
(:func:`feature_tracker_tpu_torch.convert.options_from_jax`).
"""

from __future__ import annotations

import dataclasses
import enum


class KltMethod(enum.Enum):
    """Solver mode for the sparse LK trackers."""

    INVERSE = "inverse"
    DIRECT = "direct"
    FAST = "fast"


@dataclasses.dataclass(frozen=True)
class KltOptions:
    """Options shared by all sparse LK trackers."""

    max_track_points: int = 500
    max_iterations: int = 15
    max_tolerance_large_step: int = 3
    patch_row_half_size: int = 6
    patch_col_half_size: int = 6
    max_converge_step: float = 4e-2  # compared against SQUARED step norm
    method: KltMethod = KltMethod.FAST
    # Declares the tracked images integer-valued (build_pyramid's
    # quantize=True output). The CUDA sampler reads float32 images
    # directly and needs no split for it; the field is kept so options
    # carry over unchanged from the JAX package.
    integer_pyramid: bool = True

    @property
    def patch_rows(self) -> int:
        return 2 * self.patch_row_half_size + 1

    @property
    def patch_cols(self) -> int:
        return 2 * self.patch_col_half_size + 1

    @property
    def ex_patch_rows(self) -> int:
        # Extended patch adds a 1-pixel border for central differences.
        return self.patch_rows + 2

    @property
    def ex_patch_cols(self) -> int:
        return self.patch_cols + 2


@dataclasses.dataclass(frozen=True)
class HarrisOptions:
    """Shi-Tomasi/Harris corner detection options."""

    min_feature_distance: int = 25
    min_valid_response: float = 40.0
    # Number of local-max candidates considered before radius suppression.
    max_candidates: int = 4096
    # Half window of the box filter over the structure tensor.
    window_half_size: int = 1


@dataclasses.dataclass(frozen=True)
class PyramidOptions:
    levels: int = 4
    # Truncate every level to integers after the 2x2 mean (uint8
    # arithmetic of the reference pyramid).
    quantize: bool = True
