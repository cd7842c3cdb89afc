"""Neural feature matcher front end (NNFeatureMatcher equivalent) — the
counterpart of ``feature_tracker_tpu/match/nn_matcher.py``.

 - 4 model variants: SuperPoint/DISK descriptors x score-matrix/fused
   output — one LightGlue with the descriptor dim and output mode as config
 - Options kMaxNumberOfMatches=300, kMinValidMatchScore=-3.0
 - ``initialize()`` runs a warm-up inference on kMaxNumberOfMatches zeroed
   descriptors
 - ``match()`` post-processing: status starts at LARGE_RESIDUAL, the
   matched position starts as a copy of the current position; matched
   entries become TRACKED.

Fixed-capacity arrays + valid masks, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import enum
import os

import torch

from feature_tracker_tpu_torch.core.status import STATUS_DTYPE, TrackStatus
from feature_tracker_tpu_torch.models.layers import seeded_init
from feature_tracker_tpu_torch.models.lightglue import (
    LightGlue,
    LightGlueConfig,
    fused_match_list,
    mutual_argmax_matches,
)
from feature_tracker_tpu_torch.utils.profiling import span


class NNMatcherModelType(enum.Enum):
    LIGHTGLUE_SUPERPOINT_SCORE_MAT = 0
    LIGHTGLUE_SUPERPOINT_MATCHES = 1
    LIGHTGLUE_DISK_SCORE_MAT = 2
    LIGHTGLUE_DISK_MATCHES = 3


_DESC_DIM = {
    NNMatcherModelType.LIGHTGLUE_SUPERPOINT_SCORE_MAT: 256,
    NNMatcherModelType.LIGHTGLUE_SUPERPOINT_MATCHES: 256,
    NNMatcherModelType.LIGHTGLUE_DISK_SCORE_MAT: 128,
    NNMatcherModelType.LIGHTGLUE_DISK_MATCHES: 128,
}

_FUSED = {
    NNMatcherModelType.LIGHTGLUE_SUPERPOINT_MATCHES,
    NNMatcherModelType.LIGHTGLUE_DISK_MATCHES,
}


@dataclasses.dataclass(frozen=True)
class NNMatcherOptions:
    max_number_of_matches: int = 300
    min_valid_match_score: float = -3.0
    model_type: NNMatcherModelType = (
        NNMatcherModelType.LIGHTGLUE_SUPERPOINT_SCORE_MAT)
    depth: int = 9


class NNFeatureMatcher:
    """LightGlue-based matcher with the reference's Match() contract.

    ``variables`` is a ``LightGlue`` ``state_dict`` or None (then
    ``initialize`` draws random weights from ``rng``, an int seed or a
    ``torch.Generator``, default seed 0). The model runs on ``device``
    (default ``"cuda"``; raises without a GPU unless ``device="cpu"``)."""

    def __init__(self, options: NNMatcherOptions = NNMatcherOptions(),
                 variables=None, rng=None, device="cuda"):
        self.options = options
        self.cfg = LightGlueConfig(
            descriptor_dim=_DESC_DIM[options.model_type],
            depth=options.depth)
        self.model = LightGlue(self.cfg, device=device)
        self._rng = 0 if rng is None else rng
        self._initialized = variables is not None
        if variables is not None:
            self.model.load_state_dict(variables)

    @property
    def variables(self):
        return self.model.state_dict() if self._initialized else None

    @classmethod
    def from_file(cls, options: NNMatcherOptions = NNMatcherOptions(),
                  path=None, device="cuda"):
        """Matcher with pretrained LightGlue weights; the variant picks the
        file (SuperPoint descriptors ``weights/lightglue_superpoint.npz``,
        DISK descriptors ``weights/lightglue_disk.npz``). None when the file
        is absent or the depth differs from the trained architecture (9)."""
        from feature_tracker_tpu_torch.utils.weights import (
            load_lightglue_npz,
            weights_path,
        )
        dim = _DESC_DIM[options.model_type]
        path = path or weights_path(
            "lightglue_superpoint.npz" if dim == 256
            else "lightglue_disk.npz")
        if not os.path.exists(path) or options.depth != 9:
            return None
        m = cls(options, device=device)
        m.model.load_state_dict(load_lightglue_npz(path, m.cfg))
        m._initialized = True
        return m

    def initialize(self) -> bool:
        """Create (or keep) parameters and run the reference-style warm-up
        inference on kMaxNumberOfMatches zero descriptors."""
        if not self._initialized:
            with seeded_init(self._rng):
                fresh = LightGlue(self.cfg, device="cpu")
            self.model.load_state_dict(fresh.state_dict())
        n = self.options.max_number_of_matches
        dev = self.model.device
        kpts = torch.zeros((n, 2), device=dev)
        desc = torch.zeros((n, self.cfg.descriptor_dim), device=dev)
        mask = torch.ones((n,), dtype=torch.bool, device=dev)
        self.model(kpts, desc, mask, kpts, desc, mask)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self._initialized = True
        return True

    def _require_init(self):
        if not self._initialized:
            self.initialize()

    def scores(self, ref_uv, ref_desc, cur_uv, cur_desc, mask_ref=None,
               mask_cur=None):
        """Raw ``[N, M]`` log-assignment matrix (score-matrix model
        output)."""
        self._require_init()
        dev = self.model.device
        if mask_ref is None:
            mask_ref = torch.ones((len(ref_uv),), dtype=torch.bool,
                                  device=dev)
        if mask_cur is None:
            mask_cur = torch.ones((len(cur_uv),), dtype=torch.bool,
                                  device=dev)
        scores, _, _ = self.model(ref_uv, ref_desc, mask_ref, cur_uv,
                                  cur_desc, mask_cur)
        return scores

    def match(self, ref_desc, cur_desc, ref_uv, cur_uv, mask_ref=None,
              mask_cur=None):
        """Full Match() contract. Returns (matched_uv ``[N,2]``, status
        ``[N]`` int8). Argument order follows the reference: descriptors
        first. One ``nn_matcher.match`` span; nothing is read back from
        the device."""
        with span("nn_matcher.match"):
            scores = self.scores(ref_uv, ref_desc, cur_uv, cur_desc, mask_ref,
                                 mask_cur)
            with torch.inference_mode():
                dev = scores.device
                cur_uv = torch.as_tensor(cur_uv, dtype=torch.float32,
                                         device=dev)
                n = scores.shape[0]
                if self.options.model_type in _FUSED:
                    pairs, _ = fused_match_list(
                        scores, self.options.min_valid_match_score,
                        self.options.max_number_of_matches)
                    # Scatter the fused list back to per-ref-feature
                    # indices; the padding rows all land in the dropped
                    # slot n.
                    slot = torch.where(pairs[:, 0] >= 0, pairs[:, 0],
                                       n).long()
                    idx = torch.full((n + 1,), -1, dtype=torch.int32,
                                     device=dev)
                    idx[slot] = pairs[:, 1]
                    idx = idx[:n]
                else:
                    idx = mutual_argmax_matches(
                        scores, self.options.min_valid_match_score)

                found = idx >= 0
                safe = torch.clamp(idx, 0, cur_uv.shape[0] - 1).long()
                # Unmatched entries keep the initial copy of the current
                # positions when the shapes line up, else zeros.
                if cur_uv.shape[0] == n:
                    default_uv = cur_uv
                else:
                    default_uv = torch.zeros((n, 2), device=dev)
                matched_uv = torch.where(found[:, None], cur_uv[safe],
                                         default_uv)
                status = torch.where(
                    found, torch.full_like(idx, int(TrackStatus.TRACKED)),
                    torch.full_like(idx, int(TrackStatus.LARGE_RESIDUAL)))
                return matched_uv, status.to(STATUS_DTYPE)
