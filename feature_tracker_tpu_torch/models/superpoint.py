"""SuperPoint detector + descriptor, for inference and training — the counterpart
of ``feature_tracker_tpu/models/superpoint.py``.

 - shared VGG-style encoder: [64,64]-pool-[64,64]-pool-[128,128]-pool-
   [128,128] -> H/8 x W/8, each convolution followed by batch
   normalisation (running statistics, or the batch's with ``train=True``)
   and ReLU
 - detector head: conv3x3(256) -> conv1x1(65); softmax over the 65 channels
   (64 cell pixels + dustbin), dustbin dropped, depth-to-space to a full
   resolution heatmap
 - descriptor head: conv3x3(256) -> conv1x1(D); bilinear sampling at
   keypoints + L2 normalization
 - keypoints: 3x3 local max + response threshold + top-K (ties to the lower
   flat index, as ``jax.lax.top_k``) with greedy min-distance suppression,
   the ranking and suppression of the classic detector (``ops/detect.py``;
   on the card kernel 6).

Images and maps are ``[B, H, W, C]`` as in the Flax model. Submodules carry
the Flax model's automatic names in call order (``Conv_0`` .. ``Conv_7``
and ``BatchNorm_0`` .. ``BatchNorm_7`` the encoder, ``Conv_8`` /
``BatchNorm_8`` / ``Conv_9`` the detector head, ``Conv_10`` /
``BatchNorm_9`` / ``Conv_11`` the descriptor head), so a weight file's leaf
path is its ``state_dict`` key (``convert.py::superpoint_state_from_jax``).
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.nn.functional as F
from torch import nn

from feature_tracker_tpu_torch.core.device import resolve_device
from feature_tracker_tpu_torch.models.layers import (
    divide,
    flax_order,
    seeded_init,
)
from feature_tracker_tpu_torch.models.raft import BatchNorm, Conv, full_float32
from feature_tracker_tpu_torch.ops import detect as _detect
from feature_tracker_tpu_torch.ops.cuda_detect import suppress_candidates_cuda
from feature_tracker_tpu_torch.utils.profiling import count_on_device, span


@dataclasses.dataclass(frozen=True)
class SuperPointConfig:
    descriptor_dim: int = 256
    dtype: torch.dtype = torch.float32


_ENCODER = (64, 64, 64, 64, 128, 128, 128, 128)


class SuperPoint(nn.Module):
    """``forward(image)``: image ``[B, H, W, 1]`` in 0..255. Returns
    (heatmap ``[B, H, W]``, dense descriptors ``[B, H/8, W/8, D]``,
    unnormalized). Runs on ``device`` (default ``"cuda"``; raises without a
    GPU unless ``device="cpu"``) on the running statistics, under
    ``torch.inference_mode`` unless ``grad=True`` (the trainer's form: the
    running statistics then may require grad, see ``BatchNorm``);
    ``train=True`` is Flax's training mode (see ``forward``)."""

    def __init__(self, cfg: SuperPointConfig = SuperPointConfig(),
                 device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        dt = cfg.dtype
        widths = (1,) + _ENCODER
        for i in range(len(_ENCODER)):
            setattr(self, f"Conv_{i}",
                    Conv(widths[i], widths[i + 1], 3, 1, dt))
            setattr(self, f"BatchNorm_{i}", BatchNorm(widths[i + 1]))
        self.Conv_8 = Conv(128, 256, 3, 1, dt)
        self.BatchNorm_8 = BatchNorm(256)
        self.Conv_9 = Conv(256, 65, 1, 1, torch.float32)
        self.Conv_10 = Conv(128, 256, 3, 1, dt)
        self.BatchNorm_9 = BatchNorm(256)
        self.Conv_11 = Conv(256, cfg.descriptor_dim, 1, 1, torch.float32)
        self.to(self.device).to(memory_format=torch.channels_last)
        self.eval()

    def _block(self, x, conv: int, norm: int, train: bool = False):
        x = getattr(self, f"Conv_{conv}")(x)
        return F.relu(getattr(self, f"BatchNorm_{norm}")(x, train))

    def forward(self, image, train: bool = False, *, grad: bool = False):
        """With ``train=True`` (Flax's ``apply(..., train=True,
        mutable=["batch_stats"])``) every batch norm normalises by the
        batch's statistics and updates its running ones in place to ``0.9 *
        old + 0.1 * batch`` (``models/raft.py::BatchNorm``); the call runs
        with autograd and returns ``((heat, desc), stats)``, ``stats`` the
        new running statistics in Flax's order, as ``Raft`` returns its
        own."""
        if not train:
            with torch.inference_mode(not grad), full_float32():
                return self._forward(image, False)
        with full_float32():
            out = self._forward(image, True)
        stats = {k: v for k, v in self.named_buffers()
                 if k.endswith(("running_mean", "running_var"))}
        return out, flax_order(stats)

    def _forward(self, image, train: bool):
        x = torch.as_tensor(image, dtype=torch.float32, device=self.device)
        x = divide(x, 255.0).to(self.cfg.dtype)
        for i in range(len(_ENCODER)):
            x = self._block(x, i, i, train)
            if i in (1, 3, 5):
                x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(
                    0, 2, 3, 1)

        det = self.Conv_9(self._block(x, 8, 8, train))
        prob = torch.softmax(det, dim=-1)[..., :64]   # drop dustbin
        b, hc, wc, _ = prob.shape
        heat = prob.reshape(b, hc, wc, 8, 8).permute(0, 1, 3, 2, 4)
        heat = heat.reshape(b, hc * 8, wc * 8)

        desc = self.Conv_11(self._block(x, 10, 9, train))
        return heat, desc


def sample_descriptors(desc_map, uv, stride: int = 8):
    """Bilinear-sample L2-normalized descriptors at pixel positions.

    Args:
      desc_map: ``[Hc, Wc, D]`` dense descriptors at 1/stride resolution.
      uv: ``[K, 2]`` full-resolution (x, y).
    """
    pos = divide(uv + 0.5, float(stride)) - 0.5     # cell-center aligned
    return _bilinear_normalized(desc_map, pos)


def _bilinear_normalized(desc_map, pos):
    """Bilinear sample of ``desc_map [h, w, D]`` at ``pos [K, 2]`` (x, y),
    clamped to the map, then L2-normalized (the JAX expression order)."""
    h, w, _ = desc_map.shape
    x = torch.clamp(pos[:, 0], 0.0, w - 1.0)
    y = torch.clamp(pos[:, 1], 0.0, h - 1.0)
    x0 = torch.clamp(torch.floor(x).long(), 0, w - 2)
    y0 = torch.clamp(torch.floor(y).long(), 0, h - 2)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    d = ((1 - fy) * (1 - fx) * desc_map[y0, x0]
         + (1 - fy) * fx * desc_map[y0, x0 + 1]
         + fy * (1 - fx) * desc_map[y0 + 1, x0]
         + fy * fx * desc_map[y0 + 1, x0 + 1])
    norm = torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    return d / torch.clamp(norm, min=1e-12)


# select_keypoints' candidates: none within this many pixels of an edge,
# and at most this many ranked before the suppression.
KEYPOINT_BORDER = 4
MAX_CANDIDATES = 4096


def select_keypoints(heatmap, max_num: int, min_response,
                     min_distance: int = 4):
    """Heatmap ``[H, W]`` -> (uv ``[max_num, 2]``, num) with 3x3 NMS,
    threshold, top-K and greedy radius suppression (the classic detector's
    contract and code: ``ops/detect.py::ranked_scores``, then
    ``ops/cuda_detect.py::suppress_candidates_cuda``, on the card one launch
    of kernel 6 with no read of the device, on the CPU the plain greedy
    suppression; padded entries are (-1, -1), ``num`` an int32 0-dim
    tensor)."""
    top_scores, flat_idx = _detect.ranked_scores(
        heatmap, min_response, KEYPOINT_BORDER, MAX_CANDIDATES)
    return suppress_candidates_cuda(top_scores, flat_idx,
                                    tuple(heatmap.shape), max_num,
                                    min_distance)


class SuperPointDetector:
    """Detect-and-describe front end (NNFeaturePointDetector equivalent).

    ``variables`` is the ``state_dict`` of a ``SuperPoint`` (a weight file
    through ``utils/weights.py::load_superpoint_npz``, or ``init_random``);
    the model runs on ``device`` (default ``"cuda"``)."""

    def __init__(self, variables, cfg: SuperPointConfig = SuperPointConfig(),
                 min_response: float = 0.005, min_feature_distance: int = 4,
                 max_features: int = 300, device="cuda"):
        self.model = SuperPoint(cfg, device=device)
        self.model.load_state_dict(variables)
        self.variables = self.model.state_dict()
        self.min_response = min_response
        self.min_feature_distance = min_feature_distance
        self.max_features = max_features

    @classmethod
    def init_random(cls, rng, image_shape=(1, 120, 160, 1), **kw):
        """Randomly initialised weights drawn from ``rng`` (an int seed or a
        ``torch.Generator``). ``image_shape`` is accepted for the JAX
        signature; a torch module needs no example input."""
        del image_shape
        with seeded_init(rng):
            model = SuperPoint(kw.get("cfg", SuperPointConfig()),
                               device="cpu")
        return cls(model.state_dict(), **kw)

    @classmethod
    def from_file(cls, path: str | None = None, **kw):
        """Pretrained weights (``weights/superpoint.npz``), or None when the
        file is absent."""
        from feature_tracker_tpu_torch.utils.weights import (
            load_superpoint_npz,
            weights_path,
        )
        path = path or weights_path("superpoint.npz")
        if not os.path.exists(path):
            return None
        cfg = kw.get("cfg", SuperPointConfig())
        return cls(load_superpoint_npz(path, cfg), **kw)

    def detect(self, image):
        """image: ``[H, W]`` 0..255 (a host ``uint8`` frame crosses to the
        model's device as it is and is made float32 there). Returns (uv
        ``[K,2]``, descriptors ``[K,D]``, num). On the card nothing is read
        back. Spans ``superpoint.detect`` (the call), ``superpoint.encode``
        (the network), ``superpoint.select`` (kernel 6's ``detect.suppress``
        inside it), ``superpoint.describe``; counter ``superpoint.keypoints``
        (``num``, added on the device while tracing)."""
        with span("superpoint.detect"), torch.inference_mode(), \
                full_float32():
            img = torch.as_tensor(image, device=self.model.device).to(
                torch.float32)
            with span("superpoint.encode"):
                heat, desc = self.model(img[None, :, :, None])
            with span("superpoint.select"):
                uv, num = select_keypoints(heat[0], self.max_features,
                                           self.min_response,
                                           self.min_feature_distance)
            count_on_device("superpoint.keypoints", num)
            with span("superpoint.describe"):
                return uv, sample_descriptors(desc[0], uv), num
