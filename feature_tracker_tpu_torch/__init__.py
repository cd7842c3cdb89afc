"""feature_tracker_tpu_torch — the PyTorch/CUDA port of feature_tracker_tpu.

The JAX package stays the reference; this package mirrors its layout and
public names module by module, so each module's counterpart is found at
the same path. It imports ``torch`` and numpy, never JAX.

Conventions
-----------
* Images are ``float32 [H, W]`` tensors holding 0..255 gray values.
* Pixel coordinates are ``uv = (x, y) = (col, row)`` float pairs.
* Per-feature results carry an int8 ``TrackStatus`` code
  (see :mod:`feature_tracker_tpu_torch.core.status`).
* Entry points take a ``device`` argument that defaults to ``"cuda"``;
  they raise when no GPU is present unless the caller passes
  ``device="cpu"``. CUDA tensors go through the port's hand-written
  kernels, CPU tensors through their plain PyTorch versions.
"""

from feature_tracker_tpu_torch.core.status import TrackStatus

__version__ = "0.1.0"

__all__ = ["TrackStatus", "__version__"]
