"""Host-side runtime: native library bindings and the frame stream.

The compute path is PyTorch on the card; this package is the compiled host
runtime around it: a C++ frame ring buffer, fused uint8 -> float32 +
pyramid preprocessing and nanosecond timers, with numpy fallbacks when the
shared library cannot be built.
"""

from feature_tracker_tpu_torch.runtime.native import (  # noqa: F401
    NativeRuntime,
    build_native,
    get_runtime,
)
from feature_tracker_tpu_torch.runtime.stream import FrameStream  # noqa: F401
