"""Host-side utilities: timers, logging, visualisation and weight files.

``TickTock`` wall-clock timing, ReportInfo / ReportError coloured logging
and PNG rendering of detected, tracked and matched features
(``utils/viz.py``); ``utils/weights.py`` reads and writes npz weight files.
"""

from feature_tracker_tpu_torch.utils.log import (  # noqa: F401
    report_debug,
    report_error,
    report_info,
    report_warn,
)
from feature_tracker_tpu_torch.utils.timer import (  # noqa: F401
    TickTock,
    time_jitted,
)
