"""Distributed execution: device meshes, sharded tracking, distributed BA.

The reference is single-threaded and single-process; its
embarrassingly-parallel per-feature loops and its feature->pose
reductions are the axes this package distributes:

 - features sharded over a ``data`` mesh axis for the sparse trackers
   (each rank tracks its slice, one all-gather rebuilds the whole)
 - the direct method's joint 6x6 reduction over features: per-slice H/b
   sums all-reduced each Gauss-Newton iteration
 - sharded Schur-complement bundle adjustment: landmark blocks sharded
   over the mesh, the reduced camera system all-reduced, solved on every
   rank, and back-substituted shard-local.

One process per rank; every collective is an explicit
``torch.distributed`` call through ``parallel/mesh.py``, counted by
``comm_stats``.
"""

from feature_tracker_tpu_torch.parallel.mesh import (  # noqa: F401
    ba_comm_report,
    feature_sharding,
    make_mesh,
    make_multihost_mesh,
    replicated,
)
from feature_tracker_tpu_torch.parallel.sharded import (  # noqa: F401
    shard_features,
    track_direct_sharded,
    track_klt_sharded,
)
from feature_tracker_tpu_torch.parallel.ba import (  # noqa: F401
    BaOptions,
    bundle_adjust,
)
from feature_tracker_tpu_torch.parallel.scaling import (  # noqa: F401
    measure_ba_scaling,
)
