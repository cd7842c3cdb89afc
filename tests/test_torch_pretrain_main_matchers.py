"""``main`` of the port's pretraining driver against the JAX package's, on
the CPU, for its matcher stages: from the shipped SuperPoint file
(``reuse``), DISK and the SuperPoint-descriptor LightGlue with a step each
and the held-out evaluation, cut to test size on both sides alike (see
tests/test_torch_pretrain_main.py, which holds the SuperPoint stages).
"""

from test_torch_pretrain_main import (  # noqa: F401 (fixtures)
    REPO,
    RUN,
    assert_writes_what_jax_writes,
    small,
)
from test_torch_train_raft import few_threads  # noqa: F401 (a fixture)


def test_main_matchers_write_what_jax_writes(small):
    jdir, pdir = small
    for d in small:
        d.mkdir()
        (d / "superpoint.npz").write_bytes(
            (REPO / "weights" / "superpoint.npz").read_bytes())
    run = {**RUN, "disk_steps": 1, "lg_steps": 1, "adapt_rounds": 0,
           "reuse": 1}
    assert_writes_what_jax_writes(
        jdir, pdir, run, ["disk.npz", "lightglue_superpoint.npz",
                          "metrics.json", "superpoint.npz"],
        ("disk", "lightglue", "heldout"))
