"""``main`` of the port's pretraining driver against the JAX package's, on
the CPU: both run the SuperPoint stages (here) and the matcher stages
(tests/test_torch_pretrain_main_matchers.py) with a step or two each into
a temporary ``WEIGHTS_DIR``, with the stages' image sizes, LightGlue's
depth and the held-out evaluation cut to test size on both sides alike
(``small``), and the DISK-descriptor LightGlue stage left out
(``lg_disk_steps=0``; its trainer is held to JAX in
tests/test_torch_pretrain_disk.py, the whole ``main`` on the card by
chip_smoke.py's phase 10f).
The port writes the files JAX writes, in the JAX package's npz layout (its
``load_pytree`` reads each against the JAX model's own tree), and the
``metrics.json`` keys JAX writes; ``weights/`` is left as it was. Without
the reference pair every count is None, and both take the branches that
accept and ship what they trained.
"""

import functools
import hashlib
import json
import pathlib

import jax
import jax.numpy as jnp
import pytest

from feature_tracker_tpu.models import disk as jdisk
from feature_tracker_tpu.models import lightglue as jlg
from feature_tracker_tpu.models import superpoint as jsp
from feature_tracker_tpu.train import pretrain as jpre
from feature_tracker_tpu.utils.weights import load_pytree
from feature_tracker_tpu_torch.train import pretrain as ppre

from test_torch_train_raft import few_threads  # noqa: F401 (a fixture)

REPO = pathlib.Path(__file__).resolve().parents[1]
STAGES = {"train_superpoint": dict(h=32, w=32, batch=2),
          "adapt_superpoint": dict(h=32, w=32, batch=2, n_warps=3),
          "distill_superpoint_from_disk": dict(h=32, w=32, batch=2,
                                               n_warps=3),
          "train_disk": dict(h=32, w=32),
          "train_lightglue": dict(h=48, w=48, n_kpts=24, depth=1),
          "evaluate_matching": dict(n_pairs=2, h=48, w=48, n_kpts=24)}
RUN = dict(sp_steps=1, disk_steps=0, lg_steps=0, adapt_rounds=1,
           adapt_steps=1, adapt_pool=2, lg_disk_steps=0)


def weights_digest():
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((REPO / "weights").iterdir())}


@pytest.fixture
def small(monkeypatch, tmp_path):
    """Both packages' stages at test size, each writing into its own
    temporary WEIGHTS_DIR; returns the two directories."""
    for module in (jpre, ppre):
        for name, kw in STAGES.items():
            monkeypatch.setattr(module, name, functools.partial(
                getattr(module, name), **kw))
    dirs = tmp_path / "jax", tmp_path / "port"
    monkeypatch.setattr(jpre, "WEIGHTS_DIR", str(dirs[0]))
    monkeypatch.setattr(ppre, "WEIGHTS_DIR", str(dirs[1]))
    return dirs


def jax_like(name):
    """The JAX model's variables tree a weight file holds."""
    k, m = jnp.zeros((8, 2)), jnp.ones(8, bool)
    if name == "superpoint.npz":
        return jsp.SuperPoint(jsp.SuperPointConfig()).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 1)))
    if name == "disk.npz":
        return jdisk.Disk(jdisk.DiskConfig()).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 1)))
    d = jnp.zeros((8, 256))
    return jlg.LightGlue(jlg.LightGlueConfig(depth=1)).init(
        jax.random.PRNGKey(0), k, d, m, k, d, m)


def assert_writes_what_jax_writes(jdir, pdir, run, files, keys):
    """Both mains run with ``run`` write ``files`` and JAX's metrics keys
    (and the keys of each of ``keys``' entries); JAX's ``load_pytree``
    reads each npz file of the port's."""
    before = weights_digest()
    jpre.main(**run)
    ppre.main(**run, device="cpu")
    names = sorted(p.name for p in pdir.iterdir())
    assert names == sorted(p.name for p in jdir.iterdir()) == files
    got = json.loads((pdir / "metrics.json").read_text())
    want = json.loads((jdir / "metrics.json").read_text())
    assert list(got) == list(want)
    for key in keys:
        assert list(got[key]) == list(want[key]), key
    for name in names:
        if name == "metrics.json":
            continue
        like = jax_like(name)
        loaded = load_pytree(str(pdir / name), like)
        assert (jax.tree_util.tree_structure(loaded)
                == jax.tree_util.tree_structure(like)), name
    assert weights_digest() == before


def test_main_writes_what_jax_writes(small):
    """SuperPoint trained and adapted: its file and metrics."""
    assert_writes_what_jax_writes(*small, RUN,
                                  ["metrics.json", "superpoint.npz"],
                                  ("superpoint", "superpoint_adapt"))


def test_main_reuse_and_distill_branches(small):
    """``reuse`` (the SuperPoint file of the directory, no retraining)
    with ``distill`` and ``disk_reuse``: the adapted weights are accepted
    without the reference pair and the files rewritten, on the port."""
    _, pdir = small
    before = weights_digest()
    pdir.mkdir()
    for name in ("superpoint.npz", "disk.npz"):
        (pdir / name).write_bytes((REPO / "weights" / name).read_bytes())
    ppre.main(**{**RUN, "disk_steps": 1}, reuse=1, distill=1, disk_reuse=1,
              distill_pool=2, distill_batch=2, device="cpu")
    metrics = json.loads((pdir / "metrics.json").read_text())
    assert "superpoint" not in metrics
    assert {"superpoint_adapt", "disk", "wall_s"} <= set(metrics)
    assert metrics["superpoint_adapt"]["step"] == 0
    for name in ("superpoint.npz", "disk.npz"):
        assert ((pdir / name).read_bytes()
                != (REPO / "weights" / name).read_bytes())
        load_pytree(str(pdir / name), jax_like(name))
    assert weights_digest() == before
