"""Height sharding of the port's RAFT trainers on spawned gloo ranks of
the CPU: steps on meshes with a ``model`` axis of 2 and 4 against the
port's one-rank step and JAX's unsharded step, and JAX's own departure on
a (2, 2) mesh.

Tolerances are tests/test_torch_train_raft.py's (``assert_step_close``;
losses and metrics within 1e-5 relative); the ranks' new states are equal
bit for bit, each rank's activations hold its band's rows, and the
collectives are counted as ``chip_smoke.py::expected_train_comm`` counts
them. The (1, 2) meshes run in tests/test_torch_parallel.py's two-rank
spawn and use the helpers here.

JAX's step on a (2, 2) mesh is not its unsharded step: its forward alone
leaves the unsharded flows by 1.7e-3 px at the second iteration (flows up
to 1.1 px), where the (1, 2) and (2, 1) meshes stay within 1e-6 px
(``test_jax_forward_on_a_two_by_two_mesh_departs``; ROADMAP.md section
3). On (2, 2) the port is held to the unsharded step, which its one-rank
step computes.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from feature_tracker_tpu.models import raft as jraft
from feature_tracker_tpu.train import raft_train as jrt
from feature_tracker_tpu_torch.convert import train_state_from_jax
from feature_tracker_tpu_torch.parallel.multihost_ba import run_cases, spawn
from feature_tracker_tpu_torch.train import raft_train as prt
from feature_tracker_tpu_torch.train.raft_train import data_parallel_case

from test_torch_train_raft import PTINY, TINY, assert_step_close
from test_torch_train_raft_steps import jax_state

RANK_THREADS = 2


def band_problem(h, b=4, w=32):
    """A batch of ``b`` pairs ``h x w`` as test_torch_train_raft.py's
    ``batch`` draws them: uniform images and normal ground-truth flows.
    (The draw of seed ``h`` at H = 40 lies on a kink of the step: a one-ulp
    change of ``ref`` moves JAX's own first moments by 62 times
    ``assert_step_close``'s limit, as far as the port's lie from JAX's.)"""
    rng = np.random.default_rng(h + 3)
    ref = rng.uniform(0, 255, (b, h, w, 1)).astype(np.float32)
    cur = rng.uniform(0, 255, (b, h, w, 1)).astype(np.float32)
    gt = rng.normal(0, 1, (b, h, w, 2)).astype(np.float32)
    return ref, cur, gt


@functools.lru_cache(maxsize=1)
def start_state():
    """A JAX TrainState of the TINY RAFT, and the port's copy of it."""
    js = jax_state(TINY, jrt.RaftTrainConfig())
    return js, train_state_from_jax(js, device="cpu")


def sharded_case(mesh_shape, h, supervised, cfg=PTINY, **kw):
    """A ``run_cases`` case: one step of the trainer on a mesh of
    ``mesh_shape`` from ``start_state()``, on ``band_problem(h)``."""
    batch = band_problem(h)[:3 if supervised else 2]
    return (functools.partial(data_parallel_case, shape=mesh_shape, **kw),
            (cfg, prt.RaftTrainConfig(), start_state()[1], *batch))


def one_rank_step(h, supervised, cfg=PTINY):
    """The port's one-rank step on the same problem."""
    make = prt.make_train_step if supervised else prt.make_unsup_train_step
    batch = band_problem(h)[:3 if supervised else 2]
    return make(cfg, prt.RaftTrainConfig())(start_state()[1], *batch)


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.as_tensor(tree)


def assert_sharded_step(results, mesh_shape, h, supervised, wants,
                        cfg=PTINY):
    """Each rank's result of ``sharded_case`` against each ``(state,
    metrics)`` of ``wants``, its band rows against the band rule, its
    collectives against ``expected_train_comm``, and the ranks' states
    against each other, bit for bit."""
    from chip_smoke import expected_train_comm

    d, m = mesh_shape["data"], mesh_shape["model"]
    units = h // 8
    sizes = [8 * (units // m + (i < units % m)) for i in range(m)]
    n_params = sum(v.numel() for v in start_state()[1].params.values())
    comm = expected_train_comm(cfg, n_params, (4, h, 32), mesh_shape,
                               not supervised)
    assert len(results) == d * m
    for rank, got in enumerate(results):
        j = rank % m
        assert got["band_rows"] == {"start": sum(sizes[:j]),
                                    "rows": sizes[j], "stem": sizes[j],
                                    "fmap0": sizes[j] // 8}, rank
        assert got["comm"] == {op: {"calls": c, "bytes": n}
                               for op, (c, n) in comm.items()}, rank
        state = prt.TrainState(**_tensors(got["state"]))
        for want, want_m in wants:
            for key in want_m:
                np.testing.assert_allclose(got[key], float(want_m[key]),
                                           rtol=1e-5, err_msg=key)
            assert_step_close(state, want)
    first = prt.TrainState(**_tensors(results[0]["state"]))
    for got in results[1:]:
        other = prt.TrainState(**_tensors(got["state"]))
        assert all(torch.equal(a, b) for a, b in zip(first.leaves(),
                                                     other.leaves()))


# The four-rank cases: (2, 2) at H=32, both trainers; (1, 4) at H=40,
# bands of 16 + 8 + 8 + 8 rows, whose 1/8-scale bands of one row make the
# 7x7 convolution's halo span three bands.
FOUR = [({"data": 2, "model": 2}, 32, True),
        ({"data": 2, "model": 2}, 32, False),
        ({"data": 1, "model": 4}, 40, True)]


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    cases = [sharded_case(*case) for case in FOUR]
    return spawn(run_cases, 4, str(tmp_path_factory.mktemp("gloo_store")),
                 "cpu", cases, device="cpu", threads=RANK_THREADS)


@pytest.mark.parametrize("supervised", [True, False],
                         ids=["supervised", "unsupervised"])
def test_two_by_two_mesh_step_is_the_unsharded_step(four_ranks, supervised):
    """The batch of 4 split 2 + 2 over 'data' and the 32 rows 16 + 16 over
    'model': the port's one-rank step and JAX's unsharded step."""
    i = FOUR.index(({"data": 2, "model": 2}, 32, supervised))
    js, _ = start_state()
    tcfg = jrt.RaftTrainConfig()
    batch = band_problem(32)[:3 if supervised else 2]
    make = jrt.make_train_step if supervised else jrt.make_unsup_train_step
    assert_sharded_step([r[i] for r in four_ranks], *FOUR[i],
                        [one_rank_step(32, supervised),
                         make(TINY, tcfg)(js, *batch)])


def test_one_by_four_mesh_with_bands_of_one_feature_row(four_ranks):
    assert_sharded_step([r[2] for r in four_ranks], *FOUR[2],
                        [one_rank_step(40, True)])


def test_jax_forward_on_a_two_by_two_mesh_departs():
    """JAX's own forward of the TINY RAFT (eval, two iterations) jitted with
    the images sharded P("data", "model"): on (1, 2) and (2, 1) meshes the
    flows stay within 1e-6 px of the unsharded ones, on (2, 2) they leave
    them by more than 1e-5 px at the second iteration (1.7e-3 px here).
    The first iteration agrees on every mesh."""
    js, _ = start_state()
    variables = {"params": js.params, "batch_stats": js.batch_stats}
    ref, cur, _ = band_problem(32)

    def forward(v, a, b):
        return jraft.Raft(TINY).apply(v, a, b)

    want = np.asarray(jax.jit(forward)(variables, ref, cur))
    gaps = {}
    for shape in ((1, 2), (2, 1), (2, 2)):
        mesh = Mesh(np.array(jax.devices()[:shape[0] * shape[1]]).reshape(
            shape), ("data", "model"))
        images = NamedSharding(mesh, P("data", "model"))
        got = np.asarray(jax.jit(forward, in_shardings=(
            NamedSharding(mesh, P()), images, images))(variables, ref, cur))
        gaps[shape] = np.abs(got - want).max(axis=(1, 2, 3, 4))
    assert gaps[(1, 2)].max() <= 1e-6 and gaps[(2, 1)].max() <= 1e-6, gaps
    assert gaps[(2, 2)][0] <= 1e-6 and gaps[(2, 2)][1] > 1e-5, gaps

