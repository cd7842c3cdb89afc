"""The port's parallel layer against the JAX package's, on the CPU.

The JAX side runs on the 8 virtual CPU devices of tests/conftest.py; the
port runs one gloo rank in this process (its own one-rank group), and two
gloo ranks spawned once for the module (``two_ranks``), which also run the
RAFT trainers on (1, 2) meshes (tests/test_torch_train_raft_sharded.py's
rules) and the row-band collectives (tests/torch_rank_cases.py). Tolerances:
statuses equal, uv within 1e-3 px (basic KLT) or 5e-3 px (warp
trackers); the direct method at JAX's own sharded tolerances (uv atol 0.2,
mean 0.05: a uniform shift is gauge-degenerate in that scene); the bundle
adjuster at JAX's sharded tolerances (q 1e-4; t rtol/atol 1e-3;
landmarks rtol 1e-3, atol 5e-3). A one-rank mesh gives the unsharded
port's bits; features split over two ranks give the one-rank bits.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_tracker_tpu import parallel as jpar
from feature_tracker_tpu.ops.pyramid import build_pyramid as jax_pyramid
from feature_tracker_tpu.parallel import ba as jba
from feature_tracker_tpu.parallel import scaling as jscaling
from feature_tracker_tpu.parallel import window_ba as jwin
from feature_tracker_tpu.trackers import direct as jdirect
from feature_tracker_tpu.trackers import klt as jklt
from feature_tracker_tpu_torch import parallel as par
from feature_tracker_tpu_torch.convert import (
    ba_options_from_jax,
    sliding_window_from_jax,
    tracker_from_jax,
    train_state_from_jax,
    window_config_from_jax,
)
from feature_tracker_tpu_torch.parallel import ba, mesh as pmesh, scaling
from feature_tracker_tpu_torch.parallel import window_ba
from feature_tracker_tpu_torch.parallel.multihost_ba import (
    ba_case,
    run_cases,
    spawn,
)
from feature_tracker_tpu_torch.trackers.direct import (
    DirectMethod,
    DirectMethodMode,
    DirectMethodOptions,
)
from feature_tracker_tpu_torch.train import raft_train as prt
from feature_tracker_tpu_torch.train.raft_train import data_parallel_case
from feature_tracker_tpu.train import raft_train as jrt

from synthetic import translated_pair
from test_parallel import _synthetic_ba
from test_torch_train_raft import PTINY, TINY, assert_step_close, batch
from test_torch_train_raft_sharded import (
    RANK_THREADS,
    assert_sharded_step,
    band_problem,
    one_rank_step,
    sharded_case,
    start_state,
)
from test_torch_train_raft_steps import jax_state
from torch_rank_cases import (
    BAND_CONVS,
    band_conv,
    collective_gradcheck_case,
    conv_bands_case,
    conv_input,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KLT_UV_TOL = {"BasicKlt": 1e-3, "AffineKlt": 5e-3, "LssdKlt": 5e-3}
ONE = jax.devices()[:1]


@pytest.fixture(scope="module")
def mesh():
    return par.make_mesh(device="cpu")


def _np(xs):
    return [np.asarray(x) for x in xs]


def _assert_ba_close(want, got):
    """JAX's sharded-BA tolerances (tests/test_parallel.py)."""
    np.testing.assert_allclose(want[0], got[0], atol=1e-4)
    np.testing.assert_allclose(want[1], got[1], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(want[2], got[2], rtol=1e-3, atol=5e-3)


# ---------------------------------------------------------------- inputs
def _klt_scene(levels=3, n=37, seed=0, shift=(3.0, -2.0)):
    ref, cur = translated_pair(h=96, w=128, shift=shift)
    rng = np.random.default_rng(seed)
    uv = np.stack([rng.uniform(20, 108, n), rng.uniform(20, 76, n)],
                  -1).astype(np.float32)
    jp = (jax_pyramid(jnp.asarray(ref), levels),
          jax_pyramid(jnp.asarray(cur), levels))
    return jp, tuple([np.array(l) for l in p] for p in jp), uv


KLT_TRACKERS = {
    "BasicKlt": lambda: jklt.BasicKlt(jklt.KltOptions(max_track_points=64)),
    "AffineKlt": lambda: jklt.AffineKlt(jklt.KltOptions(max_track_points=64)),
    "LssdKlt": lambda: jklt.LssdKlt(jklt.KltOptions(max_track_points=64)),
    # The global cap: lanes 10.. pass their inputs through.
    "capped": lambda: jklt.BasicKlt(jklt.KltOptions(max_track_points=10)),
}


def _direct_scene(n=51):
    """tests/test_parallel.py's direct-method scene, with an odd count so
    that two ranks pad."""
    ref, cur = translated_pair(h=96, w=160, shift=(0.0, 4.0))
    jp = (jax_pyramid(jnp.asarray(ref), 3), jax_pyramid(jnp.asarray(cur), 3))
    k4 = np.array([120.0, 120.0, 80.0, 48.0], np.float32)
    rng = np.random.default_rng(1)
    uv = np.stack([rng.uniform(15, 145, n), rng.uniform(15, 81, n)],
                  -1).astype(np.float32)
    depth = rng.uniform(4.0, 8.0, n).astype(np.float32)
    p_ref = (np.stack([(uv[:, 0] - k4[2]) / k4[0],
                       (uv[:, 1] - k4[3]) / k4[1], np.ones(n)], -1)
             * depth[:, None]).astype(np.float32)
    return jp, tuple([np.array(l) for l in p] for p in jp), k4, p_ref, uv


def _ba_problem(num_lm=63, seed=3):
    """_synthetic_ba's problem (an odd landmark count: two ranks pad)."""
    q0, t0, lm0, idx, uv, mask, k4, *_ = _synthetic_ba(num_lm=num_lm,
                                                       seed=seed)
    return q0, t0, lm0, idx, uv, mask, k4


BA_OPTS = jba.BaOptions(max_iterations=3, num_fixed_poses=2)
# The launcher's default problem and options (chip_smoke.py phase 8b).
LAUNCHER_BA = ba.BaOptions(max_iterations=10, num_fixed_poses=2)


# The two-rank result of the data-parallel RAFT train step, then the
# steps on (1, 2) meshes (H, supervised), the low-memory one, the
# convolutions on bands and the collectives' gradchecks.
TRAIN_CASE = 1 + len(KLT_TRACKERS) + len(DirectMethodMode)
MODEL2 = {"data": 1, "model": 2}
SHARDED = [(32, True), (32, False), (40, True), (40, False)]
LOW_MEMORY = dataclasses.replace(PTINY, low_memory=True)
LOW_MEMORY_CASE = TRAIN_CASE + 1 + len(SHARDED)
GRADCHECKS = [(op, rank) for op in ("halo", "gather") for rank in (0, 1)]


@functools.lru_cache(maxsize=1)
def _train_problem():
    """A JAX TrainState of the TINY RAFT and a batch of 4."""
    return jax_state(TINY, jrt.RaftTrainConfig()), batch(seed=21, b=4)


# ------------------------------------------------------------ two ranks
@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Every two-rank case, run once by two spawned gloo ranks: the
    features' slices, sharded KLT (each tracker and the global cap),
    sharded direct method (each mode), one data-parallel RAFT train step
    (with a checkpoint through the mesh), the RAFT steps on (1, 2) meshes
    (the first with a checkpoint), the row-band cases, sharded BA."""
    _, (rp, cp), uv = _klt_scene()
    _, (drp, dcp), k4, p_ref, duv = _direct_scene()
    cases = [(par.shard_features,
              (np.arange(26, dtype=np.float32).reshape(13, 2),))]
    cases += [(functools.partial(par.track_klt_sharded,
                                 tracker_from_jax(make(), device="cpu")),
               (rp, cp, uv)) for make in KLT_TRACKERS.values()]
    cases += [(functools.partial(par.track_direct_sharded, DirectMethod(
        DirectMethodOptions(method=m), device="cpu")),
        (drp, dcp, k4, p_ref, duv)) for m in DirectMethodMode]
    js, batch4 = _train_problem()
    cases.append((functools.partial(
        data_parallel_case,
        checkpoint_dir=str(tmp_path_factory.mktemp("ckpt"))),
        (PTINY, prt.RaftTrainConfig(), train_state_from_jax(js, device="cpu"),
         *batch4)))
    cases += [sharded_case(MODEL2, h, sup, **({} if i else {
        "checkpoint_dir": str(tmp_path_factory.mktemp("band_ckpt"))}))
        for i, (h, sup) in enumerate(SHARDED)]
    cases.append(sharded_case(MODEL2, 32, True, LOW_MEMORY))
    cases.append((conv_bands_case, ()))
    cases += [(collective_gradcheck_case, args) for args in GRADCHECKS]
    cases.append((ba_case, (_ba_problem(), ba_options_from_jax(BA_OPTS))))
    cases.append((ba_case, (scaling._make_problem(65536, 4, 8), LAUNCHER_BA)))
    store = tmp_path_factory.mktemp("gloo_store")
    return spawn(run_cases, 2, str(store), "cpu", cases, device="cpu",
                 threads=RANK_THREADS)


# ------------------------------------------------------------------ mesh
@pytest.mark.parametrize("shape", [None, {"data": -1}, {"host": 1, "data": -1},
                                   {"host": 1, "data": 1}, {"data": 2},
                                   {"data": 16}])
def test_make_mesh_matches_jax(shape, mesh):
    """Shapes, axis names, the -1 inference and the error text of a
    one-rank mesh are JAX's on one device."""
    try:
        want = jpar.make_mesh(shape, devices=ONE)
    except ValueError as err:
        with pytest.raises(ValueError) as got:
            par.make_mesh(shape, device="cpu")
        assert str(got.value) == str(err)
        return
    got = par.make_mesh(shape, device="cpu")
    assert got.shape == want.devices.shape
    assert got.mesh_dim_names == want.axis_names
    assert got.device_type == "cpu"


def test_make_multihost_mesh_matches_jax(mesh):
    want = jpar.make_multihost_mesh(1, devices=ONE)
    got = par.make_multihost_mesh(1, device="cpu")
    assert got.mesh_dim_names == want.axis_names == ("dcn", "ici")
    assert got.shape == want.devices.shape
    with pytest.raises(ValueError) as err:
        jpar.make_multihost_mesh(2, devices=ONE)
    with pytest.raises(ValueError) as mine:
        par.make_multihost_mesh(2, device="cpu")
    assert str(mine.value) == str(err.value)


@pytest.mark.parametrize("p,l,o", [(8, 65536, 4), (6, 64, 4), (20, 1000, 8)])
def test_ba_comm_report_matches_jax(p, l, o, mesh):
    for j_mesh, mine in ((jpar.make_mesh(devices=ONE), mesh),
                         (jpar.make_multihost_mesh(1, devices=ONE),
                          par.make_multihost_mesh(1, device="cpu"))):
        assert par.ba_comm_report(p, l, o, mine) == \
            jpar.ba_comm_report(p, l, o, j_mesh)


def test_placements_and_pad(mesh):
    from torch.distributed.tensor import Replicate, Shard

    assert par.feature_sharding(mesh) == (Shard(0),)
    assert par.replicated(mesh) == (Replicate(),)
    two_axes = par.make_mesh({"host": 1, "data": -1}, device="cpu")
    assert par.feature_sharding(two_axes) == (Shard(0), Shard(0))
    with pytest.raises(ValueError):
        par.feature_sharding(mesh, axis="model")
    assert [pmesh.pad_to_multiple(n, 4) for n in (0, 1, 4, 13)] == \
        [jpar.mesh.pad_to_multiple(n, 4) for n in (0, 1, 4, 13)]


def test_comm_stats_count_each_collective(mesh):
    pmesh.reset_comm_stats()
    pmesh._all_reduce(mesh, torch.ones(42, dtype=torch.float64))
    pmesh._all_gather(mesh, torch.ones(5, 2))
    assert pmesh.comm_stats() == {"all_reduce": {"calls": 1, "bytes": 336},
                                  "all_gather": {"calls": 1, "bytes": 40}}
    pmesh.reset_comm_stats()
    assert pmesh.comm_stats() == {}


def test_shard_features_one_rank_keeps_everything(mesh):
    idx = np.arange(13, dtype=np.int32)
    n_pad, s_idx, s_mask = par.shard_features(mesh, idx, idx % 2 == 0)
    assert n_pad == 13
    assert s_idx.dtype == torch.int32 and s_mask.dtype == torch.bool
    np.testing.assert_array_equal(s_idx.numpy(), idx)


def test_shard_features_two_ranks_pad_and_order(two_ranks):
    full = np.arange(26, dtype=np.float32).reshape(13, 2)
    padded = np.concatenate([full, np.zeros((1, 2), np.float32)])
    for rank, result in enumerate(two_ranks):
        n_pad, local = result[0]
        assert n_pad == 14
        np.testing.assert_array_equal(local, padded[7 * rank:7 * rank + 7])


# ------------------------------------------------------------------ KLT
@pytest.mark.parametrize("name", list(KLT_TRACKERS))
def test_track_klt_sharded_matches_jax_and_the_unsharded_tracker(name, mesh):
    (jrp, jcp), (rp, cp), uv = _klt_scene()
    jtracker = KLT_TRACKERS[name]()
    tracker = tracker_from_jax(jtracker, device="cpu")
    j_uv, j_st = _np(jpar.track_klt_sharded(jtracker, jpar.make_mesh(), jrp,
                                            jcp, uv))
    s_uv, s_st = _np(par.track_klt_sharded(tracker, mesh, rp, cp, uv))
    b_uv, b_st = _np(tracker.track(rp, cp, uv))
    np.testing.assert_array_equal(s_uv, b_uv)
    np.testing.assert_array_equal(s_st, b_st)
    np.testing.assert_array_equal(s_st, j_st)
    both = s_st == 1
    assert both.sum() > (5 if name == "capped" else 25)
    tol = KLT_UV_TOL.get(name, 1e-3)
    np.testing.assert_allclose(s_uv[both], j_uv[both], atol=tol)
    if name == "capped":
        np.testing.assert_array_equal(s_uv[10:], uv[10:])
        assert (s_st[10:] == 0).all()


@pytest.mark.parametrize("i,name", list(enumerate(KLT_TRACKERS)))
def test_track_klt_on_two_ranks_equals_one_rank(i, name, two_ranks, mesh):
    _, (rp, cp), uv = _klt_scene()
    tracker = tracker_from_jax(KLT_TRACKERS[name](), device="cpu")
    want = _np(par.track_klt_sharded(tracker, mesh, rp, cp, uv))
    for result in two_ranks:
        got = result[1 + i]
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_sharded_tracker_refuses_a_mesh_of_another_device(mesh):
    tracker = tracker_from_jax(KLT_TRACKERS["BasicKlt"](), device="cpu")
    tracker.device = torch.device("cuda")
    with pytest.raises(ValueError, match="cpu mesh"):
        par.track_klt_sharded(tracker, mesh, [], [], np.zeros((1, 2)))


# --------------------------------------------------------------- direct
def test_track_direct_sharded_matches_jax(mesh):
    """At tests/test_parallel.py's scene and tolerances."""
    (jrp, jcp), (rp, cp), k4, p_ref, uv = _direct_scene(n=50)
    j_uv, _, _, j_st = _np(jpar.track_direct_sharded(
        jdirect.DirectMethod(), jpar.make_mesh(), jrp, jcp, k4, p_ref, uv))
    s_uv, _, _, s_st = _np(par.track_direct_sharded(
        DirectMethod(device="cpu"), mesh, rp, cp, k4, p_ref, uv))
    np.testing.assert_array_equal(s_st, j_st)
    np.testing.assert_allclose(s_uv, j_uv, atol=0.2)
    assert np.abs(s_uv - j_uv).mean() < 0.05


@pytest.mark.parametrize("mode", list(DirectMethodMode))
def test_track_direct_one_rank_equals_the_unsharded_solver(mode, mesh):
    _, (rp, cp), k4, p_ref, uv = _direct_scene()
    solver = DirectMethod(DirectMethodOptions(method=mode), device="cpu")
    want = _np(solver.track(rp, cp, k4, p_ref, uv))
    got = _np(par.track_direct_sharded(solver, mesh, rp, cp, k4, p_ref, uv))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("j,mode", list(enumerate(DirectMethodMode)))
def test_track_direct_on_two_ranks(j, mode, two_ranks, mesh):
    """Two ranks sum the float64 system in two halves: statuses equal,
    uv within 1e-3 px, the pose within 1e-5 of one rank."""
    _, (rp, cp), k4, p_ref, uv = _direct_scene()
    solver = DirectMethod(DirectMethodOptions(method=mode), device="cpu")
    want = _np(par.track_direct_sharded(solver, mesh, rp, cp, k4, p_ref, uv))
    for result in two_ranks:
        got = result[1 + len(KLT_TRACKERS) + j]
        np.testing.assert_array_equal(got[3], want[3])
        np.testing.assert_allclose(got[0], want[0], atol=1e-3)
        np.testing.assert_allclose(got[1], want[1], atol=1e-5)
        np.testing.assert_allclose(got[2], want[2], atol=1e-5)


# ------------------------------------------------------------------- BA
@pytest.mark.parametrize("opts", [
    BA_OPTS,
    jba.BaOptions(max_iterations=8, num_fixed_poses=2),
    jba.BaOptions(max_iterations=6, landmark_prior=30.0, huber_px=2.0),
    jba.BaOptions(max_iterations=4, num_fixed_poses=0, pose_damping=1e-2)])
def test_bundle_adjust_matches_jax(opts):
    prob = _ba_problem(num_lm=64)
    want = _np(jba.bundle_adjust(*prob, opts))
    got = _np(ba.bundle_adjust(*prob, ba_options_from_jax(opts),
                               device="cpu"))
    _assert_ba_close(want, got)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-4)


def test_ba_step_and_rms_match_jax():
    q0, t0, lm0, idx, uv, mask, k4, t_true, lm_true = _synthetic_ba(seed=9)
    args = (q0, t0, lm0, idx, uv, mask, k4)
    want = _np(jba.ba_step(*(jnp.asarray(a) for a in args), BA_OPTS))
    t_args = [torch.as_tensor(a) for a in args]
    t_args[3] = t_args[3].long()
    got = _np(ba.ba_step(*t_args, ba_options_from_jax(BA_OPTS)))
    _assert_ba_close(want, got)
    np.testing.assert_allclose(
        float(ba.reprojection_rms(*t_args)),
        float(jba.reprojection_rms(*(jnp.asarray(a) for a in args))),
        rtol=1e-5)
    np.testing.assert_allclose(
        ba.project(torch.as_tensor(lm_true), t_args[6]).numpy(),
        np.asarray(jba.project(jnp.asarray(lm_true), jnp.asarray(k4))),
        rtol=1e-6)


def test_bundle_adjust_on_a_one_rank_mesh_is_bit_equal(mesh):
    """The all-reduce of one rank leaves the sums alone; the call leaves the
    caller's TF32 setting as it found it."""
    prob = _ba_problem(num_lm=64)
    opts = ba_options_from_jax(BA_OPTS)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        want = _np(ba.bundle_adjust(*prob, opts, device="cpu"))
        got = _np(ba.bundle_adjust(*prob, opts, mesh=mesh))
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


def test_bundle_adjust_on_two_ranks(two_ranks, mesh):
    """Landmarks split over two ranks: JAX's sharded tolerances against one
    rank and against JAX, the rms history within 1e-4 relative, and each
    step all-reduces exactly ba_comm_report's psum_bytes (plus the rms's
    sum and count)."""
    prob = _ba_problem()
    opts = ba_options_from_jax(BA_OPTS)
    one = _np(ba.bundle_adjust(*prob, opts, mesh=mesh))
    jax_out = _np(jba.bundle_adjust(*prob, BA_OPTS))
    psum = par.ba_comm_report(prob[0].shape[0], 63, 4, mesh)["psum_bytes"]
    for result in two_ranks:
        got = result[-2]
        got = [got["q"], got["t"], got["landmarks"], got["rms"]]
        _assert_ba_close(one, got)
        _assert_ba_close(jax_out, got)
        np.testing.assert_allclose(got[3], one[3], rtol=1e-4)
    iters = BA_OPTS.max_iterations
    assert two_ranks[0][-2]["all_reduce_calls"] == 2 * iters + 1
    assert two_ranks[0][-2]["all_reduce_bytes"] == iters * psum + \
        (iters + 1) * 8
    np.testing.assert_array_equal(two_ranks[0][-2]["q"],
                                  two_ranks[1][-2]["q"])


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.as_tensor(tree)


def test_data_parallel_train_step_on_two_ranks(two_ranks):
    """The batch of 4 split 2 + 2 over two gloo ranks gives the one-rank
    step on the whole batch and JAX's step jitted over a ("data", "model")
    mesh of two CPU devices (batch norm statistics, loss and gradient over
    the whole batch), by tests/test_torch_train_raft.py's rules; the ranks
    agree bit for bit. The all-reduces are the batch norms' statistics, the
    loss, the EPE and one flat gradient; the mesh's checkpoint is written
    once and restored on both ranks."""
    from chip_smoke import expected_train_comm

    js, (ref, cur, gt) = _train_problem()
    tcfg = jrt.RaftTrainConfig()
    one, m_one = prt.make_train_step(PTINY, prt.RaftTrainConfig())(
        train_state_from_jax(js, device="cpu"), ref, cur, gt)
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:2]).reshape(2, 1),
                              ("data", "model"))
    js1, jm = jrt.make_train_step(TINY, tcfg, mesh=jmesh)(js, ref, cur, gt)
    comm = expected_train_comm(PTINY, sum(v.numel() for v in
                                          one.params.values()),
                               ref.shape[:3], {"data": 2})
    results = [dict(r[TRAIN_CASE]) for r in two_ranks]
    for got in results:
        got["state"] = prt.TrainState(**_tensors(got["state"]))
        for key in ("loss", "epe"):
            np.testing.assert_allclose(got[key], float(m_one[key]), rtol=1e-5)
            np.testing.assert_allclose(got[key], float(jm[key]), rtol=1e-5)
        assert_step_close(got["state"], one)
        assert_step_close(got["state"], js1)
        assert got["comm"] == {op: {"calls": c, "bytes": n}
                               for op, (c, n) in comm.items()}
        assert got["restored_equal"]
    assert [r["saved"] for r in results] == [True, True]
    a, b = (r["state"] for r in results)
    assert all(torch.equal(a.params[k], b.params[k]) for k in a.params)


@pytest.mark.parametrize("i", range(len(SHARDED)), ids=[
    f"H{h}-{'supervised' if sup else 'unsupervised'}" for h, sup in SHARDED])
def test_height_sharded_step_on_two_ranks(i, two_ranks):
    """A (1, 2) mesh splits the rows of the batch of 4 over 'model' (H=32:
    16 + 16; H=40: 24 + 16): the port's one-rank step and JAX's step jitted
    over the same mesh of two CPU devices. The first case also saves its
    state through the mesh's checkpoint (rank 0 writes) and restores it on
    both ranks."""
    h, supervised = SHARDED[i]
    js, _ = start_state()
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:2]).reshape(1, 2),
                              ("data", "model"))
    tcfg = jrt.RaftTrainConfig()
    batch = band_problem(h)[:3 if supervised else 2]
    if supervised:
        step = jrt.make_train_step(TINY, tcfg, mesh=jmesh)
    else:
        step = jrt.make_unsup_train_step(TINY, tcfg, mesh=jmesh)
    results = [r[TRAIN_CASE + 1 + i] for r in two_ranks]
    assert_sharded_step(results, MODEL2, h, supervised,
                        [one_rank_step(h, supervised), step(js, *batch)])
    if i == 0:
        assert [r["saved"] for r in results] == [True, True]
        assert all(r["restored_equal"] for r in results)


def test_low_memory_step_on_two_ranks(two_ranks):
    """With ``low_memory`` each rank pools the gathered second feature map
    and looks its band's rows up on the fly: the one-rank step (which
    tests/test_torch_train_raft_steps.py holds to JAX)."""
    assert_sharded_step([r[LOW_MEMORY_CASE] for r in two_ranks], MODEL2, 32,
                        True, [one_rank_step(32, True, LOW_MEMORY)],
                        LOW_MEMORY)


@pytest.mark.parametrize("name", list(BAND_CONVS))
def test_convolution_on_bands_is_the_whole_convolution(name, two_ranks):
    """3x3, 7x7, (5, 1) and stride-2 convolutions on bands of 24 + 16 rows,
    with their halo rows from the other rank, give the rows of the same
    convolution of the whole image."""
    got = [r[LOW_MEMORY_CASE + 1] for r in two_ranks]
    assert [g["start"] for g in got] == [0, 24]
    want = band_conv(name)(conv_input()).detach().numpy()
    np.testing.assert_allclose(np.concatenate([g[name] for g in got], 1),
                               want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("op", ["halo", "gather"])
def test_row_band_collectives_pass_gradcheck_on_two_ranks(op, two_ranks):
    """``torch.autograd.gradcheck`` in float64 of the halo exchange and the
    band gather, each rank's band in turn the variable
    (``torch_rank_cases.collective_gradcheck_case``)."""
    for j, args in enumerate(GRADCHECKS):
        if args[0] == op:
            assert [r[LOW_MEMORY_CASE + 2 + j] for r in two_ranks] == [
                True, True], args


@pytest.mark.parametrize("op", ["halo", "gather"])
def test_row_bands_on_a_one_rank_mesh(op, mesh):
    """One band holds every row: the halo is the zero padding of a
    convolution, the gather the input; both count one collective each way
    (``halo`` / ``row_gather`` and their ``_backward``)."""
    from feature_tracker_tpu_torch.parallel.height import RowBands

    bands = RowBands(par.make_mesh({"data": 1, "model": 1}, device="cpu"),
                     16)
    assert (bands.start, bands.rows, bands.index) == (0, 16, 0)
    x = torch.tensor(np.random.default_rng(4).normal(size=(2, 2, 3, 4)),
                     requires_grad=True)
    pmesh.reset_comm_stats()
    if op == "halo":
        y = bands.halo(x, 3)
        want = torch.nn.functional.pad(x, (0, 0, 0, 0, 3, 3))
    else:
        y, want = bands.gather(x), x
    assert torch.equal(y, want)
    y.sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))
    name = "halo" if op == "halo" else "row_gather"
    edges = 2 * 3 * 2 * 3 * 4 * 8 if op == "halo" else x.numel() * 8
    assert pmesh.comm_stats() == {
        name: {"calls": 1, "bytes": edges},
        name + "_backward": {"calls": 1, "bytes": edges}}


def test_launcher_problem_on_two_ranks_within_its_float32_floor(two_ranks):
    """The launcher's noise-free problem (65536 landmarks, 10 iterations)
    drives the rms history to ~1.5e-4 px, where a one-ulp change of the
    inputs moves it by more than 1e-4 relative (ROADMAP.md section 3):
    two ranks are held to one within 1e-4 or twice that spread, and the
    poses and landmarks to JAX's sharded tolerances."""
    from chip_smoke import BA_RMS_RANKS, ba_spread

    prob = scaling._make_problem(65536, 4, 8)
    one, spread = ba_spread(prob, LAUNCHER_BA, "cpu")
    got = two_ranks[0][-1]
    got = [got["q"], got["t"], got["landmarks"], got["rms"]]
    _assert_ba_close(one, got)
    rel = np.abs(got[3] / one[3] - 1).max()
    assert rel <= max(BA_RMS_RANKS, 2.0 * spread), (rel, spread)
    assert one[3][-1] < 1e-3 * one[3][0]


def test_bundle_adjust_converges():
    q0, t0, lm0, idx, uv, mask, k4, t_true, lm_true = _synthetic_ba()
    t0[1] = t_true[1]
    q, t, lm, rms = _np(ba.bundle_adjust(
        q0, t0, lm0, idx, uv, mask, k4,
        ba.BaOptions(max_iterations=8, num_fixed_poses=2), device="cpu"))
    assert rms[-1] < rms[0] * 0.2
    assert rms[-1] < 1.0
    np.testing.assert_allclose(t[:2], t0[:2], atol=1e-6)
    assert np.abs(t[2:] - t_true[2:]).max() < 0.05


def test_bundle_adjust_masked_observations_inert():
    q0, t0, lm0, idx, uv, mask, k4, *_ = _synthetic_ba(num_lm=32, seed=5)
    mask2 = mask.copy()
    mask2[0] = False
    _, _, lm, _ = _np(ba.bundle_adjust(q0, t0, lm0, idx, uv, mask2, k4,
                                       ba.BaOptions(max_iterations=2),
                                       device="cpu"))
    np.testing.assert_allclose(lm[0], lm0[0], atol=1e-6)


def test_reprojection_rms_zero_at_ground_truth():
    q0, t0, lm0, idx, uv, mask, k4, t_true, lm_true = _synthetic_ba(
        pix_noise=0.0, state_noise=0.0, seed=7)
    rms = ba.reprojection_rms(*(torch.as_tensor(a) for a in (
        q0, t_true, lm_true, idx.astype(np.int64), uv, mask, k4)))
    assert float(rms) < 1e-3


def _kitti_window(seed, n_lm, n_pose, depth_max, u_range, v_range):
    """tests/test_parallel.py's KITTI-scale forward trajectory."""
    rng = np.random.default_rng(seed)
    fx = fy = 718.856
    cx, cy = 607.2, 185.2
    k4 = np.array([fx, fy, cx, cy], np.float32)
    depth = rng.uniform(5, depth_max, n_lm)
    u = rng.uniform(*u_range, n_lm)
    v = rng.uniform(*v_range, n_lm)
    lm0 = np.stack([(u - cx) / fx * depth, (v - cy) / fy * depth,
                    depth], -1).astype(np.float32)
    t_true = np.stack([[0.0, 0.0, -0.8 * k] for k in range(n_pose)],
                      0).astype(np.float32)
    idx = np.tile(np.arange(n_pose, dtype=np.int32)[None], (n_lm, 1))
    p_c = lm0[:, None, :] + t_true[None]
    uv = np.stack([fx * p_c[..., 0] / p_c[..., 2] + cx,
                   fy * p_c[..., 1] / p_c[..., 2] + cy],
                  -1).astype(np.float32)
    q0 = np.tile(np.array([1, 0, 0, 0], np.float32), (n_pose, 1))
    return k4, lm0, t_true, idx, uv, q0


def test_bundle_adjust_kitti_scale_identity_init():
    k4, lm0, t_true, idx, uv, q0 = _kitti_window(3, 120, 5, 60, (100, 1140),
                                                 (50, 330))
    mask = ((np.abs(uv[..., 0] - k4[2]) < k4[2])
            & (np.abs(uv[..., 1] - k4[3]) < k4[3]))
    q, t, lm, rms = _np(ba.bundle_adjust(
        q0, np.zeros((5, 3), np.float32), lm0, idx, uv, mask, k4,
        ba.BaOptions(max_iterations=15, landmark_prior=30.0), device="cpu"))
    assert float(rms[-1]) < 0.05, rms
    np.testing.assert_allclose(t, t_true, atol=0.02)


def test_bundle_adjust_huber_downweights_outliers():
    k4, lm0, t_true, idx, uv, q0 = _kitti_window(4, 80, 4, 50, (200, 1000),
                                                 (60, 320))
    mask = np.ones(uv.shape[:2], bool)
    uv_bad = uv.copy()
    uv_bad[:8, 1:] += 60.0
    t0 = np.zeros((4, 3), np.float32)
    _, t_l2, _, _ = _np(ba.bundle_adjust(
        q0, t0, lm0, idx, uv_bad, mask, k4,
        ba.BaOptions(max_iterations=15, landmark_prior=30.0), device="cpu"))
    _, t_hub, _, _ = _np(ba.bundle_adjust(
        q0, t0, lm0, idx, uv_bad, mask, k4,
        ba.BaOptions(max_iterations=15, landmark_prior=30.0, huber_px=2.0),
        device="cpu"))
    err_l2 = np.abs(t_l2 - t_true).max()
    err_hub = np.abs(t_hub - t_true).max()
    assert err_hub < 0.05, (err_hub, t_hub)
    assert err_hub < err_l2 / 3.0, (err_hub, err_l2)


# --------------------------------------------------------------- window
WINDOW_ARRAYS = ("q_cw", "t_cw", "kf_alive", "landmarks", "lm_alive",
                 "obs_pose", "obs_uv", "obs_mask", "_obs_next", "_next_kf")


def _assert_same_bookkeeping(jax_window, port_window):
    for name in WINDOW_ARRAYS:
        want = np.asarray(getattr(jax_window, name))
        got = np.asarray(getattr(port_window, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def _fill_window(windows, k4, rng):
    """tests/test_parallel.py's end-to-end window, the same calls on every
    window: noisy poses and landmarks, noisy observations."""
    t_true = np.stack([np.zeros(4), np.zeros(4),
                       -0.3 * np.arange(4)], -1).astype(np.float32)
    lm_true = np.stack([rng.uniform(-3, 3, 48), rng.uniform(-2, 2, 48),
                        rng.uniform(8, 14, 48)], -1).astype(np.float32)
    for i in range(4):
        noise = 0.0 if i < 2 else rng.normal(0, 0.05, 3)
        for w in windows:
            w.add_keyframe([1, 0, 0, 0], t_true[i] + noise)
    for j in range(48):
        p_w = lm_true[j] + rng.normal(0, 0.05, 3)
        assert [w.add_landmark(p_w) for w in windows] == [j] * len(windows)
        for i in range(4):
            p_c = lm_true[j] + t_true[i]
            uv = np.array([k4[0] * p_c[0] / p_c[2] + k4[2],
                           k4[1] * p_c[1] / p_c[2] + k4[3]])
            uv = uv + rng.normal(0, 0.2, 2)
            for w in windows:
                w.add_observation(j, i, uv)
    return t_true


def test_sliding_window_ba_end_to_end_matches_jax(mesh):
    k4 = np.array([200.0, 200.0, 160.0, 120.0], np.float32)
    cfg = jwin.WindowConfig(max_keyframes=4, max_landmarks=64,
                            obs_per_landmark=4)
    opts = jba.BaOptions(max_iterations=6, num_fixed_poses=2)
    jax_window = jwin.SlidingWindowBa(k4, cfg, opts)
    port_window = window_ba.SlidingWindowBa(
        k4, window_config_from_jax(cfg), ba_options_from_jax(opts),
        device="cpu")
    t_true = _fill_window([jax_window, port_window], k4,
                          np.random.default_rng(0))
    _assert_same_bookkeeping(jax_window, port_window)
    carried = sliding_window_from_jax(jax_window, mesh=mesh)
    _assert_same_bookkeeping(jax_window, carried)

    rms_j = jax_window.optimize()
    rms_p = port_window.optimize()
    rms_m = carried.optimize()
    assert rms_p[-1] < rms_p[0] and rms_p[-1] < 0.5
    assert np.abs(port_window.t_cw[2:4] - t_true[2:4]).max() < 0.03
    np.testing.assert_allclose(rms_p, rms_j, rtol=1e-4)
    _assert_ba_close([jax_window.q_cw, jax_window.t_cw, jax_window.landmarks],
                     [port_window.q_cw, port_window.t_cw,
                      port_window.landmarks])
    # The one-rank mesh gives the same bits as no mesh.
    np.testing.assert_array_equal(rms_m, rms_p)
    for name in ("q_cw", "t_cw", "landmarks"):
        np.testing.assert_array_equal(getattr(carried, name),
                                      getattr(port_window, name))


def test_sliding_window_slides_and_drops_oldest_as_jax():
    k4 = np.array([100.0, 100.0, 50.0, 50.0], np.float32)
    cfg = jwin.WindowConfig(max_keyframes=2, max_landmarks=4,
                            obs_per_landmark=2)
    windows = [jwin.SlidingWindowBa(k4, cfg),
               window_ba.SlidingWindowBa(k4, window_config_from_jax(cfg),
                                         device="cpu")]
    for w in windows:
        w.add_keyframe([1, 0, 0, 0], [0, 0, 0])
        w.add_keyframe([1, 0, 0, 0], [0, 0, -1])
        s = w.add_landmark([0, 0, 5])
        w.add_observation(s, 0, [50, 50])
        w.add_observation(s, 1, [50, 50])
        w.add_observation(s, 1, [51, 50])   # the ring wraps
        w.add_keyframe([1, 0, 0, 0], [0, 0, -2])  # slides
    _assert_same_bookkeeping(*windows)
    port = windows[1]
    assert port.obs_mask[s].sum() == 2
    np.testing.assert_allclose(port.t_cw[1], [0, 0, -2])
    for w in windows:
        for _ in range(3):
            w.add_landmark([1, 1, 5])
        with pytest.raises(RuntimeError, match="full"):
            w.add_landmark([0, 0, 1])
    _assert_same_bookkeeping(*windows)


# -------------------------------------------------------------- scaling
def test_measure_ba_scaling_reports_jax_keys(mesh):
    got = scaling.measure_ba_scaling(num_landmarks=512, iters=2,
                                     device="cpu")
    want = jscaling.measure_ba_scaling(devices=ONE, num_landmarks=512,
                                       iters=2)
    assert set(got) == set(want)
    assert got["n_devices"] == 1
    assert got["step_ms_1dev"] > 0 and got["local_ms_1dev"] > 0


def test_overhead_vs_landmarks_counts_the_analytic_bytes(mesh):
    got = scaling.measure_overhead_vs_landmarks(l_list=(512, 8192), iters=1,
                                                device="cpu")
    want = jscaling.measure_overhead_vs_landmarks(devices=ONE,
                                                  l_list=(512, 8192), iters=1)
    assert set(got) == set(want)
    assert [set(r) for r in got["sweep"]] == [set(r) for r in want["sweep"]]
    # (On one device XLA drops the all-reduce: JAX's own count is 0 there.)
    assert got["hlo_allreduce_bytes"] == got["analytic_psum_bytes"] == \
        want["analytic_psum_bytes"] > 0
    assert got["serial_ms_measured"] > 0
    assert [r["L"] for r in got["sweep"]] == [512, 8192]
    assert got["sweep"][1]["parallel_ms"] > got["sweep"][0]["parallel_ms"]


def test_scaling_problem_is_jax_problem():
    for want, got in zip(jscaling._make_problem(300, 4, 8),
                         scaling._make_problem(300, 4, 8)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------- launcher
def test_multihost_launcher_simulated_hosts():
    """The launcher's single-machine form: 2 hosts of 2 gloo ranks, each
    rank its own process; the ("dcn", "ici") mesh, JAX's report keys and
    JAX's communication report for the same layout."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    out = subprocess.run(
        [sys.executable, "-m", "feature_tracker_tpu_torch.parallel."
         "multihost_ba", "--simulate-hosts", "2", "--landmarks", "2048",
         "--iters", "4"],
        capture_output=True, text=True, timeout=600, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    rec = json.loads([l for l in out.stdout.splitlines()
                      if l.startswith("{")][-1])
    assert set(rec) == {"hosts", "devices", "mesh", "landmarks", "poses",
                        "iters", "rms_initial", "rms_final", "wall_s",
                        "comm"}
    assert rec["hosts"] == 2 and rec["devices"] == 4
    assert rec["mesh"] == {"dcn": 2, "ici": 2}
    assert rec["rms_final"] < 0.05 * rec["rms_initial"]
    j_mesh = jpar.make_multihost_mesh(2, devices=jax.devices()[:4])
    assert rec["comm"] == jpar.ba_comm_report(8, 2048, 4, j_mesh)


# ------------------------------------------------------- default device
def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    prob = _ba_problem(num_lm=8)
    for call in (lambda: par.make_mesh(),
                 lambda: par.make_multihost_mesh(1),
                 lambda: par.bundle_adjust(*prob),
                 lambda: window_ba.SlidingWindowBa(prob[-1]),
                 lambda: par.measure_ba_scaling(num_landmarks=64),
                 lambda: scaling.measure_overhead_vs_landmarks(l_list=(64,)),
                 lambda: spawn(run_cases, 2, REPO, "cpu", [])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
