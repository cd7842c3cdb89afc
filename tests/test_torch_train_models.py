"""The port's SuperPoint, DISK and LightGlue trainers against the JAX
package's, on the CPU.

For each trainer: its data function gives JAX's arrays bit for bit for the
same seed; three steps from JAX's ``model.init`` state (carried over by
``convert.model_train_state_from_jax``) give JAX's losses within 1e-5
relative, and the first step's moments and parameters agree by the rules
of tests/test_torch_train_raft.py (the gradient read from ``mu``, each
leaf within 1e-3 of its largest value plus 1e-6 of the largest over all
leaves; parameters within 1e-6 where |g| is above 1e-3 of its leaf's
largest and that floor). SuperPoint's moments include those of its batch
statistics, which its trainer optimises. The JAX trainability tests run on
the port at their own sizes and thresholds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_tracker_tpu.models import disk as jdisk
from feature_tracker_tpu.models import lightglue as jlg
from feature_tracker_tpu.models import superpoint as jsp
from feature_tracker_tpu.train import disk_train as jdt
from feature_tracker_tpu.train import lightglue_train as jlt
from feature_tracker_tpu.train import pretrain as jpre
from feature_tracker_tpu.train import raft_pretrain as jrp
from feature_tracker_tpu.train import superpoint_train as jst
from feature_tracker_tpu_torch.convert import (
    model_train_state_from_jax,
    options_from_jax,
)
from feature_tracker_tpu_torch.models.disk import (
    Disk,
    sample_descriptors_fullres,
)
from feature_tracker_tpu_torch.models.lightglue import LightGlue
from feature_tracker_tpu_torch.models.superpoint import (
    SuperPoint,
    select_keypoints,
)
from feature_tracker_tpu_torch.train import disk_train as pdt
from feature_tracker_tpu_torch.train import lightglue_train as plt
from feature_tracker_tpu_torch.train import pretrain as ppre
from feature_tracker_tpu_torch.train import raft_pretrain as prp
from feature_tracker_tpu_torch.train import superpoint_train as pst

from test_torch_train_raft import few_threads  # noqa: F401 (a fixture)

SP = jsp.SuperPointConfig(descriptor_dim=32)
DISK = jdisk.DiskConfig(descriptor_dim=16, base_channels=8, depth=2)
LG = jlg.LightGlueConfig(descriptor_dim=16, model_dim=32, num_heads=2,
                         depth=2)


def assert_first_step_close(port, jax_pair):
    """(params, opt_state) of the port against JAX's after one step."""
    want_p, want_o = model_train_state_from_jax(*jax_pair, device="cpu")
    got_p, got_o = port
    assert list(got_p) == list(want_p)
    assert int(got_o["count"]) == int(want_o["count"]) == 1
    floor = 1e-6 * max(float(v.abs().max()) for v in want_o["mu"].values())
    for moment in ("mu", "nu"):
        top = max(float(v.abs().max()) for v in want_o[moment].values())
        for k, w in want_o[moment].items():
            d = float((got_o[moment][k] - w).abs().max())
            assert d <= 1e-3 * float(w.abs().max()) + 1e-6 * top, (moment, k)
    for k, w in want_p.items():
        g = want_o["mu"][k].abs()
        sel = (g > 1e-3 * g.max()) & (g > floor)
        if sel.any():
            assert float((got_p[k] - w).abs()[sel].max()) <= 1e-6, k


def run_three(jstep, jparams, jopt, pstep, inputs):
    """Three steps on both sides from the same state; returns the port's
    first-step state, JAX's, and both loss lists."""
    params, opt = model_train_state_from_jax(jparams, jopt, device="cpu")
    jl, pl, first = [], [], None
    for args in inputs:
        jparams, jopt, jm = jstep(jparams, jopt, *args)
        params, opt, pm = pstep(params, opt, *args)
        jl.append(float(jm["loss"] if isinstance(jm, dict) else jm))
        pl.append(float(pm["loss"] if isinstance(pm, dict) else pm))
        if first is None:
            first = ((params, opt), (jparams, jopt))
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    return first


# ----------------------------------------------------------- SuperPoint
def sp_batch(rng, b=2, h=32, w=32):
    imgs, labs = [], []
    for _ in range(b):
        img, corners = jst.synthetic_corners_image(rng, h, w)
        imgs.append(img[..., None])
        labs.append(jst.corner_label_map(corners, h, w))
    return np.stack(imgs), np.stack(labs)


def test_superpoint_data_is_jax_data():
    a, b = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(3):
        ji, jc = jst.synthetic_corners_image(a, 64, 48)
        pi, pc = pst.synthetic_corners_image(b, 64, 48)
        np.testing.assert_array_equal(pi, ji)
        np.testing.assert_array_equal(pc, jc)
        np.testing.assert_array_equal(pst.corner_label_map(pc, 64, 48),
                                      jst.corner_label_map(jc, 64, 48))


def test_superpoint_steps_match_jax():
    jmodel = jsp.SuperPoint(SP)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  jnp.zeros((2, 32, 32, 1), jnp.float32))
    rng = np.random.default_rng(0)
    # Running statistics away from 0 / 1, so that their gradients count.
    params = {"params": params["params"], "batch_stats": jax.tree_util.
              tree_map(lambda x: x + jnp.asarray(rng.uniform(0.1, 0.5,
                                                             x.shape),
                                                 jnp.float32),
                       params["batch_stats"])}
    jstep, jtx = jst.make_train_step(jmodel, jst.SuperPointTrainConfig())
    pstep, _ = pst.make_train_step(SuperPoint(options_from_jax(SP),
                                              device="cpu"),
                                   pst.SuperPointTrainConfig())
    port, want = run_three(jstep, params, jtx.init(params), pstep,
                           [sp_batch(rng) for _ in range(3)])
    assert any("running_var" in k for k in port[1]["mu"])
    assert_first_step_close(port, want)


def test_superpoint_learns_corners():
    """tests/test_superpoint_train.py's trainability test on the port."""
    cfg = options_from_jax(SP)
    model, params, losses = pst.train_synthetic(
        cfg, pst.SuperPointTrainConfig(), steps=150, h=64, w=64, batch=8,
        seed=0, device="cpu")
    first = np.mean(losses[:5])
    last = np.mean(losses[-5:])
    assert last < first * 0.8, (first, last)

    rng = np.random.default_rng(99)
    img, corners = pst.synthetic_corners_image(rng, 64, 64)
    heat, _ = model(img[None, :, :, None])
    uv, num = select_keypoints(heat[0], 16, 0.01, 4)
    uv = uv.numpy()[:int(num)]
    assert len(uv) > 0
    d = np.sqrt(((uv[:, None, :] - corners[None, :, :]) ** 2).sum(-1))
    mean_nearest = d.min(axis=1).mean()
    assert mean_nearest < 8.0, mean_nearest


# ----------------------------------------------------------------- DISK
def disk_inputs(rng, n, h=32, w=32, samples=24):
    out = []
    for _ in range(n):
        a, b, (dx, dy) = jdt.translated_training_pair(rng, h, w)
        uv_a = rng.uniform(6, [w - 6, h - 6], (samples, 2)).astype(np.float32)
        out.append((a, b, uv_a, uv_a + np.array([dx, dy], np.float32)))
    return out


def test_disk_data_is_jax_data():
    a, b = np.random.default_rng(4), np.random.default_rng(4)
    for _ in range(3):
        ja, jb, jd = jdt.translated_training_pair(a, 48, 40)
        pa, pb, pd = pdt.translated_training_pair(b, 48, 40)
        np.testing.assert_array_equal(pa, ja)
        np.testing.assert_array_equal(pb, jb)
        assert pd == jd


@pytest.mark.parametrize("hinge", [0.0, 1.0])
def test_disk_steps_match_jax(hinge):
    jmodel = jdisk.Disk(DISK)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(1),
                                  jnp.zeros((1, 32, 32, 1), jnp.float32))
    cfg = dict(num_samples=24, pos_hinge_weight=hinge, pos_hinge_margin=1.01)
    jstep, jtx = jdt.make_train_step(jmodel, jdt.DiskTrainConfig(**cfg))
    pstep, _ = pdt.make_train_step(Disk(options_from_jax(DISK),
                                        device="cpu"),
                                   pdt.DiskTrainConfig(**cfg))
    rng = np.random.default_rng(1)
    port, want = run_three(jstep, params, jtx.init(params), pstep,
                           disk_inputs(rng, 3))
    assert_first_step_close(port, want)


def test_disk_descriptors_learn_correspondence():
    """tests/test_disk_train.py's trainability test on the port."""
    model, params, losses = pdt.train_synthetic(
        options_from_jax(DISK), pdt.DiskTrainConfig(), steps=40, h=64, w=64,
        seed=0, device="cpu")
    first = np.mean(losses[:5])
    last = np.mean(losses[-5:])
    assert last < first * 0.6, (first, last)

    rng = np.random.default_rng(123)
    a, b, (dx, dy) = pdt.translated_training_pair(rng, 64, 64)
    uv_a = rng.uniform(10, 54, (64, 2)).astype(np.float32)
    uv_b = uv_a + np.array([dx, dy], np.float32)
    _, da_map = model(a[None, :, :, None])
    _, db_map = model(b[None, :, :, None])
    da = sample_descriptors_fullres(da_map[0], torch.tensor(uv_a)).numpy()
    db = sample_descriptors_fullres(db_map[0], torch.tensor(uv_b)).numpy()
    acc = ((da @ db.T).argmax(axis=1) == np.arange(64)).mean()
    assert acc > 0.5, acc


# ------------------------------------------------------------ LightGlue
def lg_inputs(rng, n, k=24, matched=14):
    return [jlt.synthetic_matching_problem(rng, k, k, LG.descriptor_dim,
                                           matched) for _ in range(n)]


def test_lightglue_data_is_jax_data():
    a, b = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(3):
        for j, p in zip(jlt.synthetic_matching_problem(a, 20, 30, 16, 12),
                        plt.synthetic_matching_problem(b, 20, 30, 16, 12)):
            np.testing.assert_array_equal(p, j)


def test_lightglue_steps_match_jax():
    jmodel = jlg.LightGlue(LG)
    rng = np.random.default_rng(2)
    k0, d0, k1, d1, _ = lg_inputs(rng, 1)[0]
    params = jax.jit(jmodel.init)(
        jax.random.PRNGKey(2), k0, d0, jnp.ones(24, bool), k1, d1,
        jnp.ones(24, bool))
    jstep, jtx = jlt.make_train_step(jmodel, jlt.LightGlueTrainConfig())
    pstep, _ = plt.make_train_step(LightGlue(options_from_jax(LG),
                                             device="cpu"),
                                   plt.LightGlueTrainConfig())
    port, want = run_three(jstep, params, jtx.init(params), pstep,
                           lg_inputs(rng, 3))
    assert_first_step_close(port, want)


def test_lightglue_loss_slot_zero_as_jax_computes_it():
    """Every unmatchable ref point writes False to cur slot 0 in JAX's
    scatter, and that write wins: a true match in slot 0 then counts as
    unmatchable too. The port reproduces it; with every ref point matched
    slot 0 counts as hit."""
    rng = np.random.default_rng(6)
    n, m = 6, 7
    scores = rng.normal(-3, 1, (n, m)).astype(np.float32)
    l0 = rng.normal(0, 1, n).astype(np.float32)
    l1 = rng.normal(0, 1, m).astype(np.float32)
    for gt in ([0, 3, -1, 5, -1, 2],     # slot 0 matched, unmatched after
               [-1, 0, 3, 5, 2, -1],     # unmatched before the match
               [0, 3, 1, 5, 4, 2]):      # every ref point matched
        gt = np.asarray(gt, np.int32)
        want = float(jlt.lightglue_loss(jnp.asarray(scores), jnp.asarray(l0),
                                        jnp.asarray(l1), jnp.asarray(gt)))
        got = float(plt.lightglue_loss(torch.tensor(scores), torch.tensor(l0),
                                       torch.tensor(l1),
                                       torch.tensor(gt).long()))
        np.testing.assert_allclose(got, want, rtol=1e-6)
        # The same loss with slot 0's hit decided by the rule above.
        matched = gt >= 0
        hit = np.zeros(m, bool)
        hit[gt[matched]] = True
        hit[0] &= bool(matched.all())
        pos = -sum(scores[i, gt[i]] for i in range(n) if matched[i])
        neg0 = -np.sum(np.where(matched, 0.0, -np.logaddexp(0, l0)))
        neg1 = -np.sum(np.where(hit, 0.0, -np.logaddexp(0, l1)))
        np.testing.assert_allclose(
            got, (pos + 0.5 * (neg0 + neg1)) / matched.sum(), rtol=1e-5)


def test_lightglue_learns_synthetic_matching():
    """tests/test_lightglue_train.py's trainability test on the port."""
    _, history = plt.train_synthetic(options_from_jax(LG),
                                     plt.LightGlueTrainConfig(), steps=60,
                                     n=48, m=48, matched=32, seed=1,
                                     device="cpu")
    first = np.mean([h["loss"] for h in history[:5]])
    last = np.mean([h["loss"] for h in history[-5:]])
    assert last < first * 0.5, (first, last)
    acc_last = np.mean([h["assignment_acc"] for h in history[-5:]])
    acc_first = np.mean([h["assignment_acc"] for h in history[:5]])
    assert acc_last > acc_first
    assert acc_last > 0.5, acc_last


# --------------------------------------------------- synthetic RAFT pairs
def test_warped_texture_pair_and_flow_sample_are_jax_data():
    a, b = np.random.default_rng(7), np.random.default_rng(7)
    assert ppre._real_image_pool() == jpre._real_image_pool() == []
    for augment in (True, False):
        ja, jb, jw = jpre.warped_texture_pair(a, 24, 32, augment=augment)
        pa, pb, pw = ppre.warped_texture_pair(b, 24, 32, augment=augment)
        np.testing.assert_array_equal(pa, ja)
        np.testing.assert_array_equal(pb, jb)
        pts = np.array([[1.0, 2.0], [30.0, 5.5]])
        np.testing.assert_array_equal(pw(pts), jw(pts))
        for j, p in zip(jrp.synthetic_flow_sample(a, 24, 32),
                        prp.synthetic_flow_sample(b, 24, 32)):
            np.testing.assert_array_equal(p, j)
    pool = prp.make_pool(np.random.default_rng(8), 2, 16, 24, 3,
                         device="cpu")
    want = jrp.make_pool(np.random.default_rng(8), 2, 16, 24, 3)
    for got_batch, want_batch in zip(pool, want):
        for g, w in zip(got_batch, want_batch):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert prp.make_real_pool(np.random.default_rng(0), 2, 16, 16, 2,
                              device="cpu") == []
