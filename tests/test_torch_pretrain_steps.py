"""The SuperPoint steps of the port's pretraining driver
(``train/pretrain.py``) against the JAX package's, on the CPU.

Three steps of each from JAX's ``init`` state give JAX's losses within
1e-5 relative, and the first step's moments and parameters agree by the
rules of tests/test_torch_train_models.py: the SuperPoint step with
``point_desc`` off and on and the distillation step (where, on
photometrically augmented images, JAX's own float32 gradients of the
first layers lie up to ~2.5e-3 of the leaf's largest from the same step in
float64, so the port is held to the float64 step by those rules, and to
JAX within them or twice JAX's own distance, see
``assert_first_step_close_f64``). The stages that run these steps are in
tests/test_torch_pretrain_stages.py, the matcher stages in
tests/test_torch_pretrain_matchers.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from feature_tracker_tpu.models import superpoint as jsp
from feature_tracker_tpu.train import pretrain as jpre
from feature_tracker_tpu_torch.convert import options_from_jax
from feature_tracker_tpu_torch.models.superpoint import SuperPoint
from feature_tracker_tpu_torch.train import optim as poptim
from feature_tracker_tpu_torch.train import pretrain as ppre

from test_torch_pretrain import BATCH, HW, SP
from test_torch_train_models import run_three
from test_torch_train_raft import few_threads  # noqa: F401 (a fixture)


# ------------------------------------------------------------ the steps
def jax_sp_variables(cfg=SP, seed=0):
    """``SuperPoint.init`` with every bias and running statistic made
    non-trivial (Flax initialises them to 0 and 1), so that the running
    statistics' gradients count."""
    model = jsp.SuperPoint(cfg)
    variables = jax.jit(model.init)(jax.random.PRNGKey(seed),
                                    jnp.zeros((BATCH, HW, HW, 1),
                                              jnp.float32))
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = path[-1].key
        if name in ("bias", "mean"):
            return jnp.asarray(rng.normal(0, 0.1, x.shape), jnp.float32)
        if name == "var":
            return jnp.asarray(rng.uniform(0.5, 1.5, x.shape), jnp.float32)
        return x

    return model, jax.tree_util.tree_map_with_path(leaf, variables)


def sp_tx(lr=1e-4):
    return optax.chain(optax.clip_by_global_norm(1.0),
                       optax.adamw(lr, weight_decay=1e-5))


def sp_inputs(rng, n, point_desc):
    """``n`` batches of adapt_superpoint's pool entries, made with the JAX
    package's data functions (held equal to the port's above)."""
    out = []
    for _ in range(n):
        entries = []
        for _ in range(BATCH):
            a, b, warp = jpre.warped_texture_pair(rng, HW, HW)
            pts = [(float(x), float(y)) for x, y in
                   rng.uniform(3, HW - 3, (8, 2))]
            labels = [jpre._cell_labels_from_points(
                p, HW, HW) for p in (pts, [tuple(q) for q in warp(
                    np.asarray(pts))])]
            idx, ok = jpre._cell_correspondence(warp, HW // 8, HW // 8)
            entry = [a[..., None], b[..., None], *labels, idx, ok]
            if point_desc:
                entry.extend(jpre._fit_points(pts, warp, HW, HW, cap=16,
                                              rng=rng, n_random=6))
            entries.append(entry)
        out.append([np.stack([e[i] for e in entries])
                    for i in range(len(entries[0]))])
    return out


def without_aux(step):
    def run(params, opt_state, *args):
        params, opt_state, loss, _ = step(params, opt_state, *args)
        return params, opt_state, loss
    return run


def float64_model(cfg):
    """The port's SuperPoint computing in float64 throughout (its heads
    included), for a reference evaluation of a step."""
    from feature_tracker_tpu_torch.models.raft import Conv
    model = SuperPoint(dataclasses.replace(options_from_jax(cfg),
                                           dtype=torch.float64),
                       device="cpu")
    for m in model.modules():
        if isinstance(m, Conv):
            m.compute_dtype = torch.float64
    return model


def assert_first_step_close_f64(make_step, variables, jtx, inputs, port,
                                want):
    """``assert_first_step_close``'s rules, with JAX's own error taken into
    account: on photometrically augmented images JAX's float32 gradients
    of the first layers lie up to ~2.5e-3 of the leaf's largest from the
    same step evaluated in float64 (the port's step with a float64 model
    and state), while the port's lie within the rules. So the port's
    moments are held to the float64 step by the rules, and to JAX's
    within the rules or twice JAX's own distance from the float64 step,
    whichever is larger; the parameters where |g| is above the rules'
    floor and above that distance."""
    from feature_tracker_tpu_torch.convert import model_train_state_from_jax
    p32, o32 = model_train_state_from_jax(variables, jtx.init(variables),
                                          device="cpu")
    p64 = {k: v.double() for k, v in p32.items()}
    o64 = {"count": o32["count"],
           "mu": {k: v.double() for k, v in o32["mu"].items()},
           "nu": {k: v.double() for k, v in o32["nu"].items()}}
    _, ref, _, _ = make_step(p64, o64, *inputs[0])
    want_p, want_o = model_train_state_from_jax(*want, device="cpu")
    got_p, got_o = port
    assert list(got_p) == list(want_p)
    assert int(got_o["count"]) == int(want_o["count"]) == 1
    spread = {}
    for moment in ("mu", "nu"):
        top = max(float(v.abs().max()) for v in ref[moment].values())
        for k, r in ref[moment].items():
            rule = 1e-3 * float(r.abs().max()) + 1e-6 * top
            got = got_o[moment][k].double()
            assert float((got - r).abs().max()) <= rule, ("f64", moment, k)
            jerr = float((want_o[moment][k].double() - r).abs().max())
            spread[moment, k] = jerr
            d = float((got_o[moment][k] - want_o[moment][k]).abs().max())
            assert d <= max(rule, 2.0 * jerr), (moment, k)
    floor = 1e-6 * max(float(v.abs().max()) for v in want_o["mu"].values())
    for k, w in want_p.items():
        g = want_o["mu"][k].abs()
        sel = ((g > 1e-3 * g.max()) & (g > floor)
               & (g > 2.0 * spread["mu", k]))
        if sel.any():
            assert float((got_p[k] - w).abs()[sel].max()) <= 1e-6, k


@pytest.mark.parametrize("point_desc", [False, True])
def test_sp_steps_match_jax(point_desc):
    jmodel, variables = jax_sp_variables()
    hc = HW // 8
    jtx = sp_tx()
    jstep = jpre._make_sp_step(jmodel, jtx, hc, hc, point_desc=point_desc)
    pstep = ppre._make_sp_step(SuperPoint(options_from_jax(SP),
                                          device="cpu"),
                               poptim.ClipAdamW(1e-4, weight_decay=1e-5),
                               hc, hc, point_desc=point_desc)
    inputs = sp_inputs(np.random.default_rng(1), 3, point_desc)
    port, want = run_three(without_aux(jstep), variables,
                           jtx.init(variables), without_aux(pstep), inputs)
    step64 = ppre._make_sp_step(float64_model(SP),
                                poptim.ClipAdamW(1e-4, weight_decay=1e-5),
                                hc, hc, point_desc=point_desc)
    assert_first_step_close_f64(step64, variables, jtx, inputs, port, want)


def test_sp_distill_steps_match_jax():
    """The distillation step at SuperPoint's shipped width (its targets
    are 256-d)."""
    cfg = jsp.SuperPointConfig()
    jmodel, variables = jax_sp_variables(cfg, seed=2)
    jtx = sp_tx(2e-4)
    jstep = jpre._make_sp_distill_step(jmodel, jtx)
    pstep = ppre._make_sp_distill_step(
        SuperPoint(options_from_jax(cfg), device="cpu"),
        poptim.ClipAdamW(2e-4, weight_decay=1e-5))
    rng = np.random.default_rng(3)
    inputs = []
    for batch in sp_inputs(rng, 3, True):
        imgs_a, imgs_b, la, lb, _, _, ua, ub, pv = batch
        tgt = rng.normal(0, 1, (2,) + ua.shape[:2] + (256,))
        tgt /= np.linalg.norm(tgt, axis=-1, keepdims=True)
        tgt = (tgt * pv[None, ..., None]).astype(np.float32)
        inputs.append([imgs_a, imgs_b, la, lb, ua, ub, pv, *tgt])
    port, want = run_three(without_aux(jstep), variables,
                           jtx.init(variables), without_aux(pstep), inputs)
    step64 = ppre._make_sp_distill_step(
        float64_model(cfg), poptim.ClipAdamW(2e-4, weight_decay=1e-5))
    assert_first_step_close_f64(step64, variables, jtx, inputs, port, want)
