"""CPU parity of the port's SuperPoint with the JAX package.

The same numpy inputs go through the Flax model and the port on the CPU.
Seeded weights are initialised by Flax under ``jax.jit``, every bias, scale
and running statistic perturbed with numpy, and carried over by
``superpoint_state_from_jax``; the shipped ``weights/superpoint.npz`` goes
to both sides through their own loaders.

Tolerances, and what was observed on the CPU when they were set:
  - heatmap: 1e-5 absolute (observed 5.8e-7 with the shipped weights);
  - dense descriptors: 1e-4 of the map's largest magnitude (observed
    8.1e-7): the convolutions sum in another order;
  - keypoints (uv and num): equal; ``select_keypoints`` on one heatmap:
    bit-equal;
  - sampled descriptors: 1e-5 (observed 2.5e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_tracker_tpu.models import superpoint as jsp
from feature_tracker_tpu_torch.convert import superpoint_state_from_jax
from feature_tracker_tpu_torch.models import superpoint as sp
from synthetic import Texture


def _perturbed(variables, seed):
    """Flax variables as numpy, with every bias, scale and running
    statistic made non-trivial (Flax initialises them to 0 and 1)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = path[-1].key
        x = np.asarray(x, np.float32)
        if name in ("bias", "mean"):
            return rng.normal(0, 0.1, x.shape).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(leaf, jax.device_get(variables))


def _close_to_scale(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


@pytest.fixture(scope="module")
def seeded():
    model = jsp.SuperPoint()
    variables = _perturbed(jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 96, 1))), 1)
    port = sp.SuperPoint(device="cpu")
    port.load_state_dict(superpoint_state_from_jax(variables))
    return model, variables, port


@pytest.mark.parametrize("shape", [(64, 96), (68, 100)])
def test_superpoint_matches_jax_on_seeded_weights(seeded, shape):
    model, variables, port = seeded
    img = Texture(3).render(*shape)[None, :, :, None]
    want_heat, want_desc = model.apply(variables, jnp.asarray(img))
    heat, desc = port(img)
    # 68x100 is no multiple of 8: the pools drop the last rows, in both.
    assert heat.shape == (1, shape[0] // 8 * 8, shape[1] // 8 * 8)
    np.testing.assert_allclose(heat.numpy(), np.asarray(want_heat), rtol=0,
                               atol=1e-5)
    _close_to_scale(desc.numpy(), want_desc, 1e-4)


def test_superpoint_training_mode_matches_jax(seeded):
    """``train=True`` against ``apply(..., train=True,
    mutable=["batch_stats"])``: outputs on the batch's statistics, and the
    new running statistics (``0.9 * old + 0.1 * batch``, the batch
    variance biased) within 1e-5 of their scale."""
    model, variables, _ = seeded
    rng = np.random.default_rng(4)
    img = np.stack([Texture(s).render(48, 64) + rng.normal(0, 2, (48, 64))
                    for s in (5, 6, 7)]).astype(np.float32)[..., None]
    (want_heat, want_desc), new = model.apply(
        variables, jnp.asarray(img), train=True, mutable=["batch_stats"])
    port = sp.SuperPoint(device="cpu")
    port.load_state_dict(superpoint_state_from_jax(variables))
    (heat, desc), stats = port(img, train=True)
    assert heat.requires_grad and desc.requires_grad
    np.testing.assert_allclose(heat.detach().numpy(), np.asarray(want_heat),
                               rtol=0, atol=1e-5)
    _close_to_scale(desc.detach().numpy(), want_desc, 1e-4)
    want_stats = {k: v for k, v in superpoint_state_from_jax(new).items()
                  if not k.endswith("num_batches_tracked")}
    assert sorted(stats) == sorted(want_stats) and len(stats) == 20
    for k, w in want_stats.items():
        _close_to_scale(stats[k].numpy(), w.numpy(), 1e-5)
        assert torch.equal(port.state_dict()[k], stats[k])
    # Inference afterwards reads the updated running statistics.
    heat2, _ = port(img)
    want2, _ = model.apply({**variables, **new}, jnp.asarray(img))
    np.testing.assert_allclose(heat2.numpy(), np.asarray(want2), rtol=0,
                               atol=1e-5)


@pytest.fixture(scope="module")
def shipped():
    """Both detectors on the shipped weights, and the JAX side's outputs
    on a 120x160 synthetic image, computed once."""
    jdet = jsp.SuperPointDetector.from_file()
    det = sp.SuperPointDetector.from_file(device="cpu")
    assert jdet is not None and det is not None
    img = Texture(1).render(120, 160)
    heat, desc = jdet.model.apply(jdet.variables,
                                  jnp.asarray(img)[None, :, :, None])
    uv, d, num = jdet.detect(jnp.asarray(img))
    want = {k: np.asarray(v) for k, v in dict(
        heat=heat, desc=desc, uv=uv, d=d, num=num).items()}
    return det, img, want


def test_shipped_superpoint_maps_match_jax(shipped):
    det, img, want = shipped
    heat, desc = det.model(img[None, :, :, None])
    np.testing.assert_allclose(heat.numpy(), want["heat"], rtol=0, atol=1e-5)
    _close_to_scale(desc.numpy(), want["desc"], 1e-4)


def test_shipped_superpoint_detects_what_jax_detects(shipped):
    det, img, want = shipped
    uv, d, num = det.detect(img)
    assert int(num) == int(want["num"]) == 300
    assert num.dtype == torch.int32
    np.testing.assert_array_equal(uv.numpy(), want["uv"])
    np.testing.assert_allclose(d.numpy(), want["d"], rtol=0, atol=1e-5)
    assert d.shape == (300, 256)


def _heatmaps():
    """Heatmaps for select_keypoints: the shipped model's, one quantised to
    plant ties (equal scores, also between neighbours), one with nothing
    above the threshold, one with a single candidate."""
    rng = np.random.default_rng(4)
    heat = Texture(1).render(48, 64) / 255.0
    tied = np.round(rng.uniform(0, 1, (40, 56)) * 4) / 4
    flat = np.full((32, 32), 0.001)
    single = np.zeros((32, 40))
    single[10, 17] = 0.5
    return {"texture": heat, "tied": tied, "flat": flat, "single": single}


@pytest.mark.parametrize("name", ["texture", "tied", "flat", "single"])
@pytest.mark.parametrize("max_num,min_response,min_distance",
                         [(300, 0.005, 4), (7, 0.3, 8)])
def test_select_keypoints_is_bit_equal(name, max_num, min_response,
                                       min_distance):
    heat = _heatmaps()[name].astype(np.float32)
    want_uv, want_num = jsp.select_keypoints(jnp.asarray(heat), max_num,
                                             min_response, min_distance)
    uv, num = sp.select_keypoints(torch.from_numpy(heat), max_num,
                                  min_response, min_distance)
    assert int(num) == int(want_num)
    np.testing.assert_array_equal(uv.numpy(), np.asarray(want_uv))


def test_sample_descriptors_match_jax():
    rng = np.random.default_rng(5)
    desc = rng.normal(0, 1, (8, 12, 16)).astype(np.float32)
    # Inside, on the border, off the map and the (-1, -1) padding.
    uv = np.concatenate([rng.uniform(0, 96, (20, 2)),
                         [[0, 0], [95, 63], [-1, -1], [200, -30],
                          [3.5, 60.25]]]).astype(np.float32)
    want = jsp.sample_descriptors(jnp.asarray(desc), jnp.asarray(uv))
    got = sp.sample_descriptors(torch.from_numpy(desc), torch.from_numpy(uv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_detector_entry_points(tmp_path):
    assert sp.SuperPointDetector.from_file(
        str(tmp_path / "absent.npz"), device="cpu") is None
    a = sp.SuperPointDetector.init_random(7, device="cpu")
    b = sp.SuperPointDetector.init_random(torch.Generator().manual_seed(7),
                                          device="cpu")
    c = sp.SuperPointDetector.init_random(7, device="cpu")
    assert all(torch.equal(a.variables[k], c.variables[k])
               for k in a.variables)
    assert not torch.equal(a.variables["Conv_0.weight"],
                           b.variables["Conv_0.weight"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            sp.SuperPointDetector.from_file()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            sp.SuperPoint()
