"""CPU parity of the port's DISK with the JAX package.

The same numpy inputs go through the Flax model and the port on the CPU.
Seeded weights are initialised by Flax under ``jax.jit``, every bias
perturbed with numpy, and carried over by ``disk_state_from_jax``; the
shipped ``weights/disk.npz`` goes to both sides through their own loaders.

Tolerances, and what was observed on the CPU when they were set:
  - heatmap: 1e-5 absolute;
  - dense descriptor field: 1e-4 of the field's largest magnitude;
  - keypoints (uv and num): equal, also on images that are no multiple of
    8 (padded at the bottom and right, the maps cropped back);
  - sampled descriptors: 1e-5 (observed <= 6e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_tracker_tpu.models import disk as jdisk
from feature_tracker_tpu_torch.convert import disk_state_from_jax
from feature_tracker_tpu_torch.models import disk
from synthetic import Texture


def _perturbed(variables, seed):
    """Flax variables as numpy, every bias made non-zero."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        x = np.asarray(x, np.float32)
        if path[-1].key == "bias":
            return rng.normal(0, 0.1, x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(leaf, jax.device_get(variables))


def _close_to_scale(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


@pytest.fixture(scope="module")
def seeded():
    model = jdisk.Disk()
    variables = _perturbed(jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 96, 1))), 2)
    state = disk_state_from_jax(variables)
    return model, variables, state


def test_disk_matches_jax_on_seeded_weights(seeded):
    model, variables, state = seeded
    img = Texture(4).render(64, 96)[None, :, :, None]
    want_heat, want_desc = model.apply(variables, jnp.asarray(img))
    port = disk.Disk(device="cpu")
    port.load_state_dict(state)
    heat, desc = port(img)
    np.testing.assert_allclose(heat.numpy(), np.asarray(want_heat), rtol=0,
                               atol=1e-5)
    _close_to_scale(desc.numpy(), want_desc, 1e-4)


@pytest.mark.parametrize("shape", [(64, 96), (61, 90)])
def test_seeded_detector_detects_what_jax_detects(seeded, shape):
    model, variables, state = seeded
    img = Texture(5).render(*shape)
    jdet = jdisk.DiskDetector(variables, max_features=50)
    want_uv, want_d, want_num = jdet.detect(jnp.asarray(img))
    det = disk.DiskDetector(state, max_features=50, device="cpu")
    uv, d, num = det.detect(img)
    assert int(num) == int(want_num) > 0
    np.testing.assert_array_equal(uv.numpy(), np.asarray(want_uv))
    np.testing.assert_allclose(d.numpy(), np.asarray(want_d), rtol=0,
                               atol=1e-5)


@pytest.fixture(scope="module")
def shipped():
    """Both detectors on the shipped weights, and the JAX side's outputs
    at 120x160 and at 100x150 (no multiple of 8), computed once."""
    jdet = jdisk.DiskDetector.from_file()
    det = disk.DiskDetector.from_file(device="cpu")
    assert jdet is not None and det is not None
    want = {}
    for shape in ((120, 160), (100, 150)):
        img = Texture(2).render(*shape)
        uv, d, num = jdet.detect(jnp.asarray(img))
        want[shape] = (img, {"uv": np.asarray(uv), "d": np.asarray(d),
                             "num": int(num)})
    img = want[(120, 160)][0]
    heat, desc = jdet.model.apply(jdet.variables,
                                  jnp.asarray(img)[None, :, :, None])
    want[(120, 160)][1].update(heat=np.asarray(heat), desc=np.asarray(desc))
    return det, want


def test_shipped_disk_maps_match_jax(shipped):
    det, want = shipped
    img, w = want[(120, 160)]
    heat, desc = det.model(img[None, :, :, None])
    np.testing.assert_allclose(heat.numpy(), w["heat"], rtol=0, atol=1e-5)
    _close_to_scale(desc.numpy(), w["desc"], 1e-4)


@pytest.mark.parametrize("shape", [(120, 160), (100, 150)])
def test_shipped_disk_detects_what_jax_detects(shipped, shape):
    det, want = shipped
    img, w = want[shape]
    uv, d, num = det.detect(img)
    assert int(num) == w["num"] == 300
    np.testing.assert_array_equal(uv.numpy(), w["uv"])
    np.testing.assert_allclose(d.numpy(), w["d"], rtol=0, atol=1e-5)
    assert d.shape == (300, 128)


def test_sample_descriptors_fullres_match_jax():
    rng = np.random.default_rng(6)
    field = rng.normal(0, 1, (20, 30, 8)).astype(np.float32)
    uv = np.concatenate([rng.uniform(0, 30, (20, 2)),
                         [[0, 0], [29, 19], [-1, -1], [40, 2.5]]]
                        ).astype(np.float32)
    want = jdisk.sample_descriptors_fullres(jnp.asarray(field),
                                            jnp.asarray(uv))
    got = disk.sample_descriptors_fullres(torch.from_numpy(field),
                                          torch.from_numpy(uv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_detector_entry_points(tmp_path):
    assert disk.DiskDetector.from_file(str(tmp_path / "absent.npz"),
                                       device="cpu") is None
    small = disk.DiskConfig(descriptor_dim=16, base_channels=8, depth=2)
    det = disk.DiskDetector.init_random(3, cfg=small, device="cpu")
    uv, d, num = det.detect(Texture(0).render(30, 45))
    assert uv.shape == (300, 2) and d.shape == (300, 16)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            disk.DiskDetector.from_file()
