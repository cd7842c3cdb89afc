"""The benchmark's copies of the work arithmetic give ``chip_smoke.py``'s
numbers at its headline shapes, and RAFT's FLOP count adds up."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from benchmark import harness, work


@pytest.fixture(scope="module")
def smoke():
    return harness.load_module(os.path.join(harness.ROOT, "chip_smoke.py"),
                               "chip_smoke_for_bench_tests")


@pytest.mark.parametrize("n,n_tracked,steps", [(10240, 10240, 61234),
                                               (300, 287, 3391)])
def test_klt_work_is_chip_smokes(smoke, n, n_tracked, steps):
    from feature_tracker_tpu_torch.core.config import KltOptions

    opts = KltOptions(max_track_points=n)
    shapes = [(480, 752), (240, 376), (120, 188), (60, 94)]
    fields = {k: getattr(opts, k) for k in ("patch_rows", "patch_cols",
                                            "ex_patch_rows", "ex_patch_cols")}
    assert work.klt_work(fields, shapes, n, n_tracked, steps) == \
        smoke.klt_work(opts, shapes, n, n_tracked, steps)
    assert work.bound(*work.klt_work(fields, shapes, n, n_tracked, steps)) \
        == smoke.bound(*smoke.klt_work(opts, shapes, n, n_tracked, steps))


def test_lookup_work_is_chip_smokes(smoke):
    gen = torch.Generator().manual_seed(0)
    b, h, w, c = 4, 55, 128, 128
    f0 = torch.empty((b, h, w, c))
    pyr = [torch.empty((b, h >> l, w >> l, c)) for l in range(3)]
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                            torch.arange(w, dtype=torch.float32),
                            indexing="ij")
    locs = torch.stack([xs, ys], -1)[None].repeat(b, 1, 1, 1)
    locs = locs + 4.0 * torch.randn(locs.shape, generator=gen)
    locs[0, 0, 0] = float("nan")
    locs[1, 0, 0] = 1e9
    assert work.lookup_work(tuple(f0.shape), [tuple(p.shape) for p in pyr],
                            locs, 3) == smoke.lookup_work(f0, pyr, locs, 3)


def test_raft_flops_counts_the_encoders_and_the_loop():
    from feature_tracker_tpu_torch.models.raft import RaftConfig

    cfg = dataclasses.asdict(RaftConfig(max_iterations=12,
                                        upsample_last_only=True))
    enc = work.encoder_flops(1, 128, 440, 1024, 2) + work.encoder_flops(
        1, 192, 440, 1024, 1)
    # ~0.07 TFLOP per feature-encoder image, ~0.155 for the context one.
    assert 0.28e12 < enc < 0.31e12
    total = work.raft_flops(cfg, 1, 440, 1024, 0)
    loop = 12 * work.update_block_flops(cfg, 55, 128, 1)
    assert total == enc + loop + work.upsample_flops(55, 128, 1)
    assert np.isclose(work.raft_flops(cfg, 4, 440, 1024, 0), 4 * total)
