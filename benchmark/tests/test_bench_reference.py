"""Each plain reference agrees with the port's own CPU path at a small
size: the front end over a few 96x128 frames, each side following its own
state from the first frame, and RAFT in float32 at 1x64x64 with 12
iterations, at the configuration's widths with weights drawn from a seed;
and the weight layout is the port's model's at ``RaftConfig()``'s widths
too."""

import os

import numpy as np
import torch

from benchmark import frames, harness
from benchmark.reference import frontend as ref_fe
from benchmark.reference import raft as ref_raft

FE_CFG = harness.load_json(os.path.join(harness.BENCH_DIR, "configs",
                                        "euroc_frontend.json"))
RAFT_CFG = harness.load_json(os.path.join(harness.BENCH_DIR, "configs",
                                          "raft_full_sintel.json"))


def ring(traffic, h, w, seed=7):
    return frames.render_ring(frames.Texture(**FE_CFG["texture"]), h, w,
                              traffic, seed, "cpu")


def test_front_end_reference_follows_the_port():
    from feature_tracker_tpu_torch.pipeline import TrackingFrontEnd
    from benchmark.configs import euroc_frontend

    traffic = harness.load_json(os.path.join(harness.BENCH_DIR, "traffic",
                                             "churn.json"))
    traffic["ring"] = 6
    seq = ring(traffic, 96, 128)
    cfg = dict(FE_CFG, height=96, width=128)
    fe = TrackingFrontEnd(euroc_frontend.port_config(cfg), device="cpu")
    state = ref_fe.FrontEndState(cfg["capacity"])
    prev = None
    first_ids = None
    for img in seq:
        got = fe.process_frame(img)
        cur = torch.as_tensor(img)
        uv, status, ids, live, _ = ref_fe.frame(cfg, state, prev, cur)
        prev = cur
        assert np.array_equal(status, got.status)
        assert np.array_equal(ids, got.track_ids)
        assert live == got.num_live
        np.testing.assert_allclose(uv, got.uv, atol=1e-4)
        first_ids = state.next_id if first_ids is None else first_ids
    assert state.next_id > first_ids        # detection ran after frame 0


def test_raft_reference_follows_the_port():
    from feature_tracker_tpu_torch.models.raft import Raft
    from benchmark.configs import raft_full_sintel

    cfg = dict(RAFT_CFG, height=64, width=64, dtype="float32")
    tree = ref_raft.draw_weights(cfg, 11, "cpu")
    model = Raft(raft_full_sintel.port_config(cfg), device="cpu")
    model.load_state_dict(raft_full_sintel.port_state(tree))
    traffic = harness.load_json(os.path.join(harness.BENCH_DIR, "traffic",
                                             "pairs_b1.json"))
    traffic["ring"] = 2
    seq = np.stack([ring(traffic, 64, 64)] * 2 + [ring(traffic, 64, 64, 8)],
                   -1)
    got = model(seq[:1], seq[1:])[-1]
    want = ref_raft.RaftReference(tree, cfg, "cpu")(seq[:1], seq[1:])
    assert got.shape == want.shape == (1, 64, 64, 2)
    assert float(want.abs().max()) > 0.5
    assert float((got - want).abs().max()) < 1e-3


def test_raft_weight_layout_is_the_ports_at_other_widths():
    """The layout worked out from the configuration alone loads into the
    port's model, key for key and shape for shape, at ``RaftConfig()``'s
    widths as well as the configuration's."""
    import dataclasses

    from feature_tracker_tpu_torch.models.raft import Raft, RaftConfig
    from benchmark.configs import raft_full_sintel

    cfg = dataclasses.asdict(RaftConfig())
    model = Raft(RaftConfig(), device="cpu")
    state = raft_full_sintel.port_state(ref_raft.draw_weights(cfg, 3, "cpu"))
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)
