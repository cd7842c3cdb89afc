"""RAFT's input path (``models/raft.py::_normalised_frames``): frames
cross to the model's device in their own dtype (``uint8`` as they are) and
are made float32 there. That gives the same normalised frames, bit for bit,
as the host float32 expression below, and the same flows;
``raft.input.h2d_bytes`` counts what crossed from the host. On the CPU nothing crosses, so the counting is held on the ``meta``
device, which stands for any device but the host."""

import numpy as np
import pytest
import torch

from feature_tracker_tpu_torch.models import raft
from feature_tracker_tpu_torch.utils import profiling

H, W = 32, 48
CFG = raft.RaftConfig(
    in_channels=3, max_iterations=2, feature_channels=16,
    context_channels=16, hidden_channels=16, correlation_pyramid_levels=2,
    correlation_radius=2, correlation_hidden_channels=16,
    correlation_out_channels=8, flow_hidden_channels=8, flow_out_channels=8,
    motion_out_channels=8, mask_hidden_channels=16)


def parent_frames(img, device, dtype):
    """The input expression before uint8 frames crossed as they are: the
    oracle."""
    return (2.0 * (torch.as_tensor(img, dtype=torch.float32, device=device)
                   / 255.0) - 1.0).to(dtype)


def _pair(b, seed=0):
    """Two ``uint8`` ``[b, H, W, 3]`` frames, the second the first shifted
    by (2, 1) px."""
    base = np.random.default_rng(seed).integers(
        0, 256, (b, H + 4, W + 4, 3), dtype=np.uint8)
    return (np.ascontiguousarray(base[:, 2:H + 2, 2:W + 2]),
            np.ascontiguousarray(base[:, 1:H + 1, :W]))


def _view(b):
    """A ``uint8`` pair of strided views: every other row of a taller
    frame."""
    base = np.random.default_rng(1).integers(
        0, 256, (b, 2 * H + 2, W, 3), dtype=np.uint8)
    return base[:, :2 * H:2], base[:, 2::2]


# name -> the pair
CASES = {
    "uint8-b1": lambda: _pair(1),
    "uint8-b4": lambda: _pair(4),
    "uint8-view": lambda: _view(2),
    "uint8-tensor": lambda: tuple(map(torch.from_numpy, _pair(2))),
    "int16": lambda: tuple(x.astype(np.int16) for x in _pair(2)),
    "float32": lambda: tuple(x.astype(np.float32) for x in _pair(2)),
    "float64": lambda: tuple(x.astype(np.float64) for x in _pair(2)),
}


@pytest.fixture(autouse=True)
def tracing_off():
    profiling.disable()
    profiling.reset()
    yield
    profiling.disable()
    profiling.reset()


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(5)
    return raft.Raft(CFG, device="cpu")


def test_the_view_case_is_strided():
    assert not _view(2)[0].flags["C_CONTIGUOUS"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", CASES)
def test_normalised_frames_are_the_parents(name, dtype):
    for img in CASES[name]():
        got = raft._normalised_frames(img, torch.device("cpu"), dtype)
        want = parent_frames(img, torch.device("cpu"), dtype)
        assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("name", CASES)
def test_h2d_bytes_counts_what_crosses_from_the_host(name):
    img = CASES[name]()[0]
    profiling.enable()
    with profiling.span("crossing"):
        out = raft._normalised_frames(img, torch.device("meta"),
                                      torch.bfloat16)
    with profiling.span("staying"):
        raft._normalised_frames(img, torch.device("cpu"), torch.bfloat16)
    with profiling.span("on the device"):
        raft._normalised_frames(torch.as_tensor(img, device="meta"),
                                torch.device("meta"), torch.bfloat16)
    assert out.device.type == "meta" and out.dtype == torch.bfloat16
    assert out.shape == tuple(img.shape)
    size = torch.as_tensor(img).element_size()  # uint8: 1, float32: 4
    assert profiling.snapshot().counters["raft.input.h2d_bytes"] == {
        0: size * int(np.prod(img.shape)), 1: 0, 2: 0}


@pytest.mark.parametrize("name", CASES)
def test_flows_are_the_parents(model, name, monkeypatch):
    """Two calls: one ``raft.input`` span in each, under ``raft.forward``;
    the flows equal those of the oracle's input path, bit for bit."""
    ref, cur = CASES[name]()
    profiling.enable()
    got = [model(ref, cur) for _ in range(2)]
    snap = profiling.snapshot()
    inputs = snap.select("raft.input")
    assert snap.calls == 2 and inputs.sum() == 2
    assert sorted(snap.call[inputs].tolist()) == [0, 1]
    assert all(snap.names[snap.name[p]] == "raft.forward"
               for p in snap.parent[inputs])
    assert snap.counter("raft.input.h2d_bytes") == 0    # the CPU's own
    monkeypatch.setattr(raft, "_normalised_frames", parent_frames)
    want = model(ref, cur)
    assert torch.equal(got[0], want) and torch.equal(got[1], want)
