"""The graph path (``utils/graphs.py::GraphCache``) on the CPU: when it
engages under ``models/raft.py::UpdateBlock``, what keys a graph of the
update block and of CoTracker2's former, and, with a stand-in for a
captured graph that re-runs the block on the graph's own tensors at each
replay, what the cache copies, keeps and returns, against the eager block.
Inputs that say they are on the card stand in for the card's; its own
graphs are checked in ``test_torch_cuda.py``. The file imports no JAX."""

import copy

import pytest
import torch

from feature_tracker_tpu_torch.models import cotracker2, raft
from feature_tracker_tpu_torch.utils import graphs, profiling

from synthetic import translated_pair

CFG = raft.RaftConfig(feature_channels=32, context_channels=32,
                      hidden_channels=16, correlation_pyramid_levels=2,
                      correlation_radius=2, correlation_hidden_channels=16,
                      correlation_out_channels=8, flow_hidden_channels=8,
                      flow_out_channels=8, motion_out_channels=16,
                      mask_hidden_channels=16, max_iterations=3,
                      low_memory=True, dtype=torch.bfloat16)


class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on the card (as do the tensors made from
    it), so that the update block's choice rests on its other terms."""

    @property
    def is_cuda(self):
        return True


class _OneBand:
    """``bands`` of a mesh with one rank: the halo rows are the zeros of
    the padding."""

    def halo(self, x, k):
        return torch.nn.functional.pad(x, (0, 0, 0, 0, k, k))


def _block_inputs(seed, b=1, h=6, on_card=True):
    """``net`` and ``inp`` in the block's dtype, ``corr`` and ``flow`` in
    float32, as ``Raft`` gives them."""
    g = torch.Generator().manual_seed(seed)
    k = CFG.correlation_pyramid_levels * (2 * CFG.correlation_radius + 1) ** 2
    x = tuple(torch.randn((b, h, 8, c), generator=g).to(dt) for c, dt in (
        (CFG.hidden_channels, CFG.dtype), (CFG.context_channels, CFG.dtype),
        (k, torch.float32), (2, torch.float32)))
    return tuple(t.as_subclass(_OnCard) for t in x) if on_card else x


def _graph_calls(monkeypatch):
    """Record the signatures (``GraphCache.signature``) of the calls that
    reach a graph cache, running the eager function in their place."""
    seen = []

    def replay(cache, fn, inputs, dtypes=None, reuse=False):
        seen.append(cache.signature(inputs))
        return fn(*inputs)

    monkeypatch.setattr(graphs.GraphCache, "__call__", replay)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    return seen


class _Replay:
    """Stands in for a captured graph: a replay runs the function again on
    the graph's inputs and writes the results into the graph's outputs."""

    def __init__(self, fn, inputs):
        self.fn, self.inputs = fn, inputs
        self.outputs = fn(*inputs)

    def replay(self):
        for out, new in zip(self.outputs, self.fn(*self.inputs)):
            if out is not new:
                out.copy_(new)


def _capture_on_cpu(fn, inputs, dtypes):
    static = [x.to(dt or x.dtype, copy=True) for x, dt in zip(inputs,
                                                              dtypes)]
    for _ in range(graphs.WARM_UP):
        fn(*static)
    graph = _Replay(fn, static)
    return graphs._Graph(graph, static, graph.outputs)


@pytest.fixture(autouse=True)
def tracing_off():
    profiling.disable()
    profiling.reset()
    yield
    profiling.disable()
    profiling.reset()


@pytest.fixture
def copies(monkeypatch):
    """Graphs on the CPU; returns the number of inputs each replay copied
    in."""
    monkeypatch.setattr(graphs.GraphCache, "_capture",
                        staticmethod(_capture_on_cpu))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    seen = []
    copy = torch._foreach_copy_

    def counted(dst, src):
        seen.append(len(dst))
        return copy(dst, src)

    monkeypatch.setattr(torch, "_foreach_copy_", counted)
    return seen


def _images(b=1):
    ref, cur = translated_pair(h=32, w=48, shift=(1.5, -1.0))
    ref, cur = (torch.from_numpy(x).expand(b, *x.shape)[..., None]
                for x in (ref, cur))
    return ref.as_subclass(_OnCard), cur.as_subclass(_OnCard)


def test_raft_calls_replay_with_the_eager_flows(copies):
    """Two calls of a RAFT through the cache give the eager block's flows;
    one capture, a replay an iteration; the first iteration of a call
    copies its four inputs in, the others only ``corr`` and ``flow``
    (``net`` is the graph's own, ``inp`` the same tensor)."""
    torch.manual_seed(0)
    model = raft.Raft(CFG, device="cpu")
    # Kernel 5's plain twin stands in for the kernel, as ``copies`` does
    # for a captured graph.
    model.lookup_fn = raft.lookup_correlation_otf
    ref, cur = _images()
    profiling.enable()
    got = [model(ref, cur) for _ in range(2)]
    snap = profiling.snapshot()
    with torch.enable_grad(), raft.full_float32():
        want = model._forward(ref, cur, False, None).detach()
    iters = CFG.max_iterations
    assert snap.counter("raft.update_graph.captures") == 1
    assert snap.counter("raft.update_graph.replays") == 2 * iters
    assert copies == 2 * ([4] + [2] * (iters - 1))
    for flows in got:
        assert torch.equal(flows.as_subclass(torch.Tensor),
                           want.as_subclass(torch.Tensor))


def test_block_outputs_held_across_calls_and_graphs_per_signature(copies):
    """Outside ``Raft``, what a call returns is the caller's: the next call
    does not overwrite it. A shape seen before replays its own graph; at
    most four are kept, the least recently replayed released first."""
    torch.manual_seed(1)
    block = raft.UpdateBlock(CFG).eval()
    with torch.inference_mode():
        first = block(*_block_inputs(2))
        kept = [t.clone() for t in first]
        second = block(*_block_inputs(3))
    want = [block._body(*_block_inputs(s)) for s in (2, 3)]
    for got, held, eager in zip(first, kept, want[0]):
        assert torch.equal(got, held) and torch.equal(got, eager.detach())
    for got, eager in zip(second, want[1]):
        assert torch.equal(got, eager.detach())
    assert copies == [4, 4]     # nothing lent: each call copies all in
    # The same tensors again, one changed in place: copied in again.
    x = _block_inputs(5)
    with torch.inference_mode():
        block(*x)
        x[1].mul_(-1.0)
        again = block(*x)
        eager = block._body(*x)
    for got, want_ in zip(again, eager):
        assert torch.equal(got, want_)
    cache = block._graphs.graphs
    with torch.inference_mode():
        for h in (7, 8, 6, 9, 10):
            block(*_block_inputs(4, h=h))
    # Heights by the net input's shape, least recent first: 7 went.
    assert [key[0][0][0][1] for key in cache] == [8, 6, 9, 10]


def _graph_counters():
    snap = profiling.snapshot()
    return (snap.counter("raft.update_graph.captures"),
            snap.counter("raft.update_graph.replays"))


@pytest.mark.parametrize("case", ["cpu", "train", "grad", "bands"])
def test_update_graph_stays_off_on_cpu_in_training_with_grad_or_bands(
        monkeypatch, case):
    """The update block replays a graph only on the card, with autograd
    off and without ``bands``: each case runs the eager block, and neither
    counter moves. Past ``cpu``, the inputs say they are on the card."""
    torch.manual_seed(0)
    model = raft.Raft(CFG, device="cpu")
    block = model.UpdateBlock_0
    profiling.enable()
    if case == "cpu":
        ref, cur = translated_pair(h=32, w=48, shift=(1.5, -1.0))
        model(ref[None, ..., None], cur[None, ..., None])
        assert not block._graphs.graphs
    elif case == "train":
        seen = _graph_calls(monkeypatch)
        flows, _ = model(*_images(), train=True)
        assert flows.is_cuda and flows.shape[0] == CFG.max_iterations
        assert seen == []
    else:
        seen = _graph_calls(monkeypatch)
        bands = _OneBand() if case == "bands" else None
        with torch.inference_mode(case == "bands"):
            got = block(*_block_inputs(5), bands)
        want = block._body(*_block_inputs(5, on_card=False))
        for a, b in zip(got, want):
            assert torch.equal(a.as_subclass(torch.Tensor), b)
        assert seen == []
    assert _graph_counters() == (0, 0)


def test_update_graph_engages_in_inference_on_the_card(monkeypatch):
    """The control of the test above: inputs on the card, autograd off, no
    ``bands``; each call reaches the graphs with its signature, and a call
    of another shape with another."""
    block = raft.Raft(CFG, device="cpu").UpdateBlock_0
    seen = _graph_calls(monkeypatch)
    for b in (1, 1, 2):
        with torch.no_grad():
            block(*_block_inputs(6, b))
    assert len(seen) == 3 and seen[0] == seen[1] != seen[2]


def _graph_owner(name):
    """A module that owns a graph cache, and inputs of one of its calls."""
    torch.manual_seed(0)
    if name == "update_block":
        return raft.UpdateBlock(CFG), _block_inputs(7, on_card=False)
    cfg = cotracker2.CoTracker2Config(hidden_size=32, num_heads=2,
                                      time_depth=2, space_depth=2,
                                      num_virtual_tracks=4, input_dim=24)
    former = cotracker2.EfficientUpdateFormer(cfg)
    return former, (torch.zeros(5, 8, 24), torch.ones(8, 5, dtype=torch.bool))


SWITCHES = {"cudnn.enabled": (torch.backends.cudnn, "enabled"),
            "cudnn.benchmark": (torch.backends.cudnn, "benchmark"),
            "cudnn.deterministic": (torch.backends.cudnn, "deterministic"),
            "cudnn.allow_tf32": (torch.backends.cudnn, "allow_tf32"),
            "matmul.allow_tf32": (torch.backends.cuda.matmul, "allow_tf32")}


@pytest.mark.parametrize("change", [*SWITCHES, "parameter moved",
                                    "parameter replaced"])
@pytest.mark.parametrize("owner", ["update_block", "former"])
def test_each_switch_and_parameter_address_keys_a_new_graph(monkeypatch,
                                                            owner, change):
    """Flipping any one backend switch that picks kernels, or moving or
    replacing one of the owner's parameters, gives the same inputs a new
    signature."""
    module, inputs = _graph_owner(owner)
    cache = module._graphs
    before = cache.signature(inputs)
    assert cache.signature(inputs) == before
    if change in SWITCHES:
        switches, name = SWITCHES[change]
        monkeypatch.setattr(switches, name, not getattr(switches, name))
    elif change == "parameter moved":
        param = list(module.parameters())[-1]
        param.data = param.data.clone()
    else:
        path, param = list(module.named_parameters())[-1]
        parent, _, leaf = path.rpartition(".")
        setattr(module.get_submodule(parent), leaf,
                torch.nn.Parameter(param.detach().clone()))
    assert cache.signature(inputs) != before


@pytest.mark.parametrize("owner", ["update_block", "former"])
def test_a_copied_module_keys_its_graphs_by_its_own_parameters(owner):
    module, inputs = _graph_owner(owner)
    module._graphs.graphs[module._graphs.signature(inputs)] = None
    twin = copy.deepcopy(module)
    assert not twin._graphs.graphs and module._graphs.graphs
    modules = list(twin.modules())
    assert len(twin._graphs.modules) == len(modules) > 1
    assert all(a is b for a, b in zip(twin._graphs.modules, modules))
    assert twin._graphs.signature(inputs) != module._graphs.signature(inputs)
