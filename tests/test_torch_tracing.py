"""The port's tracer (``utils/profiling.py``) and the spans and counters at
its layer boundaries, on the CPU: off by default and free when off, the
profiler latch, the span tree, outputs unchanged by tracing, the spans of a
front-end frame and of a RAFT call, and the counts of detection's rounds
and of the trackers' Gauss-Newton steps. The file imports no JAX."""

import contextlib
import ctypes
import itertools
import sys
import types

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from feature_tracker_tpu_torch.core.config import (
    HarrisOptions,
    KltMethod,
    KltOptions,
)
from feature_tracker_tpu_torch.models import raft
from feature_tracker_tpu_torch.ops import (
    cuda_detect,
    cuda_klt,
    cuda_raft_lookup,
    cuda_warp_klt,
    detect,
)
from feature_tracker_tpu_torch.ops.pyramid import build_pyramid
from feature_tracker_tpu_torch.pipeline import FrontEndConfig, TrackingFrontEnd
from feature_tracker_tpu_torch.trackers.klt import affine, basic, lssd
from feature_tracker_tpu_torch.trackers.klt.basic import (
    track_pyramid_fast_reference,
)
from feature_tracker_tpu_torch.utils import profiling

from synthetic import Texture, translated_pair

FRAME_SPANS = {"frontend.frame", "frontend.upload", "pyramid.build",
               "klt.track", "klt.launch", "frontend.readback"}


@pytest.fixture(autouse=True)
def tracing_off():
    """Every test starts and ends with tracing off and nothing recorded."""
    profiling.disable()
    profiling.reset()
    yield
    profiling.disable()
    profiling.reset()


def _frames(n, h=96, w=128, step=(2.5, -1.5)):
    tex = Texture(3)
    return [tex.render(h, w, warp=lambda x, y, k=k: (x - step[0] * k,
                                                     y - step[1] * k)
                       ).astype(np.uint8) for k in range(n)]


def _front_end(frames, **cfg):
    fe = TrackingFrontEnd(FrontEndConfig(**cfg), device="cpu")
    return [fe.process_frame(f) for f in frames]


def _names(snap, mask=None):
    ids = snap.name if mask is None else snap.name[mask]
    return [snap.names[i] for i in ids]


class _FakeLibrary:
    """Stands in for a kernel's library: records each call of an entry
    (``functions``, ``calls``: its arguments) and returns success; given a
    counter row, kernel 1's entry adds ``steps`` and ``lanes`` to it as the
    kernel would."""

    def __init__(self, steps=7, lanes=3):
        self.functions, self.calls = [], []
        self.steps, self.lanes = steps, lanes

    def __getattr__(self, function):
        def entry(*args):
            self.functions.append(function)
            self.calls.append(args)
            if function == "ftk_klt_fast_pyramid" and args[-1] is not None:
                row = (ctypes.c_longlong * 2).from_address(args[-1])
                row[0] += self.steps
                row[1] += self.lanes
            return 0
        return entry


class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on the card, so that a kernel's wrapper
    takes its launch path (with a stand-in library: :func:`_on_card`)."""

    @property
    def is_cuda(self):
        return True


_STREAM = object()      # the stand-in current stream's handle


def _on_card(monkeypatch, kernel, lib):
    """``kernel`` takes ``lib`` for its library, and the CUDA device and
    stream calls are inert, with ``_STREAM`` for the current stream."""
    monkeypatch.setattr(kernel, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=_STREAM))


def _fake_launch(monkeypatch, lib, calls=1):
    """Launch kernel 1 through its wrapper on CPU tensors that say they
    are on the card, with ``lib`` in place of its library
    (:func:`_on_card`); returns the last pointer argument of each call."""
    _on_card(monkeypatch, cuda_klt.FAST, lib)
    pyr = tuple(torch.zeros(32 >> k, 32 >> k) for k in range(2))
    uv = torch.full((3, 2), 8.0).as_subclass(_OnCard)
    skip = torch.zeros(3, dtype=torch.bool)
    for _ in range(calls):
        with profiling.span("test.call"):
            cuda_klt.track_pyramid_fast_cuda(KltOptions(), pyr, pyr, uv, uv,
                                             skip)
    return [c[-1] for c in lib.calls]


def test_off_by_default_records_nothing(monkeypatch):
    assert not profiling.enabled()
    results = _front_end(_frames(50), capacity=60, min_live_tracks=40)
    assert len(results) == 50
    snap = profiling.snapshot()
    assert snap.calls == 0 and snap.name.size == 0
    assert snap.count_n.size == 0 and snap.counters == {}
    # Kernel 1 is handed a null counter pointer.
    assert _fake_launch(monkeypatch, _FakeLibrary()) == [None]
    assert profiling.snapshot().name.size == 0


def test_off_path_allocates_nothing():
    span, count = profiling.span, profiling.count

    def loop(n):
        for _ in itertools.repeat(None, n):
            with span("frontend.frame"):
                count("host_syncs")

    loop(100)
    blocks = sys.getallocatedblocks()
    loop(20000)
    assert sys.getallocatedblocks() - blocks < 10
    assert span("a") is span("b")


def test_latches_on_under_the_profiler_and_stays_on():
    from torch.profiler import profile

    with profiling.span("before"):
        pass
    assert not profiling.enabled()
    with profile() as prof:
        with profiling.span("profiled"):
            torch.ones(4).sum()
        # Kernels the profiler times run without their counters.
        assert profiling.kernel_counters("cpu", cuda_klt.FAST_COUNTERS) is None
    assert profiling.enabled()
    assert profiling.kernel_counters("cpu", cuda_klt.FAST_COUNTERS)
    assert "profiled" in {e.key for e in prof.key_averages()}
    with profiling.span("after"):
        pass
    assert _names(profiling.snapshot()) == ["profiled", "after"]
    profiling.disable()
    with profiling.span("off"):
        pass
    assert profiling.snapshot().calls == 2


class _Clock:
    def __init__(self, ticks):
        self.ticks = iter(ticks)

    def perf_counter_ns(self):
        return next(self.ticks)


def test_span_tree_parents_calls_and_self_times(monkeypatch):
    # Enter reads the clock last, exit first: (start, end) of each span.
    ticks = [0, 10, 15, 25, 40, 50, 60, 100,     # call 0: a(b(c), d)
             200, 205, 215, 230]                 # call 1: e(f)
    monkeypatch.setattr(profiling, "time", _Clock(ticks))
    profiling.enable()
    sp, count = profiling.span, profiling.count
    with sp("a"):
        with sp("b"):
            with sp("c"):
                count("n", 2)
            count("n")
        with sp("d"):
            pass
    with sp("e"):
        with sp("f"):
            pass
    count("n", 5)                               # after call 1, outside
    snap = profiling.snapshot()
    assert _names(snap) == list("abcdef")
    assert snap.parent.tolist() == [-1, 0, 1, 0, -1, 4]
    assert snap.call.tolist() == [0, 0, 0, 0, 1, 1]
    assert snap.calls == 2
    assert snap.duration_ns.tolist() == [100, 30, 10, 10, 30, 10]
    assert snap.self_ns.tolist() == [60, 20, 10, 10, 20, 10]
    assert snap.counters == {"n": {0: 3, 1: 5}}
    assert snap.counter("n", (0, 1)) == 3
    assert snap.select("b", (1, 2)).sum() == 0
    assert snap.dropped == {"spans": 0, "counts": 0, "kernel_rows": 0}


def test_buffer_keeps_the_newest_and_counts_what_it_dropped():
    tracer = profiling.Tracer(capacity=8, count_capacity=4)
    for k in range(10):
        with tracer.span(f"s{k}"):
            tracer.count("n", k)
    snap = tracer.snapshot()
    assert [snap.names[i] for i in snap.name] == [f"s{k}" for k in
                                                  range(2, 10)]
    assert snap.call.tolist() == list(range(2, 10)) and snap.calls == 10
    assert snap.counter("n") == 6 + 7 + 8 + 9
    assert snap.dropped == {"spans": 2, "counts": 6, "kernel_rows": 0}


def test_reset_while_a_span_is_open():
    profiling.enable()
    with profiling.span("outer"):
        profiling.reset()
        with profiling.span("inner"):
            pass
    snap = profiling.snapshot()
    assert _names(snap) == ["inner"] and snap.calls == 1


def test_front_end_outputs_bit_identical_with_tracing():
    frames = _frames(16)
    cfg = dict(capacity=80, min_live_tracks=60)
    off = _front_end(frames, **cfg)
    profiling.enable()
    on = _front_end(frames, **cfg)
    assert profiling.snapshot().calls == len(frames)
    for a, b in zip(off, on):
        assert a.frame_id == b.frame_id and a.num_live == b.num_live
        np.testing.assert_array_equal(a.uv, b.uv)
        np.testing.assert_array_equal(a.status, b.status)
        np.testing.assert_array_equal(a.track_ids, b.track_ids)


def test_front_end_frame_spans_and_counts():
    frames = _frames(8)
    profiling.enable()
    # At most 400 candidates: detection's suppression is one chunk.
    _front_end(frames, capacity=60, min_live_tracks=30,
               harris=HarrisOptions(min_feature_distance=8,
                                    min_valid_response=5.0,
                                    max_candidates=400))
    snap = profiling.snapshot()
    assert snap.calls == len(frames)
    for call in range(len(frames)):
        names = _names(snap, snap.call == call)
        assert names[0] == "frontend.frame"
        assert names.count("frontend.frame") == 1
        if call == 0:
            assert set(names) == {"frontend.frame", "frontend.upload",
                                  "pyramid.build", "detect.features",
                                  "detect.suppress"}
        else:
            assert FRAME_SPANS <= set(names) <= FRAME_SPANS | {
                "detect.features", "detect.suppress"}
            # The frame's upload, then the lanes'.
            assert names.count("frontend.upload") == 2
        frame = np.flatnonzero(snap.select("frontend.frame", (call,
                                                              call + 1)))
        children = snap.parent == frame[0]
        assert "klt.launch" not in _names(snap, children)
        own = snap.duration_ns[frame[0]] - snap.duration_ns[children].sum()
        assert snap.self_ns[frame[0]] == own >= 0
    detections = snap.select("detect.features").sum()
    assert 1 <= detections <= len(frames)
    # Every frame reads the pyramid's maximum; a tracked frame reads its
    # status and positions back; a detection its count, its round tests,
    # its selection, and the front end its uv and count.
    rounds = snap.counter("detect.suppression_rounds")
    assert rounds >= detections
    assert snap.counter("host_syncs") == (
        len(frames) + 2 * (len(frames) - 1)
        + detections * 5 + rounds)
    lanes = snap.counter("klt.lanes")
    assert lanes > 0 and snap.counter("klt.gn_steps") >= lanes


def test_raft_outputs_bit_identical_and_spans():
    cfg = raft.RaftConfig(feature_channels=32, context_channels=32,
                          hidden_channels=16, correlation_pyramid_levels=2,
                          correlation_radius=2,
                          correlation_hidden_channels=16,
                          correlation_out_channels=8,
                          flow_hidden_channels=8, flow_out_channels=8,
                          motion_out_channels=16, mask_hidden_channels=16,
                          max_iterations=3, low_memory=True)
    torch.manual_seed(0)
    model = raft.Raft(cfg, device="cpu")
    ref, cur = translated_pair(h=32, w=48, shift=(1.5, -1.0))
    ref, cur = ref[None, ..., None], cur[None, ..., None]
    off = model(ref, cur)
    profiling.enable()
    on = [model(ref, cur) for _ in range(2)]
    for flows in on:
        assert torch.equal(off, flows)
    snap = profiling.snapshot()
    assert snap.calls == 2
    for call in range(2):
        names = _names(snap, snap.call == call)
        assert names[:2] == ["raft.forward", "raft.input"]
        assert names.count("raft.update") == cfg.max_iterations
        assert names.count("raft_lookup.launch") == cfg.max_iterations
        assert names.count("raft.forward") == names.count("raft.input") == 1


def _matmuls_in_chaotic_greedy(monkeypatch):
    """Count the rounds of ``_chaotic_greedy`` by its matrix products (one
    a round), apart from the port's counter."""
    seen = {"rounds": 0}

    class Products(TorchFunctionMode):
        def __torch_function__(self, func, types_, args=(), kwargs=None):
            if getattr(func, "__name__", "") in ("matmul", "__matmul__"):
                seen["rounds"] += 1
            return func(*args, **(kwargs or {}))

    original = detect._chaotic_greedy

    def counted(*args):
        with Products():
            return original(*args)

    monkeypatch.setattr(detect, "_chaotic_greedy", counted)
    return seen


def test_suppression_rounds_match_an_independent_count(monkeypatch):
    img, _ = translated_pair(h=120, w=160)
    opts = HarrisOptions(min_feature_distance=6, min_valid_response=1.0)
    seen = _matmuls_in_chaotic_greedy(monkeypatch)
    profiling.enable()
    uv, num = detect.detect_good_features(img, 200, opts, device="cpu")
    snap = profiling.snapshot()
    assert int(num) > 20 and seen["rounds"] > 1
    assert snap.counter("detect.suppression_rounds") == seen["rounds"]
    assert snap.select("detect.features").sum() == 1


def test_cpu_steps_and_lanes_match_the_plain_version():
    ref, cur = translated_pair(h=96, w=128, shift=(2.0, -1.0))
    rp, cp = build_pyramid(ref, 3, device="cpu"), build_pyramid(
        cur, 3, device="cpu")
    rng = np.random.default_rng(5)
    uv = torch.from_numpy(np.stack([rng.uniform(-4, 132, 64),
                                    rng.uniform(-4, 100, 64)], -1)
                          .astype(np.float32))
    skip = torch.from_numpy(rng.random(64) < 0.2)
    opts = KltOptions()
    _, _, steps = track_pyramid_fast_reference(opts, rp, cp, uv, uv, skip,
                                               with_steps=True)
    off = cuda_klt.track_pyramid_fast_cuda(opts, rp, cp, uv, uv, skip)
    profiling.enable()
    on = cuda_klt.track_pyramid_fast_cuda(opts, rp, cp, uv, uv, skip)
    assert all(torch.equal(a, b) for a, b in zip(off, on))
    snap = profiling.snapshot()
    assert snap.counter("klt.gn_steps") == int(steps.sum()) > 0
    assert snap.counter("klt.lanes") == int((~skip).sum())
    assert _names(snap) == ["klt.launch"]


def test_kernel_counter_rows_by_call(monkeypatch):
    """With tracing on, each launch gets its own row of the device ring, and
    the snapshot adds the rows to the counters of their calls."""
    profiling.enable()
    lib = _FakeLibrary(steps=7, lanes=3)
    pointers = _fake_launch(monkeypatch, lib, calls=3)
    assert None not in pointers and len(set(pointers)) == 3
    assert pointers[1] - pointers[0] == 16
    snap = profiling.snapshot()
    assert snap.counters["klt.gn_steps"] == {0: 7, 1: 7, 2: 7}
    assert snap.counters["klt.lanes"] == {0: 3, 1: 3, 2: 3}
    names = _names(snap)
    assert names == ["test.call", "klt.launch"] * 3
    assert snap.launches["track_pyramid_fast_cuda"] == \
        cuda_klt.track_pyramid_fast_cuda.launches
    assert {"track_pyramid_iter_cuda", "lookup_correlation_cuda"} <= set(
        snap.launches)


def test_kernel_ring_starts_a_new_lap_from_zero(monkeypatch):
    profiling.enable()
    monkeypatch.setattr(profiling._TRACER, "kernel_rows", 2)
    lib = _FakeLibrary(steps=1, lanes=1)
    _fake_launch(monkeypatch, lib, calls=3)
    snap = profiling.snapshot()
    assert snap.dropped["kernel_rows"] == 2
    assert snap.counters["klt.lanes"] == {2: 1}


# --- The launch path of kernels 1-6 (ops/_launch.py) ------------------------

WRAPPERS = ["fast", "iter", "affine_pyramid", "affine_level", "lssd_pyramid",
            "lssd_level", "lookup", "suppress"]


def _wrapper_case(name, n):
    """``(wrapper, kernel, plain version's module and name, arguments, index
    of the argument whose device picks the path, output shapes)`` of the
    wrapper ``name`` on ``n`` features (kernel 5: ``n`` rows of queries;
    kernel 6: ``n`` ranked candidates), CPU tensors from a seed."""
    g = torch.Generator().manual_seed(n)
    img = torch.rand((32, 32), generator=g) * 255
    pyr = (img, img[::2, ::2].contiguous())
    uv = 8.0 + 16.0 * torch.rand((n, 2), generator=g)
    eye = torch.eye(2).repeat(n, 1, 1)
    skip = torch.zeros(n, dtype=torch.bool)
    fast, uv2, st = KltOptions(), (n, 2), (n,)
    if name == "fast":
        return (cuda_klt.track_pyramid_fast_cuda, cuda_klt.FAST, basic,
                "track_pyramid_fast_reference", (fast, pyr, pyr, uv, uv, skip),
                3, [uv2, st])
    if name == "iter":
        status = torch.zeros(n, dtype=torch.int8)
        return (cuda_klt.track_pyramid_iter_cuda, cuda_klt.ITER, basic,
                "track_pyramid_iter_reference",
                (KltOptions(method=KltMethod.DIRECT), pyr, pyr, uv, uv, status,
                 skip), 3, [uv2, st])
    if name == "affine_pyramid":
        return (cuda_warp_klt.affine_track_pyramid_cuda, cuda_warp_klt.AFFINE,
                affine, "affine_track_pyramid_reference",
                (fast, pyr, pyr, uv, uv, eye, skip), 3, [uv2, (n, 2, 2), st])
    if name == "affine_level":
        return (cuda_warp_klt.affine_track_level_cuda, cuda_warp_klt.AFFINE,
                affine, "affine_track_level_reference",
                (fast, img, img, uv, uv, eye, skip), 3, [uv2, (n, 2, 2), st])
    if name == "lssd_pyramid":
        return (cuda_warp_klt.lssd_track_pyramid_cuda, cuda_warp_klt.LSSD,
                lssd, "lssd_track_pyramid_reference",
                (fast, False, pyr, pyr, uv, uv, eye, skip), 4,
                [uv2, (n, 2, 2), st])
    if name == "lssd_level":
        return (cuda_warp_klt.lssd_track_level_cuda, cuda_warp_klt.LSSD,
                lssd, "lssd_track_level_reference",
                (fast, True, img, img, uv, eye, uv - 8.0, skip), 4,
                [(n, 2, 2), uv2, st])
    if name == "suppress":
        scores = torch.sort(torch.rand(n, generator=g), descending=True)[0]
        flat = torch.randperm(32 * 32, generator=g)[:n]
        return (cuda_detect.suppress_candidates_cuda, cuda_detect.SUPPRESS,
                detect, "suppress_candidates", (scores, flat, (32, 32), 4, 5),
                0, [(4, 2), ()])
    fmap0 = torch.randn((1, n, 5, 8), generator=g)
    fpyr = [torch.randn((1, 6, 7, 8), generator=g),
            torch.randn((1, 3, 4, 8), generator=g)]
    locs = 6.0 * torch.rand((1, n, 5, 2), generator=g)
    return (cuda_raft_lookup.lookup_correlation_cuda, cuda_raft_lookup.LOOKUP,
            raft, "lookup_correlation_otf", (fmap0, fpyr, locs, 2, "border"),
            0, [(1, n, 5, 2 * 25)])


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("name", WRAPPERS)
def test_cpu_calls_run_the_plain_version_inside_the_launch_span(
        monkeypatch, name):
    """A wrapper on CPU tensors returns its plain version's outputs, and
    the plain version runs inside the kernel's launch span."""
    wrapper, kernel, module, plain_name, args, _, _ = _wrapper_case(name, 3)
    plain = getattr(module, plain_name)
    want = _outputs(plain(*args))

    def traced(*a, **kw):
        with profiling.span("test.plain"):
            return plain(*a, **kw)

    monkeypatch.setattr(module, plain_name, traced)
    profiling.enable()
    got = _outputs(wrapper(*args))
    snap = profiling.snapshot()
    assert _names(snap) == [kernel.span, "test.plain"]
    assert list(snap.parent) == [-1, 0]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("name", WRAPPERS)
def test_inputs_on_another_device_raise(name):
    wrapper, _, _, _, args, x, _ = _wrapper_case(name, 3)
    args = list(args)
    args[x] = args[x].to("meta")
    with pytest.raises(ValueError, match=f"^{wrapper.__name__}: unsupported "
                                         "device meta"):
        wrapper(*args)


@pytest.mark.parametrize("n", [0, 3])
@pytest.mark.parametrize("name", WRAPPERS)
def test_card_calls_launch_once_with_work_and_never_without(monkeypatch,
                                                            name, n):
    """On the card (inputs that say so, a stand-in library): with no work
    a wrapper returns empty outputs of its shapes, calls nothing and counts
    nothing; with work it calls its entry once, with every argument of the
    C signature and the current stream, inside its launch span, and counts
    one launch."""
    wrapper, kernel, _, _, args, x, shapes = _wrapper_case(name, n)
    lib = _FakeLibrary()
    _on_card(monkeypatch, kernel, lib)
    args = list(args)
    args[x] = args[x].as_subclass(_OnCard)
    before = wrapper.launches
    profiling.enable()
    out = _outputs(wrapper(*args))
    assert [tuple(t.shape) for t in out] == shapes
    assert _names(profiling.snapshot()) == [kernel.span]
    if n == 0:
        assert lib.calls == [] and wrapper.launches == before
        return
    assert lib.functions == [kernel.function]
    (c_args,) = lib.calls
    assert len(c_args) == len(kernel.argtypes)
    assert [a is _STREAM for a in c_args].count(True) == 1
    assert wrapper.launches == before + 1


def test_suppression_kernel_launch_reads_nothing_and_counts_once(
        monkeypatch):
    """Kernel 6's launch on the card (inputs that say so, a stand-in
    library): the C arguments carry the candidates, the image's size, the
    integer conflict threshold, ``grid_layout``'s grid (zeros for the list
    path) and ``max_num``; nothing is read back, and
    ``detect.suppression_kernel`` counts 1 a launch (0 for a call with no
    candidate, which launches nothing)."""
    lib = _FakeLibrary()
    _on_card(monkeypatch, cuda_detect.SUPPRESS, lib)
    scores = torch.tensor([9.0, 8.0, 7.0, -torch.inf]).as_subclass(_OnCard)
    flat = torch.tensor([100, 900, 5000, 0])
    profiling.enable()
    for call in range(3):
        with profiling.span("detect.features"):
            uv, num = cuda_detect.suppress_candidates_cuda(
                scores, flat, (480, 752), 300, 25)
    with profiling.span("detect.features"):
        empty = cuda_detect.suppress_candidates_cuda(
            scores[:0], flat[:0], (480, 752), 300, 25)
    snap = profiling.snapshot()
    assert tuple(uv.shape) == (300, 2) and uv.dtype == torch.float32
    assert num.dtype == torch.int32 and num.dim() == 0
    assert (empty[0] == -1).all() and int(empty[1]) == 0
    assert snap.counter("host_syncs") == 0
    assert snap.counters[cuda_detect.COUNTER] == {0: 1, 1: 1, 2: 1, 3: 0}
    assert len(lib.calls) == 3
    ptr_s, ptr_i, k, h, w, threshold, *layout, max_num = lib.calls[0][:10]
    assert (ptr_s, ptr_i) == (scores.data_ptr(), flat.data_ptr())
    assert (k, h, w, threshold, max_num) == (4, 480, 752, 625, 300)
    assert layout == [25, 31, 20]
    # A distance whose grid would not fit shared memory: the list path.
    cuda_detect.suppress_candidates_cuda(scores, flat, (480, 752), 300, 3)
    assert lib.calls[-1][5:9] == (9, 0, 0, 0)
