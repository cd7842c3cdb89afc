"""Spans and the device trace of a traced run (``--trace 1``).

Spans come from the benchmark's own files: the calls into each layer are
wrapped (functions) or hooked (modules) in the traced run only. The traced
run has two phases:

- the profiled calls, the first ``trace_frames`` of the window: each span
  is a ``torch.profiler.record_function`` range and nothing more, so the
  device trace (torch.profiler, CUPTI) sees the calls as an untraced run
  makes them, but for the profiler's own host time; :func:`summarize`
  reduces it to busy time, kernels by name and idle gaps labelled by the
  span the host was in;
- as many plain calls, with no profiler and no synchronise: their mean
  time (``Profile.plain_call_s``) is a call's untraced time, which the
  device's idle share and the MFUs divide by, so that the profiler's host
  time does not count as the device's idleness;
- the rest of the window (``Tracer.timing``): a span that holds the
  device's work ends in a device synchronise and records its host-clock
  duration, for the per-layer times.

Every span counts its calls in both phases.
"""

from __future__ import annotations

import bisect
import collections
import time

import torch
from torch.autograd.profiler import record_function

WINDOW_SPAN = "bench.window"
LOOP_LABEL = "bench.loop"        # the harness between two calls


class Tracer:
    """Host spans by name. ``calls[name]``: the window's call index of every
    call of the span; ``spans[name]``: ``(call, seconds)`` of the calls made
    once ``timing`` is set (after the profiled calls)."""

    def __init__(self, device):
        self.sync = torch.device(device).type == "cuda"
        self.call = -1
        self.timing = False
        self.calls = collections.defaultdict(list)
        self.spans = collections.defaultdict(list)
        self.names = set()

    def _sync(self):
        if self.sync:
            torch.cuda.synchronize()

    def wrap(self, name, fn, sync=False):
        """``fn`` inside a span ``name``. Once ``timing`` is set, the span
        records its duration; with ``sync`` it ends after a device
        synchronise, so it holds the device's work too."""
        self.names.add(name)

        def wrapped(*args, **kwargs):
            self.calls[name].append(self.call)
            timing = self.timing
            with record_function(name):
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                if timing:
                    if sync:
                        self._sync()
                    self.spans[name].append((self.call,
                                             time.perf_counter() - t0))
            return out

        return wrapped

    def hook(self, module, name):
        """A span ``name`` over every call of ``module``, from a forward
        pre-hook to a forward hook. Once ``timing`` is set, each hook runs
        after a device synchronise, so that the span's wall time is the
        module's own."""
        self.names.add(name)
        state = {}

        def pre(_module, _args):
            self.calls[name].append(self.call)
            state["timing"] = self.timing
            if state["timing"]:
                self._sync()
            state["rf"] = record_function(name)
            state["rf"].__enter__()
            state["t0"] = time.perf_counter()

        def post(_module, _args, _out):
            if state["timing"]:
                self._sync()
                self.spans[name].append((self.call,
                                         time.perf_counter() - state["t0"]))
            state["rf"].__exit__(None, None, None)

        module.register_forward_pre_hook(pre)
        module.register_forward_hook(post)

    def count(self, name, below=None):
        """Calls of span ``name`` (in window calls ``< below`` if given)."""
        return sum(1 for c in self.calls.get(name, ())
                   if below is None or c < below)

    def seconds(self, name):
        """Durations of span ``name`` in the timed phase."""
        return [s for _, s in self.spans.get(name, ())]


class Profile:
    """What a traced window's device trace gives: ``window_s``, ``busy_s``,
    device time by operation name, and idle time by host span."""

    def __init__(self, window_s, busy_s, ops, gaps, calls):
        self.window_s = window_s
        self.busy_s = busy_s
        self.ops = ops          # name -> [launches, seconds]
        self.gaps = gaps        # host span label -> idle seconds
        self.calls = calls      # calls of the window the trace covers
        self.plain_call_s = None    # mean seconds of an untraced call

    def kernel(self, part):
        """(launches, device seconds) of the operations whose name holds
        ``part``."""
        rows = [v for k, v in self.ops.items() if part in k]
        return sum(r[0] for r in rows), sum(r[1] for r in rows)

    def breakdown(self):
        top = sorted(self.ops.items(), key=lambda kv: -kv[1][1])[:10]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k[:120], v[1]] for k, v in top],
                "idle_gaps": [[k, v] for k, v in gaps]}


def _union(intervals, lo, hi):
    """Merged ``[start, end]`` intervals clipped to ``[lo, hi]``."""
    merged = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarize(prof, span_names, call_span, calls):
    """Reduce a finished ``torch.profiler.profile`` to a :class:`Profile`.
    ``span_names``: the host spans (record_function names) of this run,
    ``call_span`` the one around each call of the window."""
    host, device, window = [], [], None
    names = set(span_names) | {WINDOW_SPAN}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if name in names or e.is_user_annotation():
                continue        # the device's copy of a host range
            device.append((start, end, name))
        elif name == WINDOW_SPAN:
            window = (start, end)
        elif name in names:
            host.append((start, end, name))
    if window is None:
        raise RuntimeError("the traced window's span is not in the trace")
    lo, hi = window
    ops = collections.defaultdict(lambda: [0, 0.0])
    for s, e, name in device:
        if lo <= s < hi:
            ops[name][0] += 1
            ops[name][1] += (e - s) / 1e9
    busy = _union([(s, e) for s, e, _ in device], lo, hi)
    host.sort()
    starts = [s for s, _, _ in host]
    gaps = collections.defaultdict(float)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        mid = (g0 + g1) / 2
        label = LOOP_LABEL
        for k in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            s, e, name = host[k]
            if e >= mid:
                label = name if name != call_span else f"{name} (own)"
                break
            if name == call_span:
                break       # an earlier call: the host was between calls
        gaps[label] += (g1 - g0) / 1e9
    return Profile((hi - lo) / 1e9, sum(e - s for s, e in busy) / 1e9,
                   dict(ops), dict(gaps), calls)
