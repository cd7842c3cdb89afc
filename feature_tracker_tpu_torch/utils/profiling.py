"""Tracing, stage timing and failure detection.

``trace()`` records a ``torch.profiler`` trace (CPU and, where present,
CUDA activity) for TensorBoard; ``StageTimer`` sums per-stage wall times,
synchronising the device of a given tensor at the end of a stage so
asynchronous launches are not misattributed; ``assert_finite`` is the
NaN / Inf guard at tracker level.

The port's tracer: ``span(name)`` and ``count(name, n)`` mark the layer
boundaries of the main path (``README.md`` lists them). Tracing is off
until :func:`enable`, or until a span is entered while a
``torch.profiler`` session records; once on it stays on until
:func:`disable`. Off, ``span()`` returns one shared no-op object and
``count()`` is one flag test: nothing is allocated or written. On, a span
records its name, its start and end (``time.perf_counter_ns``), its parent
and the index of the top-level call it belongs to (a span entered outside
every other span starts a call: one ``process_frame``, one
``Raft.forward``), in a preallocated buffer that overwrites the oldest
records and counts what it dropped; while a profiler records, each span is
also a ``record_function`` range of the kineto trace, on the kernels'
clock. A span never synchronises the device. Counting kernels take a row
of a device ring (:func:`kernel_counters`; none while a profiler records)
that :func:`snapshot` copies out once; so does a count held in a device
tensor (:func:`count_on_device`). The tracer keeps one stack of open
spans: it traces one thread.
"""

from __future__ import annotations

import array
import contextlib
import dataclasses
import time

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

from feature_tracker_tpu_torch.utils.timer import _leaves, _sync

SPAN_CAPACITY = 1 << 19     # span records the buffer holds
COUNT_CAPACITY = 1 << 18    # counter additions the buffer holds
KERNEL_ROWS = 1 << 18       # rows of a device ring of kernel counters

# The kernel wrappers whose ``.launches`` :func:`snapshot` reports.
_LAUNCH_WRAPPERS: list = []


@contextlib.contextmanager
def trace(log_dir: str):
    """Record a torch.profiler trace into ``log_dir`` (view it with
    TensorBoard's profiler plugin)."""
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


def _ring(typecode: str, n: int) -> array.array:
    return array.array(typecode, [0]) * n


class _Noop:
    """The span returned while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return None


_NOOP = _Noop()


class _Span:
    __slots__ = ("tracer", "name", "seq", "epoch", "rf", "start", "end")

    def __init__(self, tracer, name):
        self.tracer, self.name, self.rf = tracer, name, None

    def __enter__(self):
        tr = self.tracer
        seq = self.seq = tr.seq
        self.epoch = tr.epoch
        tr.seq = seq + 1
        if tr.stack:
            parent = tr.stack[-1]
        else:
            parent = -1
            tr.call = tr.calls
            tr.calls += 1
        k = seq & tr.mask
        tr.span_name[k] = tr.name_id(self.name)
        tr.span_parent[k] = parent
        tr.span_call[k] = tr.call
        tr.span_end[k] = -1
        tr.stack.append(seq)
        if _autograd_profiler._is_profiler_enabled:
            self.rf = _autograd_profiler.record_function(self.name)
            self.rf.__enter__()
        self.start = tr.span_start[k] = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        t = self.end = time.perf_counter_ns()
        tr = self.tracer
        if self.epoch == tr.epoch:      # not cleared by a reset since
            if tr.seq - self.seq <= tr.capacity:    # its record is held
                tr.span_end[self.seq & tr.mask] = t
            tr.stack.pop()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
            self.rf = None
        return None


class Tracer:
    """Bounded buffers of span records (``capacity``, a power of two) and
    counter additions, and the device rings of kernel counters."""

    def __init__(self, capacity: int = SPAN_CAPACITY,
                 count_capacity: int = COUNT_CAPACITY,
                 kernel_rows: int = KERNEL_ROWS):
        self.capacity, self.mask = capacity, capacity - 1
        self.count_capacity = count_capacity
        self.kernel_rows = kernel_rows
        self.span_name = _ring("i", capacity)
        self.span_parent = _ring("q", capacity)
        self.span_call = _ring("q", capacity)
        self.span_start = _ring("q", capacity)
        self.span_end = _ring("q", capacity)
        self.count_name = _ring("i", count_capacity)
        self.count_call = _ring("q", count_capacity)
        self.count_n = _ring("q", count_capacity)
        self.epoch = 0
        self.reset()

    def reset(self) -> None:
        self.epoch += 1
        self.names: list[str] = []
        self.ids: dict[str, int] = {}
        self.seq = 0            # spans begun
        self.counted = 0        # counter additions made
        self.calls = 0          # top-level calls begun
        self.call = -1          # the current call
        self.stack: list[int] = []
        # device -> [ring [rows, 2] int64, rows used, row calls, row name
        # ids [rows, 2]]
        self.rings: dict = {}
        self.rows_dropped = 0

    def name_id(self, name: str) -> int:
        name_id = self.ids.get(name)
        if name_id is None:
            name_id = self.ids[name] = len(self.names)
            self.names.append(name)
        return name_id

    def span(self, name: str) -> _Span:
        return _Span(self, name)

    def count(self, name: str, n: int = 1) -> None:
        k = self.counted % self.count_capacity
        self.counted += 1
        self.count_name[k] = self.name_id(name)
        self.count_call[k] = self.call
        self.count_n[k] = n

    def _ring_row(self, device, names):
        """``(table, k)``: the next row ``k`` of ``device``'s ring
        ``table``, which counts toward ``names`` (two counter names) in the
        current call."""
        ring = self.rings.get(device)
        if ring is None:
            # A normal tensor, which inference mode's calls may write to.
            with torch.inference_mode(False):
                table = torch.zeros((self.kernel_rows, 2), dtype=torch.int64,
                                    device=device)
            ring = self.rings[device] = [
                table, 0, _ring("q", self.kernel_rows),
                _ring("i", 2 * self.kernel_rows)]
        table, used = ring[0], ring[1]
        k = used % self.kernel_rows
        if used and k == 0:     # a new lap: the last one's rows are lost
            table.zero_()
            self.rows_dropped += self.kernel_rows
        ring[1] = used + 1
        ring[2][k] = self.call
        ring[3][2 * k] = self.name_id(names[0])
        ring[3][2 * k + 1] = self.name_id(names[1])
        return table, k

    def kernel_counters(self, device, names) -> int:
        """The address of the next row of ``device``'s ring, two int64 that
        a kernel adds to; the row counts toward ``names`` (two counter
        names) in the current call."""
        table, k = self._ring_row(device, names)
        return table.data_ptr() + 16 * k

    def count_on_device(self, name: str, value: torch.Tensor) -> None:
        """Write the 0-dim integer tensor ``value`` into the first column of
        the next row of its device's ring, as counter ``name`` of the
        current call (the second column stays 0): one copy on the device,
        no read."""
        table, k = self._ring_row(value.device, (name, name))
        table[k, 0].copy_(value)

    def snapshot(self) -> "Snapshot":
        held = min(self.seq, self.capacity)
        first = self.seq - held
        order = np.arange(first, self.seq) & self.mask

        def unroll(buf):
            return np.frombuffer(buf, dtype=np.int64 if buf.typecode == "q"
                                 else np.int32)[order]

        name = unroll(self.span_name)
        parent = unroll(self.span_parent) - first
        parent[parent < 0] = -1             # a top-level span, or dropped
        start, end = unroll(self.span_start), unroll(self.span_end)
        duration = np.where(end >= 0, end - start, 0)
        inner = np.bincount(parent[parent >= 0],
                            weights=duration[parent >= 0],
                            minlength=held).astype(np.int64)
        counted = min(self.counted, self.count_capacity)
        corder = (np.arange(self.counted - counted, self.counted)
                  % self.count_capacity)
        c_name = np.frombuffer(self.count_name, np.int32)[corder]
        c_call = np.frombuffer(self.count_call, np.int64)[corder]
        c_n = np.frombuffer(self.count_n, np.int64)[corder]
        for table, used, calls, ids in self.rings.values():
            if used == 0:
                continue
            n = (used - 1) % self.kernel_rows + 1     # rows of this lap
            values = table[:n].cpu().numpy()
            ids = np.frombuffer(ids, np.int32)[:2 * n].reshape(n, 2)
            row_calls = np.frombuffer(calls, np.int64)[:n]
            c_name = np.concatenate([c_name, ids[:, 0], ids[:, 1]])
            c_call = np.concatenate([c_call, row_calls, row_calls])
            c_n = np.concatenate([c_n, values[:, 0], values[:, 1]])
        return Snapshot(
            names=list(self.names), name=name, parent=parent, call=unroll(
                self.span_call), start_ns=start, end_ns=end,
            self_ns=duration - inner, count_name=c_name, count_call=c_call,
            count_n=c_n, calls=self.calls,
            dropped={"spans": first,
                     "counts": self.counted - counted,
                     "kernel_rows": self.rows_dropped},
            launches=_launches())


def counts_launches(*wrappers) -> None:
    """Give each kernel wrapper a ``.launches`` count, from 0, which the
    wrapper adds its launches to and :func:`snapshot` reports."""
    for fn in wrappers:
        fn.launches = 0
        _LAUNCH_WRAPPERS.append(fn)


def _launches() -> dict:
    """``.launches`` of every loaded kernel wrapper, by wrapper name."""
    return {fn.__name__: fn.launches for fn in _LAUNCH_WRAPPERS}


@dataclasses.dataclass
class Snapshot:
    """What the tracer holds, oldest first. Per span: ``name`` (an index
    into ``names``), ``parent`` (an index into these arrays; -1 for a
    top-level span or one whose parent was dropped), ``call``,
    ``start_ns``, ``end_ns`` (-1 while open) and ``self_ns`` (the duration
    less what its children cover). Per counter addition: ``count_name``,
    ``count_call``, ``count_n``, kernel rows included. ``calls``: top-level
    calls begun since the last reset; ``dropped``: span records, counter
    additions and kernel rows overwritten; ``launches``: the kernel
    wrappers' ``.launches``."""

    names: list
    name: np.ndarray
    parent: np.ndarray
    call: np.ndarray
    start_ns: np.ndarray
    end_ns: np.ndarray
    self_ns: np.ndarray
    count_name: np.ndarray
    count_call: np.ndarray
    count_n: np.ndarray
    calls: int
    dropped: dict
    launches: dict

    @property
    def duration_ns(self) -> np.ndarray:
        return np.where(self.end_ns >= 0, self.end_ns - self.start_ns, 0)

    def _id(self, name):
        return self.names.index(name) if name in self.names else -1

    def select(self, name: str, calls=None) -> np.ndarray:
        """Mask of the closed spans named ``name``, in the calls
        ``range(*calls)`` if given."""
        m = (self.name == self._id(name)) & (self.end_ns >= 0)
        if calls is not None:
            m &= (self.call >= calls[0]) & (self.call < calls[1])
        return m

    def counter(self, name: str, calls=None) -> int:
        """Sum of counter ``name`` over the calls ``range(*calls)`` (all if
        None)."""
        m = self.count_name == self._id(name)
        if calls is not None:
            m &= (self.count_call >= calls[0]) & (self.count_call < calls[1])
        return int(self.count_n[m].sum())

    @property
    def counters(self) -> dict:
        """``{name: {call: total}}``."""
        out = {}
        for i, name in enumerate(self.names):
            m = self.count_name == i
            if m.any():
                calls, inv = np.unique(self.count_call[m], return_inverse=True)
                sums = np.bincount(inv, weights=self.count_n[m])
                out[name] = dict(zip(calls.tolist(),
                                     sums.astype(np.int64).tolist()))
        return out


_TRACER: Tracer | None = None
_on = False


def enable() -> None:
    """Switch tracing on (the buffers are made at the first switch)."""
    global _TRACER, _on
    if _TRACER is None:
        _TRACER = Tracer()
    _on = True


def disable() -> None:
    """Switch tracing off; what was recorded stays until :func:`reset`."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


def span(name: str):
    """A context manager around one layer's call (see the module's
    docstring)."""
    if _on:
        return _Span(_TRACER, name)
    if _autograd_profiler._is_profiler_enabled:
        enable()
        return _Span(_TRACER, name)
    return _NOOP


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` in the current call."""
    if _on:
        _TRACER.count(name, n)


def host_value(t: torch.Tensor):
    """``t.item()``: a one-element tensor's value on the host, which waits
    for its device; counted in ``host_syncs``."""
    if _on:
        _TRACER.count("host_syncs")
    return t.item()


def kernel_counters(device, names):
    """While tracing, the address of two int64 on ``device`` that a
    counting kernel adds to, as ``names`` (two counter names) of the
    current call; None (a null pointer) otherwise, and while a profiler
    records, so that every launch it times is the kernel that runs with
    tracing off."""
    if _on and not _autograd_profiler._is_profiler_enabled:
        return _TRACER.kernel_counters(device, names)
    return None


def count_on_device(name: str, value: torch.Tensor) -> None:
    """While tracing and no profiler records, add the 0-dim integer tensor
    ``value`` to counter ``name`` of the current call without reading it:
    it is copied into a row of its device's ring, which :func:`snapshot`
    copies out once. Nothing otherwise, so that a profiled call makes the
    launches of an untraced one."""
    if _on and not _autograd_profiler._is_profiler_enabled:
        _TRACER.count_on_device(name, value)


def snapshot() -> Snapshot:
    """Spans, self times, counters (kernel rows copied from the device
    once: this waits for the device) and what was dropped, since the last
    :func:`reset`."""
    return (_TRACER or Tracer(1, 1, 1)).snapshot()


def reset() -> None:
    """Clear every record, counter and kernel ring (the wrappers'
    ``.launches`` are theirs and stay)."""
    if _TRACER is not None:
        _TRACER.reset()


class StageTimer:
    """Accumulate per-stage wall time; ``stage(name, sync=x)`` waits at the
    end of the stage for the devices of the tensors in ``x``. Each stage is
    a span of the timer's own tracer, recorded whether or not the port's
    tracing is on; its time is read from the span itself."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self._tracer = Tracer(64, 1, 1)

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        s = self._tracer.span(name)
        try:
            with s:
                try:
                    yield
                finally:
                    if sync is not None:
                        _sync(sync)
        finally:
            dt = (s.end - s.start) / 1e9
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> dict:
        return {name: {"total_ms": 1e3 * tot,
                       "mean_ms": 1e3 * tot / self.counts[name],
                       "count": self.counts[name]}
                for name, tot in self.totals.items()}


def assert_finite(tree, name: str = "value"):
    """Raise ``FloatingPointError`` naming the first leaf (a tensor or a
    numpy array, in nested dicts, lists and tuples) that holds NaN or Inf.
    Reading a CUDA tensor synchronises its device."""
    for path, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            bad = leaf.is_floating_point() and not bool(
                torch.isfinite(leaf).all())
        else:
            arr = np.asarray(leaf)
            bad = (np.issubdtype(arr.dtype, np.floating)
                   and not np.isfinite(arr).all())
        if bad:
            raise FloatingPointError(f"non-finite values in {name}{path}")
    return tree
