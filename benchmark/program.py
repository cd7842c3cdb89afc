"""The port's own spans and counters in a traced run
(``feature_tracker_tpu_torch.utils.profiling``).

The port's tracing switches itself on when its first span is entered under
the traced run's profiler, so its calls are the window's, and stays on
after it. The readers of the metrics it feeds read the plain phase, window
calls ``[P, 2P)`` with ``P = record.profile.calls``: no profiler runs
there, and none of the benchmark's synchronising spans do. A port without
the tracer, a count of top-level calls other than the window's, or a plain
phase cut short gives nothing to read (None).
"""

from __future__ import annotations

_cache = {}


def plain_phase(record):
    """``(snapshot, (P, 2P))`` of the port's tracer after a traced run, or
    None."""
    p = record.profile
    if p is None or p.calls == 0:
        return None
    try:
        from feature_tracker_tpu_torch.utils import profiling
    except ImportError:
        return None
    snapshot = getattr(profiling, "snapshot", None)
    if snapshot is None:
        return None
    if _cache.get("record") is not record:
        _cache.update(record=record, snap=snapshot())
    snap = _cache["snap"]
    window = (p.calls, 2 * p.calls)
    if snap.calls != len(record.latencies) or snap.calls < window[1]:
        return None
    return snap, window


def mean_span_ns(record, name, self_time=False):
    """Mean duration (or self time) in ns of span ``name`` over the plain
    phase, or None."""
    found = plain_phase(record)
    if found is None:
        return None
    snap, window = found
    m = snap.select(name, window)
    if not m.any():
        return None
    return float((snap.self_ns if self_time else snap.duration_ns)[m].mean())


def per_call_ns(record, name, calls_with=None):
    """Span ``name``'s total duration in ns over the plain phase, per call
    (per call holding span ``calls_with`` if given), or None."""
    found = plain_phase(record)
    if found is None:
        return None
    snap, window = found
    m = snap.select(name, window)
    if calls_with is None:
        calls = window[1] - window[0]
    else:
        calls = len(set(snap.call[snap.select(calls_with, window)].tolist()))
    if not m.any() or calls == 0:
        return None
    return float(snap.duration_ns[m].sum()) / calls
