"""``device.idle_share``: the share of a call's untraced time in which no
operation ran on the device, in %: the device's busy time per call over
the profiled calls (torch.profiler's trace), against the mean time of the
plain calls right after them (``Profile.plain_call_s``), so that the
profiler's own host time does not count as idleness."""


def read(record):
    p = record.profile
    if p is None or not p.plain_call_s or p.calls == 0 or p.busy_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.calls / p.plain_call_s)
