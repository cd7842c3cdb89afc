"""``frontend.replenish_share``: calls of ``detect_good_features`` over the
traced frames (the wrapper's count), as a share of those frames, in %. A
count: it repeats for a given seed."""


def read(record):
    p, t = record.profile, record.tracer
    if p is None or t is None or p.calls == 0:
        return None
    return 100.0 * t.count("pipeline.detect_good_features", below=p.calls) \
        / p.calls
