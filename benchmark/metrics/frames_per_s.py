"""``frames_per_s``: frames fully processed in the window over the window's
length (host clock; a call of a batch of pairs counts each pair)."""


def read(record):
    if not record.latencies:
        return None
    return record.frames / record.window_s
