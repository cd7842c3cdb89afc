"""Streaming frame pipeline: producer thread -> native ring -> consumer.

A producer thread takes uint8 frames from the source and pushes them into
the native single-producer single-consumer ring; the consumer pops them,
runs the fused native convert + pyramid and yields the pyramid, while the
producer works on the next frame. Frames are dropped (not waited for) when
the ring is full, as from a camera.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Iterable, Iterator

import numpy as np

from feature_tracker_tpu_torch.runtime.native import get_runtime


class FrameStream:
    """Iterate ``(frame_id, pyramid levels as float32 numpy)`` over a
    source; upload a pyramid with ``torch.as_tensor(level, device=...)``.

    Args:
      source: iterable of uint8 ``[H, W]`` frames (all of one shape).
      levels: pyramid levels to build per frame.
      capacity: ring slots; the producer drops frames when it is full.
      on_drop: called with the index of each dropped frame.
    """

    def __init__(self, source: Iterable[np.ndarray], levels: int = 4,
                 capacity: int = 8,
                 on_drop: Callable[[int], None] | None = None):
        self._source = iter(source)
        self._levels = levels
        self._capacity = capacity
        self._on_drop = on_drop
        self._rt = get_runtime()
        self._ring = None
        self._shape = None
        self._produced = 0
        self._dropped = 0
        self._done = threading.Event()
        self._thread = None

    def _producer(self):
        try:
            for frame in self._source:
                frame = np.ascontiguousarray(frame, np.uint8)
                if not self._ring.push(frame):
                    self._dropped += 1
                    if self._on_drop is not None:
                        self._on_drop(self._produced)
                self._produced += 1
        finally:
            self._done.set()

    def __iter__(self) -> Iterator:
        first = next(self._source, None)
        if first is None:
            return
        first = np.ascontiguousarray(first, np.uint8)
        self._shape = first.shape
        self._ring = self._rt.ring_buffer(self._capacity, first.nbytes)
        self._ring.push(first)
        self._produced = 1
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

        frame_id = 0
        while True:
            frame = self._ring.pop(self._shape)
            if frame is None:
                if self._done.is_set() and len(self._ring) == 0:
                    break
                # The producer is slower than the consumer: yield the core
                # briefly instead of spinning on the empty ring.
                time.sleep(0.0005)
                continue
            yield frame_id, self._rt.convert_and_pyramid(frame, self._levels)
            frame_id += 1
        self._thread.join()

    @property
    def dropped(self) -> int:
        return self._dropped
