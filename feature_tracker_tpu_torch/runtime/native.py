"""ctypes bindings for the native host runtime (``native/ftk_runtime.cpp``).

The shared library is compiled at first use from the repository's
``native/`` sources, with the flags of ``native/Makefile``, into
``feature_tracker_tpu_torch/_build/``; nothing is written into ``native/``.
The file name carries a hash of the source, the flags and the CPU that
``-march=native`` resolves to, so a checkout moved to another host builds
its own. Every entry point has a numpy fallback, so the package works
without a compiler; the native path is the production one (no per-pixel
work under the interpreter lock).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from collections import deque

import numpy as np

from feature_tracker_tpu_torch.ops._build import (
    BUILD_DIR,
    PACKAGE_DIR,
    compile_to,
)

NATIVE_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "native")

# native/Makefile's CXXFLAGS; its baseline adds -ffp-contract=off.
CXX_FLAGS = ("-std=c++17", "-O3", "-Wall", "-fPIC", "-march=native")

_lock = threading.Lock()
_runtime = None


@functools.lru_cache(maxsize=None)
def _resolved_march(cxx: str) -> str:
    """What ``-march=native`` means on this host (g++'s report)."""
    proc = subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                          capture_output=True, text=True, timeout=60)
    return "\n".join(line for line in proc.stdout.splitlines()
                     if line.strip().startswith(("-march=", "-mtune=")))


def host_library_path(name: str, source: str, extra_flags=(),
                      force: bool = False):
    """Compile ``native/<source>`` into ``_build/lib<name>-<hash>.so``
    with g++ (if not built yet, or if ``force``) and return its path;
    None without a compiler or when the build fails."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    src = os.path.join(NATIVE_DIR, source)
    if cxx is None or not os.path.exists(src):
        return None
    flags = (*CXX_FLAGS, *extra_flags)
    try:
        digest = hashlib.sha256(
            " ".join((cxx, *flags, _resolved_march(cxx))).encode())
    except (OSError, subprocess.SubprocessError):
        return None
    with open(src, "rb") as fh:
        digest.update(fh.read())
    out = os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")
    if os.path.exists(out) and not force:
        return out
    try:
        proc = compile_to(out, [cxx, *flags, "-shared"], [src], timeout=300)
    except (OSError, subprocess.SubprocessError):
        return None
    return out if proc.returncode == 0 else None


def build_native(force: bool = False) -> bool:
    """Build the runtime library; returns True on success."""
    return host_library_path("ftk_runtime", "ftk_runtime.cpp",
                             force=force) is not None


def _load_lib():
    path = host_library_path("ftk_runtime", "ftk_runtime.cpp")
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    lib.ftk_now_ns.restype = ctypes.c_uint64
    lib.ftk_now_ns.argtypes = []
    lib.ftk_ring_create.restype = ctypes.c_void_p
    lib.ftk_ring_create.argtypes = [ctypes.c_size_t, ctypes.c_size_t]
    lib.ftk_ring_destroy.restype = None
    lib.ftk_ring_destroy.argtypes = [ctypes.c_void_p]
    lib.ftk_ring_size.restype = ctypes.c_size_t
    lib.ftk_ring_size.argtypes = [ctypes.c_void_p]
    lib.ftk_ring_push.restype = ctypes.c_int
    lib.ftk_ring_push.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_uint8),
                                  ctypes.c_size_t]
    lib.ftk_ring_pop.restype = ctypes.c_int
    lib.ftk_ring_pop.argtypes = [ctypes.c_void_p,
                                 ctypes.POINTER(ctypes.c_uint8),
                                 ctypes.c_size_t]
    lib.ftk_u8_to_f32.restype = None
    lib.ftk_u8_to_f32.argtypes = [ctypes.POINTER(ctypes.c_uint8),
                                  ctypes.POINTER(ctypes.c_float),
                                  ctypes.c_size_t]
    lib.ftk_pyramid_down.restype = None
    lib.ftk_pyramid_down.argtypes = [ctypes.POINTER(ctypes.c_float),
                                     ctypes.c_int64, ctypes.c_int64,
                                     ctypes.POINTER(ctypes.c_float)]
    lib.ftk_convert_and_pyramid.restype = None
    lib.ftk_convert_and_pyramid.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.POINTER(ctypes.POINTER(ctypes.c_float))]
    return lib


class RingBuffer:
    """Single-producer single-consumer frame queue: native when the library
    is loaded, else a deque."""

    def __init__(self, capacity: int, frame_bytes: int, lib=None):
        self._lib = lib
        self._frame_bytes = frame_bytes
        if lib is not None:
            self._handle = lib.ftk_ring_create(capacity, frame_bytes)
            if not self._handle:
                raise MemoryError("ftk_ring_create failed")
        else:
            self._capacity = capacity
            self._dq = deque()

    def push(self, frame: np.ndarray) -> bool:
        """Copy ``frame`` in; False (and nothing copied) when full."""
        buf = np.ascontiguousarray(frame, dtype=np.uint8)
        if buf.nbytes != self._frame_bytes:
            raise ValueError(f"frame of {buf.nbytes} bytes, the ring holds "
                             f"{self._frame_bytes}")
        if self._lib is not None:
            ptr = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
            return bool(self._lib.ftk_ring_push(self._handle, ptr,
                                                buf.nbytes))
        if len(self._dq) >= self._capacity:
            return False
        self._dq.append(buf.copy())
        return True

    def pop(self, shape) -> np.ndarray | None:
        """The oldest frame reshaped to ``shape``, or None when empty."""
        if self._lib is not None:
            out = np.empty(self._frame_bytes, np.uint8)
            ptr = out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
            if not self._lib.ftk_ring_pop(self._handle, ptr, out.nbytes):
                return None
            return out.reshape(shape)
        if not self._dq:
            return None
        return self._dq.popleft().reshape(shape)

    def __len__(self):
        if self._lib is not None:
            return int(self._lib.ftk_ring_size(self._handle))
        return len(self._dq)

    def __del__(self):
        if getattr(self, "_lib", None) is not None and self._handle:
            self._lib.ftk_ring_destroy(self._handle)
            self._handle = None


class NativeRuntime:
    """Facade over the native library with numpy fallbacks."""

    def __init__(self):
        self.lib = _load_lib()

    @property
    def is_native(self) -> bool:
        return self.lib is not None

    def now_ns(self) -> int:
        if self.lib is not None:
            return int(self.lib.ftk_now_ns())
        return time.monotonic_ns()

    def ring_buffer(self, capacity: int, frame_bytes: int) -> RingBuffer:
        return RingBuffer(capacity, frame_bytes, self.lib)

    def convert_and_pyramid(self, frame_u8: np.ndarray, levels: int):
        """uint8 ``[H, W]`` -> tuple of float32 numpy pyramid levels, half
        resolution per level with integer truncation (equal to
        ``ops.pyramid.build_pyramid(quantize=True)``)."""
        h, w = frame_u8.shape
        shapes = [(h, w)]
        for _ in range(levels - 1):
            h, w = h // 2, w // 2
            shapes.append((h, w))
        if self.lib is None:
            out = [np.asarray(frame_u8, np.float32)]
            for _ in range(levels - 1):
                a = out[-1]
                h2, w2 = (a.shape[0] // 2) * 2, (a.shape[1] // 2) * 2
                down = (a[0:h2:2, 0:w2:2] + a[1:h2:2, 0:w2:2]
                        + a[0:h2:2, 1:w2:2] + a[1:h2:2, 1:w2:2]) * 0.25
                out.append(np.floor(down))
            return tuple(out)

        buf = np.ascontiguousarray(frame_u8, np.uint8)
        outs = [np.empty(s, np.float32) for s in shapes]
        ptrs = (ctypes.POINTER(ctypes.c_float) * levels)(
            *[o.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
              for o in outs])
        self.lib.ftk_convert_and_pyramid(
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            buf.shape[0], buf.shape[1], levels, ptrs)
        return tuple(outs)


def get_runtime() -> NativeRuntime:
    """The process's one ``NativeRuntime`` (the library is loaded once)."""
    global _runtime
    with _lock:
        if _runtime is None:
            _runtime = NativeRuntime()
        return _runtime
