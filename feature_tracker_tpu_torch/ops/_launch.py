"""How the host launches the port's hand-written kernels (kernels 1-6).

Each kernel is one C entry ``ftk_*`` of a library that ``ops/_build.py``
compiles from ``csrc/`` with ``nvcc`` at first use; it is called through
``ctypes``. A :class:`Kernel` binds its entry and does for each of its
wrappers what they share: the dispatch by device, the launch span, the
zero-work return, the device and current stream of the call, the error
check and the wrapper's ``.launches``; and the same for the build with
phase clocks and the occupancy queries. The wrappers in ``ops/cuda_*.py``
keep their input checks, their outputs' shapes and the packing of their
C arguments.

A launch synchronises nothing, reads no device value and takes the stream
that is current when it is made, so that it can be captured into a CUDA
graph.
"""

from __future__ import annotations

import ctypes

import torch

from feature_tracker_tpu_torch.ops._build import (
    load_library,
    phase_clock_library,
)
from feature_tracker_tpu_torch.utils.profiling import span

_VP, _INT = ctypes.c_void_p, ctypes.c_int

# Stands for the current stream's handle in a kernel's C arguments: the
# stream is taken when the call is made.
STREAM = object()


def check(cond: bool, where: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{where}: {msg}")


def need_card(where: str, dev=None) -> None:
    """Raise before anything is built when there is no CUDA card (or ``dev``
    is not one): the diagnostics read a kernel on the card and have no
    plain version."""
    if not torch.cuda.is_available() or (dev is not None
                                         and dev.type != "cuda"):
        raise RuntimeError(f"{where} needs a CUDA device and CUDA tensors: "
                           "it measures a kernel on the card")


def raise_on_error(lib, function: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{function} launch failed: "
            f"{lib.ftk_cuda_error_string(rc).decode()} (cudaError {rc})")


def bind(library, function: str, argtypes) -> ctypes.CDLL:
    """Build (at first use) and load ``library`` (``(name, sources)`` or
    ``(name, sources, fmad)``), and declare ``function``'s C signature (it
    returns a cudaError)."""
    lib = load_library(*library)
    fn = getattr(lib, function)
    fn.argtypes = list(argtypes)
    fn.restype = _INT
    lib.ftk_cuda_error_string.argtypes = [_INT]
    lib.ftk_cuda_error_string.restype = ctypes.c_char_p
    return lib


def read_phase_clocks(lib, names) -> dict:
    """Read and reset the phase counters of a library built with phase
    clocks (after a synchronise): ``{"clocks": total, "share": {name:
    share of the total}}`` for the phases in ``names``, in the kernel's
    order."""
    counters = (ctypes.c_ulonglong * 8)()
    rc = lib.ftk_phase_clocks_read(ctypes.cast(counters, _VP))
    raise_on_error(lib, "ftk_phase_clocks_read", rc)
    total = sum(counters) or 1
    return {"clocks": sum(counters),
            "share": {n: c / total for n, c in zip(names, counters)}}


class Kernel:
    """The C entry ``function`` of ``library`` (as :func:`bind` takes it),
    with its C argument types ``argtypes``; ``span`` names the span that
    each call of its wrappers is, and ``phases`` the phases its source
    marks for the build with phase clocks, in the source's order."""

    def __init__(self, library, function: str, argtypes, span: str,
                 phases):
        self.library, self.function = library, function
        self.argtypes, self.span, self.phases = list(argtypes), span, phases
        self._lib = None

    def load(self) -> ctypes.CDLL:
        """Build (at first use) and load the kernel's library, its entry
        bound."""
        if self._lib is None:
            self._lib = bind(self.library, self.function, self.argtypes)
        return self._lib

    def __call__(self, wrapper, x, plain, prepare):
        """A call of ``wrapper``, by the device of its input ``x``, inside
        the span: ``plain()`` on the CPU; on the card ``prepare()``, which
        checks the inputs, allocates the outputs and returns ``(outputs,
        args)``, then, unless ``args`` is None (no work: zero features, an
        empty output), the entry with the C arguments ``args``, counted in
        ``wrapper.launches``. Any other device raises. Returns the
        outputs."""
        with span(self.span):
            if not x.is_cuda:
                check(x.device.type == "cpu", wrapper.__name__,
                      f"unsupported device {x.device}")
                return plain()
            outputs, args = prepare()
            if args is not None:
                self.enqueue(self.load(), x.device, args)
                wrapper.launches += 1
        return outputs

    def enqueue(self, lib, dev, args: list) -> None:
        """Call ``lib``'s entry (the kernel's build, or the one with phase
        clocks) on ``dev``'s current stream with the C arguments ``args``,
        in which :data:`STREAM` stands for that stream, and raise on its
        error."""
        with torch.cuda.device(dev):
            args[args.index(STREAM)] = torch.cuda.current_stream(
                dev).cuda_stream
            rc = getattr(lib, self.function)(*args)
        raise_on_error(lib, self.function, rc)

    def phase_clock_spec(self):
        """The library spec of the kernel's source built with phase clocks
        (``_build.phase_clock_library``), named ``<library>_phases``."""
        name, sources, *fmad = self.library
        return phase_clock_library(f"{name}_phases", sources[0], *fmad)

    def phase_clocks(self, where: str, x, prepare) -> dict:
        """Where the kernel's time goes on the card: ``prepare()`` (as for
        :meth:`__call__`, on CUDA inputs ``x`` among them) once with the
        build with phase clocks, then the shares of ``phases``
        (:func:`read_phase_clocks`). A diagnostic of the public function
        ``where``: the launch is in no wrapper's count."""
        need_card(where, x.device)
        lib = bind(self.phase_clock_spec(), self.function, self.argtypes)
        lib.ftk_phase_clocks_read.argtypes = [_VP]
        lib.ftk_phase_clocks_read.restype = _INT
        read_phase_clocks(lib, self.phases)         # zero the counters
        with span(self.span):
            _, args = prepare()
            if args is not None:
                self.enqueue(lib, x.device, args)
        torch.cuda.synchronize(x.device)
        return read_phase_clocks(lib, self.phases)

    def occupancy(self, where: str, function: str, *ints: int) -> dict:
        """What the current card holds of the kernel, from its library's
        ``function`` (``ftk_*_occupancy``, which takes ``ints`` and three
        outputs): ``registers`` a thread, ``warps_per_block``,
        ``blocks_per_sm`` (from
        ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) and their
        product ``warps_per_sm``. Nothing is launched. A diagnostic of the
        public function ``where``."""
        need_card(where)
        lib = self.load()
        fn = getattr(lib, function)
        fn.argtypes = [_INT] * len(ints) + [_VP] * 3
        fn.restype = _INT
        regs, warps, blocks = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
        rc = fn(*ints, *(ctypes.cast(ctypes.pointer(v), _VP)
                         for v in (regs, warps, blocks)))
        raise_on_error(lib, function, rc)
        return {"registers": regs.value, "warps_per_block": warps.value,
                "blocks_per_sm": blocks.value,
                "warps_per_sm": warps.value * blocks.value}
