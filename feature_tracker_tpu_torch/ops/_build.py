"""Build the port's CUDA sources into shared libraries at first use.

Each library is compiled by ``nvcc`` from ``feature_tracker_tpu_torch/csrc``
into ``feature_tracker_tpu_torch/_build/`` (listed in ``.gitignore``). The
file name carries a hash of the sources, of every header under ``csrc/``
and of the flags, so a changed source or header is rebuilt and an unchanged
one is loaded as it is. The library has a plain C
interface and is loaded with ``ctypes``; nothing includes PyTorch's
headers, so a build takes seconds.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")

# sm_90a: Hopper. Beside these every library gets --fmad=false, which keeps
# every multiply and add rounded on its own, as in the plain PyTorch
# versions, unless its spec asks for fused multiply-adds (see the kernel
# sources: only raft_lookup.cu does).
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from source at first use and need the CUDA toolkit")


def library_path(name: str, sources, fmad: bool = False) -> str:
    """Build (if needed) and return the path of ``lib<name>-<hash>.so``.

    ``sources`` are file names under ``csrc/``; ``fmad`` allows the compiler
    to fuse multiplies and adds in this library. The compiler's report
    (registers, shared memory, spills from ``-Xptxas -v``) is kept beside
    the library as ``<library>.log``."""
    paths = [os.path.join(CSRC_DIR, s) for s in sources]
    headers = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    flags = (*NVCC_FLAGS, f"--fmad={'true' if fmad else 'false'}")
    digest = hashlib.sha256(" ".join(flags).encode())
    for p in paths + headers:
        with open(p, "rb") as fh:
            digest.update(fh.read())
    out = os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    proc = compile_to(out, [find_nvcc(), *flags], paths)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed building {name}:\n"
                           f"{proc.stdout}\n{proc.stderr}")
    with open(out + ".log", "w") as fh:
        fh.write(proc.stdout + proc.stderr)
    return out


def compile_to(out: str, command, sources, timeout: int = 600):
    """Run ``command -o <tmp> sources`` and, if it succeeds, rename the
    temporary file to ``out`` (in the build directory). Building under a
    temporary name means a concurrent build never loads a half-written
    library. Returns the finished process (text output)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([*command, "-o", tmp, *sources],
                              capture_output=True, text=True,
                              timeout=timeout)
        if proc.returncode == 0:
            os.replace(tmp, out)
        return proc
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def phase_clock_library(name: str, source: str, fmad: bool = False):
    """The spec ``(name, sources, fmad)`` of ``csrc/<source>`` compiled with
    ``FTK_PHASE_CLOCKS`` defined (``csrc/klt_common.cuh``): the same kernels
    with clocks at their phase marks, and ``ftk_phase_clocks_read``. The
    short source that defines the macro and includes the kernel's is
    written into the build directory; it carries a hash of the kernel's
    source, so that a changed kernel is rebuilt."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    included = os.path.join(CSRC_DIR, source)
    with open(included, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:16]
    path = os.path.join(BUILD_DIR, f"{name}.cu")
    text = (f'// {source} {digest}\n#define FTK_PHASE_CLOCKS 1\n'
            f'#include "{included}"\n')
    if not os.path.exists(path) or open(path).read() != text:
        with open(path, "w") as fh:
            fh.write(text)
    return (name, (path,), fmad)


def build_libraries(specs) -> list:
    """Build several libraries at once, one ``nvcc`` process each, all
    started together. ``specs`` is a sequence of ``(name, sources)`` or
    ``(name, sources, fmad)``; returns their paths in order."""
    specs = list(specs)
    with concurrent.futures.ThreadPoolExecutor(len(specs) or 1) as pool:
        return list(pool.map(lambda spec: library_path(*spec), specs))


@functools.lru_cache(maxsize=None)
def load_library(name: str, sources: tuple,
                 fmad: bool = False) -> ctypes.CDLL:
    """Build at first use and load the library once per process."""
    return ctypes.CDLL(library_path(name, sources, fmad))
