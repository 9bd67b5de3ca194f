"""Build and load the hand-written CUDA kernels.

Each ``csrc/*.cu`` source compiles on its own with ``nvcc`` into a
shared library with a plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/torch_kernels/<name>-<hash>.so <name>.cu

Libraries go to ``build/torch_kernels/`` at the root of the checkout
(listed in ``.gitignore``), named by a hash of the source, the shared
headers and the flags, so a changed source rebuilds and an unchanged one
is reused.  Nothing is built at import: ``library()`` builds on first use,
and ``build_all()`` starts one ``nvcc`` per source at once and waits for
all of them.

``CudaKernel`` wraps one C entry point: it sets the ``ctypes`` argument
types, raises when the entry returns a non-zero ``cudaError_t`` and counts
its launches in ``launches``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-shared", "-Xcompiler",
                           "-fPIC")
SOURCES = ("crossbar_mvm.cu", "fused_impact.cu", "ta_feedback.cu",
           "digital_cotm.cu")
HEADERS = ("tile_mma.cuh",)

_LIBS: dict[str, ctypes.CDLL] = {}
_ENTRIES: dict[tuple[str, str], ctypes._CFuncPtr] = {}
_KERNELS: list["CudaKernel"] = []


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin/nvcc``, else the one on PATH."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH to build the CUDA kernels")
    return found


def _target(source: str) -> Path:
    text = b"".join((CSRC / f).read_bytes() for f in (source, *HEADERS))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{Path(source).stem}-{digest[:16]}.so"


def _start(source: str) -> tuple[Path, Path, subprocess.Popen] | None:
    out = _target(source)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def _finish(source: str, job) -> None:
    if job is None:
        return
    out, tmp, proc = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {source} "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)             # atomic: a concurrent build is harmless


def build_all() -> float:
    """Compile every source that has no up-to-date library, one ``nvcc``
    process per source, all started together.  Returns the seconds taken."""
    t0 = time.perf_counter()
    jobs = {s: _start(s) for s in SOURCES}
    for s, job in jobs.items():
        _finish(s, job)
    return time.perf_counter() - t0


def library(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed."""
    lib = _LIBS.get(source)
    if lib is None:
        _finish(source, _start(source))
        lib = ctypes.CDLL(str(_target(source)))
        _LIBS[source] = lib
    return lib


# ctypes spellings of the C argument types: every pointer (and the stream)
# is c_void_p, or ctypes would pass it as a 32-bit int and cut it.
PTR = ctypes.c_void_p
INT = ctypes.c_int
FLOAT = ctypes.c_float


def entry(source: str, symbol: str, argtypes: list, restype=None):
    """A C function of ``source``'s library with its ``ctypes`` signature
    set (looked up once)."""
    fn = _ENTRIES.get((source, symbol))
    if fn is None:
        fn = getattr(library(source), symbol)
        fn.argtypes = argtypes
        fn.restype = restype
        _ENTRIES[(source, symbol)] = fn
    return fn


class CudaKernel:
    """One C entry point of a kernel library, with its launch count."""

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        _KERNELS.append(self)

    def __call__(self, *args) -> None:
        err = entry(self.source, self.symbol, self.argtypes, INT)(*args)
        if err != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {err} at launch")
        self.launches += 1


def launch_counts() -> dict[str, int]:
    """Launch count of every kernel entry point, by C symbol."""
    return {k.symbol: k.launches for k in _KERNELS}


def reset_launch_counts() -> None:
    for k in _KERNELS:
        k.launches = 0
