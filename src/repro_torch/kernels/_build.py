"""Build and load the hand-written CUDA kernels.

Each ``csrc/*.cu`` source compiles on its own with ``nvcc`` into a
shared library with a plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC --resource-usage \
         -o build/torch_kernels/<name>-<hash>.so <name>.cu

Libraries go to ``build/torch_kernels/`` at the root of the checkout
(listed in ``.gitignore``), named by a hash of the source, every header
in ``csrc/`` and the flags, so a changed source rebuilds and an unchanged
one is reused; beside each, a ``.txt`` holds what ``--resource-usage``
printed.  Nothing is built at import: ``library()`` builds on first use,
and ``build_all()`` starts one ``nvcc`` per source at once and waits for
all of them.

``CudaKernel`` wraps one C entry point: it sets the ``ctypes`` argument
types, raises when the entry returns a non-zero ``cudaError_t`` and counts
its launches in ``launches``.  ``primitive(kernel)`` marks the Python
wrapper that launches it, so that a ``launch_hook`` (the session's op
trace, ``InferenceSession.ir_text``) sees each wrapper call as one line
named by its kernel, on the card and on the CPU alike.

A session on a card captures each prepared entry into a CUDA graph
(``impact.graphs``), and a replay makes no Python call.  So while an
entry is prepared (its eager run on zero inputs, then its capture) the
launches go to a ``record_launches`` record instead of ``launches``, and
every replay adds the capture's record with ``add_launches``:
``launch_counts()`` counts the kernel launches of each call, graphed or
eager, and none of the preparation.  A ``launch_hook`` sees the wrapper
calls of the preparation only, never a replay.

What was compiled can be read back: ``resource_table`` parses the
``--resource-usage`` report into each kernel's registers, shared memory
and spills, and ``sass`` disassembles a library with ``cuobjdump``.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-shared", "-Xcompiler",
                           "-fPIC", "--resource-usage")
SOURCES = ("crossbar_mvm.cu", "fused_impact.cu", "ta_feedback.cu",
           "digital_cotm.cu")
# Every header beside the sources: each is part of every library's hash.
HEADERS = tuple(sorted(p.name for p in CSRC.glob("*.cuh")))

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
    out.with_suffix(".txt").write_text(log)  # registers, spills, smem
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


def resource_usage(source: str) -> str:
    """What ``nvcc --resource-usage`` printed when ``source``'s library was
    built: each kernel's registers, spills and shared memory."""
    library(source)
    return _target(source).with_suffix(".txt").read_text()


@dataclass(frozen=True)
class Resources:
    """One compiled kernel's resources, as ``--resource-usage`` reports
    them: registers a thread, static shared memory a block (bytes), and
    the bytes of its stack frame and spills."""
    registers: int
    smem: int
    stack: int
    spill_stores: int
    spill_loads: int


def kernel_name(mangled: str) -> str:
    """A readable name of a mangled kernel symbol: the function's name
    and its integer template arguments, as ``impact_tail<1>`` for
    ``_ZN48_GLOBAL__N__5b68df1e_15_fused_impact_cu_968572f211impact_tailILb1EEEv...``
    (the anonymous namespace a source's kernels live in is dropped)."""
    m = re.match(r"_Z(N?)", mangled)
    if m is None:
        return mangled
    i, parts = m.end(), []
    while i < len(mangled) and mangled[i].isdigit():
        d = re.match(r"\d+", mangled[i:]).group(0)
        start = i + len(d)
        parts.append(mangled[start:start + int(d)])
        i = start + int(d)
        if not m.group(1):
            break
    names = [p for p in parts if not p.startswith("_GLOBAL__N")]
    if not names:
        return mangled
    args = []
    if mangled[i:i + 1] == "I":
        for a in re.finditer(r"L[a-z](\d+)E", mangled[i + 1:]):
            if a.start() != sum(len(x.group(0)) for x in args):
                break
            args.append(a)
    return names[-1] + (f"<{','.join(a.group(1) for a in args)}>"
                        if args else "")


def parse_resources(text: str) -> dict[str, Resources]:
    """Each kernel's ``Resources`` in a ``--resource-usage`` report, by
    ``kernel_name``.  A report without a kernel is an error."""
    fields: dict[str, dict[str, int]] = {}
    name = None
    for line in text.splitlines():
        sym = re.search(r"(_Z\w+)", line)
        if sym is not None:
            name = kernel_name(sym.group(1))
            fields.setdefault(name, {})
            continue
        if name is None:
            continue
        for key, pat in (("registers", r"Used (\d+) registers"),
                         ("smem", r"(\d+) bytes smem"),
                         ("stack", r"(\d+) bytes stack frame"),
                         ("spill_stores", r"(\d+) bytes spill stores"),
                         ("spill_loads", r"(\d+) bytes spill loads")):
            m = re.search(pat, line)
            if m is not None:
                fields[name][key] = int(m.group(1))
    table = {k: Resources(**{f: v.get(f, 0) for f in Resources.__annotations__})
             for k, v in fields.items() if "registers" in v}
    if not table:
        raise ValueError("no kernel's registers in the resource report")
    return table


def resource_table(source: str) -> dict[str, Resources]:
    """``parse_resources`` of ``source``'s build report."""
    return parse_resources(resource_usage(source))


def cuobjdump() -> str:
    """Path of ``cuobjdump``, next to ``nvcc()``; raises where it is
    missing."""
    tool = Path(nvcc()).parent / "cuobjdump"
    if not tool.exists():
        raise RuntimeError(f"cuobjdump not found beside nvcc ({tool}): it "
                           f"disassembles the built kernels")
    return str(tool)


@functools.lru_cache(maxsize=None)
def _sass(target: Path) -> str:
    return subprocess.run([cuobjdump(), "-sass", str(target)],
                          capture_output=True, text=True, check=True).stdout


def sass(source: str) -> str:
    """The SASS of ``source``'s library (``cuobjdump -sass``), built
    first if needed."""
    library(source)
    return _sass(_target(source))


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


_HOOKS: list = []
_RECORDS: list[collections.Counter] = []


@contextlib.contextmanager
def launch_hook(hook):
    """Within the block, each call of a ``primitive`` wrapper goes to
    ``hook(symbol, fn, args, kwargs)``, which must call ``fn(*args,
    **kwargs)`` and return its result."""
    _HOOKS.append(hook)
    try:
        yield
    finally:
        _HOOKS.remove(hook)


def primitive(kernel: "CudaKernel"):
    """Mark the Python wrapper of ``kernel``: outside a ``launch_hook``
    the call is the wrapper's own."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if _HOOKS:
                return _HOOKS[-1](kernel.symbol, fn, args, kwargs)
            return fn(*args, **kwargs)
        return wrapper
    return deco


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
        if _RECORDS:
            _RECORDS[-1][self] += 1
        else:
            self.launches += 1


@contextlib.contextmanager
def record_launches():
    """Within the block, each kernel launch is added to the yielded
    ``Counter`` (by ``CudaKernel``) instead of to its ``launches``."""
    record: collections.Counter = collections.Counter()
    _RECORDS.append(record)
    try:
        yield record
    finally:
        _RECORDS.remove(record)


def add_launches(record: collections.Counter) -> None:
    """Count the launches of a ``record_launches`` record once more: one
    replay of the graph it was recorded at."""
    for kernel, n in record.items():
        kernel.launches += n


def record_symbols(record: collections.Counter) -> dict[str, int]:
    """A ``record_launches`` record by C symbol."""
    return {k.symbol: n for k, n in record.items()}


def launch_counts() -> dict[str, int]:
    """Launch count of every kernel entry point, by C symbol."""
    return {k.symbol: k.launches for k in _KERNELS}


def reset_launch_counts() -> None:
    for k in _KERNELS:
        k.launches = 0
