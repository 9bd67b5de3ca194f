"""One CUDA graph per prepared ``(entry, batch)`` of a session on a card:
the counterpart of the reference's AOT executables (``_compile_entry``).

``capture(fn, inputs, pool)`` prepares one entry.  It runs ``fn(*inputs)``
once eagerly on a side stream, so that everything lazy happens outside
the capture (a kernel library is built and loaded, the clause stage sets
its dynamic shared-memory attribute, CUDA loads a module on its first
launch).  Then it captures ``fn`` on that stream into one
``torch.cuda.CUDAGraph`` that reads the static ``inputs`` and writes
static outputs.  The kernel wrappers' launches at preparation go to a
``kernels._build.record_launches`` record, and ``census`` counts the
captured graph's nodes through the driver.  A capture that fails raises,
naming the CUDA error; nothing retries eagerly.

``GraphedEntry`` is what a session calls.  It copies the caller's
operands into the static inputs: numpy arrays and host tensors through a
pinned staging buffer, device tensors on the device.  It replays the
graph, adds the recorded launches to the kernels' counts, and returns
clones of the static outputs, so that a result survives the next call.
Each step is a span of ``repro_torch.tracing`` (``graphs.copy_in`` with
its ``graphs.staging_wait``, ``graphs.replay``, ``graphs.clone``,
``graphs.capture``), with the bytes copied in and cloned out and the
captures counted.

``StagedEntry`` is the same for an entry of a sharded session, whose
body sums over the process group between its local stages
(``sharding.crossbar.ShardedCall``): one graph a stage, all in the
session's pool, each stage reading the entry's static inputs and the
previous stage's static outputs; the collectives run on those outputs
between the replays, outside every graph.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import functools
import gc
import re
from typing import Any, Callable, Sequence

import numpy as np
import torch

from .. import tracing
from ..kernels import _build

#: ``CUgraphNodeType`` names (``cuda.h``), for the census.
NODE_TYPES = ("kernel", "memcpy", "memset", "host", "graph", "empty",
              "wait_event", "event_record", "ext_semas_signal",
              "ext_semas_wait", "mem_alloc", "mem_free", "batch_mem_op",
              "conditional")

# The port's kernels live in each source's anonymous namespace, which
# nvcc mangles as ``_GLOBAL__N__<hash>_<n>_<stem>_cu_<hash>``.
_PORT_KERNEL_RE = re.compile(
    r"_GLOBAL__N__\w*?_\d+_(?:%s)_cu_" % "|".join(
        re.escape(s.rsplit(".", 1)[0]) for s in _build.SOURCES))


def enabled(device: torch.device) -> bool:
    """Whether a session on ``device`` captures its entries: on a card,
    whatever the backend, as the reference compiles every backend's
    entries."""
    return device.type == "cuda"


def new_pool(device: torch.device):
    """A graph memory pool for one session's graphs on ``device`` (None
    where it captures nothing)."""
    return torch.cuda.graph_pool_handle() if enabled(device) else None


@dataclasses.dataclass(frozen=True)
class Census:
    """The nodes of one captured graph: each kernel node's mangled name,
    and the number of nodes of every other type."""
    kernels: tuple[str, ...]
    other: dict[str, int]

    @property
    def port_kernels(self) -> int:
        """Kernel nodes of the port's own CUDA sources."""
        return sum(1 for k in self.kernels if is_port_kernel(k))

    @property
    def library_kernels(self) -> int:
        """Kernel nodes of PyTorch's (aten's) kernels."""
        return len(self.kernels) - self.port_kernels

    def describe(self) -> str:
        names = collections.Counter(
            _build.kernel_name(k) for k in self.kernels if is_port_kernel(k))
        return (f"{len(self.kernels)} kernel nodes ({self.port_kernels} of "
                f"the port: "
                + (", ".join(f"{k} x{n}" for k, n in sorted(names.items()))
                   or "none")
                + f"; {self.library_kernels} of PyTorch)"
                + "".join(f", {n} {t}" for t, n in sorted(self.other.items())))


def is_port_kernel(mangled: str) -> bool:
    """Whether a kernel's mangled name is one of the port's kernels."""
    return _PORT_KERNEL_RE.search(mangled) is not None


class _KernelNodeParams(ctypes.Structure):
    """``CUDA_KERNEL_NODE_PARAMS_v2`` (``cuda.h``)."""
    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3),
                ("shared_mem_bytes", ctypes.c_uint),
                ("kernel_params", ctypes.c_void_p),
                ("extra", ctypes.c_void_p), ("kern", ctypes.c_void_p),
                ("ctx", ctypes.c_void_p)]


@functools.lru_cache(maxsize=None)
def _driver() -> ctypes.CDLL:
    return ctypes.CDLL("libcuda.so.1")


def _check(what: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA driver error {err}")


def census(graph: torch.cuda.CUDAGraph) -> Census:
    """Count the nodes of a graph captured with ``keep_graph=True``
    (``cuGraphGetNodes``, ``cuGraphNodeGetType``), naming each kernel
    node by its function (``cuFuncGetName``, or ``cuKernelGetName`` for a
    kernel node that holds a library kernel)."""
    cu = _driver()
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    _check("cuGraphGetNodes", cu.cuGraphGetNodes(handle, None,
                                                 ctypes.byref(n)))
    nodes = (ctypes.c_void_p * n.value)()
    _check("cuGraphGetNodes", cu.cuGraphGetNodes(handle, nodes,
                                                 ctypes.byref(n)))
    kernels, other = [], collections.Counter()
    for node in nodes:
        kind = ctypes.c_int(-1)
        _check("cuGraphNodeGetType",
               cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                     ctypes.byref(kind)))
        if kind.value != 0:
            other[NODE_TYPES[kind.value] if kind.value < len(NODE_TYPES)
                  else f"type {kind.value}"] += 1
            continue
        params = _KernelNodeParams()
        _check("cuGraphKernelNodeGetParams",
               cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node),
                                                ctypes.byref(params)))
        name = ctypes.c_char_p()
        if params.func:
            _check("cuFuncGetName", cu.cuFuncGetName(
                ctypes.byref(name), ctypes.c_void_p(params.func)))
        else:
            _check("cuKernelGetName", cu.cuKernelGetName(
                ctypes.byref(name), ctypes.c_void_p(params.kern)))
        kernels.append(name.value.decode())
    return Census(kernels=tuple(kernels), other=dict(other))


@dataclasses.dataclass
class Captured:
    """What preparing one entry on a card made: the graph, its static
    outputs, the launches its kernel wrappers made at capture (by
    ``CudaKernel``) and its node census."""
    graph: Any
    outputs: Any
    launches: collections.Counter
    census: Census


def capture(fn: Callable, inputs: Sequence[torch.Tensor], pool) -> Captured:
    """Run ``fn(*inputs)`` once on a side stream, then capture it there
    into one CUDA graph drawing on the memory ``pool``.  Neither run adds
    to the kernels' launch counts.  The garbage collector is off while
    capturing: a collection that frees another graph then calls the CUDA
    runtime in a way a capture forbids, and the capture is invalidated
    (``cudaErrorStreamCaptureInvalidated`` at the body's next launch)."""
    side = torch.cuda.Stream(device=inputs[0].device)
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), _build.record_launches():
        fn(*inputs)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.stream(side), _build.record_launches() as launches:
            graph.capture_begin(pool=pool)
            try:
                outputs = fn(*inputs)
            except BaseException:
                # End the broken capture; the body's own error is the one
                # to raise.
                with contextlib.suppress(RuntimeError):
                    graph.capture_end()
                raise
            graph.capture_end()
    finally:
        if collecting:
            gc.enable()
    graph.instantiate()
    torch.cuda.current_stream().wait_stream(side)
    return Captured(graph=graph, outputs=outputs, launches=launches,
                    census=census(graph))


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    return type(x)(_clone(y) for y in x)


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for y in x for t in _leaves(y)]


class GraphedEntry:
    """One prepared ``(entry, batch)`` on a card: static input buffers,
    the captured graph and its static outputs.  ``__call__`` takes the
    entry's operands (numpy arrays, host or device tensors) already
    checked by the session."""

    def __init__(self, name: str, batch: int, fn: Callable,
                 inputs: Sequence[torch.Tensor], pool):
        self._setup(name, batch, inputs)
        self.stages = [(self._capture(fn, self.inputs, pool), None)]

    def _setup(self, name: str, batch: int,
               inputs: Sequence[torch.Tensor]) -> None:
        self.name, self.batch = name, batch
        self.inputs = tuple(inputs)
        # Pinned host buffers of the inputs that host operands pass
        # through, made on first use, each with its numpy view.
        self._staging: list[tuple[torch.Tensor, np.ndarray] | None] = \
            [None] * len(inputs)
        # Recorded after a call's copies out of the staging buffers.
        self._copied = torch.cuda.Event() if self.inputs[0].is_cuda else None
        self._pending = False

    def _capture(self, fn: Callable, inputs, pool, what: str = "") -> Captured:
        try:
            with tracing.span("graphs.capture"):
                cap = capture(fn, inputs, pool)
        except RuntimeError as e:
            raise RuntimeError(f"capturing {self.name}@{self.batch}{what} "
                               f"into a CUDA graph failed: {e}") from e
        tracing.add("graphs.captures", always=True)
        return cap

    @property
    def outputs(self):
        """The static outputs a call returns clones of."""
        return self.stages[-1][0].outputs

    @functools.cached_property
    def in_bytes(self) -> int:
        """Bytes a call copies into the static inputs."""
        return sum(t.nbytes for t in self.inputs)

    @functools.cached_property
    def out_bytes(self) -> int:
        """Bytes a call clones out of the static outputs."""
        return sum(t.nbytes for t in _leaves(self.outputs))

    @property
    def census(self) -> Census:
        """The nodes of the entry's graphs, all stages together."""
        kernels, other = [], collections.Counter()
        for cap, _ in self.stages:
            kernels += cap.census.kernels
            other.update(cap.census.other)
        return Census(kernels=tuple(kernels), other=dict(other))

    @property
    def launches(self) -> dict[str, int]:
        """The launches of one call, by C symbol."""
        record = collections.Counter()
        for cap, _ in self.stages:
            record.update(cap.launches)
        return _build.record_symbols(record)

    def _stage(self, i: int, x) -> torch.Tensor:
        """The host operand ``x`` in input ``i``'s pinned staging buffer."""
        if self._staging[i] is None:
            static = self.inputs[i]
            buf = torch.empty(static.shape, dtype=static.dtype,
                              pin_memory=True)
            self._staging[i] = (buf, buf.numpy())
        buf, view = self._staging[i]
        # numpy casts (bool literals to int8, say) without a dispatch.
        np.copyto(view, x.numpy() if isinstance(x, torch.Tensor) else x,
                  casting="unsafe")
        return buf

    def copy_in(self, *args) -> None:
        """Copy the operands into the static inputs: a device tensor on
        the device, anything else through its pinned staging buffer
        without a synchronize.  A staging buffer is written only once
        the previous call's copies out of it have run."""
        with tracing.span("graphs.copy_in"):
            if self._pending:
                with tracing.span("graphs.staging_wait"):
                    self._copied.synchronize()
                self._pending = False
            for i, (static, x) in enumerate(zip(self.inputs, args)):
                if isinstance(x, torch.Tensor) and x.device.type != "cpu":
                    static.copy_(x)
                elif static.device.type == "cpu":
                    static.copy_(torch.as_tensor(x))
                else:
                    static.copy_(self._stage(i, x), non_blocking=True)
                    self._pending = True
            if self._pending:
                self._copied.record()
        tracing.add("graphs.copy_in_bytes", self.in_bytes)

    def replay(self) -> None:
        """Replay the graph of every stage on the current stream, in
        order, and count its launches; a stage's collective runs on its
        static outputs after its replay."""
        with tracing.span("graphs.replay"):
            for i, (cap, collective) in enumerate(self.stages):
                try:
                    cap.graph.replay()
                except RuntimeError as e:
                    what = f" stage {i}" if len(self.stages) > 1 else ""
                    raise RuntimeError(
                        f"replaying the CUDA graph of {self.name}@"
                        f"{self.batch}{what} failed: {e}") from e
                _build.add_launches(cap.launches)
                if collective is not None:
                    # gloo's all_reduce of a CUDA tensor makes its own
                    # stream wait on the current one before it copies the
                    # tensor to the host, and makes the current stream
                    # wait on its copy back before it returns: the replay
                    # above is on the current stream, and so is the next
                    # stage's, so the sum sits between them.
                    collective(*cap.outputs)

    def __call__(self, *args):
        self.copy_in(*args)
        self.replay()
        with tracing.span("graphs.clone"):
            out = _clone(self.outputs)
        tracing.add("graphs.clone_bytes", self.out_bytes)
        return out


class StagedEntry(GraphedEntry):
    """One prepared ``(entry, batch)`` of a sharded session on a card: one
    captured graph a local stage, in the session's pool, with the
    collectives between them.

    ``stages`` is a list of ``(fn, collective)``: stage i's ``fn`` takes
    the entry's static inputs and then stage i - 1's static outputs (a
    tuple of tensors) and returns its own; ``collective`` (None after the
    last stage) sums stage i's outputs in place over the process group.
    Stage i is captured once stage i - 1's outputs exist, so its warm-up
    run reads buffers no replay has written yet: a stage must not branch
    on the values it reads."""

    def __init__(self, name: str, batch: int,
                 stages: Sequence[tuple[Callable, Callable | None]],
                 inputs: Sequence[torch.Tensor], pool):
        self._setup(name, batch, inputs)
        self.stages = []
        carry = ()
        for i, (fn, collective) in enumerate(stages):
            cap = self._capture(fn, self.inputs + carry, pool,
                                f" stage {i}")
            self.stages.append((cap, collective))
            carry = tuple(cap.outputs)
