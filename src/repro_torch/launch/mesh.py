"""Device meshes over ``torch.distributed`` (the port of
``repro.launch.mesh``).

A mesh here is a ``torch.distributed.device_mesh.DeviceMesh`` over the
world of a process group that the caller has initialised
(``init_process_group``, or a ``torchrun`` launch): one process a rank,
every rank running the same program (SPMD).  The axes are ``("data",
"model")``, with ``"pod"`` in front for a multi-pod mesh, as in the
reference.  The functions build nothing at import and touch no process
group until called.

``DeviceMesh.shape`` is a tuple, where the reference's jax ``Mesh.shape``
maps axis names to sizes; ``axis_sizes`` reads either, so the sharding
code runs on a ``DeviceMesh`` and on any object whose ``shape`` is such
a dict (the tests' ``FakeMesh``).

``spawn`` runs a function on a world of processes on one host, each
rank in a ``gloo`` process group: the way the tests, ``chip_smoke.py``
and ``repro_torch.crossbar_scaling`` start a world.  ``gloo`` reduces
CPU and CUDA tensors alike, so every rank of a world may share one card.

``make_production_mesh`` builds the LM stack's production mesh, 16 x 16
(one pod of 256 ranks) or 2 x 16 x 16 (two pods, 512).  ``fake_world``
gives one process such a world without the ranks: ``torch.distributed``'s
``"fake"`` process group, whose collectives do nothing, so that a step on
``meta`` tensors runs as rank ``rank`` of the world would run it (the
counterpart of the reference's ``--xla_force_host_platform_device_count
=512``; ``launch.dryrun`` runs in it).
"""
from __future__ import annotations

import contextlib
import datetime
import gc
from typing import Any, Callable

import torch.distributed as dist

from ..device import DEFAULT_DEVICE

#: How long a rank waits on a collective or on the rendezvous before it
#: fails, so that a rank that died cannot hang the rest for gloo's
#: default half hour.
TIMEOUT_S = 300


def axis_sizes(mesh) -> dict[str, int]:
    """Axis name -> size of ``mesh``: a ``DeviceMesh`` (its
    ``mesh_dim_names`` against its tuple ``shape``) or an object whose
    ``shape`` is that dict already."""
    if isinstance(mesh.shape, dict):
        return {k: int(v) for k, v in mesh.shape.items()}
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the mesh has no axis names: build it with "
                         "mesh_dim_names=('data', 'model')")
    return dict(zip(names, (int(s) for s in mesh.shape)))


def _world_size() -> int:
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group is initialised: call torch.distributed."
            "init_process_group (or launch with torchrun, or through "
            "repro_torch.launch.mesh.spawn) before building a mesh")
    return dist.get_world_size()


def make_debug_mesh(n_data: int = 2, n_model: int = 2, *,
                    multi_pod: bool = False,
                    device_type: str = DEFAULT_DEVICE):
    """A small (data, model) mesh, (pod, data, model) with ``multi_pod``
    (two pods), over a world of exactly that many ranks."""
    shape = (2, n_data, n_model) if multi_pod else (n_data, n_model)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = _world_size()
    n = 1
    for s in shape:
        n *= s
    if n != world:
        raise ValueError(f"a {shape} mesh needs {n} ranks, the world has "
                         f"{world}")
    return _mesh(device_type, shape, names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = DEFAULT_DEVICE):
    """16 x 16 ``("data", "model")`` over a world of 256 ranks (one pod);
    2 x 16 x 16 ``("pod", "data", "model")`` over 512 with
    ``multi_pod`` (two pods)."""
    return make_debug_mesh(16, 16, multi_pod=multi_pod,
                           device_type=device_type)


@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0):
    """Within the block this process is rank ``rank`` of a world of
    ``world_size`` in the ``"fake"`` process group (its collectives
    accept any tensor, ``meta`` ones too, and do nothing); the group is
    destroyed on exit, on an error too.  The group is process-global:
    raises if one is initialised already."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is initialised already")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        gc.collect()
        dist.destroy_process_group()


def make_crossbar_mesh(n_model: int | None = None, *,
                       device_type: str = DEFAULT_DEVICE):
    """(data, model) mesh over every rank of the world for the sharded
    IMPACT crossbar (``sharding.crossbar``): ``n_model`` ranks hold the
    R / S row-shard slices (default: every rank), the rest form the data
    axis for batch sharding.  ``n_model`` must divide the world size."""
    world = _world_size()
    n_model = world if n_model is None else n_model
    if n_model < 1 or world % n_model:
        raise ValueError(f"n_model={n_model} does not divide the "
                         f"{world} ranks of the world")
    return _mesh(device_type, (world // n_model, n_model),
                 ("data", "model"))


def _mesh(device_type: str, shape: tuple[int, ...],
          names: tuple[str, ...]):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def _rank_main(rank: int, fn: Callable, world_size: int, init_method: str,
               args: tuple) -> None:
    dist.init_process_group(
        "gloo", init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        fn(rank, *args)
    finally:
        # Sessions and systems hold the mesh in reference cycles: free
        # them, and the process groups they keep alive, before the groups
        # are destroyed, not while the interpreter shuts down (where gloo's
        # threads can abort the process).
        gc.collect()
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable[..., Any], world_size: int, *args: Any,
          init_method: str) -> None:
    """Run ``fn(rank, *args)`` on ``world_size`` new processes, each rank
    in one ``gloo`` process group rendezvousing at ``init_method``
    (``"file:///path"`` that does not exist yet, or
    ``"tcp://localhost:<port>"``).  ``fn`` and ``args`` must pickle: a
    function at module level.  ``fn`` may destroy the group and join
    another; the group it holds at its end is destroyed.  Returns when
    every rank has returned, and raises if any rank raised or died (the
    others are then stopped)."""
    import torch.multiprocessing as mp
    mp.spawn(_rank_main, args=(fn, world_size, init_method, args),
             nprocs=world_size, join=True)
