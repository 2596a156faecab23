"""Device meshes over ``torch.distributed`` (counterpart of
``chowdsp_fft_tpu/parallel/mesh.py``).

A JAX ``Mesh`` is a named array of devices inside one program; here a
mesh is a :class:`~torch.distributed.device_mesh.DeviceMesh` over the
ranks of a process group, one device a rank, its dimensions named with
the JAX package's axis names. The JAX sharding vocabulary maps as:

| JAX | torch |
|---|---|
| ``Mesh`` | ``DeviceMesh`` (``mesh_dim_names`` = axis names) |
| ``PartitionSpec`` (``P``) entry naming an axis | ``Shard(dim)`` on that mesh dimension |
| ``PartitionSpec`` entry ``None`` | ``Replicate()`` |
| ``NamedSharding(mesh, P(...))`` | a ``DTensor``'s ``(device_mesh, placements)`` |
| a global ``jax.Array`` | a ``DTensor``; its ``to_local()`` is one rank's shard |

The process group comes first: :func:`init_multihost` joins a launched
multi-process run (torchrun's environment), :func:`init_local_group`
makes a group of one rank in this process (a single card, or the CPU).
A mesh's device type is the card's unless the caller asks for ``"cpu"``
(a gloo group); the sharded entries refuse a tensor on another device
type than their mesh's.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

__all__ = [
    "CHANNEL_AXIS",
    "TIME_AXIS",
    "HOST_AXIS",
    "DeviceMesh",
    "DTensor",
    "Shard",
    "Replicate",
    "dsp_mesh",
    "channel_time_mesh",
    "init_multihost",
    "init_local_group",
    "multihost_mesh",
    "host_major_ranks",
]

CHANNEL_AXIS = "chan"
TIME_AXIS = "time"
HOST_AXIS = "host"


def _world_size() -> int:
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: call init_multihost() in a launched multi-process run, "
            "or init_local_group() for one rank in this process"
        )
    return dist.get_world_size()


def dsp_mesh(n_devices: int | None = None, axis: str = TIME_AXIS, device_type: str = "cuda") -> DeviceMesh:
    """1-D mesh over the first ``n_devices`` ranks of the process group
    (default: all of them), one device a rank. Raises if the group has
    fewer ranks: a smaller mesh would leave the caller believing the work
    is split ``n_devices`` ways. Ranks outside the mesh hold no coordinate
    in it, and the sharded entries refuse to run there."""
    world = _world_size()
    n = n_devices or world
    if world < n:
        raise ValueError(f"need {n} devices, have {world}")
    return init_device_mesh(device_type, (n,), mesh_dim_names=(axis,))


def channel_time_mesh(channel_parallel: int, time_parallel: int, device_type: str = "cuda") -> DeviceMesh:
    """2-D (chan, time) mesh: channels data-parallel across one dimension,
    stream time blocks sequence-parallel across the other."""
    world = _world_size()
    need = channel_parallel * time_parallel
    if world < need:
        raise ValueError(f"need {need} devices, have {world}")
    return init_device_mesh(device_type, (channel_parallel, time_parallel),
                            mesh_dim_names=(CHANNEL_AXIS, TIME_AXIS))


def init_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
    **kwargs,
) -> None:
    """Join this process to a multi-process run (``init_process_group``).

    Under torchrun the arguments come from its environment (``WORLD_SIZE``,
    ``RANK``, ``MASTER_ADDR``/``MASTER_PORT``, ``LOCAL_RANK``) and the call
    collapses to ``init_multihost()``; ``coordinator_address`` ("host:port")
    replaces the environment's rendezvous. The backend is NCCL where a card
    is present, gloo otherwise. Idempotent: with a group already up it
    returns, unless ``num_processes`` asks for another size, which raises.
    A single process (``num_processes`` 1 or unset, no ``WORLD_SIZE``) needs
    no group and returns (use :func:`init_local_group` to build a mesh of
    one). A run that declares more than one process and cannot say which
    rank this one is raises.
    """
    if dist.is_initialized():
        world = dist.get_world_size()
        if num_processes not in (None, world):
            raise RuntimeError(
                f"a process group of {world} ranks is already up; num_processes={num_processes} cannot be met"
            )
        return
    env = os.environ
    num = num_processes if num_processes is not None else int(env.get("WORLD_SIZE", "1"))
    if num == 1:
        return
    rank = process_id if process_id is not None else env.get("RANK")
    if rank is None:
        raise ValueError(f"num_processes={num} needs this process's rank (process_id, or RANK in the environment)")
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl" and "LOCAL_RANK" in env:
        kwargs.setdefault("device_id", torch.device("cuda", int(env["LOCAL_RANK"])))
    init_method = f"tcp://{coordinator_address}" if coordinator_address else "env://"
    dist.init_process_group(backend, init_method=init_method, world_size=num, rank=int(rank), **kwargs)


def init_local_group(device_type: str = "cuda") -> None:
    """A process group of one rank in this process: NCCL on card 0 for
    ``"cuda"``, gloo for ``"cpu"``, rendezvous in memory (``HashStore``).
    Its collectives are copies; a mesh of one device is built on it.
    Raises if a group is already up."""
    if dist.is_initialized():
        raise RuntimeError("a process group is already up")
    store = dist.HashStore()
    if device_type == "cuda":
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", store=store, rank=0, world_size=1, device_id=torch.device("cuda", 0))
    else:
        dist.init_process_group("gloo", store=store, rank=0, world_size=1)


def host_major_ranks(devices: list[tuple[int, int]], time_parallel: int | None = None) -> np.ndarray:
    """The (rows, time_parallel) rank layout of :func:`multihost_mesh`
    from ``(host, rank)`` pairs: ranks grouped by host in host order, so
    with ``time_parallel`` equal to the chips per host (the default) each
    row is one host. Raises on uneven chips per host."""
    by_host: dict[int, list[int]] = {}
    for host, rank in devices:
        by_host.setdefault(host, []).append(rank)
    hosts = sorted(by_host)
    per_host = len(by_host[hosts[0]])
    if any(len(by_host[h]) != per_host for h in hosts):
        raise ValueError(f"uneven chips per host: {[len(by_host[h]) for h in hosts]}")
    tp = time_parallel or per_host
    if (per_host * len(hosts)) % tp:
        raise ValueError(f"time_parallel={tp} does not divide {per_host * len(hosts)} devices")
    ordered = [r for h in hosts for r in by_host[h]]
    return np.asarray(ordered, dtype=np.int64).reshape(-1, tp)


def multihost_mesh(
    time_parallel: int | None = None,
    axis: str = TIME_AXIS,
    devices: list[tuple[int, int]] | None = None,
    device_type: str = "cuda",
) -> DeviceMesh:
    """A (host, time) mesh over the whole group, host-major: collectives
    along ``axis`` stay within a host (NVLink) and only the host dimension
    crosses the network. ``time_parallel`` defaults to the chips per host.
    ``devices`` lists ``(host, rank)`` pairs in place of the group's own
    (rank r on host r // LOCAL_WORLD_SIZE under torchrun, all on one host
    without it), to test a layout no launcher here provides."""
    world = _world_size()
    if devices is None:
        per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        devices = [(r // per_host, r) for r in range(world)]
    layout = host_major_ranks(devices, time_parallel)
    return DeviceMesh(device_type, torch.from_numpy(layout), mesh_dim_names=(HOST_AXIS, axis))


# ---------------------------------------------------------------------------
# Shards in and out: what shard_map's in_specs/out_specs do in the JAX package
# ---------------------------------------------------------------------------


def axis_group(mesh: DeviceMesh, axis_name: str) -> tuple[dist.ProcessGroup, int, int]:
    """(process group, size, this rank's index) of the mesh dimension
    ``axis_name``. Raises if the mesh has no such dimension or this rank
    is not in the mesh."""
    names = mesh.mesh_dim_names or ()
    if axis_name not in names:
        raise ValueError(f"mesh has no axis {axis_name!r} (axes {names})")
    if mesh.get_coordinate() is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh")
    return mesh.get_group(axis_name), mesh.size(names.index(axis_name)), mesh.get_local_rank(axis_name)


def require_mesh_device(t: torch.Tensor, mesh: DeviceMesh) -> None:
    """A tensor must lie on its mesh's device type: nothing is moved
    between the CPU and the card behind the caller's back."""
    if t.device.type != mesh.device_type:
        raise ValueError(f"tensor on {t.device.type}, mesh on {mesh.device_type}: move it first")


class _SumGradOverAxis(torch.autograd.Function):
    """Identity forward; backward sums the gradient over the axis group.
    A tensor every rank holds whole (a filter, an undistributed stream) is
    replicated: each rank's work reads a different part, so its gradient
    is the sum of the ranks' (the transpose of JAX's replicated in_spec)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _positive(dim: int, ndim: int) -> int:
    return dim % ndim


def _placements(mesh: DeviceMesh, axis_name: str, dim: int) -> list:
    return [Shard(dim) if name == axis_name else Replicate() for name in mesh.mesh_dim_names]


def replicated(t, mesh: DeviceMesh, axis_name: str) -> torch.Tensor:
    """The whole tensor on this rank, from a replicated ``DTensor`` or a
    plain tensor every rank holds; its gradient sums over ``axis_name``."""
    if isinstance(t, DTensor):
        if t.device_mesh != mesh:
            raise ValueError("the DTensor lies on another mesh")
        t = t.redistribute(mesh, [Replicate()] * mesh.ndim)
        return t.to_local(grad_placements=[Partial() if name == axis_name else Replicate()
                                           for name in mesh.mesh_dim_names])
    t = torch.as_tensor(t)
    require_mesh_device(t, mesh)
    if torch.is_grad_enabled() and t.requires_grad:
        t = _SumGradOverAxis.apply(t, axis_group(mesh, axis_name)[0])
    return t


def local_shard(x, mesh: DeviceMesh, axis_name: str, dim: int = -1) -> torch.Tensor:
    """This rank's shard of ``x`` along ``dim``, split over ``axis_name``:
    from a ``DTensor`` on ``mesh`` (redistributed to that placement if it
    has another), or from a plain tensor every rank holds whole (its
    gradient then sums over the axis). The length along ``dim`` must
    divide by the axis size."""
    _, size, index = axis_group(mesh, axis_name)
    if isinstance(x, DTensor):
        if x.device_mesh != mesh:
            raise ValueError("the DTensor lies on another mesh")
        want = _placements(mesh, axis_name, _positive(dim, x.ndim))
        if list(x.placements) != want:
            x = x.redistribute(mesh, want)
        return x.to_local()
    x = replicated(x, mesh, axis_name)
    dim = _positive(dim, x.ndim)
    if x.shape[dim] % size:
        raise ValueError(f"length {x.shape[dim]} along dim {dim} does not divide over {size} devices")
    step = x.shape[dim] // size
    return x.narrow(dim, index * step, step)


def sharded(local: torch.Tensor, mesh: DeviceMesh, axis_name: str, dim: int = -1) -> DTensor:
    """The ``DTensor`` whose shard along ``dim`` over ``axis_name`` is
    ``local`` on this rank (replicated over the mesh's other axes)."""
    return DTensor.from_local(local, mesh, _placements(mesh, axis_name, _positive(dim, local.ndim)),
                              run_check=False)
