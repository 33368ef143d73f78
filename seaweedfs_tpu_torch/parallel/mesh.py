"""One home for device-mesh construction and axis naming.

Port of seaweedfs_tpu/parallel/mesh.py.  Both halves of the system place
work on the same devices:

  * the bulk plane (parallel/distributed.py) runs encode/rebuild over a
    (shard, batch) mesh: each lane runs K1 over its column block, and the
    partials fold over the "shard" axis;
  * the serving plane (ops/rs_resident.py) lane-shards resident EC volumes
    across a 1-D ("shard",) mesh and runs a batch's reconstruct as one
    launch of the fused kernel on every lane.

A `Mesh` is an ordered list of torch devices with axis names and a shape,
plus the process (rank) that owns each lane.  `make_mesh` is the 2-D
bulk constructor, `serving_mesh` the cached 1-D serving constructor.
`global_serving_mesh` spans every process of a torch.distributed group
(joined through `initialize_distributed`; without one it is the local
mesh), with the lanes in canonical (rank, local index) order so every
process numbers them alike.  A mesh that would be one lane wide is None
(`_serving_mesh_or_none`): one lane only adds dispatch overhead over the
plain one-device path.

What differs from the JAX package: JAX's single-controller mode sees
every local device in one program, and its multi-controller mode spans
processes; here a process drives its local devices directly, and the
processes of a pod meet only in torch.distributed collectives, whose
backend is named by the caller (NCCL for CUDA devices, gloo for CPU
ranks) and never picked silently.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

SHARD_AXIS = "shard"
BATCH_AXIS = "batch"


class PodDevice(NamedTuple):
    """One lane of a mesh that spans processes: the owning rank and the
    device as that rank names it."""

    process_index: int
    device: torch.device


class Mesh:
    """An ordered list of devices laid out as `shape` over `axis_names`
    (row-major: lane (s, b) of a (shard, batch) mesh is
    devices[s * n_batch + b]), with the rank that owns each lane."""

    def __init__(self, devices, axis_names: tuple[str, ...],
                 shape: tuple[int, ...] | None = None):
        devs, procs = [], []
        for d in devices:
            if isinstance(d, PodDevice):
                procs.append(d.process_index)
                devs.append(torch.device(d.device))
            else:
                procs.append(0)
                devs.append(torch.device(d))
        self.devices: list[torch.device] = devs
        self.processes: list[int] = procs
        self.axis_names = tuple(axis_names)
        self.dims = tuple(shape) if shape is not None else (len(devs),)
        n = 1
        for d in self.dims:
            n *= d
        if n != len(devs) or len(self.dims) != len(self.axis_names):
            raise ValueError(
                f"{len(devs)} devices do not form a {self.dims} mesh over "
                f"{self.axis_names}")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict[str, int]:
        """axis name -> lanes along it (jax's Mesh.shape)."""
        return dict(zip(self.axis_names, self.dims))

    def lane(self, *index: int) -> int:
        """Flat lane number of a mesh coordinate."""
        flat = 0
        for i, n in zip(index, self.dims):
            flat = flat * n + i
        return flat

    def local_lanes(self, rank: int | None = None) -> list[int]:
        """The lanes owned by `rank` (default: this process)."""
        rank = process_index() if rank is None else rank
        return [i for i, p in enumerate(self.processes) if p == rank]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices={[str(d) for d in self.devices]}"
                f", processes={self.processes})")


def make_mesh(n_shard: int = 1, n_batch: int | None = None, devices=None):
    """(n_shard, n_batch) mesh with axes ("shard", "batch"): the bulk
    constructor (partials fold over "shard", "batch" is data-parallel).
    `devices` (default: every process's, `global_devices`) may repeat a
    device: two lanes on one card are a valid mesh."""
    devices = list(devices) if devices is not None else global_devices()
    if n_batch is None:
        n_batch = len(devices) // n_shard
    if n_shard < 1 or n_batch < 1 or n_shard * n_batch > len(devices):
        raise ValueError(
            f"a ({n_shard}, {n_batch}) mesh needs {n_shard * n_batch} "
            f"devices, {len(devices)} given")
    return Mesh(devices[: n_shard * n_batch], (SHARD_AXIS, BATCH_AXIS),
                (n_shard, n_batch))


def _dist():
    """torch.distributed when a process group is up, else None."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist
    return None


def process_index() -> int:
    """This process's rank in the pod (0 without a process group)."""
    dist = _dist()
    return dist.get_rank() if dist is not None else 0


def local_devices(device_type: str = "cuda") -> list[torch.device]:
    """This process's devices of `device_type`: every visible card, or
    the one CPU."""
    if device_type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if device_type == "cpu":
        return [torch.device("cpu")]
    raise ValueError(f"no mesh of {device_type} devices")


def global_devices(device_type: str = "cuda") -> list[PodDevice]:
    """Every process's devices in canonical pod order, sorted by (rank,
    local index), so every process numbers the lanes alike.  In a pod
    this is a collective (every rank must call it)."""
    mine = [str(d) for d in local_devices(device_type)]
    dist = _dist()
    if dist is None:
        return [PodDevice(0, torch.device(d)) for d in mine]
    everyone: list = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, mine)
    return [PodDevice(rank, torch.device(d))
            for rank, devs in enumerate(everyone) for d in devs]


def device_host(dev) -> int:
    """Failure-domain id of a mesh lane: the owning process index (one
    volume-server process per host in a pod)."""
    return int(getattr(dev, "process_index", 0))


def mesh_hosts(mesh) -> tuple[int, ...]:
    """Sorted distinct host (process) ids a mesh spans."""
    if mesh is None:
        return ()
    return tuple(sorted(set(mesh.processes)))


def _serving_mesh_or_none(devs):
    """The one width-1 degrade rule both serving-mesh constructors share:
    fewer than 2 lanes serve un-meshed (None)."""
    devs = list(devs)
    if len(devs) < 2:
        return None
    return Mesh(devs, (SHARD_AXIS,))


@functools.lru_cache(maxsize=8)
def serving_mesh(n_devices: int = 0, device_type: str = "cuda"):
    """Cached 1-D ("shard",) mesh over the first `n_devices` local devices
    (0 = all), so every call site shares one Mesh object; None when it
    would be one device wide."""
    devs = local_devices(device_type)
    if n_devices > 0:
        devs = devs[:n_devices]
    return _serving_mesh_or_none(devs)


@functools.lru_cache(maxsize=8)
def global_serving_mesh(n_devices: int = 0, device_type: str = "cuda"):
    """Cached 1-D serving mesh over every process's devices in canonical
    pod order, with serving_mesh's width-1 degrade.  In one process it is
    the mesh serving_mesh picks; in a pod every process must build it
    alike (it is a collective)."""
    devs = global_devices(device_type)
    if n_devices > 0:
        devs = devs[:n_devices]
    return _serving_mesh_or_none(devs)


def backend_for(ec_backend: str) -> str:
    """The collective backend of a pod whose EC backend is `ec_backend`:
    NCCL for the card, gloo for the CPU ranks of the plain versions."""
    backends = {"cuda": "nccl", "torch": "gloo"}
    if ec_backend not in backends:
        raise ValueError(f"no pod mesh for -ec.backend {ec_backend}")
    return backends[ec_backend]


def initialize_distributed(coordinator: str, process_id: int,
                           n_processes: int, backend: str = "nccl") -> bool:
    """Join the pod: torch.distributed.init_process_group at
    tcp://`coordinator` as rank `process_id` of `n_processes`, on
    `backend` ("nccl" or "gloo").  No-op (False) below 2 processes.  A
    failed rendezvous raises; nothing falls back to one process."""
    if n_processes <= 1:
        return False
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown collective backend {backend!r}")
    torch.distributed.init_process_group(
        backend=backend, init_method=f"tcp://{coordinator}",
        world_size=n_processes, rank=process_id,
    )
    return True
