"""Device meshes and the process group of the port.

Port of ``muchsalsa_tpu/parallel/mesh.py``.  A ``Mesh`` is the ordered
devices that the sharded steps (``parallel/sharded.py``) cut a leading axis
over, one contiguous range each, as ``shard_map`` cuts ``P(axis)``.  A
device may appear more than once: N shards on one card (or on the CPU) run
the same code path as N cards.

``visible_devices`` is the one place where the port lists cards: the cards
this process sees (``CUDA_VISIBLE_DEVICES`` decides which), the counterpart
of ``jax.local_devices()``.  Across processes only pickled host records
cross (``pipeline/scrubber.py::torch_record_allgather``), so the process
group is gloo whatever the cards.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch

from muchsalsa_tpu_torch.device import resolve_device


@dataclass(frozen=True)
class Mesh:
    """Devices in shard order along one named axis."""

    devices: tuple[torch.device, ...]
    axis: str = "reads"

    @property
    def size(self) -> int:
        return len(self.devices)


def visible_devices() -> list[torch.device]:
    """Every card this process sees: ``cuda:0`` to ``cuda:{count - 1}``."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: int | None = None, axis: str = "reads", devices=None) -> Mesh:
    """A mesh over ``devices`` (default: ``visible_devices()``), cut to its
    first ``n_devices``.  Raises where there is no card and no ``devices``
    were given, as ``resolve_device("cuda")`` does."""
    if devices is None:
        devices = visible_devices()
        if not devices:
            resolve_device("cuda")  # raises: no card
    devices = [resolve_device(d) for d in devices][:n_devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return Mesh(tuple(devices), axis)


def local_mesh(device: torch.device, axis: str = "reads") -> Mesh | None:
    """The mesh over this process's visible devices of ``device``'s type, or
    None where there are fewer than two: the mesh the core's driver and the
    device mapper take whenever more than one device is attached."""
    devices = [d for d in visible_devices() if d.type == device.type]
    return make_mesh(axis=axis, devices=devices) if len(devices) > 1 else None


def init_distributed(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Join the gloo process group at ``tcp://{coordinator}`` (``host:port``;
    default ``MS_TPU_COORDINATOR``) as rank ``process_id`` of
    ``num_processes``.  No-op for a single process, and where the group is
    already initialised."""
    import torch.distributed as dist

    coordinator = coordinator or os.environ.get("MS_TPU_COORDINATOR")
    if coordinator is None and num_processes is None:
        return  # single process
    if num_processes == 1 or dist.is_initialized():
        return
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError(
            "a process group needs the coordinator, the number of processes and this "
            f"process's id: got {coordinator!r}, {num_processes!r}, {process_id!r}")
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


def process_count() -> int:
    """Processes in the group (1 without one)."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank in the group (0 without one)."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
