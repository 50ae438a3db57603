"""Device meshes — the port of ``repro.launch.mesh``.

Functions, not module-level constants, so importing starts no process group.
The production meshes are the reference's: one pod of 16×16 = 256 ranks
``("data", "model")``, or two pods, 2×16×16 = 512 ranks ``("pod", "data",
"model")``, the pod axis an outer data-parallel axis. They are
``torch.distributed.device_mesh.DeviceMesh``es over the current process
group, which must span that many ranks: on real cards one process per card,
or, for the dry run, the ``fake`` backend of ``start_fake_group``, where one
CPU process stands in for every rank (the reference forces 512 host devices
with an ``XLA_FLAGS`` line instead).

``start_group`` is the one place that starts a real group: a ``FileStore``
under a directory the caller names (no network), NCCL on the card, gloo on
the CPU.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["start_group", "start_fake_group", "make_production_mesh", "make_host_mesh",
           "data_axes"]


def start_group(store_dir: str, *, rank: int = 0, world_size: int = 1,
                device: "str | torch.device" = "cuda") -> None:
    """Join the default process group through a ``FileStore`` in
    ``store_dir`` (every rank names the same directory): NCCL for
    ``device="cuda"`` (rank r on card r), gloo for ``"cpu"``."""
    dev = torch.device(device)
    os.makedirs(store_dir, exist_ok=True)
    store = dist.FileStore(os.path.join(store_dir, "pg_store"), world_size)
    if dev.type == "cuda":
        torch.cuda.set_device(rank)
        dist.init_process_group("nccl", store=store, rank=rank, world_size=world_size,
                                device_id=torch.device("cuda", rank))
    else:
        dist.init_process_group("gloo", store=store, rank=rank, world_size=world_size)


def start_fake_group(world_size: int) -> None:
    """A ``fake`` process group of ``world_size`` ranks in this one process:
    collectives return at once and move no data. Only the dry run uses it."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(model_axis: int = 1, *, device_type: str = "cuda") -> DeviceMesh:
    """A ``("data", "model")`` mesh over every rank of the current group."""
    n = dist.get_world_size()
    model_axis = min(model_axis, n)
    return init_device_mesh(device_type, (n // model_axis, model_axis),
                            mesh_dim_names=("data", "model"))


def data_axes(mesh: DeviceMesh) -> tuple[str, ...]:
    """The (pure) data-parallel axes of a mesh: everything except "model"."""
    return tuple(a for a in mesh.mesh_dim_names if a != "model")
