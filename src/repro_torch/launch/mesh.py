"""Mesh builders — the port of `repro.launch.mesh` onto
`torch.distributed.device_mesh`.

Each builder is a function (not module state), so importing this module
touches no process group.  A mesh spans ranks of the default process
group, one device each, and building one is collective (every rank of
the world calls the same builder), `single_device_mesh` excepted.  Device type: "cuda" by default, "cpu"
when asked.

Mesh axes:
  pod    crosses the data-centre network; only DP gradient reductions
         ride it.
  data   data parallel / ZeRO-1 / sequence parallel.
  model  tensor / expert parallel.
"""

from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.distributed.sharding import axis_sizes


def _init_mesh(device_type: str, shape: Tuple[int, ...], axes: Tuple[str, ...]):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _init_mesh(device_type, shape, axes)


def make_mesh(shape: Tuple[int, ...], axes: Optional[Tuple[str, ...]] = None,
              device_type: str = "cuda"):
    """A mesh of `shape` over the whole world (e.g. (2, 2) on 4 ranks)."""
    if axes is None:
        axes = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    return _init_mesh(device_type, shape, axes)


def _ensure_process_group(device_type: str) -> None:
    """A world of one (gloo on the CPU, nccl on the card, over an in-memory
    store) where no default process group is up; an existing group is
    used as it is and never torn down here."""
    import torch.distributed as dist

    if not dist.is_initialized():
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)


def single_device_mesh(device_type: str = "cuda"):
    """A (1, 1) data x model mesh holding this rank's device alone; works
    in a bare process (see `_ensure_process_group`).  Not collective: in a
    world of more ranks it builds no subgroup, as a mesh of one device
    communicates with no other."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    _ensure_process_group(device_type)
    return DeviceMesh(device_type, torch.tensor([[dist.get_rank()]]),
                      mesh_dim_names=("data", "model"),
                      _init_backend=dist.get_world_size() == 1)


def tp_mesh(tp: int, device_type: str = "cuda"):
    """A (1, tp) data x model serving mesh over the FIRST `tp` ranks of the
    world: a subset, as the reference's device subset, so tp = 1 / 2 / 4
    meshes can stand side by side in one world.  `mesh.get_group("model")`
    is the model axis' process group, the one the tensor-parallel
    collectives run on (`distributed.collectives`)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    if tp > world:
        raise ValueError(
            f"tp={tp} needs {tp} devices but the process has {world}; "
            "start a world of at least that many ranks (torch.distributed)")
    _ensure_process_group(device_type)
    return DeviceMesh(device_type, torch.arange(tp).reshape(1, tp),
                      mesh_dim_names=("data", "model"))


def init_file_world(path: str, rank: int, world: int, backend: str = "gloo") -> None:
    """Start this process's default process group: rank `rank` of `world`,
    rendezvous through the file `path` (`torch.distributed.FileStore`; no
    port, so worlds started side by side cannot collide).  Every rank
    passes the same path; the file must not exist before the first."""
    import torch.distributed as dist

    dist.init_process_group(backend, store=dist.FileStore(path, world),
                            rank=rank, world_size=world)


def mesh_axis_size(mesh, name: str) -> int:
    """The size of axis `name` (1 where the mesh lacks it) of a DeviceMesh,
    or of anything with the reference's `shape` mapping."""
    return axis_sizes(mesh).get(name, 1)
