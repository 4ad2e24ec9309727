"""Mesh construction over ``torch.distributed`` (``repro.launch.mesh``).

Functions, not module-level constants, so importing this module starts
no process group and touches no device.

Mesh axes, as the reference names them:
  single-pod:  (16, 16)      -> ('data', 'model')         = 256 devices
  multi-pod:   (2, 16, 16)   -> ('pod', 'data', 'model')  = 512 devices

'pod'   - data parallelism across pods (the DCN hop),
'data'  - data parallelism (and FSDP weight sharding) within a pod,
'model' - tensor / expert parallelism within a pod; the DB-search bank
          is row-sharded over it.

A mesh is a ``DeviceMesh`` over the default process group, which the
caller initializes (``torchrun`` and ``init_process_group``); these
functions start none. ``make_debug_mesh`` with no process group returns
the mapping ``{"data": 1, "model": 1}``, which
:func:`repro_torch.dist.sharding.mesh_shape` reads like a mesh and which
every route takes as "one device".
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def join_group(dev: torch.device) -> bool:
    """Joins the process group ``torchrun`` describes (``WORLD_SIZE`` > 1)
    unless one is initialized already; returns whether it started one.
    On CUDA each rank takes the card ``LOCAL_RANK`` modulo the cards
    present, and the backend is NCCL unless the node runs more ranks
    than it has cards (NCCL refuses two ranks on one card): then, as on
    the CPU, gloo. The launchers' shared entry to a mesh."""
    if (int(os.environ.get("WORLD_SIZE", "1")) <= 1
            or dist.is_initialized()):
        return False
    backend = "gloo"
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0"))
                              % cards)
        if int(os.environ.get("LOCAL_WORLD_SIZE", "1")) <= cards:
            backend = "nccl"
    dist.init_process_group(backend, init_method="env://")
    return True


def mesh_line(mesh) -> str:
    """The reference's ``mesh: {...} devices=N`` line of a mesh (a
    ``DeviceMesh`` or the one-device mapping)."""
    from repro_torch.dist.sharding import mesh_shape

    shape = mesh_shape(mesh)
    n = 1
    for size in shape.values():
        n *= size
    return f"mesh: {shape} devices={n}"


def _world_size() -> int | None:
    """The default process group's size, None when there is none."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    return dist.get_world_size()


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The production ``DeviceMesh``: (16, 16) over ('data', 'model'), or
    (2, 16, 16) over ('pod', 'data', 'model') with ``multi_pod``. Needs an
    initialized process group of exactly 256 (512) ranks and raises a
    ``ValueError`` otherwise, so on one card it always raises."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, names = PRODUCTION_SHAPES[bool(multi_pod)]
    need = 1
    for s in shape:
        need *= s
    world = _world_size()
    if world != need:
        have = ("no process group" if world is None
                else f"a process group of {world} rank(s)")
        raise ValueError(
            f"the {'multi' if multi_pod else 'single'}-pod production mesh "
            f"{dict(zip(names, shape))} needs {need} ranks; there is {have}")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def debug_mesh_shape(n: int) -> tuple[int, int]:
    """(data, model) of the debug mesh over ``n`` devices: ``model`` is
    the first of 4, 2, 1 that divides ``n`` (the reference's rule)."""
    if n < 1:
        raise ValueError(f"a mesh needs at least one device, got {n}")
    model = next(c for c in (4, 2, 1) if n % c == 0)
    return n // model, model


def make_debug_mesh(n_devices: int | None = None, device_type: str = "cuda"):
    """A small ('data', 'model') mesh over the default process group's
    ranks, factored by :func:`debug_mesh_shape`. With no process group it
    returns ``{"data": 1, "model": 1}`` (one device; no group is started),
    and ``n_devices`` other than 1 then raises. With a group,
    ``n_devices`` (default: its world size) must equal the world size."""
    world = _world_size()
    if world is None:
        if n_devices not in (None, 1):
            raise ValueError(f"a debug mesh over {n_devices} devices needs an "
                             f"initialized process group of as many ranks")
        return {"data": 1, "model": 1}
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"a debug mesh over {n} devices in a process group "
                         f"of {world} ranks")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, debug_mesh_shape(n),
                            mesh_dim_names=("data", "model"))
