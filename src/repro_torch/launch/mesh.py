"""Device meshes (the port of ``repro/launch/mesh.py``): a
:class:`torch.distributed.device_mesh.DeviceMesh` with named dims over the
ranks of the current process group.

The process group comes from the launch: under ``torchrun`` (or any
launcher that sets ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
``MASTER_PORT``) :func:`init_distributed` joins it on first use. The
backend is NCCL on the card and gloo only where the caller asks for the
CPU (``device="cpu"``). Functions, not module constants, so that importing
this module never touches a device or a process group.
"""
from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device


def init_distributed(device="cuda") -> None:
    """Join the launch's process group if this process has not: NCCL for
    the card (each rank on card ``LOCAL_RANK``), gloo for the CPU."""
    dev = resolve_device(device)
    if dist.is_initialized():
        return
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("nccl")
    else:
        dist.init_process_group("gloo")


def make_mesh(shape, axes, device="cuda"):
    """A mesh of ``shape`` with dims named ``axes`` over every rank of the
    process group (joined first if needed); the ranks must number
    ``prod(shape)``."""
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    # a launch without a launcher is one process
    n = (dist.get_world_size() if dist.is_initialized()
         else int(os.environ.get("WORLD_SIZE", "1")))
    if math.prod(shape) != n:
        raise ValueError(f"mesh {tuple(shape)} needs {math.prod(shape)} "
                         f"ranks; the launch has {n}")
    init_distributed(dev)
    return init_device_mesh(dev.type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """16×16 = 256 ranks per pod; multi-pod adds a leading pod axis
    (2×16×16 = 512). Raises with the world size found when the launch has
    another."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def parse_mesh(spec: str):
    """``"2x2"`` → ((2, 2), ("data", "model")); ``"4"`` → ((4,),
    ("data",)); three dims name ("pod", "data", "model")."""
    shape = tuple(int(p) for p in spec.lower().split("x"))
    names = {1: ("data",), 2: ("data", "model"),
             3: ("pod", "data", "model")}
    if len(shape) not in names or min(shape) < 1:
        raise ValueError(f"mesh {spec!r}: one to three positive dims")
    return shape, names[len(shape)]


__all__ = ["init_distributed", "make_mesh", "make_production_mesh",
           "parse_mesh"]
