"""Production and debug device meshes (port of ``repro.launch.mesh``).

Defined as functions, so importing this module touches no process group.
A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the default
process group, with the reference's axis names:

    pod    — inter-pod DP / pipeline stages
    data   — DP + FSDP
    model  — TP / EP / SP

The production meshes keep the reference's chip counts (256 and 512) on
H100s: ``(data, model) = (32, 8)`` and ``(pod, data, model) = (2, 32, 8)``,
a pod being 32 nodes of 8 GPUs.  The ``model`` axis is one 8-GPU node,
whose GPUs are joined all to all by NVLink.  The reference's 16-wide ``model`` axis is a TPU v5e pod's
inter-chip torus; on H100s a 16-wide tensor-parallel group would cross the
network between nodes on every layer.  ``data`` and ``pod`` cross it.

A shape-only dry-run builds these meshes in one process over the fake
backend (:func:`fake_world`): no GPU, no peer, and collectives that move
nothing.
"""

from __future__ import annotations

import math
from typing import Optional

PRODUCTION_SHAPES = {
    False: ((32, 8), ("data", "model")),
    True: ((2, 32, 8), ("pod", "data", "model")),
}


def _device_type() -> str:
    import torch.distributed as dist

    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False, device_type: Optional[str] = None):
    """H100 meshes: 32 x 8 = 256 GPUs (32 nodes of 8); 2 x 32 x 8 = 512.

    Axes: ``pod`` (inter-pod DP / pipeline), ``data`` (DP+FSDP), ``model``
    (TP/EP/SP, within a node)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = PRODUCTION_SHAPES[multi_pod]
    return init_device_mesh(device_type or _device_type(), shape, mesh_dim_names=axes)


def make_debug_mesh(n_data: int = 1, n_model: int = 1, device_type: Optional[str] = None):
    """A ``(data, model)`` mesh over the current world (tests, one card)."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type or _device_type(), (n_data, n_model),
                            mesh_dim_names=("data", "model"))


def mesh_chip_count(mesh) -> int:
    return math.prod(mesh.shape)


def fake_world(n: int) -> None:
    """Initialise the default process group on the fake backend with ``n``
    ranks (this process is rank 0): every collective returns at once and
    moves nothing, so a production mesh can be built and a step traced in
    one process.  The group is process-global: a dry-run runs in a process
    of its own."""
    import torch.distributed as dist

    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == n:
            return
        raise RuntimeError(f"a process group is already initialised "
                           f"({dist.get_backend()}, {dist.get_world_size()} ranks)")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), world_size=n, rank=0)
