"""Meshes of ranks: the port's counterpart of ``repro.launch.mesh``.

A mesh is a ``torch.distributed`` ``DeviceMesh`` with the JAX package's
dim names ("data", "model", and "pod" across pods), built over a process
group that the caller has initialised with the mesh's world size.  Nothing
tells a program of a cluster here, so the caller gives
``init_process_group`` its address, its world size and its rank.

* :func:`make_mesh` builds the mesh of a ``MeshConfig`` on the ranks'
  cards (NCCL) or on the CPU (gloo); ``backend="gloo"`` puts ranks that
  share one card on gloo, since NCCL refuses two ranks on one device.
* :func:`make_production_mesh` is the dry run's mesh of the JAX package's
  256 or 512 devices, over a fake process group in one process: the
  step is traced on meta tensors, and no collective runs.
* :func:`make_test_mesh` is the 1 x 1 mesh over one rank.
"""
from __future__ import annotations

import contextlib
from typing import Optional

from repro_torch.core.config import MULTI_POD, SINGLE_POD, TINY_MESH, MeshConfig

DEFAULT_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def mesh_config(multi_pod: bool = False) -> MeshConfig:
    return MULTI_POD if multi_pod else SINGLE_POD


def parse_mesh(text: str) -> MeshConfig:
    """``"DxM"`` (data x model) or ``"PxDxM"`` as a ``MeshConfig``."""
    shape = tuple(int(s) for s in text.lower().split("x"))
    axes = {2: ("data", "model"), 3: ("pod", "data", "model")}.get(len(shape))
    if axes is None or min(shape) < 1:
        raise ValueError(f"mesh {text!r}: expected DxM or PxDxM")
    return MeshConfig(shape, axes)


def make_mesh(mesh_cfg: MeshConfig, device: str = "cuda",
              backend: Optional[str] = None):
    """The ``DeviceMesh`` of ``mesh_cfg`` over the initialised default
    process group, whose backend must be ``backend`` (default: NCCL on
    ``cuda``, gloo on ``cpu``) and whose world size must be the mesh's
    device count; raises where either differs."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh: initialise the process group first "
                           "(init_process_group with its address, world "
                           "size and rank)")
    want = backend or DEFAULT_BACKEND[device]
    have = dist.get_backend()
    if have != want:
        raise ValueError(f"make_mesh: the process group runs {have}, the "
                         f"mesh on {device} asks for {want}")
    world = dist.get_world_size()
    if world != mesh_cfg.num_devices:
        raise ValueError(f"make_mesh: a world of {world} ranks for the "
                         f"mesh {mesh_cfg.shape} of {mesh_cfg.num_devices}")
    return init_device_mesh(device, tuple(mesh_cfg.shape),
                            mesh_dim_names=tuple(mesh_cfg.axes))


@contextlib.contextmanager
def fake_group(world_size: int):
    """A fake process group of ``world_size`` ranks in this process (rank
    0), destroyed on exit: the dry run's mesh lives inside it."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_group: a process group already exists")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False,
                         mesh_cfg: Optional[MeshConfig] = None):
    """The dry run's mesh (rank 0's view) of the JAX package's 16 x 16
    single pod, its 2 x 16 x 16 pods, or ``mesh_cfg``, inside a
    :func:`fake_group` of its device count."""
    from torch.distributed.device_mesh import init_device_mesh

    cfg = mesh_cfg or mesh_config(multi_pod)
    return init_device_mesh("cpu", tuple(cfg.shape),
                            mesh_dim_names=tuple(cfg.axes))


def make_test_mesh(device: str = "cpu"):
    """The 1 x 1 mesh over the one rank of an initialised group of one, so
    that the same sharded code paths run unmodified."""
    return make_mesh(TINY_MESH, device)
