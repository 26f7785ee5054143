"""Production mesh construction (``repro.launch.mesh``'s counterpart).

The reference lays its meshes over TPU v5e chips: 16 x 16 = 256 a pod, 2
pods = 512, placeholder devices in one process for its dry run.  The
port's production meshes are ``DeviceMesh`` objects of the same shapes
and axis names over torch's FAKE process group (``backend="fake"``): this
process is rank 0 of 256 or 512, and a collective returns at once, moving
nothing.  That is the counterpart of XLA's placeholder devices: the dry
run (`repro_torch.launch.dryrun`) traces a step over it with fake tensors,
and rank 0's shard of a step can run for real on one card.

The hardware constants are the NVIDIA H100 SXM5 data sheet's.  A mesh of
256 cards spans 32 nodes of 8, so most of its links are InfiniBand, not
NVLink: the collective term, priced at NVLink 4's rate, is a lower bound.

Functions only: importing this module starts no process group.
"""

from __future__ import annotations

import math

import torch

from repro_torch import resolve_device

# H100 SXM5 data sheet
PEAK_FLOPS_BF16 = 989e12  # dense BF16 tensor-core FLOP/s per card (1,979e12 with sparsity)
HBM_BW = 3.35e12  # HBM3 bytes/s per card
NVLINK_BW = 25e9  # bytes/s per NVLink 4 link, each direction (900 GB/s over 18 links, both ways)
NVLINK_LINKS = 18  # NVLink 4 links per card
CHIPS_PER_POD = 256
#: the fake world's ranks: both production meshes lie in one world (a world
#: torn down and built again leaves DTensor holding its old groups' names)
FAKE_WORLD = 2 * CHIPS_PER_POD


def _world(backend: str, n: int) -> None:
    """A process group of ``n`` ranks with this process as rank 0: the fake
    backend's for a fake mesh (a fake world of more ranks serves), else a
    real one of one rank."""
    import torch.distributed as dist

    if dist.is_initialized():
        if dist.get_backend() == backend and (dist.get_world_size() == n or backend == "fake"
                                              and dist.get_world_size() >= n):
            return
        dist.destroy_process_group()
    if backend == "fake":
        from torch.testing._internal.distributed.fake_pg import FakeStore

        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=n)


def make_fake_mesh(shape: tuple, axes: tuple, device=None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the first
    prod(shape) ranks of the fake process group, this process rank 0, on
    ``cuda`` unless ``device`` says otherwise.  The fake world has
    `FAKE_WORLD` ranks (more if the mesh needs them), so the 16 x 16 mesh
    takes the first 256 ranks of the 2 x 16 x 16 one's world and every
    mesh of a dry run shares one world."""
    from torch.distributed.device_mesh import DeviceMesh

    dev = resolve_device(device)
    n = math.prod(shape)
    _world("fake", max(n, FAKE_WORLD))
    return DeviceMesh(dev.type, torch.arange(n).reshape(tuple(shape)), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data",
    "model"), over the fake process group: 256 or 512 ranks."""
    if multi_pod:
        return make_fake_mesh((2, 16, 16), ("pod", "data", "model"), device)
    return make_fake_mesh((16, 16), ("data", "model"), device)


def make_host_mesh(model: int = 1, device=None):
    """A (data, model) mesh over the devices this process drives: one, on
    ``cuda`` (NCCL) unless ``device`` says otherwise (gloo on the CPU), so
    (1, 1) with ``model=1``.  A fake production world is replaced."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    n = 1
    if n % model:
        raise ValueError(f"model = {model} does not divide the {n} devices")
    _world("nccl" if dev.type == "cuda" else "gloo", n)
    return init_device_mesh(dev.type, (n // model, model), mesh_dim_names=("data", "model"))


def release() -> None:
    """End this process's process group, if it has one."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
