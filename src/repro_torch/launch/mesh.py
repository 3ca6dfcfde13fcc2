"""Meshes and the card's datasheet peaks, the port of
``repro/launch/mesh.py``.

Single pod:  (16, 16)      dims ("data", "model")          = 256 devices
Multi-pod:   (2, 16, 16)   dims ("pod", "data", "model")   = 512 devices

``make_mesh`` and ``make_production_mesh`` are functions (never work at
import): a ``DeviceMesh`` needs a default process group whose world holds
the mesh. ``fake_world`` starts one of any size in this process on
torch's fake backend, which runs no collective and needs no device, so
the dry run can take the production meshes' shardings on one host; a
process that has a real group (NCCL on the card) builds its mesh with
``make_mesh`` directly. The process group is process-wide state: start a
fake world only in a process of its own (the dry run's entry point, a
test's subprocess) or tear it down after.

The reference's ``axis_types_kwargs`` is a shim over JAX versions (the
``axis_types=`` argument of ``jax.make_mesh``); a ``DeviceMesh`` has no
such notion, so it has no counterpart here.
"""
from __future__ import annotations

import contextlib

# NVIDIA H100 SXM5 80 GB, datasheet figures (roofline and memory fit)
PEAK_FLOPS_BF16 = 989e12        # datasheet: dense bf16 tensor-core FLOP/s
PEAK_FLOPS_F32 = 67e12          # datasheet: float32 FLOP/s, no tensor cores
HBM_BW = 3.35e12                # datasheet: HBM3 bytes/s
HBM_BYTES = 80e9                # datasheet: 80 GB of HBM3
NVLINK_BW = 450e9               # datasheet: NVLink 900 GB/s, 450 each way


def peak_flops(dtype: str) -> float:
    """The datasheet peak of operations on ``dtype`` (a torch dtype's
    name, ``"bfloat16"``): bf16 and fp16 on the tensor cores, any other
    type at the float32 rate outside them (PyTorch's float32 products
    leave TF32 off unless asked)."""
    return PEAK_FLOPS_BF16 if dtype in ("bfloat16", "float16") \
        else PEAK_FLOPS_F32


PRODUCTION_MESHES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def make_mesh(shape, axes, device_type: str = "cpu"):
    """A ``DeviceMesh`` of ``shape`` with dims named ``axes`` over the
    default process group (whose world must hold it)."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, tuple(int(s) for s in shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cpu"):
    shape, axes = PRODUCTION_MESHES[multi_pod]
    return make_mesh(shape, axes, device_type)


def init_fake_world(world_size: int) -> None:
    """Start the default process group on the fake backend as rank 0 of
    ``world_size`` (no-op when a group of at least that size is running:
    a mesh needs a world that holds it). The fake
    backend's store and group live in
    ``torch.testing._internal.distributed.fake_pg``, a private module:
    where it is missing this raises ImportError."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() < world_size:
            raise RuntimeError(f"a process group of {dist.get_world_size()} "
                               f"is running; the fake world needs "
                               f"{world_size}")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


@contextlib.contextmanager
def fake_world(world_size: int):
    """``init_fake_world`` for the length of the block; the group is
    destroyed after it if the block started it."""
    import torch.distributed as dist

    started = not dist.is_initialized()
    init_fake_world(world_size)
    try:
        yield
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


def fake_production_mesh(*, multi_pod: bool = False):
    """A production mesh on the fake backend: starts a fake world of 512
    (both meshes fit in it) unless a group is running. The mesh is typed
    as the cards' (``cuda``), so DTensor lowers a reshard to the
    collective NCCL would run (an all-to-all, where a ``cpu`` mesh falls
    back to an all-gather); its tensors are meta, and nothing touches a
    device."""
    init_fake_world(512)
    return make_production_mesh(multi_pod=multi_pod, device_type="cuda")
