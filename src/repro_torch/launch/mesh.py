"""Production and host meshes: the port's counterpart of
``repro.launch.mesh``.

Functions, not module-level constants, so importing this module touches no
process group. ``make_production_mesh`` lays the reference's 16x16 and
2x16x16 meshes over a *fake* process group (``torch.distributed``'s
``fake`` backend: every collective returns at once, nothing is sent), the
host-side stand-in for 512 TPU chips that the dry run traces against. A
process has one default group and it cannot be resized, so the fake world
is made once at 512 ranks and the single pod is its first 256. This
process is rank 0: its local shards are the per-device shapes.
``make_host_mesh`` is the reference's ``("data","model")`` mesh over the
real world (one rank on one card; several gloo ranks in a test).
"""
from __future__ import annotations

import socket
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

FAKE_WORLD = 512


def _fake_world() -> None:
    if dist.is_initialized():
        if (dist.get_backend() != "fake"
                or dist.get_world_size() != FAKE_WORLD):
            raise RuntimeError(
                "the production meshes need this process's default group "
                f"to be the fake one of {FAKE_WORLD} ranks; it is "
                f"{dist.get_backend()} of {dist.get_world_size()}")
        return
    # registers the "fake" backend with torch.distributed
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=FAKE_WORLD)


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_fake_mesh(shape, axes)


def make_fake_mesh(shape, axes) -> DeviceMesh:
    """A mesh of ``shape`` over the first ranks of the fake world (the dry
    run's small meshes in tests, too)."""
    _fake_world()
    n = 1
    for d in shape:
        n *= d
    return DeviceMesh("cpu", torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def make_host_mesh() -> DeviceMesh:
    """Every rank of the world as a ``("data","model")`` mesh, the model
    axis the largest of 8, 4, 2, 1 that divides the world, as in the
    reference. Without a default group, one rank of its own is started
    (NCCL on a card, gloo otherwise) at a free port of localhost."""
    if not dist.is_initialized():
        backend = "nccl" if torch.cuda.is_available() else "gloo"
        dist.init_process_group(backend,
                                init_method=f"tcp://localhost:{_free_port()}",
                                rank=0, world_size=1)
    n = dist.get_world_size()
    model = next(m for m in (8, 4, 2, 1) if n % m == 0)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(n).reshape(n // model, model),
                      mesh_dim_names=("data", "model"))
