"""Meshes over a torch process group, and a gloo group on one host.

Counterpart of `repro.launch.mesh`.  A jax Mesh is a torch DeviceMesh
whose dims carry the reference's names (``data``, ``model``, with ``pod``
in front for the multi-pod mesh).  JAX runs one controller over every
device; torch runs one process a rank, and the caller starts the process
group (``torch.distributed.init_process_group``, or `spawn` below) before
a mesh is built over its ranks.

The collectives the port's SPMD code calls over these meshes' named
dims live with the placements, in `repro_torch.sharding`.
"""
from __future__ import annotations

import os
import socket

import torch
import torch.distributed as dist

PRODUCTION_WORLD = {False: 256, True: 512}


def _device_type(device) -> str:
    from repro_torch.device import resolve_device
    return resolve_device(device).type


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16x16 single pod (256 ranks) or 2x16x16 multi-pod (512 ranks) over
    the caller's process group; another world size raises, as the
    reference's `jax.make_mesh` does on another device count."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != PRODUCTION_WORLD[multi_pod]:
        raise ValueError(
            f"the production mesh {shape} needs {PRODUCTION_WORLD[multi_pod]} "
            f"ranks; this process group has {world}")
    return init_device_mesh(_device_type(device), shape, mesh_dim_names=axes)


def make_host_mesh(data: int | None = None, model: int = 1, *, device=None):
    """A (data, model) mesh over the ranks of the caller's process group
    (tests, CPU training, the card's two-rank check).  The device is CUDA
    unless the caller asks for the CPU."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh runs over a process group: call "
                           "torch.distributed.init_process_group first (or "
                           "repro_torch.launch.mesh.spawn)")
    n = dist.get_world_size()
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh ({data}, {model}) does not cover the {n} "
                         "ranks of the process group")
    return init_device_mesh(_device_type(device), (data, model),
                            mesh_dim_names=("data", "model"))


# ---------------------------------------------------------------------------
# A process group on one host (tests; the card's two-rank check)
# ---------------------------------------------------------------------------

def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _child(rank, fn, world, port, args):
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, *args, timeout: float = 120.0) -> None:
    """Run fn(rank, world, *args) in `world` spawned processes joined in one
    gloo process group on localhost.  `fn` must be importable by name (a
    module-level function); the children import what `fn`'s module does
    and nothing of the caller's.  Raises if a child fails or the group
    has not finished within `timeout` seconds (the children are then
    killed)."""
    import time
    import torch.multiprocessing as mp
    ctx = mp.start_processes(_child, args=(fn, world, free_port(), args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"process group of {world} ranks still "
                                   f"running after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(5)
