"""Process-group runtime of the sharded layer (port of
`kzg_tpu/parallel/runtime.py`).

The JAX package scales with JAX's distributed runtime: every host calls
`initialize_distributed()` once, after which `jax.devices()` spans the
slice and `make_mesh` lays a `jax.sharding.Mesh` over it. The port runs one
process per rank on `torch.distributed`: NCCL between cards, gloo between
CPU processes. Each process calls `initialize_distributed` with the group's
address (a `file://` store or `tcp://host:port`), its world size and its
rank, then `make_mesh`, a `DeviceMesh` whose axis names the sharded modules
take. Rank r works on `cuda:(r % device_count)`, or on the CPU when
`config.device` is the CPU. `launch` starts a world of worker processes
and bounds its wall time: a collective with a missing rank waits forever.
"""

import os
import subprocess
import tempfile
import time
from dataclasses import dataclass
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from ..config import get_config, resolve_device

DEFAULT_TIMEOUT = timedelta(seconds=300)


def rank_device() -> torch.device:
    """This process's device: card rank % device_count (rank 0 before the
    group exists) when the configured device is a card, else the CPU."""
    device = resolve_device()
    if device.type != "cuda":
        return device
    rank = dist.get_rank() if dist.is_initialized() else 0
    return torch.device("cuda", rank % torch.cuda.device_count())


def initialize_distributed(backend=None, init_method=None, world_size=None, rank=None,
                           timeout=DEFAULT_TIMEOUT):
    """Join the process group (`dist.init_process_group`): NCCL when the
    configured device is a card, gloo on the CPU, unless `backend` says.
    `world_size` and `rank` default to the RANK and WORLD_SIZE environment
    variables that `launch` (and torchrun) set; `init_method` defaults to
    torch's `env://`. A no-op when the group is already initialised, as in
    the JAX package. Every collective of the group gives up after
    `timeout`."""
    if dist.is_initialized():
        return
    if world_size is None and "WORLD_SIZE" in os.environ:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None and "RANK" in os.environ:
        rank = int(os.environ["RANK"])
    on_card = resolve_device().type == "cuda"
    if backend is None:
        backend = "nccl" if on_card else "gloo"
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=-1 if world_size is None else world_size,
                            rank=-1 if rank is None else rank, timeout=timeout)
    if on_card:  # before the first collective, which creates NCCL's communicator
        torch.cuda.set_device(rank_device())


def make_mesh(config=None):
    """The device mesh of config.mesh_shape / config.mesh_axis_names
    (default: a 1-D mesh named "shard" over every rank, the layout the
    sharded NTT, MSM and pipeline modules expect), as a
    `torch.distributed.device_mesh.DeviceMesh`. Raises ValueError when the
    shape needs more ranks than the group holds."""
    from torch.distributed.device_mesh import init_device_mesh

    cfg = config or get_config()
    world = dist.get_world_size()
    shape = (world,) if cfg.mesh_shape is None else tuple(cfg.mesh_shape)
    names = tuple(cfg.mesh_axis_names)[: len(shape)]
    if int(np.prod(shape)) > world:
        raise ValueError(f"mesh shape {shape} needs {int(np.prod(shape))} devices, "
                         f"have {world}")
    return init_device_mesh(rank_device().type, shape, mesh_dim_names=names)


@dataclass(frozen=True)
class MeshAxis:
    """One axis of a mesh as the sharded modules use it: its process group,
    its size (the device count R of the JAX package's `_split`), this
    process's rank along it (JAX's traced `axis_index`, a host integer here)
    and this rank's device."""

    group: object
    size: int
    rank: int
    device: torch.device


def mesh_axis(mesh, axis_name: str) -> MeshAxis:
    group = mesh.get_group(axis_name)
    return MeshAxis(group, dist.get_world_size(group), dist.get_rank(group), rank_device())


def block(t: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """This rank's block of the last axis of a replicated array, on its
    device (the port's counterpart of `jax.device_put` into the block
    sharding)."""
    n = t.shape[-1]
    if n % axis.size:
        raise ValueError(f"{n} elements do not split over {axis.size} ranks")
    blk = n // axis.size
    return t[..., axis.rank * blk:(axis.rank + 1) * blk].to(axis.device).contiguous()


def launch(argv, world_size: int, timeout: float, env=None) -> list:
    """Run `argv` as `world_size` processes, rank r with RANK=r and
    WORLD_SIZE set, and wait at most `timeout` seconds for all of them.
    Returns each rank's standard output. When one exits non-zero or the
    time runs out, every process still running is killed and RuntimeError
    says which ranks failed, with the end of their standard error."""
    logs, procs = [], []
    try:
        for r in range(world_size):
            logs.append((tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")))
            procs.append(subprocess.Popen(
                argv, stdout=logs[-1][0], stderr=logs[-1][1],
                env={**os.environ, **(env or {}), "RANK": str(r),
                     "WORLD_SIZE": str(world_size)}))
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            codes = [p.poll() for p in procs]
            if None not in codes or any(codes):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        outs = []
        for o, e in logs:
            o.seek(0)
            e.seek(0)
            outs.append((o.read(), e.read()))
            o.close()
            e.close()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        detail = "\n".join(f"--- rank {r} (exit {procs[r].returncode}):\n{outs[r][1][-3000:]}"
                           for r in failed)
        raise RuntimeError(f"ranks {failed} of {world_size} failed or ran past {timeout} s: "
                           f"{' '.join(map(str, argv))}\n{detail}")
    return [o for o, _ in outs]
