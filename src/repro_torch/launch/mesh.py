"""The ``(data, model)`` mesh over ``torch.distributed`` (port of
``repro.launch.mesh``).

:func:`make_axis_env` builds one rank's :class:`~repro_torch.models.
pjit_utils.AxisEnv` from an initialised process group.  Only the model
axis is ported: ``data > 1`` (data parallelism, FSDP) raises.
:func:`spawn_ranks` starts the ranks of one mesh on this host:

- rank r binds ``cuda:(r % device_count)`` (or the CPU);
- the process group is NCCL when every rank has a card of its own, gloo
  when ranks share one (NCCL refuses two ranks on one device; gloo
  reduces CUDA tensors through the host) and on the CPU;
- the rendezvous is a file in a fresh temporary directory (no port).
"""

from __future__ import annotations

import os
import tempfile
from typing import Callable, Sequence, Tuple

import torch

from ..models.pjit_utils import AxisEnv

__all__ = ["make_axis_env", "parse_mesh", "check_mesh", "rank_device", "backend_for",
           "spawn_ranks", "DATA_AXIS_ITEM"]

#: where the data axis waits
DATA_AXIS_ITEM = "ROADMAP.md Queue 1 item 12 (the data axis and FSDP)"


def parse_mesh(text: str) -> Tuple[int, int]:
    """``"DxM"`` -> ``(D, M)``, as the JAX launcher's ``--mesh``."""
    d, m = map(int, text.lower().split("x"))
    return check_mesh((d, m))


def check_mesh(mesh: Sequence[int]) -> Tuple[int, int]:
    """A ``(data, model)`` mesh the port can run: data 1, model >= 1."""
    d, m = (int(v) for v in mesh)
    if d < 1 or m < 1:
        raise ValueError(f"mesh {tuple(mesh)}: axis sizes must be positive")
    if d != 1:
        raise ValueError(f"mesh (data={d}, model={m}): a data axis > 1 is not ported; "
                         f"see {DATA_AXIS_ITEM}")
    return d, m


def make_axis_env(mesh: Sequence[int]) -> AxisEnv:
    """This rank's env on a ``(1, M)`` mesh: the default process group must
    be initialised with M ranks."""
    import torch.distributed as dist

    d, m = check_mesh(mesh)
    if not dist.is_initialized():
        raise RuntimeError("make_axis_env needs an initialised torch.distributed "
                           "process group (launch.mesh.spawn_ranks starts one)")
    world = dist.get_world_size()
    if world != m:
        raise ValueError(f"mesh (data={d}, model={m}) needs {m} ranks, the group has {world}")
    return AxisEnv(shape={"data": d, "model": m}, model_rank=dist.get_rank())


def rank_device(rank: int, device_type: str = "cuda") -> torch.device:
    """Rank r's device: ``cuda:(r % device_count)``, or the CPU."""
    if device_type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", rank % torch.cuda.device_count())


def backend_for(world: int, device_type: str = "cuda") -> str:
    """NCCL when every rank has its own card, else gloo."""
    if device_type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def _rank_main(rank: int, world: int, init_file: str, backend: str, device_type: str,
               fn: Callable, args: tuple) -> None:
    import torch.distributed as dist

    dev = rank_device(rank, device_type)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        fn(rank, world, dev, *args)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, world: int, *args, device_type: str = "cuda") -> None:
    """Run ``fn(rank, world, device, *args)`` in ``world`` processes joined
    in one process group over :func:`backend_for`'s backend.  A rank's
    exception fails the call (``torch.multiprocessing.spawn`` raises).
    Build the kernels before: the ranks then load them and never race on
    the build."""
    import torch.multiprocessing as mp

    backend = backend_for(world, device_type)
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank_main, args=(world, os.path.join(tmp, "rdzv"), backend, device_type,
                                   fn, args),
                 nprocs=world, join=True)
