"""Process-group bootstrap on ``torch.distributed``.

Port of the JAX package's ``parallel/distributed.py`` (``jax.distributed``
there).  One process drives one device: a CUDA rank drives the card of its
``LOCAL_RANK`` and talks over NCCL, a CPU rank talks over gloo.  The
backend follows the device the caller names, and nothing falls back to
another.  Call :func:`initialize` once per process before any device use;
with nothing set it is a no-op, so library code can call it
unconditionally.  Meshes built afterwards (``parallel/mesh.py``) span the
world's ranks.
"""
from __future__ import annotations

import os
import tempfile
from contextlib import contextmanager
from datetime import timedelta
from typing import Iterator, Optional

import torch
import torch.distributed as dist

from ..ops.upload import resolve_device

DEFAULT_TIMEOUT_S = 600.0


def backend_for(device: torch.device) -> str:
    """``"nccl"`` for a CUDA device, ``"gloo"`` for the CPU."""
    if device.type == "cuda":
        return "nccl"
    if device.type == "cpu":
        return "gloo"
    raise ValueError(f"no process-group backend for device {device}")


def rank_device(device=None) -> torch.device:
    """The device this process drives: ``device`` (the card unless
    ``"cpu"``; raises without one), a CUDA device resolved to its index."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def initialize(init_method: Optional[str] = None, world_size: Optional[int] = None,
               rank: Optional[int] = None, *, device=None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> Optional[torch.device]:
    """Join the process group; returns this rank's device, or None when
    there is nothing to join.

    With no arguments it reads torchrun's ``WORLD_SIZE``, ``RANK``,
    ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` (``env://``), and is
    a no-op for a single process (``WORLD_SIZE`` unset or 1).  A CUDA rank
    first makes the card of ``LOCAL_RANK`` (or the given device's index)
    current, before any device use; ``init_process_group`` then gets the
    device's backend and ``timeout_s``, so a collective that one rank never
    reaches fails instead of hanging.
    """
    if dist.is_initialized():
        raise RuntimeError("the process group is already initialized")
    if world_size is None:
        env_ws = os.environ.get("WORLD_SIZE")
        world_size = int(env_ws) if env_ws is not None else None
    if init_method is None and (world_size is None or world_size <= 1):
        return None
    if world_size is None:
        raise ValueError("world_size must be given with init_method when WORLD_SIZE is unset")
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    dev = resolve_device(device)
    if dev.type == "cuda":
        index = dev.index if dev.index is not None else int(os.environ.get("LOCAL_RANK", "0"))
        torch.cuda.set_device(index)
        dev = torch.device("cuda", index)
    dist.init_process_group(
        backend_for(dev), init_method=init_method or "env://", world_size=world_size,
        rank=rank, timeout=timedelta(seconds=timeout_s),
    )
    return dev


def is_multi_process() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


@contextmanager
def single_process_world(device=None, timeout_s: float = DEFAULT_TIMEOUT_S) -> Iterator[torch.device]:
    """A world of this process alone on ``device`` (the card unless
    ``"cpu"``), through a file rendezvous in a temporary directory; the
    process group is destroyed on exit.  Yields the rank's device."""
    with tempfile.TemporaryDirectory(prefix="fct_world_") as tmp:
        dev = initialize(f"file://{tmp}/rendezvous", 1, 0, device=device, timeout_s=timeout_s)
        try:
            yield dev
        finally:
            dist.destroy_process_group()
