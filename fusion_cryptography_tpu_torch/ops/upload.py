"""Where the port runs, and host data to a device without waiting for it.

A blocking host-to-device copy (``torch.as_tensor(x, device="cuda")``,
``.to("cuda")`` from pageable memory) synchronises the host with the device,
so a verify call that makes one mid-call cannot overlap host work with the
device's.  :func:`upload` copies through pinned memory with
``non_blocking=True`` instead: the copy is queued on the current stream, and
the caching host allocator keeps the pinned block until it has run.  The
calling thread fills the pinned block: torch's own copy there (``pin_memory``)
is parallel above 32,768 elements, and waiting for its threads took ~6 ms
for 128 KiB on a busy host (H100 machine, 8 cores).
"""
from __future__ import annotations

from typing import Optional

import torch


def upload(x, device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x`` (a numpy array, a host tensor or a list) as a tensor on
    ``device``; on a CUDA device the copy is asynchronous from pinned
    memory."""
    t = torch.as_tensor(x, dtype=dtype)
    if torch.device(device).type != "cuda" or t.is_pinned():
        return t.to(device, non_blocking=True)
    pinned = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    pinned.numpy()[...] = t.numpy()
    return pinned.to(device, non_blocking=True)


def resolve_device(device) -> torch.device:
    """``device``, or the CUDA device when it is None; raises when that
    device is CUDA and there is none (nothing falls back to the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


def input_device(device, *inputs) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else that of
    the first torch tensor among ``inputs``, else CUDA (numpy inputs; raises
    without a card)."""
    if device is None:
        for x in inputs:
            if isinstance(x, torch.Tensor):
                return x.device
    return resolve_device(device)
