"""Host data to a device without waiting for the device.

A blocking host-to-device copy (``torch.as_tensor(x, device="cuda")``,
``.to("cuda")`` from pageable memory) synchronises the host with the device,
so a verify call that makes one mid-call cannot overlap host work with the
device's.  :func:`upload` copies through pinned memory with
``non_blocking=True`` instead: the copy is queued on the current stream, and
the caching host allocator keeps the pinned block until it has run.
"""
from __future__ import annotations

from typing import Optional

import torch


def upload(x, device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x`` (a numpy array, a host tensor or a list) as a tensor on
    ``device``; on a CUDA device the copy is asynchronous from pinned
    memory."""
    t = torch.as_tensor(x, dtype=dtype)
    dev = torch.device(device)
    if dev.type != "cuda":
        return t.to(dev)
    if not t.is_pinned():
        t = t.pin_memory()
    return t.to(dev, non_blocking=True)
