"""Profiling: torch.profiler traces, and the program's own spans and counters.

``trace(log_dir)`` records the enclosed region with torch.profiler (host
activity, and the CUDA device's when there is one) and writes a Chrome trace
into ``log_dir`` (viewable in Perfetto, with each kernel's device time).

``span(name)`` and ``count(name, n)`` mark the program's work where it
happens.  They act only while a torch profiler records on this process (in
``trace``, or any ``torch.profiler.profile``): a span is then a
``record_function`` range in the same trace as the CUDA runtime calls and the
kernels, on one clock, nested on the caller's thread, and a count adds to a
counter that ``counters()`` reads and ``reset_counters()`` clears.  Otherwise
a span is one shared null context and a count does nothing, so the cost is
one flag check.  Neither waits for the device.

The program's spans, all named ``fct.*``: ``fct.verify`` (a grouped verify
call), ``fct.pack`` with ``fct.pack.encode``, ``fct.pack.scatter`` and
``fct.pack.upload`` (packing a chunk's messages: their offsets and
lengths, read from the ``str`` objects or after one join and encoding, the
flat stream's copy into pinned memory and its upload, and the launch of
kernel ``place_preimages``), ``fct.prehash``, ``fct.signer``,
``fct.group`` with ``fct.group.fold`` (kernel ``agg_fold``),
``fct.group.sponge`` (the aggregation preimage's SHAKE256 absorb and
squeeze) and ``fct.group.decode`` (the alphas' decode), ``fct.lattice`` with
``fct.lattice.target`` (kernel ``lattice_target``) (the pipeline's stages),
``fct.keygen`` with ``fct.sample`` (the host sampler), ``fct.sign`` with
``fct.sign.product`` (the signature product), ``fct.shard`` with
``fct.shard.gather`` (a rank's share of the sharded verify, and the
verdicts' all-gather with its uint8 pack and unpack).  Its counters:
``pack.payload_bytes`` (the messages' bytes), ``pack.shipped_bytes`` (the
uploaded stream's bytes, word padding included), ``pack.rows_direct``
(messages copied straight from their ``str``), ``pack.rows_fallback``
(messages encoded one by one because their chunk was not all ASCII),
``group.signers`` (N, once a group stage) and ``group.agg_words`` (the
padded aggregation preimage's width in words, from the op table, once a
group stage), ``shard.groups`` (the groups a rank verified) and
``shard.gather_bytes`` (the bytes of the gathered verdicts),
``sample.seeds_device`` and ``sample.seeds_host`` (the keys' seeds, two a
key, drawn by kernel ``sample_short`` or on the host); none of them reads
the device.
"""
from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path
from typing import Dict, Iterator

import torch
from torch.profiler import record_function

_OFF = contextlib.nullcontext()
_counters: Dict[str, int] = {}


def span(name: str):
    """A ``record_function`` range named ``name`` while a profiler records,
    else a shared null context."""
    if torch.autograd._profiler_enabled():
        return record_function(name)
    return _OFF


def count(name: str, n: int) -> None:
    """Add ``n`` to counter ``name`` while a profiler records."""
    if torch.autograd._profiler_enabled():
        _counters[name] = _counters.get(name, 0) + n


def counters() -> Dict[str, int]:
    """A copy of the counters."""
    return dict(_counters)


def reset_counters() -> None:
    _counters.clear()


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Trace the enclosed region into ``log_dir/trace_<pid>_<ns>.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(out / f"trace_{os.getpid()}_{time.time_ns()}.json"))
