"""Profiling helpers: torch.profiler traces and per-op wall-clock timers.

``trace(log_dir)`` records the enclosed region with torch.profiler (host
activity, and the CUDA device's when there is one) and writes a Chrome trace
into ``log_dir`` (viewable in Perfetto, with each kernel's device time);
``op_timer`` gives the mean/median/min summary per op name of the reference's
benchmark harness.  The port of the JAX package's ``utils/profiling.py``.
"""
from __future__ import annotations

import contextlib
import os
import statistics
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterator, List

import torch


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


class op_timer:
    """Accumulate wall-clock samples per op name; summarize like the reference
    harness (mean/median/min per op)."""

    def __init__(self) -> None:
        self.samples: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def measure(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.samples[name].append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "n": len(ts),
                "mean": statistics.mean(ts),
                "median": statistics.median(ts),
                "min": min(ts),
            }
            for name, ts in self.samples.items()
        }

    def report(self) -> str:
        lines = []
        for name, s in self.summary().items():
            lines.append(
                f"{name:30s} n={s['n']:4d} min={s['min']*1e3:9.3f}ms "
                f"mean={s['mean']*1e3:9.3f}ms median={s['median']*1e3:9.3f}ms"
            )
        return "\n".join(lines)
