"""The traced segment of a ``--trace 1`` run and its reduction to numbers.

A run with ``--trace 1`` measures its window as any run does, then traces
a short segment of further calls with ``torch.profiler`` (CPU and CUDA
activity).  The benchmark's own files put named ranges
(``record_function``) around the calls into the program's layers: ``call``
around each call, ``readback`` around the copy of its answers to the host,
and what a driver's ``instrument`` adds (``host.pack``, ``stage.<name>``,
``host.sampler``).  The program itself carries no span.

The profile is exported as a Chrome trace into ``TMPDIR``, read back and
deleted.  Host ranges, CUDA runtime calls and device activity share one
clock there; a device operation belongs to the range its launch (the
runtime call with the same correlation id) was issued in.  The per-layer
metric readers (``portbench/metrics/*.py``) read a :class:`Trace`.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from bisect import bisect_right
from typing import Callable, Dict, List, Optional

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")

# The port's kernels by a piece of their CUDA function's name (a frozen copy
# of the classification in the port's profile_verify.py): ``ntt_kernel<d,
# inverse, T>`` is both NTT kernels, T = long for ntt_u and int for
# ntt_centered.
PORT_KERNELS = {
    "keccak_absorb_kernel": "keccak_absorb", "keccak_squeeze_kernel": "keccak_squeeze",
    "agg_check_kernel": "intt_norm_weight", "signer_fold_a_kernel": "signer_fold_a",
    "signer_fold_b_kernel": "signer_fold_b", "agg_fold_kernel": "agg_fold",
    "assemble_spec_kernel": "assemble_spec", "xof_decode_kernel": "xof_decode",
    "render_prehash_kernel": "render_prehash", "lattice_target_kernel": "lattice_target",
}


def port_kernel(function: str) -> Optional[str]:
    """The port kernel a traced CUDA function belongs to, or None."""
    head = function.replace("(anonymous namespace)", "").split("(")[0]
    if "ntt_kernel" in head:
        return "ntt_u" if "long" in head else "ntt_centered"
    return next((k for fn, k in PORT_KERNELS.items() if fn in head), None)


def is_collective(function: str) -> bool:
    return "nccl" in function.lower()


def _union(intervals: List[tuple]) -> List[tuple]:
    out: List[list] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


class Trace:
    """A traced segment of ``calls`` calls, reduced from a Chrome trace."""

    def __init__(self, events: List[dict], calls: int, device_type: str,
                 work: Callable[[], List[dict]]):
        self.calls = calls
        self.device_type = device_type
        self._work = work
        self.ranges = [e for e in events if e.get("cat") == "user_annotation"]
        call_ranges = [e for e in self.ranges if e["name"] == "call"]
        self.t0 = min(e["ts"] for e in call_ranges)
        self.t1 = max(e["ts"] + e["dur"] for e in call_ranges)
        inside = lambda e: e["ts"] < self.t1 and e["ts"] + e.get("dur", 0) > self.t0
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS and inside(e)]
        self.launches = [e for e in events if e.get("cat") in LAUNCH_CATS]
        self.busy = _union([(max(e["ts"], self.t0), min(e["ts"] + e["dur"], self.t1))
                            for e in self.device])

    @property
    def on_device(self) -> bool:
        return self.device_type == "cuda" and bool(self.device)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) / 1e6

    def idle_share(self) -> float:
        """100 x (1 - union of device activity / segment), the segment from
        the first call's start to the last call's end on the host clock."""
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def range_ms(self, name: str) -> float:
        """Host ms inside ranges named ``name``, over the segment."""
        return sum(e["dur"] for e in self.ranges if e["name"] == name) / 1e3

    def device_ms(self, pick: Callable[[str], bool], cats=DEVICE_CATS) -> float:
        """Device ms of the operations of ``cats`` whose name ``pick`` accepts."""
        return sum(e["dur"] for e in self.device if e["cat"] in cats and pick(e["name"])) / 1e3

    def device_ms_in(self, name: str) -> float:
        """Device ms of the operations launched inside ranges named ``name``."""
        spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in self.ranges if e["name"] == name)
        starts = [a for a, _ in spans]

        def within(t: float) -> bool:
            k = bisect_right(starts, t) - 1
            return k >= 0 and t <= spans[k][1]

        corr = {e["args"].get("correlation") for e in self.launches if within(e["ts"])}
        return sum(e["dur"] for e in self.device
                   if e.get("args", {}).get("correlation") in corr) / 1e3

    def work(self) -> List[dict]:
        """The driver's count of the work of each traced call."""
        return self._work()

    def device_ops(self, top: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for e in self.device:
            by[e["name"]] = by.get(e["name"], 0.0) + e["dur"] / 1e6
        return [[n[:160], s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """Idle device time in the segment, summed by what the host was doing
        meanwhile: the innermost benchmark range it was in ("between calls"
        outside every range)."""
        edges = [self.t0] + [x for ab in self.busy for x in ab] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in self.ranges)
        by: Dict[str, float] = {}
        for a, b in gaps:
            near = [s for s in spans[:bisect_right(spans, (b,))] if s[1] > a]
            cuts = sorted({a, b} | {t for s in near for t in s[:2] if a < t < b})
            for lo, hi in zip(cuts, cuts[1:]):
                mid = (lo + hi) / 2
                holding = [s for s in near if s[0] <= mid < s[1]]
                label = max(holding)[2] if holding else "between calls"
                by[label] = by.get(label, 0.0) + (hi - lo) / 1e6
        return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

def capture(driver, first_call: int, min_seconds: float, min_calls: int,
            device_type: str, go: Callable[[bool], bool]) -> Trace:
    """Trace calls ``first_call``, ``first_call + 1``, ... of ``driver``
    until ``min_calls`` have run and ``min_seconds`` have passed
    (``go(mine)`` makes every rank of a multi-card run agree)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if device_type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    traced = []
    with driver.instrument():
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            i = first_call
            more = True
            while more:
                with record_function("call"):
                    driver.call(i)
                traced.append(i)
                i += 1
                more = go(len(traced) < min_calls or time.perf_counter() - t0 < min_seconds)
            if device_type == "cuda":
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            raw = json.load(f)
    finally:
        os.unlink(path)
    events = raw["traceEvents"] if isinstance(raw, dict) else raw
    return Trace(events, len(traced), device_type, lambda: [driver.work(i) for i in traced])
