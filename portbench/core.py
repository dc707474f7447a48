"""The harness: finds a cell's files by name, runs its window, reads its
metrics, judges its answers and prints the result line.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own under ``portbench/``, found by the name ``BENCHMARK.json``
gives it:

* ``configs/<config>.json``: the configuration as it is run; its ``driver``
  key names ``drivers/<driver>.py``, the entry point the window drives;
* ``traffic/<traffic>.json``: the parameters ``traffic.py`` generates from;
* ``endtoend/<metric>.py`` and ``metrics/<metric>.py``: one reader each,
  ``read(window)`` or ``read(trace)`` -> a number, or None when the run has
  nothing to read (the metric is then left out).  A multi-card run
  reports the largest rank's value of a per-layer metric.

A run: set-up (the driver builds its inputs and warms every shape), then
calls back to back for ``--seconds``, then with ``--trace 1`` a traced
segment, then the program's state is freed and the driver's answers are
held against the plain reference.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from statistics import mean
from typing import Dict, List, Optional

from . import tracing
from .driver_base import World

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "fusion_cryptography_tpu")
TRACE_MIN_SECONDS = 1.0
TRACE_MIN_CALLS = 3


class Cell:
    """One entry of ``workloads``, with its configuration, traffic and metrics."""

    def __init__(self, manifest: dict, name: str, bench_dir: Path = HERE):
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")
        w = cells[name]
        self.name, self.chips = name, int(w["chips"])
        self.bench_dir = bench_dir
        self.config = _json(bench_dir / "configs" / f"{w['config']}.json")
        self.traffic = _json(bench_dir / "traffic" / f"{w['traffic']}.json")

        def mine(entry: dict) -> bool:
            return name in entry.get("workloads", [name])

        self.end_to_end = [m for m in manifest["end_to_end"] if mine(m)]
        reported = {m["name"] for m in self.end_to_end}

        def layer_mine(entry: dict) -> bool:
            return mine(entry) if "workloads" in entry else entry["moves"] in reported

        self.per_layer = [m for m in manifest["per_layer"] if layer_mine(m)]

    def driver_module(self):
        return load(self.bench_dir / "drivers" / f"{self.config['driver']}.py")

    def reader(self, kind: str, metric: str):
        return load(self.bench_dir / kind / f"{metric}.py")


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


_loaded: Dict[Path, object] = {}


def load(path: Path):
    """The module of a file under ``portbench/``, loaded once by its path."""
    path = Path(path).resolve()
    if path not in _loaded:
        name = "portbench_file_" + "_".join(path.relative_to(path.parents[1]).with_suffix("").parts)
        spec = importlib.util.spec_from_file_location(name.replace(".", "_"), path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _loaded[path] = module
    return _loaded[path]


def manifest(root: Path) -> dict:
    return _json(Path(root) / "BENCHMARK.json")


class Window:
    """What the end-to-end readers read: the window's length, the answers
    its calls produced and the set-up time."""

    def __init__(self, seconds: float, answers: int, setup_s: float):
        self.seconds, self.answers, self.setup_s = seconds, answers, setup_s


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_body(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, world: Optional[World] = None) -> dict:
    """One process's run of ``cell`` -> its part of the result."""
    import torch

    driver = cell.driver_module().Driver(cell.config, cell.traffic, seed, device, world)
    t_setup = time.time()
    driver.setup()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    gc.collect()
    gc.freeze()  # the set-up's objects stay out of the window's collections
    go = _flag(world)
    go(True)  # every rank has finished its set-up
    setup_wall = time.time()
    calls, i = [], 0
    start = time.perf_counter()
    while True:
        a = time.perf_counter()
        n = driver.call(i)
        b = time.perf_counter()
        calls.append((a, b, n))
        i += 1
        if not go(b - start < seconds):
            break
    out = {"setup_wall": setup_wall, "driver_setup_s": setup_wall - t_setup,
           "window_s": calls[-1][1] - calls[0][0],
           "answers": sum(c[2] for c in calls), "calls": len(calls)}
    if trace:
        tr = tracing.capture(driver, i, TRACE_MIN_SECONDS, TRACE_MIN_CALLS, device.type, go)
        out["calls"] += tr.calls
        out["per_layer"] = {}
        for m in cell.per_layer:
            value = cell.reader("metrics", m["name"]).read(tr)
            if value is not None:
                out["per_layer"][m["name"]] = value
        out["busy_s"], out["traced_s"] = tr.busy_s, tr.window_s
        out["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if device.type == "cuda" else 0)
    driver.release()
    out["checks"] = driver.check()
    out["forbidden"] = forbidden_modules()
    return out


def control_body(cell: Cell, seeds: List[int], seconds: float, device,
                 world: Optional[World] = None) -> List[dict]:
    """For each seed, a window of the program as a run has it, then the
    checks of the program's answers and of the control's put in their place
    (``portbench/control.py``) -> one {seed, program, control} a seed."""
    import torch

    out = []
    go = _flag(world)
    for seed in seeds:
        driver = cell.driver_module().Driver(cell.config, cell.traffic, seed, device, world)
        driver.setup()
        go(True)
        start, i = time.perf_counter(), 0
        while True:
            driver.call(i)
            i += 1
            if not go(time.perf_counter() - start < seconds):
                break
        driver.release()
        out.append({"seed": seed, "calls": i, "program": driver.check(),
                    "control": driver.control_check()})
        del driver
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def _flag(world: Optional[World]):
    """``go(mine) -> every rank's mine``: one rank ending the window ends it
    for all, so the ranks make the same calls."""
    if world is None:
        return lambda mine: mine

    import torch
    import torch.distributed as dist

    def go(mine: bool) -> bool:
        t = torch.tensor([int(mine)], dtype=torch.int32)
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=world.flags_group)
        return bool(t.item())
    return go


def result(cell: Cell, parts: List[dict], t_start: float, device_name: str,
           platform: str, trace: bool) -> dict:
    """The result line from each process's part (one, or one a rank)."""
    first = parts[0]
    merged_checks = (cell.driver_module().merge_checks([p["checks"] for p in parts])
                     if len(parts) > 1 else first["checks"])
    window = Window(first["window_s"], first["answers"],
                    max(p["setup_wall"] for p in parts) - t_start)
    metrics = {}
    if trace:
        for m in cell.per_layer:
            values = [p["per_layer"][m["name"]] for p in parts if m["name"] in p["per_layer"]]
            if values:
                metrics[m["name"]] = {"value": max(values), "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            value = cell.reader("endtoend", m["name"]).read(window)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = all(v <= lim for v, lim in merged_checks.values())
    device = {"platform": platform, "kind": device_name, "count": len(parts),
              "memory_peak_bytes": max(p["memory_peak_bytes"] for p in parts)}
    line = {"correct": correct, "attempted": first["calls"], "failed": 0, "metrics": metrics,
            "device": device}
    if trace:
        device["busy_s"] = mean(p["busy_s"] for p in parts)
        device["window_s"] = mean(p["traced_s"] for p in parts)
        line["breakdown"] = first["breakdown"]
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in merged_checks.items()}
    return line
