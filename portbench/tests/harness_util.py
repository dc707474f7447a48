"""Helpers of the benchmark's CPU tests: a cell run on the CPU at a tiny
size, with the harness's look for a card skipped."""
import json
import shutil
import time
from pathlib import Path

import torch

from portbench import core, world

ROOT = Path(__file__).resolve().parents[2]
S128 = {"secpar": 128, "degree": 64, "rank": 195}
TINY = {
    "verify.s256n4.short": ({**S128, "groups": 8},
                            {"tamper_share": 0.5, "check_groups": 8}),
    "verify.s256n4.nist": ({**S128, "groups": 4},
                           {"tamper_share": 0.5, "check_groups": 4,
                            "message_length": {"multiple": 33, "k_min": 1, "k_max": 4}}),
    "sign.s128.b1024": ({"batch": 2}, {}),
    "verify.s256n4x4.short": ({**S128, "groups": 8},
                              {"tamper_share": 0.5, "check_groups": 8}),
}


def tiny_cell(name: str, bench_dir: Path = core.HERE) -> core.Cell:
    cell = core.Cell(with_waiting(core.manifest(bench_dir.parent)), name, bench_dir)
    config, traffic = TINY[name]
    cell.config.update(config)
    cell.traffic.update(traffic)
    return cell


def run_cpu(cell: core.Cell, seed: int = 2**33 + 1, seconds: float = 0.5,
            trace: bool = False) -> dict:
    t = time.time()
    part = core.run_body(cell, seed, seconds, trace, torch.device("cpu"), t)
    return core.result(cell, [part], t, "cpu", "cpu", trace)


# cells whose files are in portbench/ and which enter BENCHMARK.json once
# proved on the card: the four-card cell, and the long-message cell
FOUR_CARD = {"name": "verify.s256n4x4.short", "config": "fusion256-n4-dp4", "traffic": "short",
             "chips": 4, "why": "the sharded verify on four ranks"}
NIST = {"name": "verify.s256n4.nist", "config": "fusion256-n4-g8192", "traffic": "nist",
        "chips": 1, "why": "the verify over NIST KAT message lengths"}


def with_waiting(manifest: dict, cells=(NIST,)) -> dict:
    """``manifest`` with the waiting ``cells`` added to its workloads and to
    the cells that report ``verifies_per_s``."""
    have = {w["name"] for w in manifest["workloads"]}
    new = [c for c in cells if c["name"] not in have]
    manifest["workloads"] += new
    for m in manifest["end_to_end"]:
        if m["name"] == "verifies_per_s":
            m["workloads"] += [c["name"] for c in new]
    return manifest


def copy_bench(tmp: Path, tiny: str = None, cells=()) -> Path:
    """BENCHMARK.json and portbench/ in ``tmp``, with ``cells`` added to the
    manifest's workloads; with ``tiny`` that cell's configuration and
    traffic files rewritten at its tiny size."""
    manifest = with_waiting(core.manifest(ROOT), cells)
    (tmp / "BENCHMARK.json").write_text(json.dumps(manifest))
    shutil.copytree(ROOT / "portbench", tmp / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    if tiny:
        w = {c["name"]: c for c in core.manifest(tmp)["workloads"]}[tiny]
        for kind, key, extra in (("configs", "config", TINY[tiny][0]),
                                 ("traffic", "traffic", TINY[tiny][1])):
            path = tmp / "portbench" / kind / f"{w[key]}.json"
            path.write_text(json.dumps({**json.loads(path.read_text()), **extra}))
    return tmp / "portbench"


def run_world_cpu(bench_dir: Path, name: str, seed: int = 2**34 + 3, seconds: float = 0.5) -> dict:
    cell = core.Cell(core.manifest(bench_dir.parent), name, bench_dir)
    t = time.time()
    parts = world.launch(cell.chips, {
        "workload": name, "seed": seed, "seconds": seconds, "trace": False, "device": "cpu",
        "t_start": t, "bench_dir": str(bench_dir), "timeout_s": 240.0}, 240.0)
    return core.result(cell, parts, t, "cpu", "cpu", False)
