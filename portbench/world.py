"""A multi-card run: one process a card on this host, in the pattern of
the port's ``parallel/_launch.py``.

The process that prints the result starts ``n`` ranks, each a fresh
interpreter (``python -m portbench.world DIR``) with ``RANK``,
``WORLD_SIZE`` and ``LOCAL_RANK`` set.  They meet through a ``file://``
rendezvous in a new directory under ``TMPDIR``; rank r drives card r over
NCCL (or the CPU over gloo).  The run's arguments and each rank's part of
the result travel as JSON files in that directory, each rank's output goes
to a log there, and the directory is removed afterwards.  When a rank fails
or the time runs out every rank is stopped, and the failed ranks' logs are
raised.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from datetime import timedelta
from pathlib import Path
from typing import List

ROOT = Path(__file__).resolve().parent.parent
GRACE_S = 5.0


def _tail(path: Path, n: int = 4000) -> str:
    return path.read_text(errors="replace")[-n:] if path.exists() else ""


def launch(n: int, payload: dict, timeout_s: float) -> List[dict]:
    """Run ``payload`` (a run's arguments) on ``n`` ranks -> their parts in
    rank order."""
    tmp = Path(tempfile.mkdtemp(prefix="portbench_world_"))
    procs = []
    try:
        (tmp / "payload.json").write_text(json.dumps(payload))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join([str(ROOT)] + [
            p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
        for r in range(n):
            with open(tmp / f"rank{r}.log", "wb") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "portbench.world", str(tmp)],
                    env=dict(env, RANK=str(r), WORLD_SIZE=str(n), LOCAL_RANK=str(r)),
                    cwd=str(ROOT), stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout_s
        while True:
            codes = [p.poll() for p in procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                grace = time.monotonic() + GRACE_S
                while any(p.poll() is None for p in procs) and time.monotonic() < grace:
                    time.sleep(0.05)
                codes = [p.poll() for p in procs]
                failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
                logs = "\n".join(f"--- rank {r} (exit {codes[r]})\n{_tail(tmp / f'rank{r}.log')}"
                                  for r in failed)
                raise RuntimeError(f"ranks {failed} of {n} failed:\n{logs}")
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                logs = "\n".join(f"--- rank {r}\n{_tail(tmp / f'rank{r}.log', 1500)}"
                                  for r in range(n))
                raise RuntimeError(f"the world of {n} did not finish in {timeout_s} s\n{logs}")
            time.sleep(0.05)
        return [json.loads((tmp / f"result{r}.json").read_text()) for r in range(n)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def _rank_main(tmp: Path) -> None:
    import torch
    import torch.distributed as dist

    from portbench import core
    from portbench.driver_base import World

    p = json.loads((tmp / "payload.json").read_text())
    rank, n = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    if p["device"] == "cuda":
        torch.cuda.set_device(rank)
        device, backend = torch.device("cuda", rank), "nccl"
    else:
        device, backend = torch.device("cpu"), "gloo"
    dist.init_process_group(backend, init_method=f"file://{tmp}/rendezvous", world_size=n,
                            rank=rank, timeout=timedelta(seconds=p["timeout_s"]))
    flags = dist.new_group(backend="gloo")
    dist.barrier(group=flags)  # no rank leaves while a peer still connects
    bench = Path(p["bench_dir"])
    cell = core.Cell(core.manifest(bench.parent), p["workload"], bench)
    here = World(rank, n, flags)
    if p.get("control_seeds"):
        part = core.control_body(cell, p["control_seeds"], p["seconds"], device, here)
    else:
        part = core.run_body(cell, p["seed"], p["seconds"], p["trace"], device, p["t_start"],
                             here)
    dist.barrier(group=flags)
    dist.destroy_process_group()
    (tmp / f"result{rank}.json.tmp").write_text(json.dumps(part))
    os.replace(tmp / f"result{rank}.json.tmp", tmp / f"result{rank}.json")


if __name__ == "__main__":
    try:
        _rank_main(Path(sys.argv[1]))
    except Exception:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)  # a broken communicator can hang in the interpreter's teardown
