"""A world of n processes on one host, for the tests, ``chip_smoke.py`` and
``pod_scale``: each rank a fresh interpreter started with ``RANK``,
``WORLD_SIZE`` and ``LOCAL_RANK`` set, joined through a ``file://``
rendezvous in a temporary directory (no port to pick, so no race between
worlds started side by side).

``launch(n, "package.module:function", *args)`` (or ``"path/to/file.py:
function"``) runs ``function(*args)`` on every rank inside the process
group and returns the ranks' results in rank order.  The arguments and
results travel as pickles in the world's temporary directory; each rank's
output goes to a log there.  One timeout covers the whole world: when it
runs out, or when any rank fails, every rank is killed and the call raises
with the failed ranks' logs.  Each rank checks, before it returns, that it
never imported JAX.
"""
from __future__ import annotations

import importlib
import importlib.util
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import Any, List

import torch

from .distributed import initialize

REPO_ROOT = Path(__file__).resolve().parents[2]
DEFAULT_TIMEOUT_S = 300.0
FAILURE_GRACE_S = 5.0


def _tail(path: Path, n: int = 6000) -> str:
    text = path.read_text(errors="replace") if path.exists() else ""
    return text[-n:]


def launch(n: int, target: str, *args, device="cpu",
           timeout_s: float = DEFAULT_TIMEOUT_S) -> List[Any]:
    """Run ``target(*args)`` on each rank of a world of ``n`` processes on
    ``device`` (``"cpu"``: gloo; ``"cuda"``: NCCL, rank r on card r) and
    return the results in rank order."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if torch.cuda.device_count() < n:
            raise ValueError(f"a world of {n} CUDA ranks needs {n} cards, "
                             f"have {torch.cuda.device_count()}")
        from .. import kernels

        kernels.library()  # build once here, not once per rank
    tmp = Path(tempfile.mkdtemp(prefix="fct_launch_"))
    procs = []
    try:
        with open(tmp / "args.pkl", "wb") as f:
            pickle.dump((target, args, dev.type, timeout_s), f)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join([str(REPO_ROOT)] + [
            p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
        for r in range(n):
            env_r = dict(env, RANK=str(r), WORLD_SIZE=str(n), LOCAL_RANK=str(r))
            with open(tmp / f"rank{r}.log", "wb") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", __name__, str(tmp)], env=env_r, cwd=str(REPO_ROOT),
                    stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout_s
        while True:
            codes = [p.poll() for p in procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                # the rank at fault may still be exiting when a peer it broke
                # has gone: give the others a moment, then report all failures
                grace = time.monotonic() + FAILURE_GRACE_S
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
                logs = "\n".join(f"--- rank {r}\n{_tail(tmp / f'rank{r}.log', 2000)}"
                                  for r in range(n))
                raise RuntimeError(f"world of {n} did not finish within {timeout_s} s\n{logs}")
            time.sleep(0.05)
        results = []
        for r in range(n):
            with open(tmp / f"result{r}.pkl", "rb") as f:
                results.append(pickle.load(f))  # written by this world's ranks
        return results
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def _resolve(target: str):
    where, _, name = target.rpartition(":")
    if where.endswith(".py"):
        spec = importlib.util.spec_from_file_location(Path(where).stem, where)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    else:
        module = importlib.import_module(where)
    return getattr(module, name)


def _rank_main(tmp: Path) -> None:
    import torch.distributed as dist

    with open(tmp / "args.pkl", "rb") as f:
        target, args, device_type, timeout_s = pickle.load(f)  # written by the parent
    rank, n = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if device_type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    initialize(f"file://{tmp}/rendezvous", n, rank, device=device_type, timeout_s=timeout_s)
    if n > 1:
        # init_process_group does not wait for the other ranks: without this
        # barrier a rank could finish and exit while a peer still connects to it
        dist.barrier()
    result = _resolve(target)(*args)
    # only after success: a failed rank exits without it, since with its peers
    # waiting in a collective the teardown of its communicator can hang
    dist.destroy_process_group()
    if "jax" in sys.modules:
        raise RuntimeError(f"rank {rank} imported jax")
    with open(tmp / f"result{rank}.pkl.tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(tmp / f"result{rank}.pkl.tmp", tmp / f"result{rank}.pkl")


if __name__ == "__main__":
    try:
        _rank_main(Path(sys.argv[1]))
    except Exception:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)  # skip interpreter teardown: a broken communicator can hang in it
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)  # the result is written: skip the teardown, which can abort too
