"""Build-at-first-use for the port's native code (CUDA kernels, host C).

Shared libraries are compiled from the sources in the checkout into
``build/<kind>/<hash>/`` at the repository root (listed in ``.gitignore``),
keyed by a hash of the sources and the compiler command, so an edited source
rebuilds and an unchanged one loads the cached library.  A build writes to a
temporary name and renames it into place, so a concurrent or interrupted build
never leaves a half-written library under the final name.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path
from typing import Callable, List, Sequence

REPO_ROOT = Path(__file__).resolve().parent.parent
BUILD_ROOT = REPO_ROOT / "build"


def build_shared_library(
    kind: str,
    sources: Sequence[Path],
    command: Callable[[Path], List[str]],
    timeout_s: float = 900.0,
) -> Path:
    """Compile ``sources`` with ``command(output_path)`` unless a library for
    the same sources and command already exists; returns the library path.

    The compiler's combined output is kept beside the library as
    ``build.log`` (for nvcc it carries ``-Xptxas -v``'s register report)."""
    h = hashlib.sha256()
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update("\0".join(command(Path("OUT"))).encode())
    out_dir = BUILD_ROOT / kind / h.hexdigest()[:16]
    lib = out_dir / f"lib{kind}.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".lib{kind}.{os.getpid()}.so"
    proc = subprocess.run(
        command(tmp), capture_output=True, text=True, timeout=timeout_s
    )
    (out_dir / "build.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"building {kind} failed (exit {proc.returncode}):\n"
            f"{' '.join(command(tmp))}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib)
    return lib


def build_log(lib: Path) -> str:
    """The compiler output recorded when ``lib`` was built."""
    log = lib.parent / "build.log"
    return log.read_text() if log.exists() else ""
