"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload CELL --seed N --seconds S --trace 0|1

from the root of a checkout that holds ``BENCHMARK.json``.  The cell's
configuration, traffic and metrics are the files that ``BENCHMARK.json``
names (``portbench/core.py``).  Set-up counts from this script's start to
the window's first call; the window runs calls back to back for
``--seconds``; ``--trace 1`` adds a traced segment and reports the
per-layer metrics instead of the end-to-end ones.  The last lines of
standard error give each number the correctness check compared, beside its
limit; the last line of standard output is the result as one JSON object.

It measures only the card: without CUDA, or with fewer cards than the cell
asks for, it prints no result and exits 2.  It exits 3, with no result,
when JAX or the JAX package was imported.  Build and kernel caches stay in
``build/`` inside the checkout.
"""
import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton",
          "CUDA_CACHE_PATH": "cuda_cache"}
WORLD_TIMEOUT_S = 330.0  # a run must end within 360 s


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / "portbench_cache" / sub)
    sys.path.insert(0, str(ROOT))

    import torch

    from portbench import core, world

    cell = core.Cell(core.manifest(ROOT), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {cell.name} needs {cell.chips} CUDA card(s), found {have}; "
              "nothing is measured on the CPU", file=sys.stderr)
        return 2
    trace = bool(args.trace)
    if cell.chips == 1:
        parts = [core.run_body(cell, args.seed, args.seconds, trace, torch.device("cuda", 0),
                               T_START)]
    else:
        from fusion_cryptography_tpu_torch import kernels, native

        kernels.library()  # built once here, not once a rank
        native.available()
        parts = world.launch(cell.chips, {
            "workload": cell.name, "seed": args.seed, "seconds": args.seconds, "trace": trace,
            "device": "cuda", "t_start": T_START, "bench_dir": str(core.HERE),
            "timeout_s": WORLD_TIMEOUT_S}, WORLD_TIMEOUT_S)
    found = sorted(set(core.forbidden_modules()).union(*(p["forbidden"] for p in parts)))
    if found:
        print(f"portbench: the run imported {', '.join(found)}", file=sys.stderr)
        return 3
    line = core.result(cell, parts, T_START, torch.cuda.get_device_name(0), "gpu", trace)
    print(f"set-up: {line['metrics'].get('setup_s', {}).get('value', '-')} s, of which the "
          f"driver's (inputs from the seed, warm-up) "
          f"{max(p['driver_setup_s'] for p in parts):.3f} s", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
