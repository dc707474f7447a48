"""The control of a cell's correctness check, and the program's readings
beside it, for setting and proving the check's limits.

    python3 portbench/control.py --workload CELL --seeds S1 S2 ... [--seconds 4]

For each seed: the cell's set-up at its own size, a short window of the
program's calls, then the numbers the check compares, once for the
program's answers and once with the control's in their place.  The control
is the plain reference computed with its modular products in float64
(``reference/fusion_ref.control``): the precision below the configuration's
exact integer arithmetic, which the check must catch.  One JSON line a
seed; the benchmark's runs never run it.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import torch

    from portbench import core, world

    cell = core.Cell(core.manifest(ROOT), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"control: {cell.name} needs {cell.chips} CUDA card(s)", file=sys.stderr)
        return 2
    if cell.chips == 1:
        rows = core.control_body(cell, args.seeds, args.seconds, torch.device("cuda", 0))
    else:
        ranks = world.launch(cell.chips, {
            "workload": cell.name, "control_seeds": args.seeds, "seconds": args.seconds,
            "device": "cuda", "t_start": time.time(), "bench_dir": str(core.HERE),
            "timeout_s": 3000.0}, 3000.0)
        merge = cell.driver_module().merge_checks
        rows = [{"seed": per[0]["seed"], "calls": per[0]["calls"],
                 "program": merge([r["program"] for r in per]),
                 "control": merge([r["control"] for r in per])} for per in zip(*ranks)]
    for row in rows:
        print(json.dumps({"workload": cell.name, "card": torch.cuda.get_device_name(0), **row}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
