"""Kernels ``xof_decode`` and ``render_prehash`` of this tree against
another checkout's, on one card, in one process.

    python -m fusion_cryptography_tpu_torch.glue_ab OTHER_ROOT

OTHER_ROOT is an unpacked ``git archive`` of another commit of this
repository (the parent, say).  Its package is imported under another name,
so it builds its own kernels from its own sources into ``OTHER_ROOT/build``.
Both packages' wrappers (``ops.xof_decode.decode_coeffs_rows``,
``ops.ragged_words.render_bigint_dec_w``, each given its own package's
geometries) then run at the shapes of a secpar=256 verify call on the same
seeded random inputs: the challenge decode (32,768 streams), the alphas'
decode (8,192 lanes of 4 streams, the group stage's blob read in place)
and the prehash render (32,768 digests).  Each output must equal this
tree's plain version; then each pair is timed in the order other, this,
this, other, by torch.profiler (the median device time of the kernel's
launches in 20 calls) and by CUDA events (the mean time of a call over 20
calls queued behind a device spin, as ``chip_smoke.py`` times; it includes
the wrapper's host time where that is the longer, as for the render).
Prints the card's name and power limit, then one JSON line.  Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path
from statistics import median
from types import SimpleNamespace

import torch

from . import kernels
from .ops import ragged_words as rw
from .ops import xof_decode as xd

REPS = 20
PACKAGE = Path(__file__).resolve().parent


def _side(pkg) -> SimpleNamespace:
    """A package's decode and render wrappers and its secpar=256 geometries."""
    def sub(name: str):
        return importlib.import_module(f"{pkg.__name__}.{name}")

    return SimpleNamespace(
        decode=sub("ops.xof_decode").decode_coeffs_rows,
        render=sub("ops.ragged_words").render_bigint_dec_w,
        geoms=sub("scheme.device_pipeline")._geometries(pkg.fusion_setup(256, 1)))


def import_other(root: Path):
    """The package of the checkout at ``root``, imported as ``other_<name>``."""
    src = root.resolve() / PACKAGE.name
    name = "other_" + PACKAGE.name
    spec = importlib.util.spec_from_file_location(name, src / "__init__.py",
                                                  submodule_search_locations=[str(src)])
    if spec is None or not src.is_dir():
        raise SystemExit(f"glue_ab: no package {PACKAGE.name} under {root}")
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[name] = pkg
    spec.loader.exec_module(pkg)
    return pkg


def event_ms(fn) -> float:
    """Mean time of ``fn()`` over REPS calls by CUDA events, queued behind a
    ~0.5 ms device spin (chip_smoke.py's ``cuda_ms``)."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1_000_000)
    start.record()
    for _ in range(REPS):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / REPS


def device_us(fn, kernel: str) -> float:
    """Median device time (us) of the launches of CUDA functions whose name
    holds ``kernel`` in REPS calls of ``fn`` under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    times = [e.device_time for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name]
    if len(times) < REPS:
        raise SystemExit(f"glue_ab: {len(times)} launches of {kernel} traced in {REPS} calls")
    return float(median(times))


def ab(label: str, kernel: str, other, this, want) -> dict:
    """``other`` and ``this`` (each returning a tuple of tensors) equal to
    ``want``, then timed other, this, this, other."""
    for who, fn in (("other", other), ("this", this)):
        if not all(torch.equal(a, b) for a, b in zip(fn(), want, strict=True)):
            raise SystemExit(f"glue_ab: {who}'s {label} differs from the plain version")
    out = {"other_ms": [], "this_ms": [], "other_device_us": [], "this_device_us": []}
    for who, fn in (("other", other), ("this", this), ("this", this), ("other", other)):
        out[f"{who}_ms"].append(event_ms(fn))
        out[f"{who}_device_us"].append(device_us(fn, kernel))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path, help="an unpacked git archive of another commit")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("glue_ab: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    kernels.library()
    other = _side(import_other(args.other))
    this = _side(sys.modules[__package__])
    g = this.geoms
    gen = torch.Generator(device=dev).manual_seed(15)

    def words(n_words: int, lanes: int) -> torch.Tensor:
        return torch.randint(-(2**31), 2**31, (n_words, lanes), dtype=torch.int64, device=dev,
                             generator=gen).to(torch.int32)

    result: dict = {"card": card, "other": str(args.other), "xof_decode": {}}
    launches = {"challenge": ("geom_ch", g["n_xof_ch_used"], 32768, 1),
                "alphas": ("geom_ag", g["block_ag"], 8192, 4)}
    for label, (key, n, lanes, ns) in launches.items():
        w = words(-(-ns * n // 4), lanes)
        want = (xd.decode_rows_plain(w, g[key], n, ns),)
        result["xof_decode"][label] = dict(
            lanes=lanes, streams=ns, n_bytes=n, **ab(
                f"{label} decode", "xof_decode_kernel",
                lambda: (other.decode(w, other.geoms[key], n, ns),),
                lambda: (this.decode(w, this.geoms[key], n, ns),), want))
    digest = words(8, 32768)
    plain = rw.render_bigint_dec_plain(digest)

    def render(side):
        out = side.render(digest)
        return out.buf, out.length

    result["render_prehash"] = dict(lanes=32768, **ab(
        "render", "render_prehash_kernel", lambda: render(other), lambda: render(this),
        (plain.buf, plain.length)))
    print(f"card: {card}")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
