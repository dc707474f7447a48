"""Where a grouped verify spends its time on the GPU.

    python -m fusion_cryptography_tpu_torch.profile_verify [--groups 8192]
        [--group-chunk 8192] [--assembly fold|spec] [--messages short|nist]
        [--out DIR]

Builds a secpar=256, N=4 fleet on the first CUDA device (messages of
``--messages``: "short", build_fleet's own ~12-byte ones; "nist", 33 * k
bytes, k = 1..100 equally often in seeded order, the mlen schedule of
NIST's PQC signature KAT generator), then, for verify
calls in the ``--assembly`` configuration ("fold", the default: the
signer fold kernels; "spec": ``assemble_spec`` on the challenge and triple
specs),
  1. times one verify call, then traces one more with torch.profiler and
     reads the program's spans (``utils/profiling.py``) in it: the host's
     packing of each chunk's messages (``fct.pack``) and the device time of
     the operations launched inside each stage's span (``fct.prehash``,
     ``fct.signer``, ``fct.group``, ``fct.lattice``);
  2. prints, from the same trace, the device time by kernel and the
     device's busy share of the call;
  3. beside each of the port's kernels, its device time in that trace, its
     launches and its bound (``bounds.py``) summed over the call's launches,
     each launch's bound computed from its own arguments in another,
     untraced call; then each launch of a kernel launched more than once,
     in order, with its traced time and its bound.
Nothing waits for the device inside the traced call, so the stages overlap
as they do untraced.  With ``--out`` the chrome trace and the kernel table
are written there.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

STAGES = {
    "prehash": "prehash (SHA3 + decimal)",
    "signer": "signer hash (vk, challenge, decode, NTT, triple)",
    "group": "group hash (agg preimage, SHAKE, decode)",
    "lattice": "lattice (alpha NTT, aggregate check, target)",
}


# the port's kernels by a piece of their CUDA function's name in a trace
# (``ntt_kernel<d, inverse, T>`` is both NTT kernels: T = long, the int64
# residues, for ntt_u; T = int, the centered values, for ntt_centered)
KERNEL_FUNCTIONS = {
    "keccak_absorb_kernel": "keccak_absorb", "keccak_squeeze_kernel": "keccak_squeeze",
    "agg_check_kernel": "intt_norm_weight", "signer_fold_a_kernel": "signer_fold_a",
    "signer_fold_b_kernel": "signer_fold_b", "agg_fold_kernel": "agg_fold",
    "assemble_spec_kernel": "assemble_spec", "xof_decode_kernel": "xof_decode",
    "render_prehash_kernel": "render_prehash", "lattice_target_kernel": "lattice_target",
    "place_preimages_kernel": "place_preimages", "sample_short_kernel": "sample_short",
    # the second launches of a split check and of a wide group's fold
    "lattice_partial_kernel": "lattice_target", "lattice_combine_kernel": "lattice_target",
    "agg_prefix_kernel": "agg_fold",
}


def port_kernel(function: str):
    """The port kernel a traced CUDA function belongs to, or None."""
    head = function.replace("(anonymous namespace)", "").split("(")[0]
    if "ntt_kernel" in head:
        return "ntt_u" if "long" in head else "ntt_centered"
    return next((k for fn, k in KERNEL_FUNCTIONS.items() if fn in head), None)


def trace(fn) -> tuple:
    """One call of ``fn`` under torch.profiler, ended by a device sync ->
    (wall seconds, [(function, device us, launches)] by device time, the
    profile).  The program's spans, which the profiler also projects onto
    the device, are left out of the rows."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and not e.key.startswith("fct.")]
    if not events:
        events = list(prof.key_averages())

    def dev_us(e) -> float:
        return getattr(e, "self_device_time_total", 0.0) or getattr(e, "self_cuda_time_total", 0.0)

    return wall, sorted(((e.key, dev_us(e), e.count) for e in events), key=lambda r: -r[1]), prof


def launch_times(prof) -> dict:
    """{port kernel: [device ms of each launch, in launch order]} from a trace."""
    out: dict = {}
    for e in prof.events():
        k = port_kernel(e.name) if e.device_type == torch.autograd.DeviceType.CUDA else None
        if k:
            out.setdefault(k, []).append(e.time_range.elapsed_us() / 1e3)
    return out


def span_times(prof, keep: Optional[Path] = None) -> tuple:
    """From a trace's Chrome export (written to ``keep`` if given, else to a
    temporary file; a profile exports once): ({stage: device ms of the
    operations launched inside its ``fct.<stage>`` spans}, [host ms of each
    ``fct.pack`` span, in order]).  A device operation belongs to the span
    its launch (the runtime call with its correlation id) was issued in."""
    if keep is None:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
    else:
        path = str(keep)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            raw = json.load(f)
    finally:
        if keep is None:
            os.unlink(path)
    events = raw["traceEvents"] if isinstance(raw, dict) else raw
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("cat") == "user_annotation")
    launches = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")]
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]

    def launched_ms(name: str) -> float:
        inside = [(a, b) for a, b, n in spans if n == name]
        corr = {e["args"].get("correlation") for e in launches
                if any(a <= e["ts"] <= b for a, b in inside)}
        return sum(e["dur"] for e in device if e.get("args", {}).get("correlation") in corr) / 1e3

    return ({k: launched_ms(f"fct.{k}") for k in STAGES},
            [(b - a) / 1e3 for a, b, n in spans if n == "fct.pack"])


def record_calls(wraps, run, on_call) -> None:
    """Run ``run()`` with each function ``(module, attribute, name)`` of
    ``wraps`` patched to hand ``on_call(name, args)`` the arguments of each
    of its calls before it runs, all positional in the function's own order
    (defaults filled in); the functions are restored afterwards."""
    saved = [getattr(module, attr) for module, attr, _ in wraps]

    def recorder(fn, name):
        sig = inspect.signature(fn)

        def wrapped(*args, **kwargs):
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            on_call(name, tuple(bound.arguments.values()))
            return fn(*args, **kwargs)
        return wrapped

    for (module, attr, name), fn in zip(wraps, saved):
        setattr(module, attr, recorder(fn, name))
    try:
        run()
    finally:
        for (module, attr, _), fn in zip(wraps, saved):
            setattr(module, attr, fn)


def call_bounds(params, run) -> dict:
    """{kernel: [launches, bound ms, [bound ms of each launch]]} over one
    ``run()``: each kernel wrapper the call reaches is wrapped to add its
    launch's bound, computed from the launch's own arguments (the block
    counts, the rendered lengths)."""
    from . import bounds
    from .interop import device_serial as ds
    from .ops import keccak_sponge as ks
    from .ops import place_preimages as pp
    from .ops import preimage_fold as pf
    from .ops import ragged_words as rw
    from .ops import xof_decode as xd
    from .scheme import device_pipeline as dp

    d = params.degree
    (tri_w,) = ds.signer_fold_b_table(params).widths
    bound_of = {  # kernel -> (module, wrapper, bound from the wrapper's arguments)
        "keccak_absorb": (ks, "absorb", lambda words, nb: bounds.keccak_absorb(nb)),
        "keccak_squeeze": (ks, "squeeze",
                           lambda st, n_words: bounds.keccak_squeeze(st.shape[1], n_words)),
        "ntt_u": (dp, "ntt_fwd_u", lambda plan, x: bounds.ntt(x.numel() // d, d, 16)),
        "intt_norm_weight": (dp, "agg_check",
                             lambda plan, table, aggs: bounds.agg_check(*aggs.shape)),
        "signer_fold_a": (pf, "signer_fold_a",
                          lambda p, vk2d_t, pre_w, pre_len: bounds.signer_fold_a(
                              d, pre_len, *ds.signer_fold_a_table(p).widths)),
        "signer_fold_b": (pf, "signer_fold_b",
                          lambda p, vk_buf, vk_len, pre_w, pre_len, c_hat_t:
                          bounds.signer_fold_b(d, vk_len, pre_len, tri_w)),
        "agg_fold": (pf, "agg_fold", lambda p, n, tbuf, tlen: bounds.agg_fold(
            tlen, n, ds.agg_fold_table(p, n).widths[0])),
        "assemble_spec": (dp, "assemble_spec",
                          lambda spec, values, extras, extra_bounds, pad_words:
                          bounds.assemble_spec(
                              0 if values is None else values.shape[0],
                              (extras[0][0] if values is None else values).shape[-1],
                              [el for _, el in extras],
                              pad_words or rw.words_for(spec.out_max))),
        "xof_decode": (xd, "decode_coeffs_rows",
                       lambda words, geom, n_bytes, n_streams: bounds.xof_decode(
                           geom, n_bytes, words.shape[1] * n_streams)),
        "render_prehash": (rw, "render_bigint_dec_w",
                           lambda digest: bounds.render_prehash(digest.shape[1])),
        "lattice_target": (dp, "lattice_target",
                           lambda F, vks, c, a, obs, nrm, wgt, beta, omega:
                           bounds.lattice_target(vks.shape[0], vks.shape[1], vks.shape[3],
                                                 nrm.shape[-1])),
        "place_preimages": (pp, "place_preimages",
                            lambda prefix, offsets, stream, n, rows: bounds.place_preimages(
                                offsets.numel() - 1, rows, stream.numel())),
    }
    per: dict = {}

    def add(kernel, args):
        b_ms = bound_of[kernel][2](*args)["bound_ms"]
        entry = per.setdefault(kernel, [0, 0.0, []])
        entry[0] += 1
        entry[1] += b_ms
        entry[2].append(b_ms)

    record_calls([(m, a, k) for k, (m, a, _) in bound_of.items()], run, add)
    return per


def nist_messages(n: int, seed: int = 42) -> list:
    """``n`` printable ASCII messages of 33 * k bytes, k = 1..100 equally
    often, in an order drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    lengths = 33 * rng.permutation(np.resize(np.arange(1, 101), n))
    text = rng.integers(0x20, 0x7F, int(lengths.sum()), dtype=np.uint8).tobytes().decode()
    ends = np.cumsum(lengths)
    return [text[e - k:e] for e, k in zip(ends.tolist(), lengths.tolist())]


def main() -> None:
    from .params import fusion_setup
    from .scheme import device_pipeline as dp
    from .scheme.device_setup import build_fleet

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--groups", type=int, default=8192)
    ap.add_argument("--group-chunk", type=int, default=dp.DEFAULT_GROUP_CHUNK)
    ap.add_argument("--assembly", choices=dp.ASSEMBLIES, default="fold")
    ap.add_argument("--messages", choices=("short", "nist"), default="short")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(f"card: {card}")
    dev = torch.device("cuda", 0)
    G, N = args.groups, 4
    params = fusion_setup(256, 42)
    vks, msgs, aggs = build_fleet(params, G, N, device=dev, group_chunk=args.group_chunk,
                                  messages=nist_messages(G * N) if args.messages == "nist"
                                  else None)

    def verify():
        out = dp.verify_batch_device(params, vks, msgs, aggs, group_chunk=args.group_chunk,
                                     assembly=args.assembly)
        torch.cuda.synchronize()
        return out

    verify()  # warm
    t0 = time.perf_counter()
    verify()
    wall = time.perf_counter() - t0

    # 1. the program's spans in one traced call
    traced, rows, prof = trace(verify)
    out = Path(args.out) if args.out else None
    if out:
        out.mkdir(parents=True, exist_ok=True)
    stages, packing = span_times(prof, out / "verify_trace.json" if out else None)
    if not packing:
        raise SystemExit("profile: the traced call opened no fct.pack span")
    print(f"verify G={G}, group_chunk {args.group_chunk}, group_hash_chunk "
          f"{dp.DEFAULT_GROUP_HASH_CHUNK}, assembly {args.assembly!r}, {args.messages} "
          f"messages: {wall * 1e3:.2f} ms per call")
    print(f"  host packing of the messages (fct.pack), {len(packing)} chunks: "
          + ", ".join(f"{t:.2f}" for t in packing) + " ms")
    for k, label in STAGES.items():
        print(f"  {label:52s} {stages[k]:9.3f} device ms launched in fct.{k}")

    # 2. the same trace by kernel
    busy = sum(r[1] for r in rows) / 1e3
    launches = sum(r[2] for r in rows)
    print(f"traced call {traced * 1e3:.2f} ms, device busy {busy:.2f} ms "
          f"({100 * busy / (traced * 1e3):.1f}% of the call), {launches} device launches")
    for name, us, n in rows[:25]:
        print(f"  {us / 1e3:9.3f} ms  x{n:<5d} {name[:90]}")

    # 3. the port's kernels beside their bounds at the call's shapes
    traced_ms: dict = {}
    for name, us, n in rows:
        k = port_kernel(name)
        if k:
            t = traced_ms.setdefault(k, [0, 0.0])
            t[0] += n
            t[1] += us / 1e3
    per = call_bounds(params, verify)
    each = launch_times(prof)
    port = []
    print("port kernels: traced device time, launches, bound summed over the call's launches")
    for k, (n_b, b_ms, b_each) in sorted(per.items(),
                                         key=lambda kv: -traced_ms.get(kv[0], [0, 0.0])[1]):
        n, ms = traced_ms.get(k, [0, 0.0])
        port.append({"kernel": k, "ms": ms, "launches": n, "bound_ms": b_ms,
                     "bound_launches": n_b, "gap_ms": ms - b_ms,
                     "launch_ms": each.get(k, []), "launch_bound_ms": b_each})
        print(f"  {k:18s} {ms:8.3f} ms  x{n:<3d} bound {b_ms:7.4f} ms  "
              f"({ms / b_ms:5.2f}x, gap {ms - b_ms:6.3f} ms)")
    for k, b_each in ((k, v[2]) for k, v in per.items() if v[0] > 1):
        pairs = zip(each.get(k, []), b_each)
        print(f"  {k} by launch: " + ", ".join(f"{t:.4f} ms (bound {b:.4f})" for t, b in pairs))
    if out:
        (out / "verify_kernels.json").write_text(json.dumps(
            {"card": card, "groups": G, "group_chunk": args.group_chunk,
             "group_hash_chunk": dp.DEFAULT_GROUP_HASH_CHUNK, "assembly": args.assembly,
             "messages": args.messages,
             "wall_ms": wall * 1e3, "packing_ms": packing,
             "traced_ms": traced * 1e3,
             "busy_ms": busy, "launches": launches, "stages_device_ms": stages,
             "kernels": [{"name": k, "ms": us / 1e3, "count": n} for k, us, n in rows],
             "port_kernels": port},
            indent=1))


if __name__ == "__main__":
    main()
