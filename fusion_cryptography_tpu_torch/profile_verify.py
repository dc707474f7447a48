"""Where a grouped verify spends its time on the GPU.

    python -m fusion_cryptography_tpu_torch.profile_verify [--groups 8192]
        [--assembly fold|spec] [--out DIR]

Builds a secpar=256, N=4 fleet on the first CUDA device, then, for verify
calls in the ``--assembly`` configuration ("fold", the default: the
signer fold kernels; "spec": ``assemble_spec`` on the challenge and triple
specs),
  1. times each stage of one verify (prehash, signer hash, group hash,
     lattice) between device synchronisations;
  2. traces one verify with torch.profiler and prints the device time by
     kernel and the device's busy share of the call;
  3. beside each of the port's kernels, its device time in that trace, its
     launches and its bound (``bounds.py``) summed over the call's launches,
     each launch's bound computed from its own arguments in another,
     untraced call; then each launch of a kernel launched more than once,
     in order, with its traced time and its bound.
Stage times include the synchronisations, so they sum to a little more than
an unsynchronised call.  With ``--out`` the chrome trace and the kernel table
are written there.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

import torch


def _timed(fn, acc: dict, name: str):
    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        acc[name] = acc.get(name, 0.0) + time.perf_counter() - t0
        return out
    return wrapper


# the port's kernels by a piece of their CUDA function's name in a trace
# (``ntt_kernel`` is both NTT kernels: int64 residues for ntt_u, int32
# centered values for ntt_centered)
KERNEL_FUNCTIONS = {
    "keccak_absorb_kernel": "keccak_absorb", "keccak_squeeze_kernel": "keccak_squeeze",
    "agg_check_kernel": "intt_norm_weight", "signer_fold_a_kernel": "signer_fold_a",
    "signer_fold_b_kernel": "signer_fold_b", "agg_fold_kernel": "agg_fold",
    "assemble_spec_kernel": "assemble_spec",
}


def port_kernel(function: str):
    """The port kernel a traced CUDA function belongs to, or None."""
    head = function.replace("(anonymous namespace)", "").split("(")[0]
    if "ntt_kernel" in head:
        return "ntt_u" if "long" in head else "ntt_centered"
    return next((k for fn, k in KERNEL_FUNCTIONS.items() if fn in head), None)


def launch_times(prof) -> dict:
    """{port kernel: [device ms of each launch, in launch order]} from a trace."""
    out: dict = {}
    for e in prof.events():
        k = port_kernel(e.name) if e.device_type == torch.autograd.DeviceType.CUDA else None
        if k:
            out.setdefault(k, []).append(e.time_range.elapsed_us() / 1e3)
    return out


def call_bounds(params, run) -> dict:
    """{kernel: [launches, bound ms, [bound ms of each launch]]} over one
    ``run()``: each kernel wrapper the call reaches is wrapped to add its
    launch's bound, computed from the launch's own arguments (the block
    counts, the rendered lengths)."""
    from . import bounds
    from .interop import device_serial as ds
    from .ops import keccak_sponge as ks
    from .ops import preimage_fold as pf
    from .ops import ragged_words as rw
    from .scheme import device_pipeline as dp

    d = params.degree
    (tri_w,) = ds.signer_fold_b_table(params).widths
    per = {}

    def record(module, attr, kernel, bound_of):
        fn = getattr(module, attr)

        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            entry = per.setdefault(kernel, [0, 0.0, []])
            b_ms = bound_of(*args, **kwargs)["bound_ms"]
            entry[0] += 1
            entry[1] += b_ms
            entry[2].append(b_ms)
            return out
        return module, attr, fn, wrapped

    patches = [
        record(ks, "absorb", "keccak_absorb", lambda words, nb: bounds.keccak_absorb(nb)),
        record(ks, "squeeze", "keccak_squeeze",
               lambda st, n_words: bounds.keccak_squeeze(st.shape[1], n_words)),
        record(dp, "ntt_fwd_u", "ntt_u", lambda plan, x: bounds.ntt(x.numel() // d, d, 16)),
        record(dp, "agg_check", "intt_norm_weight",
               lambda plan, table, aggs: bounds.agg_check(*aggs.shape)),
        record(pf, "signer_fold_a", "signer_fold_a",
               lambda p, vk2d_t, pre_w, pre_len: bounds.signer_fold_a(
                   d, pre_len, *ds.signer_fold_a_table(p).widths)),
        record(pf, "signer_fold_b", "signer_fold_b",
               lambda p, vk_buf, vk_len, pre_w, pre_len, c_hat_t: bounds.signer_fold_b(
                   d, vk_len, pre_len, tri_w)),
        record(pf, "agg_fold", "agg_fold", lambda p, n, tbs, tls: bounds.agg_fold(
            tls, ds.agg_fold_table(p, n).widths[0])),
        record(dp, "assemble_spec", "assemble_spec",
               lambda spec, values=None, extras=(), extra_bounds=None, pad_words=None:
               bounds.assemble_spec(0 if values is None else values.shape[0],
                                    (extras[0][0] if values is None else values).shape[-1],
                                    [el for _, el in extras],
                                    pad_words or rw.words_for(spec.out_max))),
    ]
    for module, attr, _, wrapped in patches:
        setattr(module, attr, wrapped)
    try:
        run()
    finally:
        for module, attr, fn, _ in patches:
            setattr(module, attr, fn)
    return per


def main() -> None:
    from .params import fusion_setup
    from .scheme import device_pipeline as dp
    from .scheme.device_setup import build_fleet

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--groups", type=int, default=8192)
    ap.add_argument("--group-chunk", type=int, default=dp.DEFAULT_GROUP_CHUNK)
    ap.add_argument("--assembly", choices=dp.ASSEMBLIES, default="fold")
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
    vks, msgs, aggs = build_fleet(params, G, N, device=dev, group_chunk=args.group_chunk)

    def verify():
        out = dp.verify_batch_device(params, vks, msgs, aggs, group_chunk=args.group_chunk,
                                     assembly=args.assembly)
        torch.cuda.synchronize()
        return out

    verify()  # warm
    t0 = time.perf_counter()
    verify()
    wall = time.perf_counter() - t0

    # 1. stage breakdown: the call's own pipeline, its stages timed
    P = dp.get_pipeline(params, N, str(dev), args.assembly)
    stages = {
        "prehash": "prehash (SHA3 + decimal)",
        "signer": "signer hash (vk, challenge, decode, NTT, triple)",
        "group": "group hash (agg preimage, SHAKE, decode)",
        "lattice": "lattice (sums, INTT kernel)",
    }
    acc: dict = {}
    saved = {attr: getattr(P, attr) for attr in stages}
    for attr, label in stages.items():
        setattr(P, attr, _timed(saved[attr], acc, label))
    try:
        verify()
    finally:
        for attr, fn in saved.items():
            setattr(P, attr, fn)
    if not acc:
        raise SystemExit("profile: the call did not run the timed pipeline")
    print(f"verify G={G}, assembly {args.assembly!r}: {wall * 1e3:.2f} ms per call "
          "(unsynchronised stages)")
    for k, v in acc.items():
        print(f"  {k:52s} {v * 1e3:9.2f} ms")

    # 2. profiler trace
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        verify()
        traced = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        events = list(prof.key_averages())

    def dev_us(e) -> float:
        return getattr(e, "self_device_time_total", 0.0) or getattr(e, "self_cuda_time_total", 0.0)

    rows = sorted(((e.key, dev_us(e), e.count) for e in events), key=lambda r: -r[1])
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
    if args.out:
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out / "verify_trace.json"))
        (out / "verify_kernels.json").write_text(json.dumps(
            {"card": card, "groups": G, "assembly": args.assembly, "wall_ms": wall * 1e3,
             "traced_ms": traced * 1e3,
             "busy_ms": busy, "launches": launches, "stages_ms": {k: v * 1e3 for k, v in acc.items()},
             "kernels": [{"name": k, "ms": us / 1e3, "count": n} for k, us, n in rows],
             "port_kernels": port},
            indent=1))


if __name__ == "__main__":
    main()
