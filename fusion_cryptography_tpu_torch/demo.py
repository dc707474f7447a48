"""Two-signer lifecycle walkthrough: setup -> keygen -> sign -> aggregate ->
verify on both API levels (the port of the JAX package's
``examples/demo.py``).

    python -m fusion_cryptography_tpu_torch.demo [--device cuda|cpu]

The batched tensor API runs at secpar=256, the object API (the reference's
classes) at secpar=128, both on ``--device`` (default ``cuda``; ``cpu`` runs
the kernels' plain versions).
"""
from __future__ import annotations

import argparse
import sys

from . import aggregate, fusion_setup, keygen, sign, verify
from .interop import api

MESSAGES = ["Hello world!", "Hello sailor!"]


def batched_api_demo(device) -> bool:
    print("=== tensor-native batched API (secpar=256) ===")
    params = fusion_setup(256, seed=42)
    keys = keygen(params, seeds=[1, 2], device=device)
    sigs = sign(params, keys, MESSAGES)
    agg = aggregate(params, keys.vk, MESSAGES, sigs.sig)
    ok, reason = verify(params, keys.vk, MESSAGES, agg)
    print(f"aggregate of {len(keys)} signatures on {agg.device} verifies: {ok} {reason!r}")
    return ok


def object_api_demo(device) -> bool:
    print("=== object compat API (reference surface, secpar=128) ===")
    params = api.fusion_setup(128, seed=42)
    key_one = api.keygen(params, seed=7, device=device)
    key_two = api.keygen(params, seed=8, device=device)
    m1, m2 = MESSAGES
    sig_one = api.sign(params, key_one, m1)
    sig_two = api.sign(params, key_two, m2)
    agg = api.aggregate(params, [key_one[1], key_two[1]], [m1, m2], [sig_one, sig_two])
    ok, reason = api.verify(params, [key_one[1], key_two[1]], [m1, m2], agg)
    print(f"aggregate of 2 signatures verifies: {ok} {reason!r}")
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="fusion_cryptography_tpu_torch.demo")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the kernels' plain versions)")
    args = ap.parse_args(argv)
    ok = batched_api_demo(args.device) and object_api_demo(args.device)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
