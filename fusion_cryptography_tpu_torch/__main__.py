"""Command-line interface: keygen / sign / aggregate / verify over files.

The port of the JAX package's CLI: the same subcommands, flags, printed
lines and exit codes (0 on success, 1 on a failed verify with the
reference's reason, 2 on an arity error or a security-level mismatch), and
files in the same versioned binary format (scheme/serde.py), so either
package reads what the other writes.  ``--device`` (default ``cuda``) picks
where the tensors live; ``--device cpu`` runs the kernels' plain versions.

Examples:
    python -m fusion_cryptography_tpu_torch setup  --secpar 256 --seed 42 --out params.fp
    python -m fusion_cryptography_tpu_torch keygen --params params.fp --seed 7 \
        --out-sk sk.fp --out-vk vk.fp
    python -m fusion_cryptography_tpu_torch sign   --params params.fp --sk sk.fp \
        --message "hello" --out sig.fp
    python -m fusion_cryptography_tpu_torch aggregate --params params.fp \
        --vk vk1.fp --message m1 --sig s1.fp  --vk vk2.fp --message m2 --sig s2.fp \
        --out agg.fp
    python -m fusion_cryptography_tpu_torch verify --params params.fp \
        --vk vk1.fp --message m1 --vk vk2.fp --message m2 --agg agg.fp
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path


def _write(path: str, data: bytes) -> None:
    Path(path).write_bytes(data)


def _read(path: str) -> bytes:
    return Path(path).read_bytes()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="fusion_cryptography_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--device", default="cuda",
                        help="torch device of the tensors (default cuda; cpu runs the "
                             "kernels' plain versions)")

    p = sub.add_parser("setup", parents=[common], help="create a parameter set")
    p.add_argument("--secpar", type=int, default=256, choices=(128, 256))
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--out", required=True)

    p = sub.add_parser("keygen", parents=[common], help="generate a one-time key pair")
    p.add_argument("--params", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--out-sk", required=True)
    p.add_argument("--out-vk", required=True)

    p = sub.add_parser("sign", parents=[common], help="sign one message")
    p.add_argument("--params", required=True)
    p.add_argument("--sk", required=True)
    p.add_argument("--message", required=True)
    p.add_argument("--out", required=True)

    p = sub.add_parser("aggregate", parents=[common], help="aggregate signatures")
    p.add_argument("--params", required=True)
    p.add_argument("--vk", action="append", required=True)
    p.add_argument("--message", action="append", required=True)
    p.add_argument("--sig", action="append", required=True)
    p.add_argument("--out", required=True)

    p = sub.add_parser("verify", parents=[common], help="verify an aggregate signature")
    p.add_argument("--params", required=True)
    p.add_argument("--vk", action="append", required=True)
    p.add_argument("--message", action="append", required=True)
    p.add_argument("--agg", required=True)

    args = ap.parse_args(argv)

    import torch

    from .interop import api
    from .ops.upload import resolve_device
    from .scheme import ring, serde

    if args.cmd == "setup":
        params = api.fusion_setup(args.secpar, args.seed)
        _write(args.out, serde.encode_params(params))
        print(f"wrote {args.out} (secpar={args.secpar})")
        return 0

    dev = resolve_device(args.device)
    params = serde.decode_params(_read(args.params))

    if args.cmd == "keygen":
        sk, vk = api.keygen(params, args.seed, device=dev)
        _write(args.out_sk, serde.encode_sk(params, args.seed, sk.sk_hat))
        _write(args.out_vk, serde.encode_vk(params, vk.vk))
        print(f"wrote {args.out_sk}, {args.out_vk}")
        return 0

    if args.cmd == "sign":
        secpar, seed, sk_hat = serde.decode_sk(_read(args.sk))
        if secpar != params.secpar:
            print("error: key/params security level mismatch", file=sys.stderr)
            return 2
        sk = api.OneTimeSigningKey(params, seed, sk_hat, device=dev)
        # the vk (needed for the challenge hash) from the sk: A·sk over the rank
        F, q = params.plan.field, params.modulus
        a_u = F.to_unsigned(torch.as_tensor(params.public_challenge, device=dev))
        vk_u = ring.mul(a_u, F.to_unsigned(sk.sk_hat), q).sum(dim=-2).remainder_(q)
        vk = api.OneTimeVerificationKey(params, F.to_centered(vk_u))
        sig = api.sign(params, (sk, vk), args.message)
        _write(args.out, serde.encode_signature(params, sig.signature_hat))
        print(f"wrote {args.out}")
        return 0

    if args.cmd == "aggregate":
        if not (len(args.vk) == len(args.message) == len(args.sig)):
            print("error: need equal counts of --vk/--message/--sig", file=sys.stderr)
            return 2
        vks = [api.OneTimeVerificationKey(params, serde.decode_vk(_read(v))[1], device=dev)
               for v in args.vk]
        sigs = [api.Signature(params, serde.decode_signature(_read(s))[1], device=dev)
                for s in args.sig]
        agg = api.aggregate(params, vks, args.message, sigs, device=dev)
        _write(args.out, serde.encode_signature(params, agg.signature_hat))
        print(f"wrote {args.out} (aggregate of {len(sigs)})")
        return 0

    if args.cmd == "verify":
        if len(args.vk) != len(args.message):
            print("error: need equal counts of --vk/--message", file=sys.stderr)
            return 2
        vks = [api.OneTimeVerificationKey(params, serde.decode_vk(_read(v))[1], device=dev)
               for v in args.vk]
        agg = api.Signature(params, serde.decode_signature(_read(args.agg))[1], device=dev)
        ok, why = api.verify(params, vks, args.message, agg, device=dev)
        print("OK" if ok else f"FAIL: {why}")
        return 0 if ok else 1

    return 2


if __name__ == "__main__":
    sys.exit(main())
