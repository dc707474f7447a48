"""Known-Answer-Test harness: check the port against a KAT corpus, and
generate one.

The port of the JAX package's ``interop/kat.py`` plus the loop of
``KATs/generate_kat_values.py`` (:func:`generate_corpus`).  A corpus holds
golden ``(input_repr, output_repr)`` CSV rows per stage.  Inputs are
``str()`` reprs of object tuples, not literals, so the checkers reconstruct
the tensors with a small regex scanner over the very regular repr grammar:

* polynomial payloads match ``values=[...]``;
* object boundaries are class-name markers (``OneTimeVerificationKey(`` etc.);
* scalars (seeds, prehash ints, lengths, messages) sit at known tail positions.

Every check regenerates the output through the port and compares the
serialized repr byte for byte.  The default corpus is the repository's
``KATs/reference_frozen/`` (18 files, seed 20260820, 3 signers per level),
generated by the reference code itself.  Functions that create tensors take
``device=None``, meaning the card (``device="cpu"`` for the CPU).
"""
from __future__ import annotations

import csv
import dataclasses
import random
import re
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..hashing.xof import challenge_xof_len
from ..ops.upload import resolve_device
from ..params import Params, _LEVELS, fusion_setup
from . import api, serial

csv.field_size_limit(sys.maxsize)

DEFAULT_KAT_DIR = Path(__file__).resolve().parents[2] / "KATs" / "reference_frozen"

_VALUES_RE = re.compile(r"values=\[([-0-9, ]*)\]")


def load_rows(path: Path) -> List[Tuple[str, str]]:
    with open(path, newline="") as f:
        return [(row[0], row[1]) for row in csv.reader(f)]


def _poly_values_list(s: str, start: int = 0, end: Optional[int] = None) -> List[np.ndarray]:
    out = []
    for m in _VALUES_RE.finditer(s, start, end if end is not None else len(s)):
        out.append(np.array([int(x) for x in m.group(1).split(", ")], dtype=np.int32))
    return out


def params_from_repr(s: str) -> Params:
    """Reconstruct a Params object from a ``Params(...)`` repr segment: parse the
    security level and the public-challenge value lists; everything else is
    derived by the parameter formulas."""
    secpar = int(re.search(r"Params\(secpar=(\d+)", s).group(1))
    rank = _LEVELS[secpar]["rank"]
    end = s.index("sign_pre_hash_dst=")
    polys = _poly_values_list(s, s.index("public_challenge="), end)
    if len(polys) != rank:
        raise ValueError(f"expected {rank} public-challenge polynomials, found {len(polys)}")
    base = fusion_setup(secpar, 0)
    return dataclasses.replace(
        base, seed=None, public_challenge=np.stack(polys).astype(np.int32)
    )


def _vk_from_repr(s: str, start: int) -> np.ndarray:
    """Parse OneTimeVerificationKey(...) beginning at ``start`` -> int32[2, d]."""
    polys = _poly_values_list(s, start)
    return np.stack([polys[0], polys[1]])


# ---------------------------------------------------------------------------
# Per-file checkers: each returns one bool per row.
# ---------------------------------------------------------------------------


def check_setup(path: Path, *, device=None) -> List[bool]:
    """fusion_setup_KAT_*: regenerate params from (secpar, seed), compare repr
    (host only; ``device`` is accepted for a uniform checker signature)."""
    results = []
    for inp, out in load_rows(path):
        secpar, seed = (int(x) for x in inp.strip("()").split(", "))
        results.append(serial.params_str(fusion_setup(secpar, seed)) == out)
    return results


def check_hash_message_to_int(path: Path, *, device=None) -> List[bool]:
    """intermediate_hash_message_to_int_KAT_* (host only)."""
    results = []
    for inp, out in load_rows(path):
        params = params_from_repr(inp)
        msg = re.search(r", '([^']*)'\)$", inp).group(1)
        results.append(str(api.hash_message_to_int(params, msg)) == out)
    return results


def check_hash_vk_and_int_to_bytes(path: Path, *, device=None) -> List[bool]:
    """intermediate_hash_vk_and_int_to_bytes_to_int_KAT_*: the key on
    ``device``, the hash on the host."""
    results = []
    for inp, out in load_rows(path):
        params = params_from_repr(inp)
        m = re.search(r", (\d+), (\d+)\)$", inp)
        i, n = int(m.group(1)), int(m.group(2))
        vk = _vk_from_repr(inp, inp.index("OneTimeVerificationKey("))
        vk_obj = api.OneTimeVerificationKey(params, vk, device=device)
        results.append(str(api.hash_vk_and_int_to_bytes(params, vk_obj, i, n)) == out)
    return results


def check_hash_ch(path: Path, *, device=None) -> List[bool]:
    """intermediate_hash_ch_KAT_*: the challenge NTT on ``device``."""
    results = []
    for inp, out in load_rows(path):
        params = params_from_repr(inp)
        msg = re.search(r", '([^']*)'\)$", inp).group(1)
        vk = _vk_from_repr(inp, inp.index("OneTimeVerificationKey("))
        vk_obj = api.OneTimeVerificationKey(params, vk, device=device)
        results.append(str(api.hash_ch(params, vk_obj, msg)) == out)
    return results


def check_aggregate(path: Path, setup_path: Optional[Path] = None, *,
                    device=None) -> List[bool]:
    """fusion_aggregate_KAT_*: full-pipeline replay on ``device``.

    1. Replay the generator's global-RNG stream from the setup KAT's seed
       (setup re-seeds the stream, then each sk seed is drawn between
       keygens) through the port, for as many signers as the row holds, and
       require ``str((params, otvks, msgs, sigs))`` to equal the stored input
       byte for byte: setup, keygen, sign, challenge hashing and every
       serialization path end to end.
    2. Require the port's aggregate of those signatures to verify.
    3. Require its repr to equal the stored output.  A corpus made by the
       reference code itself (``KATs/reference_frozen``) stores the
       reference's aggregate, so this holds the port to it; the JAX
       package's checker compares against a live reference install instead.
    """
    if setup_path is None:
        setup_path = path.parent / path.name.replace("fusion_aggregate", "fusion_setup")
    setup_rows = load_rows(setup_path)
    results = []
    for run, (inp, out) in enumerate(load_rows(path)):
        secpar, seed_a = (int(x) for x in setup_rows[run][0].strip("()").split(", "))
        n_signers = inp.count("OneTimeVerificationKey(")
        params = fusion_setup(secpar, seed_a)
        otks, msgs, sigs = [], [], []
        for i in range(n_signers):
            sk_seed = random.randint(0, 2**32 - 1)
            otks.append(api.keygen(params, sk_seed, device=device))
            msgs.append(str(i))
            sigs.append(api.sign(params, otks[i], msgs[i]))
        otvks = [k[1] for k in otks]
        input_repr = (
            "(" + serial.params_str(params) + ", "
            + "[" + ", ".join(str(v) for v in otvks) + "], "
            + str(msgs) + ", "
            + "[" + ", ".join(str(s) for s in sigs) + "])"
        )
        ok = input_repr == inp
        agg = api.aggregate(params, otvks, msgs, sigs)
        if ok:
            ok = api.verify(params, otvks, msgs, agg)[0]
        results.append(ok and str(agg) == out)
    return results


CHECKERS = {
    "fusion_setup_KAT_128.csv": check_setup,
    "fusion_setup_KAT_256.csv": check_setup,
    "intermediate_hash_message_to_int_KAT_128.csv": check_hash_message_to_int,
    "intermediate_hash_message_to_int_KAT_256.csv": check_hash_message_to_int,
    "intermediate_hash_vk_and_int_to_bytes_to_int_KAT_128.csv": check_hash_vk_and_int_to_bytes,
    "intermediate_hash_vk_and_int_to_bytes_to_int_KAT_256.csv": check_hash_vk_and_int_to_bytes,
    "intermediate_hash_ch_KAT_128.csv": check_hash_ch,
    "intermediate_hash_ch_KAT_256.csv": check_hash_ch,
    "fusion_aggregate_KAT_128.csv": check_aggregate,
    "fusion_aggregate_KAT_256.csv": check_aggregate,
}


def run_all(kat_dir: Path = DEFAULT_KAT_DIR, *, device=None) -> Dict[str, List[bool]]:
    """Run every recognized KAT file present in ``kat_dir`` on ``device``;
    returns {filename: [bool per row]}."""
    dev = resolve_device(device)
    out = {}
    for name, checker in CHECKERS.items():
        p = Path(kat_dir) / name
        if p.exists():
            out[name] = checker(p, device=dev)
    return out


# ---------------------------------------------------------------------------
# Corpus generation (KATs/generate_kat_values.py:28-90 on the port's API)
# ---------------------------------------------------------------------------


def generate_corpus(out_dir, seed: Optional[int], secpars: Sequence[int] = (128, 256),
                    signers: int = 10, *, device=None) -> Dict[str, Path]:
    """Write a KAT corpus into ``out_dir`` with the port's object API on
    ``device`` (the card unless ``device="cpu"``); returns {file name: path}.

    The same calls in the same order as the generator script, so the global
    ``random`` stream is consumed the same way: ``random.seed(seed)`` first
    (when ``seed`` is not None), then per level the setup seed, and one sk
    seed drawn between keygens; the 256 level continues the stream the 128
    level left.  Each file is written whole (the script appends rows)."""
    dev = resolve_device(device)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    rows: Dict[str, list] = {}

    def emit(name: str, row) -> None:
        rows.setdefault(name, []).append(row)

    if seed is not None:
        random.seed(seed)
    for secpar in secpars:
        seed_a = random.randint(0, 2**32 - 1)
        params = api.fusion_setup(secpar, seed_a)
        emit(f"fusion_setup_KAT_{secpar}.csv", [str((secpar, seed_a)), str(params)])

        otks, otvks, msgs, prehashed, challs, sigs = [], [], [], [], [], []
        for i in range(signers):
            sk_seed = random.randint(0, 2**32 - 1)
            msgs.append(str(i))
            otks.append(api.keygen(params, sk_seed, device=dev))
            emit(f"fusion_keygen_KAT_{secpar}.csv", [str((params, sk_seed)), str(otks[-1])])
            otvks.append(otks[i][1])

            prehashed.append(api.hash_message_to_int(params, msgs[i]))
            emit(f"intermediate_hash_message_to_int_KAT_{secpar}.csv",
                 [str((params, msgs[i])), str(prehashed[-1])])

            n = challenge_xof_len(params.secpar, params.degree, params.modulus,
                                  params.beta_ch, params.omega_ch)
            chall_bytes = api.hash_vk_and_int_to_bytes(params, otvks[i], prehashed[i], n)
            emit(f"intermediate_hash_vk_and_int_to_bytes_to_int_KAT_{secpar}.csv",
                 [str((params, otvks[i], prehashed[i], n)), str(chall_bytes)])

            challs.append(api.hash_ch(params, otvks[i], msgs[i]))
            emit(f"intermediate_hash_ch_KAT_{secpar}.csv",
                 [str((params, otvks[i], msgs[i])), str(challs[-1])])

            sigs.append(api.sign(params, otks[i], msgs[i]))
            emit(f"fusion_sign_KAT_{secpar}.csv",
                 [str((params, otks[i], prehashed[i])), str(sigs[-1])])

        # quirk parity: the reference generator hashes the full (sk, vk)
        # tuples here, not just the vks
        agg_bytes = api.hash_vks_and_ints_and_challs_to_bytes(params, otks, prehashed, challs)
        emit(f"intermediate_hash_vks_and_ints_and_challs_to_bytes_KAT_{secpar}.csv",
             [str((params, otks, prehashed, challs)), str(agg_bytes)])

        agg_coefs = api.hash_ag(params, otks, msgs)
        emit(f"intermediate_hash_ag_KAT_{secpar}.csv",
             [str((params, otks, msgs)), str(agg_coefs)])

        agg_sig = api.aggregate(params, otvks, msgs, sigs)
        emit(f"fusion_aggregate_KAT_{secpar}.csv",
             [str((params, otvks, msgs, sigs)), str(agg_sig)])

        ok, why = api.verify(params, otvks, msgs, agg_sig)
        if not ok:
            raise RuntimeError(f"secpar={secpar}: the corpus aggregate does not verify: {why}")

    paths = {}
    for name, name_rows in rows.items():
        paths[name] = out / name
        with open(paths[name], "w", newline="") as f:
            csv.writer(f).writerows(name_rows)
    return paths
