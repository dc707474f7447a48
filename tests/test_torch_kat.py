"""The port's KAT harness (interop/kat.py) on the CPU: the corpus it
generates through the object API is byte-equal to the frozen reference
corpus ``KATs/reference_frozen/`` (all 18 files, seed 20260820, 3 signers
per level), and its checkers accept that corpus and reject a corrupted
row.  The JAX package's twin is tests/test_kat_frozen.py; chip_smoke.py runs
the same on the card."""
import csv
import filecmp
import random
import shutil
from pathlib import Path

import pytest

from fusion_cryptography_tpu_torch.interop import kat

FROZEN = Path(__file__).resolve().parent.parent / "KATs" / "reference_frozen"


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    out = tmp_path_factory.mktemp("kat")
    state = random.getstate()
    try:
        paths = kat.generate_corpus(out, 20260820, (128, 256), 3, device="cpu")
    finally:
        random.setstate(state)
    return out, paths


def test_generated_corpus_equals_frozen(corpus):
    out, paths = corpus
    names = sorted(p.name for p in FROZEN.glob("*.csv"))
    assert len(names) == 18 and sorted(paths) == names
    bad = [n for n in names if not filecmp.cmp(FROZEN / n, out / n, shallow=False)]
    assert not bad, f"byte drift vs the reference-generated corpus: {bad}"


def test_run_all_accepts_the_frozen_corpus():
    state = random.getstate()
    try:
        res = kat.run_all(FROZEN, device="cpu")
    finally:
        random.setstate(state)
    assert sorted(res) == sorted(kat.CHECKERS)
    assert all(rows and all(rows) for rows in res.values()), res


def test_checkers_reject_a_corrupted_row(tmp_path):
    """One changed digit in an output: the hash_ch and aggregate checkers
    (the latter replays keygen, sign and aggregate) report that row."""
    for name in ("intermediate_hash_ch_KAT_128.csv", "fusion_aggregate_KAT_128.csv",
                 "fusion_setup_KAT_128.csv"):
        shutil.copy(FROZEN / name, tmp_path / name)
    for name, checker in (("intermediate_hash_ch_KAT_128.csv", kat.check_hash_ch),
                          ("fusion_aggregate_KAT_128.csv", kat.check_aggregate)):
        rows = kat.load_rows(tmp_path / name)
        inp, out = rows[-1]
        i = out.index("values=[") + len("values=[")
        rows[-1] = (inp, out[:i] + ("1" if out[i] != "1" else "2") + out[i + 1:])
        with open(tmp_path / name, "w", newline="") as f:
            csv.writer(f).writerows(rows)
        state = random.getstate()
        try:
            got = checker(tmp_path / name, device="cpu")
        finally:
            random.setstate(state)
        assert got == [True] * (len(rows) - 1) + [False], name
