"""The benchmark's plain reference against the frozen KAT corpus
(``KATs/reference_frozen/``, written by the reference implementation):
parameters, keys, challenges, signatures and aggregates byte for byte in
their ``str()`` form, and the verify's verdicts on the corpus aggregate."""
import csv
import re
import sys

import numpy as np
import pytest

from portbench.reference import fusion_ref as ref

from conftest import ROOT

KATS = ROOT / "KATs" / "reference_frozen"
csv.field_size_limit(sys.maxsize)


def rows(name):
    with open(KATS / name, newline="") as f:
        return [(r[0], r[1]) for r in csv.reader(f)]


def params_of(secpar):
    (inp, out), = rows(f"fusion_setup_KAT_{secpar}.csv")
    level, seed = (int(x) for x in inp.strip("()").split(", "))
    return ref.setup(level, seed), out


def values(text):
    return [np.array([int(x) for x in m.split(", ")])
            for m in re.findall(r"values=\[([-0-9, ]*)\]", text)]


@pytest.mark.parametrize("secpar", [128, 256])
def test_setup_str(secpar):
    p, out = params_of(secpar)
    assert ref.params_str(p) == out


@pytest.mark.parametrize("secpar", [128, 256])
def test_keygen_and_sign_str(secpar):
    p, _ = params_of(secpar)
    keygen = rows(f"fusion_keygen_KAT_{secpar}.csv")
    for i, ((kin, kout), (sin, sout)) in enumerate(zip(keygen, rows(f"fusion_sign_KAT_{secpar}.csv"))):
        seed = int(re.search(r", (\d+)\)$", kin).group(1))
        sk_hat, vk = ref.keygen(p, seed)
        assert f"({ref.sk_str(p, seed, sk_hat)}, {ref.vk_str(p, vk)})" == kout
        assert ref.sig_str(p, ref.sign(p, sk_hat, vk, str(i))) == sout


@pytest.mark.parametrize("secpar", [128, 256])
def test_challenge_str(secpar):
    p, _ = params_of(secpar)
    for inp, out in rows(f"intermediate_hash_ch_KAT_{secpar}.csv"):
        vk = np.stack(values(inp[inp.index("OneTimeVerificationKey("):])[:2])
        msg = re.search(r", '([^']*)'\)$", inp).group(1)
        c_hat = ref.challenges(p, [ref.vk_str(p, vk)], [ref.prehash(p, msg)])[0]
        assert ref.challenge_str(p, c_hat) == out


@pytest.mark.parametrize("secpar", [128, 256])
def test_prehash_and_challenge_bytes(secpar):
    p, _ = params_of(secpar)
    for inp, out in rows(f"intermediate_hash_message_to_int_KAT_{secpar}.csv"):
        msg = re.search(r", '([^']*)'\)$", inp).group(1)
        assert str(ref.prehash(p, msg)) == out
    for inp, out in rows(f"intermediate_hash_vk_and_int_to_bytes_to_int_KAT_{secpar}.csv"):
        i, n = (int(x) for x in re.search(r", (\d+), (\d+)\)$", inp).groups())
        vk = np.stack(values(inp[inp.index("OneTimeVerificationKey("):])[:2])
        assert n == ref.challenge_len(p)
        from hashlib import shake_256
        got = shake_256(p.ch_dst + b"," + ref.vk_str(p, vk).encode() + b"," + str(i).encode())
        assert str(got.digest(n)) == out


@pytest.mark.parametrize("secpar", [128, 256])
def test_aggregate_str_and_verdicts(secpar):
    p, _ = params_of(secpar)
    (inp, out), = rows(f"fusion_aggregate_KAT_{secpar}.csv")
    n = inp.count("OneTimeVerificationKey(")
    seeds = [int(re.search(r", (\d+)\)$", k).group(1))
             for k, _ in rows(f"fusion_keygen_KAT_{secpar}.csv")][:n]
    keys = [ref.keygen(p, s) for s in seeds]
    msgs = [str(i) for i in range(n)]
    sigs = [ref.sign(p, sk, vk, m) for (sk, vk), m in zip(keys, msgs)]
    agg = ref.aggregate(p, [vk for _, vk in keys], msgs, sigs)
    assert ref.sig_str(p, agg) == out
    stored = np.stack(values(out))
    assert np.array_equal(stored, agg)
    vks = np.stack([vk for _, vk in keys])[None]
    assert ref.verify_groups(p, vks, [msgs], stored[None]).tolist() == [[True, True, True]]
    # signers in another order verify alike; a changed coefficient or message does not
    assert ref.verify_groups(p, vks[:, ::-1], [msgs[::-1]], stored[None]).all()
    bad = stored.copy()
    bad[1, 2] += 1
    assert ref.verify_groups(p, vks, [msgs], bad[None]).tolist() == [[False, False, True]]
    assert not ref.verify_groups(p, vks, [["x"] + msgs[1:]], stored[None])[0, 0]


def test_ntt_round_trip():
    p = ref.setup(256, 42)
    x = np.random.default_rng(0).integers(-p.modulus // 2, p.modulus // 2, size=(3, p.degree))
    assert np.array_equal(ref.intt(p, ref.ntt(p, x)), x)


def test_control_is_wrong():
    """The control (float64 products) breaks what the exact reference keeps."""
    p, _ = params_of(256)
    (inp, out), = rows("fusion_aggregate_KAT_256.csv")
    seeds = [int(re.search(r", (\d+)\)$", k).group(1)) for k, _ in rows("fusion_keygen_KAT_256.csv")]
    n = inp.count("OneTimeVerificationKey(")
    vks = np.stack([ref.keygen(p, s)[1] for s in seeds[:n]])[None]
    msgs = [[str(i) for i in range(n)]]
    stored = np.stack(values(out))[None]
    assert ref.verify_groups(p, vks, msgs, stored).all()
    assert not ref.verify_groups(ref.control(p), vks, msgs, stored).all()
    sk_hat, vk = ref.keygen(p, seeds[0])
    c_sk, c_vk = ref.keygen(ref.control(p), seeds[0])
    assert not np.array_equal(vk, c_vk)
