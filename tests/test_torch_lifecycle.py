"""The port's batched lifecycle (scheme/lifecycle.py) on the CPU vs the JAX
package's (the counterpart of tests/test_scheme.py): keys, signatures and
aggregates bit-identical, the same verdicts and reason strings, and each
side verifying the other's aggregates."""
import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import fusion_cryptography_tpu as ftpu
from fusion_cryptography_tpu.interop import serial as jserial
from fusion_cryptography_tpu.scheme import lifecycle as jlc
import fusion_cryptography_tpu_torch as ft
from fusion_cryptography_tpu_torch.interop import serial as tserial
from fusion_cryptography_tpu_torch.scheme import lifecycle as tlc

SEEDS = [7, 1000, 999999, 5]
MSGS = ["alpha", "beta", "gamma", "delta"]


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


@pytest.fixture(scope="module")
def life128():
    """Four keys and signatures at secpar=128 from both packages."""
    jp = ftpu.fusion_setup(128, 42)
    p = ft.params_from_numpy(jp)
    jkeys = ftpu.keygen(jp, SEEDS)
    jsigs = ftpu.sign(jp, jkeys, MSGS)
    tkeys = ft.keygen(p, SEEDS, device="cpu")
    tsigs = ft.sign(p, tkeys, MSGS)
    agg = ft.aggregate(p, tkeys.vk, MSGS, tsigs.sig)
    return jp, p, jkeys, jsigs, tkeys, tsigs, agg


def test_keys_and_signatures_equal_jax(life128):
    jp, p, jkeys, jsigs, tkeys, tsigs, _ = life128
    B, d, rank = len(SEEDS), p.degree, p.rank
    assert tkeys.sk_hat.shape == (B, 2, rank, d) and tkeys.sk_hat.dtype == torch.int32
    assert tkeys.vk.shape == (B, 2, d) and tsigs.sig.shape == (B, rank, d)
    assert tkeys.seeds == SEEDS and len(tkeys) == len(tsigs) == B
    np.testing.assert_array_equal(_np(tkeys.sk_hat), np.asarray(jkeys.sk_hat))
    np.testing.assert_array_equal(tkeys.vk_np(), jkeys.vk_np())
    np.testing.assert_array_equal(_np(tsigs.sig), np.asarray(jsigs.sig))
    sk = _np(tkeys.sk_hat)
    assert np.all(sk == sk[:, :, :1, :])  # per-entry reseed quirk: rank entries identical
    assert tkeys.vk_strs() == jkeys.vk_strs()
    c_hat = np.asarray(jsigs.sig)[0, 0]
    assert tserial.challenge_str(p, c_hat) == jserial.challenge_str(jp, c_hat)


def test_keygen_rejects_none_and_leaves_random_like_jax(life128):
    jp, p = life128[:2]
    with pytest.raises(TypeError):
        ft.keygen(p, [3, None], device="cpu")
    ftpu.keygen(jp, [11, 12])
    want = random.random()
    ft.keygen(p, [11, 12], device="cpu")
    assert random.random() == want


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_subset_aggregates_equal_jax_and_verify(life128, n):
    jp, p, jkeys, jsigs, tkeys, tsigs, _ = life128
    agg = ft.aggregate(p, tkeys.vk[:n], MSGS[:n], tsigs.sig[:n])
    assert agg.shape == (p.rank, p.degree) and agg.dtype == torch.int32
    want = jlc.aggregate(jp, jkeys.vk_np()[:n], MSGS[:n], jsigs.sig[:n])
    np.testing.assert_array_equal(agg.numpy(), np.asarray(want))
    assert ft.verify(p, tkeys.vk[:n], MSGS[:n], agg) == (True, "")


def test_order_invariance_and_cross_verification(life128):
    jp, p, jkeys, jsigs, tkeys, tsigs, agg = life128
    perm = [2, 0, 3, 1]
    agg2 = ft.aggregate(p, tkeys.vk[perm], [MSGS[i] for i in perm], tsigs.sig[perm])
    assert torch.equal(agg, agg2)
    assert ft.verify(p, tkeys.vk[perm], [MSGS[i] for i in perm], agg) == (True, "")
    # JAX verifies the port's aggregate; the port verifies JAX's (numpy inputs)
    assert jlc.verify(jp, jkeys.vk_np(), MSGS, jnp.asarray(agg.numpy())) == (True, "")
    jagg = np.asarray(jlc.aggregate(jp, jkeys.vk_np(), MSGS, jsigs.sig))
    assert ft.verify(p, jkeys.vk_np(), MSGS, jagg, device="cpu") == (True, "")


def _over_norm(p, agg):
    """An aggregate whose image A·z is unchanged (every rank entry of A is the
    same polynomial) but whose first row holds a coefficient near q/2."""
    z = agg.numpy().astype(np.int64)
    c = p.modulus // 2  # NTT of the constant polynomial c: every value c
    z[0] += c
    z[1] -= c
    z %= p.modulus
    return np.where(z > p.modulus // 2, z - p.modulus, z).astype(np.int32)


def _case(p, tkeys, agg, case):
    vk, msgs, a = tkeys.vk_np(), list(MSGS), agg.numpy().copy()
    if case.startswith("tamper"):
        rng = np.random.default_rng(int(case[-1]))
        a[rng.integers(0, a.shape[0]), rng.integers(0, a.shape[1])] += 1
    elif case == "wrong_message":
        msgs[0] = "tampered"
    elif case == "length":
        msgs = msgs[:-1]
    elif case == "capacity":
        vk = np.repeat(vk, p.capacity // 4 + 1, axis=0)
        msgs = ["m"] * len(vk)
    elif case == "norm":
        a = _over_norm(p, agg)
    return vk, msgs, a


REASONS = {"tamper0": jlc.REASON_TARGET, "tamper1": jlc.REASON_TARGET,
           "tamper2": jlc.REASON_TARGET, "wrong_message": jlc.REASON_TARGET,
           "length": jlc.REASON_LEN_MISMATCH, "capacity": jlc.REASON_TOO_MANY,
           "norm": jlc.REASON_NORM}


@pytest.mark.parametrize("case", sorted(REASONS))
def test_failure_reasons_equal_jax(life128, case):
    jp, p, _, _, tkeys, _, agg = life128
    vk, msgs, a = _case(p, tkeys, agg, case)
    got = ft.verify(p, vk, msgs, a, device="cpu")
    assert got == (False, REASONS[case])
    assert got == jlc.verify(jp, vk, msgs, jnp.asarray(a))
    assert tlc.REASON_TARGET == jlc.REASON_TARGET and tlc.REASON_NORM == jlc.REASON_NORM


def test_verify_many_matches_jax(life128):
    jp, p = life128[:2]
    msgs = ["m1", "m2", "m3", "m4", "m5"]
    keys = ft.keygen(p, [201, 202, 203, 204, 205], device="cpu")
    sigs = ft.sign(p, keys, msgs)
    vk = keys.vk
    agg2 = ft.aggregate(p, vk[:2], msgs[:2], sigs.sig[:2]).numpy()
    agg3 = ft.aggregate(p, vk[2:], msgs[2:], sigs.sig[2:]).numpy()
    bad = agg3.copy()
    bad[0, 0] += 1
    groups = [
        (vk[:2], msgs[:2], agg2),  # valid, N=2
        (vk[2:], msgs[2:], agg3),  # valid, N=3
        (vk[2:], msgs[2:], bad),  # tampered
        (vk[:2], ["m1"], agg2),  # length mismatch
        (vk[[1, 0]], msgs[1::-1], agg2),  # valid, signers in the other order
    ]
    got = ft.verify_many(p, groups)
    assert got == [(True, ""), (True, ""), (False, jlc.REASON_TARGET),
                   (False, jlc.REASON_LEN_MISMATCH), (True, "")]
    jgroups = [(g[0].numpy(), g[1], jnp.asarray(g[2])) for g in groups]
    assert got == jlc.verify_many(jp, jgroups)


def test_verify_batch_matches_jax(life128):
    """Three groups of two from JAX's keys and coefficients, the middle one
    tampered."""
    jp, p = life128[:2]
    G, N = 3, 2
    vks, ccs, als, aggs = [], [], [], []
    for g in range(G):
        keys = ftpu.keygen(jp, [100 * g + 1, 100 * g + 2])
        msgs = [f"g{g}m{i}" for i in range(N)]
        sigs = ftpu.sign(jp, keys, msgs)
        reprs = keys.vk_strs()
        order = sorted(range(N), key=lambda i: reprs[i])
        _, cc, al = jlc.derive_alphas(jp, [reprs[i] for i in order], [msgs[i] for i in order])
        agg = jlc._ctx(jp)["aggregate_core"](jnp.asarray(np.asarray(sigs.sig)[order]),
                                              jnp.asarray(al))
        vks.append(keys.vk_np()[order])
        ccs.append(cc)
        als.append(al)
        aggs.append(np.asarray(agg))
    aggs[1] = aggs[1].copy()
    aggs[1][0, 0] += 1
    args = [np.stack(x) for x in (vks, ccs, als, aggs)]
    got = ft.verify_batch(p, *(torch.from_numpy(x) for x in args))
    want = jlc.verify_batch(jp, *(jnp.asarray(x) for x in args))
    for g, w in zip(got, want):
        assert g.dtype == torch.bool and g.shape == (G,)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].tolist() == [True, False, True]
    # int8 coefficients, numpy inputs on the CPU when asked
    got8 = ft.verify_batch(p, args[0], args[1].astype(np.int8), args[2].astype(np.int8),
                           args[3], device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(got, got8))


def test_port_signs_jax_keys(life128):
    jp, p, jkeys, jsigs = life128[:4]
    keys = ft.key_batch_from_numpy(p, jkeys, device="cpu")
    assert keys.seeds == SEEDS
    np.testing.assert_array_equal(_np(ft.sign(p, keys, MSGS).sig), np.asarray(jsigs.sig))


def test_lifecycle_256():
    jp = ftpu.fusion_setup(256, 99)
    p = ft.params_from_numpy(jp)
    msgs = ["x", "y"]
    jkeys = ftpu.keygen(jp, [1, 2])
    jsigs = ftpu.sign(jp, jkeys, msgs)
    jagg = np.asarray(jlc.aggregate(jp, jkeys.vk_np(), msgs, jsigs.sig))
    keys = ft.keygen(p, [1, 2], device="cpu")
    sigs = ft.sign(p, keys, msgs)
    agg = ft.aggregate(p, keys.vk, msgs, sigs.sig)
    np.testing.assert_array_equal(_np(keys.sk_hat), np.asarray(jkeys.sk_hat))
    np.testing.assert_array_equal(keys.vk_np(), jkeys.vk_np())
    np.testing.assert_array_equal(_np(sigs.sig), np.asarray(jsigs.sig))
    np.testing.assert_array_equal(agg.numpy(), jagg)
    assert ft.verify(p, keys.vk, msgs, agg) == (True, "")
