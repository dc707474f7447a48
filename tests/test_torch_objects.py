"""The port's object API on the CPU vs the JAX package's: the polynomial and
matrix objects (interop/objects.py, algebra/*) operation by operation by
their ``str()``, the list-level NTT surface, ``fusion.fusion``, and the
``interop/api`` lifecycle at secpar=128 (keygen, the hash pipeline, sign,
hash_ag, aggregate, verify with each reason string), with the lifecycle
pieces it stands on (``derive_alphas``, ``sign_from_c_hat``,
``aggregate_from_alpha_hat``)."""
import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fusion_cryptography_tpu.algebra import ntt as jntt
from fusion_cryptography_tpu.fusion import fusion as jfusion
from fusion_cryptography_tpu.interop import api as japi
from fusion_cryptography_tpu.interop import objects as jobj
from fusion_cryptography_tpu.scheme import lifecycle as jlc
from fusion_cryptography_tpu_torch.algebra import matrices as tmat
from fusion_cryptography_tpu_torch.algebra import ntt as tntt
from fusion_cryptography_tpu_torch.algebra import polynomials as tpoly
from fusion_cryptography_tpu_torch.fusion import fusion as tfusion
from fusion_cryptography_tpu_torch.interop import api as tapi
from fusion_cryptography_tpu_torch.interop import serial as tserial
from fusion_cryptography_tpu_torch.scheme import lifecycle as tlc

Q = 2147465729
RING = dict(modulus=Q, degree=64, root=23584283, inv_root=pow(23584283, Q - 2, Q),
            root_order=128)


class _Side:
    """One package's classes, with the port's built on the CPU."""

    def __init__(self, mod, matrix, **kw):
        self.mod, self.matrix, self.kw = mod, matrix, kw

    def coef(self, vals):
        return self.mod.PolynomialCoefficientRepresentation(**RING, coefficients=list(vals),
                                                            **self.kw)

    def ntt(self, vals):
        return self.mod.PolynomialNTTRepresentation(**RING, values=list(vals), **self.kw)


JAX, PORT = _Side(jobj, jobj.GeneralMatrix), _Side(tpoly, tmat.GeneralMatrix, device="cpu")


def _vals(seed, lo=-(Q // 2), hi=Q // 2 + 1):
    rng = random.Random(seed)
    out = [rng.randrange(lo, hi) for _ in range(64)]
    out[:4] = [0, 1, -1, Q // 2]
    return out


# each op builds its operands from one package's classes and returns an object
OPS = {
    "coef_repr": lambda s: s.coef(_vals(1)),
    "coef_add": lambda s: s.coef(_vals(1)) + s.coef(_vals(2)),
    "coef_sub": lambda s: s.coef(_vals(1)) - s.coef(_vals(2)),
    "coef_neg": lambda s: -s.coef(_vals(3)),
    "coef_radd_zero": lambda s: 0 + s.coef(_vals(4)),
    "coef_mul": lambda s: s.coef(_vals(5)) * s.coef(_vals(6)),
    "coef_mul_small": lambda s: s.coef(_vals(5, -9, 10)) * s.coef(_vals(6, -3, 4)),
    "coef_mul_one": lambda s: s.coef(_vals(7)) * 1,
    "coef_unreduced": lambda s: s.coef([v + 3 * Q for v in _vals(8)]) + s.coef(_vals(9)),
    "ntt_repr": lambda s: s.ntt(_vals(10)),
    "ntt_add": lambda s: s.ntt(_vals(10)) + s.ntt(_vals(11)),
    "ntt_sub": lambda s: s.ntt(_vals(10)) - s.ntt(_vals(11)),
    "ntt_neg": lambda s: -s.ntt(_vals(12)),
    "ntt_mul": lambda s: s.ntt(_vals(13)) * s.ntt(_vals(14)),
    "ntt_add_zero_poly": lambda s: s.ntt(_vals(15)) + s.ntt([0] * 64),
    "transform": lambda s: s.mod.transform(s.coef(_vals(16))),
    "inverse_transform": lambda s: s.mod.transform(s.ntt(_vals(17))),
    "sample_coef": lambda s: s.mod.sample_polynomial_coefficient_representation(
        **RING, norm_bound=52, weight_bound=40, seed=77, **s.kw),
    "sample_ntt": lambda s: s.mod.sample_polynomial_ntt_representation(**RING, seed=78, **s.kw),
    "matrix": lambda s: _matrix(s, 20),
    "matrix_add": lambda s: _matrix(s, 20) + _matrix(s, 30),
    "matrix_sub": lambda s: _matrix(s, 20) - _matrix(s, 30),
    "matrix_mul": lambda s: _matrix(s, 20) * _matrix(s, 30),
    "matrix_scalar": lambda s: _matrix(s, 20) * s.coef(_vals(40)),
    "ntt_matrix_mul": lambda s: _matrix(s, 50, s.ntt) * _matrix(s, 60, s.ntt),
}


def _matrix(s, seed, make=None):
    make = make or s.coef
    return s.matrix([[make(_vals(seed + 2 * i + j)) for j in range(2)] for i in range(2)])


@pytest.mark.parametrize("op", sorted(OPS))
def test_object_str_equals_jax(op):
    got, want = OPS[op](PORT), OPS[op](JAX)
    assert str(got) == str(want) and repr(got) == repr(want)
    for poly in (got.matrix if hasattr(got, "matrix") else [[got]]):
        for x in poly:
            t = x.coefficients if hasattr(x, "coefficients") else x.values
            assert isinstance(t, torch.Tensor) and t.device.type == "cpu"


def test_object_predicates_equal_jax():
    res = []
    for s in (JAX, PORT):
        a = s.coef(_vals(1))
        res.append((
            a == s.coef([v + Q for v in _vals(1)]), a == s.coef(_vals(2)), a == 0,
            s.ntt([0] * 64) == 0, s.ntt(_vals(3)) == s.ntt([v - Q for v in _vals(3)]),
            hash(a) == hash(s.coef([v + Q for v in _vals(1)])),
            s.coef([3, -7] + [0] * 62).norm(p="infty"), s.coef([3, -7] + [0] * 62).weight(),
            _matrix(s, 5).norm(p="infty"), _matrix(s, 5).weight(), _matrix(s, 5).norm(p=2),
            _matrix(s, 5) == _matrix(s, 5), (_matrix(s, 5) - _matrix(s, 5)) == 0,
            repr(type(a)), repr(type(s.ntt(_vals(1)))), repr(type(_matrix(s, 5))),
        ))
    assert res[0] == res[1]


BAD = {
    "modulus_type": lambda s: s.mod.PolynomialCoefficientRepresentation(
        **{**RING, "modulus": "x"}, coefficients=[0] * 64, **s.kw),
    "short": lambda s: s.coef([0] * 63),
    "floats": lambda s: s.mod.PolynomialCoefficientRepresentation(
        **RING, coefficients=[0.5] * 64, **s.kw),
    "root_order": lambda s: s.mod.PolynomialNTTRepresentation(
        **{**RING, "root_order": 127}, values=[0] * 64, **s.kw),
    "not_primitive": lambda s: s.mod.PolynomialCoefficientRepresentation(
        **{**RING, "root": pow(RING["root"], 2, Q), "inv_root": pow(RING["root"], 2 * (Q - 2), Q)},
        coefficients=[0] * 64, **s.kw),
    "mixed_ring_add": lambda s: s.coef(_vals(1)) + s.ntt(_vals(1)),
    "matrix_ragged": lambda s: s.matrix([[s.coef(_vals(1))], []]),
    "norm_p2": lambda s: s.coef(_vals(1)).norm(p=2),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_validation_errors_equal_jax(case):
    errors = []
    for s in (JAX, PORT):
        with pytest.raises(Exception) as info:
            BAD[case](s)
        errors.append((type(info.value), str(info.value)))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("q,d,psi", [(17, 8, None), (Q, 64, RING["root"])])
def test_list_level_ntt_equals_jax(q, d, psi):
    psi = psi or jntt.find_primitive_root(q, 2 * d)  # a search: slow for the Fusion prime
    inv_psi = pow(psi, q - 2, q)
    brp = jntt.bit_reverse_copy([pow(psi, i, q) for i in range(d)])
    brpi = jntt.bit_reverse_copy([pow(inv_psi, i, q) for i in range(d)])
    rng = random.Random(q + d)
    f = [rng.randrange(-(q // 2), q // 2 + 1) for _ in range(d)]
    g = [rng.randrange(-3 * q, 3 * q) for _ in range(d)]
    ours = tntt.cooley_tukey_ntt(list(f), q, 2 * d, brp, device="cpu")
    assert ours == jntt.cooley_tukey_ntt(list(f), q, 2 * d, brp)
    assert tntt.gentleman_sande_intt(list(ours), q, 2 * d, brpi, device="cpu") == \
        jntt.gentleman_sande_intt(list(ours), q, 2 * d, brpi)
    f1, g1, f2, g2 = list(f), list(g), list(f), list(g)
    assert tntt.ntt_poly_mult(f1, g1, q, psi, inv_psi, 2 * d, device="cpu") == \
        jntt.ntt_poly_mult(f2, g2, q, psi, inv_psi, 2 * d)
    assert f1 == f2 and g1 == g2  # the reference's in-place side effect
    assert tntt.cent(12345678901234567890, 17, 8, 5) == jntt.cent(12345678901234567890, 17, 8, 5)
    with pytest.raises(TypeError):
        tntt.cent(1.5, 17, 8, 5)


def test_fusion_surface_equals_jax():
    assert tfusion.PREFIX_PARAMETERS == jfusion.PREFIX_PARAMETERS
    assert set(tfusion.__all__) == set(jfusion.__all__)
    assert str(tfusion.fusion_setup(256, 5)) == str(jfusion.fusion_setup(256, 5))


# ---------------------------------------------------------------------------
# interop/api at secpar=128
# ---------------------------------------------------------------------------

SEEDS = [7, 1000, 424242]
MSGS = ["alpha", "beta", "gamma"]


@pytest.fixture(scope="module")
def api128():
    jp, p = japi.fusion_setup(128, 42), tapi.fusion_setup(128, 42)
    jkeys = [japi.keygen(jp, s) for s in SEEDS]
    tkeys = [tapi.keygen(p, s, device="cpu") for s in SEEDS]
    jsigs = [japi.sign(jp, k, m) for k, m in zip(jkeys, MSGS)]
    tsigs = [tapi.sign(p, k, m) for k, m in zip(tkeys, MSGS)]
    jagg = japi.aggregate(jp, [k[1] for k in jkeys], MSGS, jsigs)
    tagg = tapi.aggregate(p, [k[1] for k in tkeys], MSGS, tsigs)
    return jp, p, jkeys, tkeys, jsigs, tsigs, jagg, tagg


def test_api_lifecycle_str_equals_jax(api128):
    jp, p, jkeys, tkeys, jsigs, tsigs, jagg, tagg = api128
    assert str(p) == str(jp) and repr((p, 1)) == repr((jp, 1))
    for jk, tk in zip(jkeys, tkeys):
        assert str(tk) == str(jk)  # the (sk, vk) tuple repr
        assert tk[0].sk_hat.device.type == "cpu" and tk[0].seed == jk[0].seed
    assert [str(s) for s in tsigs] == [str(s) for s in jsigs]
    assert str(tagg) == str(jagg) and tagg.signature_hat.device.type == "cpu"
    # the reversed order aggregates to the same signature
    rev = tapi.aggregate(p, [k[1] for k in tkeys][::-1], MSGS[::-1], tsigs[::-1])
    assert str(rev) == str(tagg)


def test_api_hash_pipeline_equals_jax(api128):
    jp, p, jkeys, tkeys = api128[:4]
    jvk, tvk = jkeys[0][1], tkeys[0][1]
    assert tapi.hash_message_to_int(p, "m") == japi.hash_message_to_int(jp, "m")
    i = japi.hash_message_to_int(jp, "m")
    assert tapi.hash_vk_and_int_to_bytes(p, tvk, i, 500) == japi.hash_vk_and_int_to_bytes(jp, jvk, i, 500)
    tch, jch = tapi.hash_ch(p, tvk, "m"), japi.hash_ch(jp, jvk, "m")
    assert str(tch) == str(jch) and tch.c_hat.device.type == "cpu"
    n = 2000
    b = japi.hash_vk_and_int_to_bytes(jp, jvk, i, n)
    assert tapi.parse_challenge(p, b, device="cpu") == tch.__class__(p, tapi.parse_challenge(
        p, b, device="cpu").c_hat)
    assert str(tapi.parse_challenge(p, b, device="cpu")) == str(japi.parse_challenge(jp, b))
    with pytest.raises(ValueError):
        tapi.parse_challenge(p, b[:10], device="cpu")
    args = (b, 128, Q, 64, 1, 27)
    assert tapi.decode_bytes_to_polynomial_coefficients(*args) == \
        japi.decode_bytes_to_polynomial_coefficients(*args)
    # hash_ag over (sk, vk) tuples, as the KAT generator calls it
    tag, jag = tapi.hash_ag(p, tkeys, MSGS), japi.hash_ag(jp, jkeys, MSGS)
    assert str(tag) == str(jag)
    pre = [japi.hash_message_to_int(jp, m) for m in MSGS]
    challs = [japi.hash_ch(jp, k[1], m) for k, m in zip(jkeys, MSGS)]
    tb = tapi.hash_vks_and_ints_and_challs_to_bytes(p, tkeys, pre, [str(c) for c in challs])
    assert tb == japi.hash_vks_and_ints_and_challs_to_bytes(jp, jkeys, pre, challs)
    assert [str(a) for a in tapi.decode_bytes_to_agg_coefs(p, tb, device="cpu")] == \
        [str(a) for a in japi.decode_bytes_to_agg_coefs(jp, tb)]


def _over_norm(p, agg):
    """An aggregate whose image A·z is unchanged (every rank entry of A is the
    same polynomial) but whose first row holds a coefficient near q/2."""
    z = np.asarray(agg).astype(np.int64)
    z[0] += p.modulus // 2
    z[1] -= p.modulus // 2
    z %= p.modulus
    return np.where(z > p.modulus // 2, z - p.modulus, z).astype(np.int32)


@pytest.mark.parametrize("case", ["valid", "tampered", "wrong_message", "length", "capacity",
                                  "norm"])
def test_api_verify_reasons_equal_jax(api128, case):
    jp, p, jkeys, tkeys, _, _, jagg, tagg = api128
    out = []
    for api, params, keys, agg in ((japi, jp, jkeys, jagg), (tapi, p, tkeys, tagg)):
        vks, msgs = [k[1] for k in keys], list(MSGS)
        a = np.array(agg.signature_hat.cpu() if isinstance(agg.signature_hat, torch.Tensor)
                     else agg.signature_hat)
        if case == "tampered":
            a[5, 7] += 1
        elif case == "wrong_message":
            msgs[1] = "tampered"
        elif case == "length":
            msgs = msgs[:-1]
        elif case == "capacity":
            vks = vks[:1] * (params.capacity + 1)
            msgs = ["m"] * len(vks)
        elif case == "norm":
            a = _over_norm(params, a)
        kw = {"device": "cpu"} if api is tapi else {}
        out.append(api.verify(params, vks, msgs, api.Signature(params, a, **kw)))
    assert out[0] == out[1]
    want = {"valid": "", "tampered": jlc.REASON_TARGET, "wrong_message": jlc.REASON_TARGET,
            "length": jlc.REASON_LEN_MISMATCH, "capacity": jlc.REASON_TOO_MANY,
            "norm": jlc.REASON_NORM}[case]
    assert out[1] == (case == "valid", want)


def test_lifecycle_pieces_equal_jax(api128):
    """derive_alphas with (sk, vk) tuple reprs, sign_from_c_hat and
    aggregate_from_alpha_hat against the JAX package's."""
    jp, p, jkeys, tkeys = api128[:4]
    reprs = [str(k) for k in tkeys]
    vk_reprs = [str(k[1]) for k in tkeys]
    pre, cc, al = tlc.derive_alphas(p, vk_reprs, MSGS, key_reprs=reprs, device="cpu")
    jpre, jcc, jal = jlc.derive_alphas(jp, vk_reprs, MSGS, key_reprs=reprs)
    assert pre == jpre and cc.device.type == "cpu"
    np.testing.assert_array_equal(cc.numpy(), np.asarray(jcc))
    np.testing.assert_array_equal(al.numpy(), np.asarray(jal))
    _, cc_vk, _ = tlc.derive_alphas(p, vk_reprs, MSGS, device="cpu")
    np.testing.assert_array_equal(cc_vk.numpy(), np.asarray(jlc.derive_alphas(jp, vk_reprs, MSGS)[1]))
    ctx = jlc._ctx(jp)
    sk = np.stack([np.asarray(k[0].sk_hat) for k in jkeys])
    c_hat = np.stack([np.asarray(japi.hash_ch(jp, k[1], m).c_hat) for k, m in zip(jkeys, MSGS)])
    sig = tlc.sign_from_c_hat(p, torch.from_numpy(sk), torch.from_numpy(c_hat))
    np.testing.assert_array_equal(sig.numpy(), np.asarray(ctx["sign_from_c_hat"](
        jnp.asarray(sk), jnp.asarray(c_hat))))
    alpha_hat = c_hat[::-1].copy()  # any NTT-domain values
    agg = tlc.aggregate_from_alpha_hat(p, sig, torch.from_numpy(alpha_hat))
    np.testing.assert_array_equal(agg.numpy(), np.asarray(ctx["aggregate_from_alpha_hat"](
        jnp.asarray(sig.numpy()), jnp.asarray(alpha_hat))))
    assert tserial.sig_str(p, agg) == str(japi.Signature(jp, np.asarray(agg)))
