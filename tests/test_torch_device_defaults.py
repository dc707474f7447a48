"""The port's entry points run on the card unless asked for the CPU: without a
card a call that names no device raises, nothing falls back to the CPU, and
``device="cpu"`` (or CPU tensors, for the entry points that take tensors)
runs there."""
import numpy as np
import pytest
import torch

import fusion_cryptography_tpu_torch as ft
from fusion_cryptography_tpu_torch import (build_fleet, derive_coeffs_device,
                                           fusion_setup, verify_batch_device)


@pytest.fixture
def no_card(monkeypatch):
    """A machine without a CUDA device, whatever this one has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture(scope="module")
def fleet():
    params = fusion_setup(128, 5)
    return params, build_fleet(params, 2, 2, seed0=3, device="cpu")


def test_build_fleet_defaults_to_the_card(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_fleet(fusion_setup(128, 5), 1, 2)


@pytest.mark.parametrize("entry", [verify_batch_device, derive_coeffs_device])
def test_numpy_inputs_go_to_the_card(no_card, fleet, entry):
    params, (vks, msgs, aggs) = fleet
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry(params, vks.numpy(), msgs, aggs.numpy())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry(params, vks, msgs, aggs, device="cuda")


@pytest.mark.parametrize("entry", [verify_batch_device, derive_coeffs_device])
def test_cpu_when_asked(no_card, fleet, entry):
    params, (vks, msgs, aggs) = fleet
    assert vks.device.type == "cpu" and aggs.device.type == "cpu"
    from_numpy = entry(params, vks.numpy(), msgs, aggs.numpy(), device="cpu")
    from_tensors = entry(params, vks, msgs, aggs)
    for a, b in zip(from_numpy, from_tensors):
        assert a.device.type == "cpu" and torch.equal(a, b)
    assert all(bool(t.all()) for t in from_tensors[:3])


def test_build_fleet_on_the_cpu_when_asked(no_card, fleet):
    params, (vks, msgs, aggs) = fleet
    v2, m2, a2 = build_fleet(params, 2, 2, seed0=3, device="cpu")
    assert v2.device.type == "cpu" and a2.device.type == "cpu"
    assert np.array_equal(v2.numpy(), vks.numpy()) and m2 == msgs
    assert torch.equal(a2, aggs)


@pytest.fixture(scope="module")
def group():
    """One group of two keys, signed and aggregated on the CPU (numpy copies)."""
    params = fusion_setup(128, 5)
    keys = ft.keygen(params, [21, 22], device="cpu")
    msgs = ["a", "b"]
    sigs = ft.sign(params, keys, msgs)
    agg = ft.aggregate(params, keys.vk, msgs, sigs.sig)
    return params, keys.vk.numpy(), msgs, sigs.sig.numpy(), agg.numpy()


def _lifecycle_calls(group):
    """Each lifecycle entry point on numpy inputs, as f(**device)."""
    params, vk, msgs, sig, agg = group
    d = params.degree
    cc = np.zeros((1, 2, d), np.int32)
    return {
        "keygen": lambda **kw: ft.keygen(params, [21, 22], **kw).vk,
        "aggregate": lambda **kw: ft.aggregate(params, vk, msgs, sig, **kw),
        "verify": lambda **kw: ft.verify(params, vk, msgs, agg, **kw),
        "verify_many": lambda **kw: ft.verify_many(params, [(vk, msgs, agg)], **kw),
        "verify_batch": lambda **kw: ft.verify_batch(params, vk[None], cc, cc, agg[None], **kw),
    }


LIFECYCLE = ["keygen", "aggregate", "verify", "verify_many", "verify_batch"]


@pytest.mark.parametrize("entry", LIFECYCLE)
def test_lifecycle_defaults_to_the_card(no_card, group, entry):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _lifecycle_calls(group)[entry]()


@pytest.mark.parametrize("entry", LIFECYCLE)
def test_lifecycle_on_the_cpu_when_asked(no_card, group, entry):
    params, vk, msgs, sig, agg = group
    out = _lifecycle_calls(group)[entry](device="cpu")
    if entry == "keygen":
        assert out.device.type == "cpu" and np.array_equal(out.numpy(), vk)
    elif entry == "aggregate":
        assert out.device.type == "cpu" and np.array_equal(out.numpy(), agg)
    elif entry == "verify":
        assert out == (True, "")
    elif entry == "verify_many":
        assert out == [(True, "")]
    else:  # zero coefficients: a valid aggregate is not the image of zero
        assert all(t.device.type == "cpu" for t in out) and out[0].tolist() == [False]


def _object_api_calls(tmp_path):
    """Each object-API entry point that creates tensors, as f(**device)."""
    from fusion_cryptography_tpu_torch.algebra import ntt as tntt
    from fusion_cryptography_tpu_torch.algebra import polynomials as tpoly
    from fusion_cryptography_tpu_torch.interop import api, kat
    from fusion_cryptography_tpu_torch.scheme import lifecycle as lc

    params = fusion_setup(128, 5)
    q, root = params.modulus, params.root
    ring = dict(modulus=q, degree=64, root=root, inv_root=pow(root, q - 2, q), root_order=128)
    brp = tntt.bit_reverse_copy([pow(root, i, q) for i in range(64)])
    xof = bytes(range(256)) * 40
    vk = np.zeros((2, 64), np.int32)
    return {
        "api.keygen": lambda **kw: api.keygen(params, 3, **kw)[1].vk,
        "api.OneTimeVerificationKey": lambda **kw: api.OneTimeVerificationKey(params, vk, **kw).vk,
        "api.parse_challenge": lambda **kw: api.parse_challenge(params, xof, **kw).c_hat,
        "api.decode_bytes_to_agg_coefs": lambda **kw: api.decode_bytes_to_agg_coefs(
            params, xof, **kw)[0].alpha_hat,
        "api.hash_ch": lambda **kw: api.hash_ch(params, "key", "m", **kw).c_hat,
        "PolynomialCoefficientRepresentation": lambda **kw: tpoly.PolynomialCoefficientRepresentation(
            **ring, coefficients=[1] * 64, **kw).coefficients,
        "sample_polynomial_ntt_representation": lambda **kw:
            tpoly.sample_polynomial_ntt_representation(**ring, seed=4, **kw).values,
        "cooley_tukey_ntt": lambda **kw: torch.tensor(tntt.cooley_tukey_ntt(
            [1] * 64, q, 128, brp, **kw)),
        "derive_alphas": lambda **kw: lc.derive_alphas(params, ["k"], ["m"], **kw)[2],
        "kat.run_all": lambda **kw: torch.tensor(kat.run_all(tmp_path, **kw) == {}),
    }


OBJECT_API = ["api.keygen", "api.OneTimeVerificationKey", "api.parse_challenge",
              "api.decode_bytes_to_agg_coefs", "api.hash_ch",
              "PolynomialCoefficientRepresentation", "sample_polynomial_ntt_representation",
              "cooley_tukey_ntt", "derive_alphas", "kat.run_all"]


@pytest.mark.parametrize("entry", OBJECT_API)
def test_object_api_defaults_to_the_card(no_card, tmp_path, entry):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _object_api_calls(tmp_path)[entry]()


@pytest.mark.parametrize("entry", OBJECT_API)
def test_object_api_on_the_cpu_when_asked(no_card, tmp_path, entry):
    out = _object_api_calls(tmp_path)[entry](device="cpu")
    assert out.device.type == "cpu"


def test_object_api_follows_its_objects(no_card):
    """Without ``device``, sign / hash_ag / aggregate / verify run where
    their objects' tensors are (here the CPU), with no card."""
    from fusion_cryptography_tpu_torch.interop import api

    params = fusion_setup(128, 5)
    keys = [api.keygen(params, s, device="cpu") for s in (1, 2)]
    sigs = [api.sign(params, k, m) for k, m in zip(keys, "ab")]
    assert all(s.signature_hat.device.type == "cpu" for s in sigs)
    assert api.hash_ag(params, keys, ["a", "b"])[0].alpha_hat.device.type == "cpu"
    agg = api.aggregate(params, [k[1] for k in keys], ["a", "b"], sigs)
    assert agg.signature_hat.device.type == "cpu"
    assert api.verify(params, [k[1] for k in keys], ["a", "b"], agg) == (True, "")


def test_spec_assembly_defaults_to_the_card(no_card, fleet):
    params, (vks, msgs, aggs) = fleet
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_fleet(params, 1, 2, assembly="spec")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        verify_batch_device(params, vks.numpy(), msgs, aggs.numpy(), assembly="spec")
    out = verify_batch_device(params, vks, msgs, aggs, assembly="spec")
    assert all(t.device.type == "cpu" and bool(t.all()) for t in out)
