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
