"""The port's entry points run on the card unless asked for the CPU: without a
card a call that names no device raises, nothing falls back to the CPU, and
``device="cpu"`` (or CPU tensors, for the verify entry points) runs there."""
import numpy as np
import pytest
import torch

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
