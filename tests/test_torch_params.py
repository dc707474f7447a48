"""Port parameter sets (fusion_cryptography_tpu_torch.params) vs the JAX
package's, field by field, and the cross-implementation constructor."""
import dataclasses
import random

import numpy as np
import pytest

import fusion_cryptography_tpu as ftpu
from fusion_cryptography_tpu import params as jparams
from fusion_cryptography_tpu_torch import params as tparams


def _assert_same(port, jax_params):
    for f in dataclasses.fields(jax_params):
        got, want = getattr(port, f.name), getattr(jax_params, f.name)
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype and np.array_equal(got, want), f.name
        else:
            assert got == want and type(got) is type(want), f.name


@pytest.mark.parametrize("secpar", [128, 256])
def test_fusion_setup_field_by_field(secpar):
    _assert_same(tparams.fusion_setup(secpar, 42), ftpu.fusion_setup(secpar, 42))
    assert tparams._LEVELS == jparams._LEVELS


def test_unseeded_setup_draws_the_same_stream():
    random.seed(1234)
    want = ftpu.fusion_setup(128, None)
    random.seed(1234)
    got = tparams.fusion_setup(128, None)
    _assert_same(got, want)
    assert len({row.tobytes() for row in got.public_challenge}) > 1


@pytest.mark.parametrize("secpar", [128, 256])
def test_params_from_numpy(secpar):
    jp = ftpu.fusion_setup(secpar, 7)
    from_object = tparams.params_from_numpy(jp)
    from_mapping = tparams.params_from_numpy(
        {f.name: getattr(jp, f.name) for f in dataclasses.fields(jp)}
    )
    _assert_same(from_object, jp)
    _assert_same(from_mapping, jp)
    assert from_object == tparams.fusion_setup(secpar, 7)
    assert hash(from_object) == hash(from_mapping)
    assert from_object.plan.degree == jp.degree
    with pytest.raises(ValueError):
        tparams.fusion_setup(192, 1)
