"""Port INTT + norm/weight (ops/intt_norm_weight.py, plain path on CPU) vs the
JAX package's Pallas kernel run in interpret mode, as in
tests/test_ntt_mxu_pallas.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fusion_cryptography_tpu.ops import ntt as jntt
from fusion_cryptography_tpu.ops.field import Q
from fusion_cryptography_tpu.ops.ntt_mxu_pallas import intt_norm_weight_mxu_pallas
from fusion_cryptography_tpu_torch.ops import ntt as tntt
from fusion_cryptography_tpu_torch.ops.intt_norm_weight import (
    intt_norm_weight,
    intt_norm_weight_plain,
)


def _inputs(d, plan):
    rng = np.random.default_rng(d)
    x = rng.integers(0, Q, size=(6, 5, d), dtype=np.int64)
    x[0, 0] = 0  # all-zero row: norm 0, weight 0
    x[0, 1, :3] = [0, 1, Q - 1]
    # sparse rows: NTTs of short polynomials, so weights vary below d
    for k in range(4):
        poly = np.zeros(d, np.int64)
        poly[rng.choice(d, size=k + 1, replace=False)] = rng.integers(1, Q, size=k + 1)
        x[1, k] = tntt.ntt_fwd_u(plan, torch.from_numpy(poly)).numpy()
    return x


@pytest.mark.parametrize("d,root", [(64, 23584283), (256, 3337519)])
def test_matches_jax_pallas_interpret(d, root):
    plan = tntt.make_plan(Q, d, root)
    x = _inputs(d, plan)
    nrm, wgt = intt_norm_weight(plan, torch.from_numpy(x))
    assert nrm.shape == (6, 5) and nrm.dtype == torch.int32 and wgt.dtype == torch.int32
    j_nrm, j_wgt = intt_norm_weight_mxu_pallas(
        jntt.make_plan(Q, d, root), jnp.asarray(x.astype(np.uint32)), tile=8, interpret=True
    )
    np.testing.assert_array_equal(nrm.numpy(), np.asarray(j_nrm))
    np.testing.assert_array_equal(wgt.numpy(), np.asarray(j_wgt))
    assert list(wgt[1, :4].numpy()) != [d] * 4 and int(wgt[0, 0]) == 0


def test_plain_is_explicit_centered_reduction():
    plan = tntt.make_plan(Q, 256, 3337519)
    x = torch.from_numpy(_inputs(256, plan))
    coef = plan.field.to_centered(tntt.ntt_inv_u(plan, x)).numpy()
    nrm, wgt = intt_norm_weight_plain(plan, x)
    np.testing.assert_array_equal(nrm.numpy(), np.abs(coef).max(axis=-1))
    np.testing.assert_array_equal(wgt.numpy(), (coef != 0).sum(axis=-1))


def test_wrapper_never_falls_back_off_cpu():
    plan = tntt.make_plan(Q, 256, 3337519)
    with pytest.raises(ValueError):
        intt_norm_weight(plan, torch.zeros((3, 256), dtype=torch.int64, device="meta"))
