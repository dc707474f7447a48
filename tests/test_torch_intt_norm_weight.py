"""Port aggregate check (ops/intt_norm_weight.py, plain path on CPU) vs the
JAX package: its observed sum ``dot_mod(a_mont, to_unsigned(aggs))`` and its
INTT + norm/weight Pallas kernel run in interpret mode, as in
tests/test_ntt_mxu_pallas.py; and, on int32 values outside the centered
range, vs Python-int arithmetic."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fusion_cryptography_tpu.ops import field as jf
from fusion_cryptography_tpu.ops import ntt as jntt
from fusion_cryptography_tpu.ops.field import Q
from fusion_cryptography_tpu.ops.ntt_mxu_pallas import intt_norm_weight_mxu_pallas
from fusion_cryptography_tpu_torch.ops import ntt as tntt
from fusion_cryptography_tpu_torch.ops.intt_norm_weight import (
    agg_check,
    agg_check_plain,
    agg_table,
    intt_norm_weight_plain,
)

CPU = torch.device("cpu")
IN_RANGE_EDGES = [0, 1, -1, Q // 2, -(Q // 2)]
OUT_OF_RANGE_EDGES = [-(2**31), -Q - 1, -Q, Q, 2**31 - 1]


def _aggs(d, plan, G=3, rank=5):
    """Centered int32 aggregates with a zero row, sparse rows (NTTs of short
    polynomials, so weights vary below d) and the in-range edges."""
    rng = np.random.default_rng(d)
    x = rng.integers(-(Q // 2), Q // 2 + 1, size=(G, rank, d), dtype=np.int64)
    x[0, 0] = 0  # all-zero row: norm 0, weight 0
    x[0, 1, : len(IN_RANGE_EDGES)] = IN_RANGE_EDGES
    x[2, 0] = Q // 2
    x[2, 1] = -(Q // 2)
    for k in range(4):
        poly = np.zeros(d, np.int64)
        poly[rng.choice(d, size=k + 1, replace=False)] = rng.integers(1, Q, size=k + 1)
        x[1, k] = plan.field.to_centered(tntt.ntt_fwd_u(plan, torch.from_numpy(poly))).numpy()
    return x.astype(np.int32)


def _pub(d, rank=5):
    return np.random.default_rng(d + 1).integers(-(Q // 2), Q // 2 + 1, size=(rank, d)).astype(np.int32)


def _jax_check(d, root, pub, aggs):
    agg_u = jf.to_unsigned(jnp.asarray(aggs))
    observed = jf.dot_mod(jf.to_mont(jf.to_unsigned(jnp.asarray(pub))), agg_u, axis=-2)
    nrm, wgt = intt_norm_weight_mxu_pallas(jntt.make_plan(Q, d, root), agg_u, tile=8,
                                           interpret=True)
    return np.asarray(observed).astype(np.int64), np.asarray(nrm), np.asarray(wgt)


@pytest.mark.parametrize("d,root", [(64, 23584283), (256, 3337519)])
def test_matches_jax_pallas_interpret(d, root):
    plan = tntt.make_plan(Q, d, root)
    aggs, pub = _aggs(d, plan), _pub(d)
    observed, nrm, wgt = agg_check(plan, agg_table(plan.field, pub, CPU), torch.from_numpy(aggs))
    assert observed.shape == (3, d) and observed.dtype == torch.int64
    assert nrm.shape == (3, 5) and nrm.dtype == torch.int32 and wgt.dtype == torch.int32
    for got, want in zip((observed, nrm, wgt), _jax_check(d, root, pub, aggs)):
        np.testing.assert_array_equal(got.numpy(), want)
    assert list(wgt[1, :4].numpy()) != [d] * 4 and int(wgt[0, 0]) == 0


def test_out_of_range_edges_match_python_int():
    """Every int32 is lifted to its canonical residue x mod q: the observed
    sum equals Python-int arithmetic and the norms and weights equal those
    of the centered representative.  The JAX package lifts through uint32,
    which aliases -2**31 to 2**31 + q (mod 2**32) = 17919 mod q: there it
    differs."""
    d, root, rank = 64, 23584283, 5
    plan = tntt.make_plan(Q, d, root)
    pub = _pub(d, rank)
    x = np.zeros((len(OUT_OF_RANGE_EDGES), rank, d), np.int64)
    rng = np.random.default_rng(3)
    for g, v in enumerate(OUT_OF_RANGE_EDGES):
        x[g] = rng.integers(-(Q // 2), Q // 2 + 1, size=(rank, d))
        x[g, 0, :3] = v
        x[g, 2] = v
    aggs = torch.from_numpy(x.astype(np.int32))
    table = agg_table(plan.field, pub, CPU)
    observed, nrm, wgt = agg_check(plan, table, aggs)
    want = [[sum(int(pub[r, k]) * int(x[g, r, k]) for r in range(rank)) % Q for k in range(d)]
            for g in range(x.shape[0])]
    np.testing.assert_array_equal(observed.numpy(), np.array(want, np.int64))
    canon = x % Q
    canon = np.where(canon > Q // 2, canon - Q, canon).astype(np.int32)
    _, c_nrm, c_wgt = agg_check_plain(plan, table, torch.from_numpy(canon))
    np.testing.assert_array_equal(nrm.numpy(), c_nrm.numpy())
    np.testing.assert_array_equal(wgt.numpy(), c_wgt.numpy())
    j_obs, j_nrm, _ = _jax_check(d, root, pub, x.astype(np.int32))
    g_min = OUT_OF_RANGE_EDGES.index(-(2**31))
    assert not np.array_equal(j_obs[g_min], observed[g_min].numpy())
    assert not np.array_equal(j_nrm[g_min], nrm[g_min].numpy())


def test_plain_is_explicit_centered_reduction():
    plan = tntt.make_plan(Q, 256, 3337519)
    x = plan.field.to_unsigned(torch.from_numpy(_aggs(256, plan)))
    coef = plan.field.to_centered(tntt.ntt_inv_u(plan, x)).numpy()
    nrm, wgt = intt_norm_weight_plain(plan, x)
    np.testing.assert_array_equal(nrm.numpy(), np.abs(coef).max(axis=-1))
    np.testing.assert_array_equal(wgt.numpy(), (coef != 0).sum(axis=-1))


def test_wrapper_never_falls_back_off_cpu():
    plan = tntt.make_plan(Q, 256, 3337519)
    table = agg_table(plan.field, _pub(256, 3), CPU)
    with pytest.raises(ValueError):
        agg_check(plan, table, torch.zeros((2, 3, 256), dtype=torch.int32, device="meta"))
