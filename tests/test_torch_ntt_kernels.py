"""The port's NTT (ops/ntt.py) vs the JAX package's two NTT kernels, run as
the JAX package's own tests run them on the CPU (interpret mode): the
residue form vs ``ntt_mxu_pallas`` (kernel 4), the centered form vs
``ntt_pallas`` (kernel 9).  On CPU tensors the dispatchers run the plain
versions and launch nothing.  Integer arithmetic: exact equality."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fusion_cryptography_tpu.ops.ntt_mxu_pallas import ntt_fwd_u_mxu_pallas, ntt_inv_u_mxu_pallas
from fusion_cryptography_tpu.ops.ntt import make_plan as jax_plan
from fusion_cryptography_tpu.ops.ntt_pallas import ntt_fwd_pallas, ntt_inv_pallas
from fusion_cryptography_tpu_torch import kernels
from fusion_cryptography_tpu_torch.ops import ntt as tntt
from fusion_cryptography_tpu_torch.ops.field import Q

ROOTS = {64: 23584283, 256: 3337519}
# (shape, degree): 70 rows is not a multiple of the interpret tile (32)
CASES = [((70, 64), 64), ((70, 256), 256), ((3, 5, 256), 256)]
IDS = ["70x64", "70x256", "3x5x256"]


def _residues(seed, shape):
    """Residues in [0, q) with whole rows of 0 and q-1 and the edges 0, 1, q-1."""
    x = np.random.default_rng(seed).integers(0, Q, size=shape, dtype=np.int64)
    flat = x.reshape(-1, shape[-1])
    flat[0] = 0
    flat[1] = Q - 1
    flat[2, :3] = [0, 1, Q - 1]
    return x


def _centered(seed, shape):
    """Centered values with 0, +-1 and +-(q-1)/2."""
    x = np.random.default_rng(seed).integers(-(Q // 2), Q // 2 + 1, size=shape, dtype=np.int64)
    flat = x.reshape(-1, shape[-1])
    flat[0] = 0
    flat[1, :5] = [0, 1, -1, Q // 2, -(Q // 2)]
    flat[2] = -(Q // 2)
    return x.astype(np.int32)


@pytest.mark.parametrize("shape,d", CASES, ids=IDS)
def test_residue_ntt_matches_jax_mxu_kernel(shape, d):
    jp, tp = jax_plan(Q, d, ROOTS[d]), tntt.make_plan(Q, d, ROOTS[d])
    x = _residues(d + len(shape), shape)
    want_f = np.asarray(ntt_fwd_u_mxu_pallas(jp, jnp.asarray(x.astype(np.uint32)), tile=32,
                                             interpret=True)).astype(np.int64)
    got_f = tntt.ntt_fwd_u_plain(tp, torch.from_numpy(x))
    np.testing.assert_array_equal(got_f.numpy(), want_f)
    want_i = np.asarray(ntt_inv_u_mxu_pallas(jp, jnp.asarray(want_f.astype(np.uint32)), tile=32,
                                             interpret=True)).astype(np.int64)
    got_i = tntt.ntt_inv_u_plain(tp, got_f)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_array_equal(got_i.numpy(), x)


@pytest.mark.parametrize("shape,d", CASES, ids=IDS)
def test_centered_ntt_matches_jax_stage_kernel(shape, d):
    jp, tp = jax_plan(Q, d, ROOTS[d]), tntt.make_plan(Q, d, ROOTS[d])
    x = _centered(d + len(shape), shape)
    want_f = np.asarray(ntt_fwd_pallas(jp, jnp.asarray(x), tile=32, interpret=True))
    got_f = tntt.ntt_fwd_plain(tp, torch.from_numpy(x))
    assert got_f.dtype == torch.int32
    np.testing.assert_array_equal(got_f.numpy(), want_f)
    want_i = np.asarray(ntt_inv_pallas(jp, jnp.asarray(want_f), tile=32, interpret=True))
    got_i = tntt.ntt_inv_plain(tp, got_f)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_array_equal(got_i.numpy(), x)


@pytest.mark.parametrize("d", [64, 256])
def test_dispatch_on_cpu_runs_plain_and_launches_nothing(d):
    tp = tntt.make_plan(Q, d, ROOTS[d])
    u = torch.from_numpy(_residues(d, (9, d)))
    c = torch.from_numpy(_centered(d, (2, 3, d)))
    before = dict(kernels.LAUNCHES)
    cases = [(tntt.ntt_fwd_u, tntt.ntt_fwd_u_plain, u), (tntt.ntt_inv_u, tntt.ntt_inv_u_plain, u),
             (tntt.ntt_fwd, tntt.ntt_fwd_plain, c), (tntt.ntt_inv, tntt.ntt_inv_plain, c)]
    for public, plain, x in cases:
        got = public(tp, x)
        assert got.device.type == "cpu" and torch.equal(got, plain(tp, x))
    assert dict(kernels.LAUNCHES) == before
