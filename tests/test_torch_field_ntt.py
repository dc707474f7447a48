"""Port field ops and NTT (fusion_cryptography_tpu_torch.ops.field/ntt) vs the
JAX package on the same numpy inputs.  Everything is integer: exact equality."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fusion_cryptography_tpu.ops import field as jf
from fusion_cryptography_tpu.ops import ntt as jntt
from fusion_cryptography_tpu_torch.ops import field as tf
from fusion_cryptography_tpu_torch.ops import ntt as tntt

Q = jf.Q
EDGE_RESIDUES = np.array([0, 1, 2, Q // 2, Q // 2 + 1, Q - 2, Q - 1], dtype=np.int64)
EDGE_WORDS = np.concatenate([EDGE_RESIDUES, [Q, Q + 1, 2**31 - 2, 2**31 - 1]])


def _residues(seed, shape):
    r = np.random.default_rng(seed).integers(0, Q, size=shape, dtype=np.int64)
    r.flat[: EDGE_RESIDUES.size] = EDGE_RESIDUES
    return r


def _words31(seed, shape):
    r = np.random.default_rng(seed).integers(0, 2**31, size=shape, dtype=np.int64)
    r.flat[: EDGE_WORDS.size] = EDGE_WORDS
    return r


def _jax(fn, *xs):
    return np.asarray(fn(*[jnp.asarray(x.astype(np.uint32)) for x in xs])).astype(np.int64)


def _port(fn, *xs):
    return fn(*[torch.from_numpy(x) for x in xs]).numpy().astype(np.int64)


@pytest.mark.parametrize("op", ["add_mod", "sub_mod", "mont_mul"])
def test_binary_ops_on_residues(op):
    a = _residues(1, (40, 33))
    b = _residues(2, (40, 33))
    b[0, : EDGE_RESIDUES.size] = EDGE_RESIDUES[::-1]
    np.testing.assert_array_equal(
        _port(getattr(tf, op), a, b), _jax(getattr(jf, op), a, b)
    )


@pytest.mark.parametrize("op", ["mont_mul", "add_mod"])
def test_binary_ops_to_2_31(op):
    a = _words31(3, (50, 21))
    b = _words31(4, (50, 21))
    np.testing.assert_array_equal(
        _port(getattr(tf, op), a, b), _jax(getattr(jf, op), a, b)
    )


@pytest.mark.parametrize("op", ["to_mont", "from_mont"])
def test_montgomery_lifts(op):
    a = _words31(5, (64, 17))
    np.testing.assert_array_equal(_port(getattr(tf, op), a), _jax(getattr(jf, op), a))
    # the lift round-trips and turns mont_mul into the plain product
    r = _residues(6, (64, 17))
    rt = tf.from_mont(tf.to_mont(torch.from_numpy(r)))
    np.testing.assert_array_equal(rt.numpy(), r)
    b = _residues(7, (64, 17))
    prod = tf.mont_mul(tf.to_mont(torch.from_numpy(r)), torch.from_numpy(b))
    np.testing.assert_array_equal(prod.numpy(), (r * b) % Q)


def test_centering():
    c = np.random.default_rng(8).integers(-(Q // 2), Q // 2 + 1, size=500).astype(np.int32)
    c[:5] = [0, 1, -1, Q // 2, -(Q // 2)]
    got = tf.to_unsigned(torch.from_numpy(c)).numpy()
    want = np.asarray(jf.to_unsigned(jnp.asarray(c))).astype(np.int64)
    np.testing.assert_array_equal(got, want)
    u = _words31(9, (300,))
    got = tf.to_centered(torch.from_numpy(u))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jf.to_centered(jnp.asarray(u.astype(np.uint32)))))


@pytest.mark.parametrize("n_terms", [83, 1000])
def test_sum_and_dot_mod(n_terms):
    x = _residues(10, (3, n_terms, 16))
    a = _residues(11, (n_terms, 16))
    np.testing.assert_array_equal(
        _port(lambda t: tf.sum_mod(t, axis=-2), x), _jax(lambda t: jf.sum_mod(t, axis=-2), x)
    )
    a_m = tf.to_mont(torch.from_numpy(a))
    got = tf.dot_mod(a_m, torch.from_numpy(x), axis=-2).numpy()
    want = np.asarray(jf.dot_mod(jf.to_mont(jnp.asarray(a.astype(np.uint32))),
                                 jnp.asarray(x.astype(np.uint32)), axis=-2)).astype(np.int64)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.sum((a * x) % Q, axis=-2) % Q)


PLANS = [(64, 23584283), (256, 3337519)]


@pytest.mark.parametrize("d,root", PLANS)
def test_plan_tables_match(d, root):
    jp, tp = jntt.make_plan(Q, d, root), tntt.make_plan(Q, d, root)
    for name in ("brp", "brp_shoup", "brp_inv", "brp_inv_shoup"):
        np.testing.assert_array_equal(getattr(tp, name), getattr(jp, name))
    assert (tp.n_inv, tp.n_inv_shoup, tp.inv_root) == (jp.n_inv, jp.n_inv_shoup, jp.inv_root)


@pytest.mark.parametrize("d,root", PLANS)
def test_ntt_matches_jax(d, root):
    jp, tp = jntt.make_plan(Q, d, root), tntt.make_plan(Q, d, root)
    j_fwd = jax.jit(lambda t: jntt.ntt_fwd_u(jp, t))
    j_inv = jax.jit(lambda t: jntt.ntt_inv_u(jp, t))
    for x in (_residues(d, (9, d)), _words31(d + 1, (2, 3, d))):
        np.testing.assert_array_equal(_port(lambda t: tntt.ntt_fwd_u(tp, t), x), _jax(j_fwd, x))
        np.testing.assert_array_equal(_port(lambda t: tntt.ntt_inv_u(tp, t), x), _jax(j_inv, x))
    r = _residues(d + 2, (5, d))
    back = tntt.ntt_inv_u(tp, tntt.ntt_fwd_u(tp, torch.from_numpy(r)))
    np.testing.assert_array_equal(back.numpy(), r)
