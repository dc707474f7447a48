"""The port's coefficient-sharded NTTs (fusion_cryptography_tpu_torch/
parallel/distributed_ntt.py) in gloo worlds of CPU processes against the JAX
package's on conftest's virtual devices, at the same shard counts: the
matrix form's forward, inverse and round trip, the four-step form in both
orders (its outputs, round trip, pointwise homomorphism and
``fourstep_order``), and JAX's padded case (d=32, S=8) in a world of 8.

Each world runs every case once (a module fixture); a mesh (S, world // S)
named ("sp", "rep") holds S shards, and each rank returns its column block,
which the tests reassemble."""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from fusion_cryptography_tpu.ops.field import Q
from fusion_cryptography_tpu.ops.ntt import make_plan, negacyclic_poly_mult, ntt_fwd, ntt_inv
from fusion_cryptography_tpu.parallel import distributed_ntt as jdn
from fusion_cryptography_tpu_torch.ops.ntt import make_plan as t_make_plan
from fusion_cryptography_tpu_torch.parallel import _launch
from fusion_cryptography_tpu_torch.parallel import distributed_ntt as tdn

RANKS = str(Path(__file__).with_name("torch_parallel_ranks.py"))
WORLD = 4
R256, R64 = 3337519, 23584283
R32 = pow(R256, 512 // 64, Q)  # primitive 64th root -> degree 32
MATRIX = {"256-S4": (256, R256, 4), "64-S4": (64, R64, 4), "256-S2": (256, R256, 2)}
FOURSTEP = {f"{d}-S{S}-{order}": (d, root, S, order)
            for d, root, S in ((256, R256, 4), (64, R64, 4), (256, R256, 2))
            for order in ("reference", "fourstep")}
PADDED = {"32-S8": (32, R32, 8, None)}


def _inputs(ds):
    rng = np.random.default_rng(13)
    x = {d: rng.integers(-(Q // 2), Q // 2 + 1, size=(6, d), dtype=np.int64).astype(np.int32)
         for d in ds}
    g = {d: rng.integers(-200, 201, size=(6, d)).astype(np.int32) for d in ds}
    return x, g


X, GX = _inputs((256, 64))
X32, G32 = _inputs((32,))


@pytest.fixture(scope="module")
def world():
    return _launch.launch(WORLD, RANKS + ":ntt_cases", MATRIX, FOURSTEP, X, GX,
                          device="cpu", timeout_s=300)


@pytest.fixture(scope="module")
def world8():
    return _launch.launch(8, RANKS + ":ntt_cases", {}, PADDED, X32, G32,
                          device="cpu", timeout_s=300)


def _jax_mesh(S):
    return Mesh(np.array(jax.devices()[:S]), ("sp",))


def _columns(results, S, pick):
    """Global array from the ranks' column blocks (sp index i is the ranks
    i·rep .. (i+1)·rep - 1, all holding the same block)."""
    rep = len(results) // S
    blocks = []
    for i in range(S):
        for j in range(rep):
            np.testing.assert_array_equal(pick(results[i * rep + j]), pick(results[i * rep]))
        blocks.append(pick(results[i * rep]))
    return np.concatenate(blocks, axis=1)


@pytest.mark.parametrize("name", list(MATRIX))
def test_matrix_ntt_matches_jax(world, name):
    d, root, S = MATRIX[name]
    plan = make_plan(Q, d, root)
    fwd, inv = jdn.make_distributed_ntt(plan, _jax_mesh(S))
    x = jnp.asarray(X[d])
    y = _columns(world, S, lambda r: r[name][0])
    np.testing.assert_array_equal(y, np.asarray(fwd(x)))
    np.testing.assert_array_equal(y, np.asarray(ntt_fwd(plan, x)))
    np.testing.assert_array_equal(_columns(world, S, lambda r: r[name][1]), X[d])
    np.testing.assert_array_equal(_columns(world, S, lambda r: r[name][2]),
                                  np.asarray(inv(x)))
    np.testing.assert_array_equal(_columns(world, S, lambda r: r[name][2]),
                                  np.asarray(ntt_inv(plan, x)))


def _check_fourstep(results, d, root, S, order, name, x, g):
    plan = make_plan(Q, d, root)
    fwd, inv, layout, unlayout = jdn.make_fourstep_ntt(plan, _jax_mesh(S), order=order)
    res = results[0][name]
    assert res["order"] == fwd.order and res["out_width"] == fwd.out_width
    y = _columns(results, S, lambda r: r[name]["y"])
    assert y.shape == (x.shape[0], fwd.out_width)
    np.testing.assert_array_equal(y, np.asarray(fwd(layout(jnp.asarray(x)))))
    # round trip, in the cyclic layout
    back = _columns(results, S, lambda r: r[name]["back"])
    np.testing.assert_array_equal(np.asarray(unlayout(jnp.asarray(back))), x)
    t_plan = t_make_plan(Q, d, root)
    np.testing.assert_array_equal(
        tdn.fourstep_perm(t_plan, S), jdn.fourstep_perm(plan, S))
    # inv(fwd(x) ⊙ fwd(g)) is the negacyclic product
    prod = _columns(results, S, lambda r: r[name]["prod"])
    np.testing.assert_array_equal(
        np.asarray(unlayout(jnp.asarray(prod))),
        np.asarray(negacyclic_poly_mult(plan, jnp.asarray(x), jnp.asarray(g))))
    return plan, fwd, y


@pytest.mark.parametrize("name", list(FOURSTEP))
def test_fourstep_ntt_matches_jax(world, name):
    d, root, S, order = FOURSTEP[name]
    plan, fwd, y = _check_fourstep(world, d, root, S, order, name, X[d], GX[d])
    perm = tdn.fourstep_perm(t_make_plan(Q, d, root), S)
    ref = np.asarray(ntt_fwd(plan, jnp.asarray(X[d])))
    if order == "reference":
        np.testing.assert_array_equal(y, ref)
    else:
        np.testing.assert_array_equal(y, ref[:, perm])
    # the probe on every rank: the closed form in the fourstep order,
    # the identity in the reference order
    probes = {tuple(r[name]["probe"]) for r in world}
    assert len(probes) == 1
    want = perm if order == "fourstep" else np.arange(d)
    np.testing.assert_array_equal(np.array(probes.pop()), want)
    assert world[0][name]["reference_ok"] is True


def test_fourstep_padded_shards(world8):
    """S^2 does not divide d (d=32, S=8): order='reference' raises JAX's
    error, the padded all_to_all chunks round-trip and the closed-form perm
    maps every valid slot to ntt_fwd's."""
    name = "32-S8"
    d, root, S, _ = PADDED[name]
    plan, fwd, y = _check_fourstep(world8, d, root, S, None, name, X32[d], G32[d])
    assert fwd.order == "fourstep" and y.shape == (6, 64)
    with pytest.raises(ValueError, match="reference") as e:
        jdn.make_fourstep_ntt(plan, _jax_mesh(S), order="reference")
    assert {r[name]["reference_ok"] for r in world8} == {str(e.value)}
    perm = tdn.fourstep_perm(t_make_plan(Q, d, root), S)
    valid = perm >= 0
    assert valid.sum() == 32 and set(perm[valid]) == set(range(32))
    expect = np.asarray(ntt_fwd(plan, jnp.asarray(X32[d])))
    np.testing.assert_array_equal(y[:, valid], expect[:, perm[valid]])
