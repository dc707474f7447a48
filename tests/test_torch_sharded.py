"""The port's sharded lifecycle step (fusion_cryptography_tpu_torch/parallel/
sharded.py) in a gloo world of 4 CPU processes against the JAX package's
``sharded_lifecycle_step`` on conftest's 8 virtual devices, at the same mesh
shapes: every output bit for bit, ``prepare`` and ``prepare_real`` equal to
JAX's, and ``device_inputs`` the same global batch at every mesh shape.

The world runs every case once (a module fixture); each rank returns its
shards, which the tests reassemble by mesh coordinate (row-major, as JAX)."""
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import fusion_cryptography_tpu as ftpu
from fusion_cryptography_tpu.parallel import make_mesh as jax_make_mesh
from fusion_cryptography_tpu.parallel import prepare_real as jax_prepare_real
from fusion_cryptography_tpu.parallel import sharded_lifecycle_step as jax_step
from fusion_cryptography_tpu_torch import params_from_numpy
from fusion_cryptography_tpu_torch.parallel import _launch
from fusion_cryptography_tpu_torch.scheme import lifecycle as tlc

RANKS = str(Path(__file__).with_name("torch_parallel_ranks.py"))
WORLD = 4
# name -> (secpar, setup seed, mesh (dp, tp), B, prepare seed)
STEP_CASES = {
    "256-(4,1)": (256, 7, (4, 1), 8, 3),
    "256-(2,2)": (256, 7, (2, 2), 8, 3),
    "256-(1,4)": (256, 7, (1, 4), 8, 3),
    "128-(2,2)": (128, 5, (2, 2), 8, 4),
}
REAL_CASE = (256, 7, (2, 2), [500 + i for i in range(8)], [f"sharded-hash:{i}" for i in range(8)])
LOCAL_SHAPES = [(4, 1), (2, 2), (1, 4)]
LOCAL_CASE = (128, 5, 8, 11, LOCAL_SHAPES)


@pytest.fixture(scope="module")
def world():
    return _launch.launch(WORLD, RANKS + ":lifecycle_cases", STEP_CASES, REAL_CASE, LOCAL_CASE,
                          device="cpu", timeout_s=300)


def _jax_mesh(shape):
    return jax_make_mesh(shape, devices=jax.devices()[:WORLD])


def _at(results, key, shape):
    """The ranks' outputs of case ``key`` by mesh coordinate (i, j)."""
    tp = shape[1]
    return lambda i, j: results[i * tp + j][key]


def _assemble_step(results, key, shape):
    """Global (vk, agg) and the verdicts from the ranks' step shards: vk is
    dp-sharded and the same on every tp rank, agg tp-sharded and the same
    on every dp rank, the verdicts the same everywhere."""
    dp, tp = shape
    at = _at(results, key, shape)
    for i in range(dp):
        for j in range(tp):
            np.testing.assert_array_equal(at(i, j)[0], at(i, 0)[0])
            np.testing.assert_array_equal(at(i, j)[1], at(0, j)[1])
    flags = {tuple(bool(x) for x in r[key][2:]) for r in results}
    assert len(flags) == 1, f"verdicts differ across ranks: {flags}"
    vk = np.concatenate([at(i, 0)[0] for i in range(dp)])
    agg = np.concatenate([at(0, j)[1] for j in range(tp)])
    return vk, agg, flags.pop()


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_step_matches_jax(world, name):
    secpar, pseed, shape, B, seed = STEP_CASES[name]
    step, prepare, rank_p = jax_step(ftpu.fusion_setup(secpar, pseed), _jax_mesh(shape))
    sk, c, al = prepare(B, seed=seed)
    for got, want in zip(world[0][name + "/prepare"], (sk, c, al)):
        np.testing.assert_array_equal(got, np.asarray(want))
    vk, agg, eq, norm_ok, w_ok = step(sk, c, al)
    t_vk, t_agg, flags = _assemble_step(world, name, shape)
    assert t_agg.shape == (rank_p, ftpu.fusion_setup(secpar, pseed).degree)
    np.testing.assert_array_equal(t_vk, np.asarray(vk))
    np.testing.assert_array_equal(t_agg, np.asarray(agg))
    assert flags == (bool(eq), bool(norm_ok), bool(w_ok)) == (True, True, True)


def test_prepare_real_matches_jax_and_unsharded_port(world):
    """prepare_real's arrays, reprs and order equal JAX's; the step on them
    equals JAX's step, the port's keygen (vk, sorted) and the port's
    unsharded aggregate; the padded rank rows stay zero."""
    secpar, pseed, shape, seeds, msgs = REAL_CASE
    jp = ftpu.fusion_setup(secpar, pseed)
    step, _, rank_p = jax_step(jp, _jax_mesh(shape))
    sk, cc, al, keys, order = jax_prepare_real(jp, rank_p, seeds, msgs)
    t_sk, t_cc, t_al, t_reprs, t_order = world[0]["real/prepare"]
    assert t_order == list(order)
    assert t_reprs == keys.vk_strs()
    for got, want in zip((t_sk, t_cc, t_al), (sk, cc, al)):
        np.testing.assert_array_equal(got, np.asarray(want))
    vk, agg, eq, norm_ok, w_ok = step(sk, cc, al)
    t_vk, t_agg, flags = _assemble_step(world, "real", shape)
    np.testing.assert_array_equal(t_vk, np.asarray(vk))
    np.testing.assert_array_equal(t_agg, np.asarray(agg))
    assert flags == (True, True, True) == (bool(eq), bool(norm_ok), bool(w_ok))
    # the unsharded port on the CPU
    p = params_from_numpy(jp)
    t_keys = tlc.keygen(p, seeds, device="cpu")
    np.testing.assert_array_equal(t_vk, t_keys.vk_np()[np.array(t_order)])
    sigs = tlc.sign(p, t_keys, msgs)
    t_agg_host = tlc.aggregate(p, t_keys.vk, msgs, sigs.sig)
    np.testing.assert_array_equal(t_agg[: p.rank], t_agg_host.numpy())
    assert not t_agg[p.rank:].any(), "padded rank rows must stay zero"


def test_device_inputs_same_batch_at_every_mesh(world):
    """device_inputs' shards reassemble to one global batch at every mesh
    shape (padded rank rows zero), drawn from prepare's distributions."""
    secpar, pseed, B, seed, shapes = LOCAL_CASE
    rank = ftpu.fusion_setup(secpar, pseed).rank
    batches = []
    for shape in shapes:
        dp, tp = shape
        at = _at(world, f"local/{shape}", shape)
        sk = np.concatenate([np.concatenate([at(i, j)[0] for j in range(tp)], axis=2)
                             for i in range(dp)])
        c = np.concatenate([at(i, 0)[1] for i in range(dp)])
        al = np.concatenate([at(i, 0)[2] for i in range(dp)])
        assert sk.shape[:2] == (B, 2) and sk.shape[2] == -(-rank // tp) * tp
        assert not sk[:, :, rank:].any()
        batches.append((sk[:, :, :rank], c, al))
    for other in batches[1:]:
        for a, b in zip(batches[0], other):
            np.testing.assert_array_equal(a, b)
    sk, c, al = batches[0]
    assert sk.min() >= -52 and sk.max() <= 52 and len(np.unique(sk)) == 105
    assert set(np.unique(c)) == set(np.unique(al)) == {-1, 0, 1}
