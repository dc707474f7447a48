"""The port's ``sharded_verify_device`` (fusion_cryptography_tpu_torch/
parallel/sharded.py) in a gloo world of 4 CPU processes, at dp = 4 and at
(2, 2), in both assemblies: the verdicts of a G=8, N=2, secpar=128 fleet with
one tampered group equal the JAX package's ``sharded_verify_device`` on
conftest's virtual devices at the same mesh shape and the port's one-device
``verify_batch_device``; ``sharded_verify_local`` on each rank's own groups,
several signer chunks a rank, equals the plain reference
(``portbench/reference/fusion_ref.py``) and opens the parallel layer's
spans and counters; the mesh's and the verify's ValueErrors are JAX's; and
a world of one rank equals the unsharded port."""
import re
from pathlib import Path

import jax
import numpy as np
import pytest

import fusion_cryptography_tpu as ftpu
from fusion_cryptography_tpu.parallel import make_mesh as jax_make_mesh
from fusion_cryptography_tpu.parallel.sharded import sharded_verify_device as jax_sharded_verify
from fusion_cryptography_tpu_torch import params_from_numpy
from fusion_cryptography_tpu_torch.parallel import _launch
from fusion_cryptography_tpu_torch.scheme import device_pipeline as tdp
from fusion_cryptography_tpu_torch.scheme import lifecycle as tlc
from fusion_cryptography_tpu_torch.scheme.device_setup import build_fleet
from portbench.reference import fusion_ref as ref

RANKS = str(Path(__file__).with_name("torch_parallel_ranks.py"))
WORLD = 4
SECPAR, PSEED, G, N, BAD = 128, 7, 8, 2, 4
SHAPES = [(4, 1), (2, 2)]
CASES = {f"{assembly}-{shape}": (shape, assembly)
         for shape in SHAPES for assembly in ("fold", "spec")}
# sharded_verify_local's signer chunk and window, in groups: each rank's 2
# groups go as 2 chunks in one window, as a card's 65,536 go as 8 in 4
LOCAL_CHUNKS = (1, 2)


@pytest.fixture(scope="module")
def fleet():
    """The port's fleet on the CPU with group BAD's aggregate tampered, and
    the one-device verify's verdicts."""
    p = params_from_numpy(ftpu.fusion_setup(SECPAR, PSEED))
    vks, msgs, aggs = build_fleet(p, G, N, seed0=400, device="cpu")
    aggs[BAD, 0, 0] = (aggs[BAD, 0, 0] + 1) % p.modulus
    want = [x.numpy() for x in tdp.verify_batch_device(p, vks, msgs, aggs)]
    return vks.numpy(), msgs, aggs.numpy(), want


@pytest.fixture(scope="module")
def world(fleet):
    vks, msgs, aggs, _ = fleet
    return _launch.launch(WORLD, RANKS + ":verify_cases", SECPAR, PSEED, vks, msgs, aggs, CASES,
                          LOCAL_CHUNKS, device="cpu", timeout_s=300)


@pytest.fixture(scope="module")
def jax_verdicts(fleet):
    vks, msgs, aggs, _ = fleet
    jp = ftpu.fusion_setup(SECPAR, PSEED)
    return {shape: [np.asarray(x) for x in jax_sharded_verify(
        jp, jax_make_mesh(shape, devices=jax.devices()[:WORLD]), vks, msgs, aggs)]
        for shape in SHAPES}


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_verify_matches_jax(fleet, world, jax_verdicts, name):
    shape, _ = CASES[name]
    want = fleet[3]
    for rank, res in enumerate(world):
        for got, jx, one in zip(res[name], jax_verdicts[shape], want):
            assert got.dtype == np.bool_ and got.shape == (G,)
            np.testing.assert_array_equal(got, jx, err_msg=f"rank {rank}")
            np.testing.assert_array_equal(got, one, err_msg=f"rank {rank}")
    eq = world[0][name][0]
    assert not eq[BAD] and eq[np.arange(G) != BAD].all()


def test_sharded_verify_local_matches_reference(fleet, world):
    """Every rank's gathered verdicts equal the plain reference's verify of
    the global groups; under a profiler each rank opens ``fct.shard``
    around its grouped verify and, after it, ``fct.shard.gather``, packs
    one chunk a group, and counts its own G/4 groups and the 3·G gathered
    bytes."""
    vks, msgs, aggs, _ = fleet
    want = ref.verify_groups(ref.setup(SECPAR, PSEED), vks,
                             [msgs[g * N:(g + 1) * N] for g in range(G)], aggs).T
    assert not want[0, BAD] and want[:, np.arange(G) != BAD].all()
    for rank, res in enumerate(world):
        local = res["local"]
        for got, w in zip(local["verdicts"], want):
            assert got.dtype == np.bool_
            np.testing.assert_array_equal(got, w, err_msg=f"rank {rank}")
        spans = local["spans"]
        (shard,), (gather,), (verify,) = (spans[n] for n in
                                         ("fct.shard", "fct.shard.gather", "fct.verify"))
        assert shard[0] <= verify[0] <= verify[1] <= gather[0] <= gather[1] <= shard[1]
        assert len(spans["fct.pack"]) == G // WORLD // LOCAL_CHUNKS[0]
        assert local["counters"]["shard.groups"] == G // WORLD
        assert local["counters"]["shard.gather_bytes"] == 3 * G


def test_errors_match_jax(world):
    """The same ValueErrors as the JAX package's make_mesh and
    sharded_verify_device, and device_inputs' on an uneven batch."""
    errors = world[0]["errors"]
    jp = ftpu.fusion_setup(SECPAR, PSEED)
    want = {}
    with pytest.raises(ValueError) as e:
        jax_make_mesh((8, 8), devices=jax.devices()[:WORLD])
    want["too_many_ranks"] = str(e.value)
    mesh4 = jax_make_mesh((4, 1), devices=jax.devices()[:WORLD])
    with pytest.raises(ValueError) as e:
        jax_sharded_verify(jp, mesh4, np.zeros((6, 2, 2, 64), np.int32), ["m"] * 12,
                           np.zeros((6, 195, 64), np.int32))
    want["verify_not_divisible"] = str(e.value)
    with pytest.raises(ValueError) as e:
        jax_sharded_verify(jp, mesh4, np.zeros((8, 2, 2, 64), np.int32), ["m"] * 15,
                           np.zeros((8, 195, 64), np.int32))
    want["verify_messages"] = str(e.value)
    # JAX says "devices" where the port says "ranks"
    assert errors["too_many_ranks"] == want["too_many_ranks"].replace("devices", "ranks")
    assert errors["verify_not_divisible"] == want["verify_not_divisible"]
    assert errors["verify_messages"] == want["verify_messages"]
    assert re.search(r"B=6 must be divisible by the dp axis \(4\)", errors["inputs_not_divisible"])


def test_world_of_one_equals_unsharded_port(fleet):
    """At mesh (1, 1) in a world of one rank the step on prepare_real's
    inputs gives the port's keygen vk (sorted) and its unsharded aggregate,
    all verdicts true, and the sharded verify the one-device verify's."""
    vks, msgs, aggs, want = fleet
    p = params_from_numpy(ftpu.fusion_setup(SECPAR, PSEED))
    seeds, smsgs = [700 + i for i in range(4)], [f"one:{i}" for i in range(4)]
    (res,) = _launch.launch(1, RANKS + ":world_of_one", SECPAR, PSEED, seeds, smsgs,
                            (vks, msgs, aggs), device="cpu", timeout_s=300)
    vk, agg, eq, norm_ok, w_ok = res["step"]
    keys = tlc.keygen(p, seeds, device="cpu")
    np.testing.assert_array_equal(vk, keys.vk_np()[np.array(res["order"])])
    sigs = tlc.sign(p, keys, smsgs)
    np.testing.assert_array_equal(agg, tlc.aggregate(p, keys.vk, smsgs, sigs.sig).numpy())
    assert bool(eq) and bool(norm_ok) and bool(w_ok)
    for got, one in zip(res["verify"], want):
        np.testing.assert_array_equal(got, one)
