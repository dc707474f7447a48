"""The port's slice end to end (scheme/device_pipeline.py, device_setup.py) on
the CPU vs the JAX package: challenge and alpha coefficients, verdicts, fleet
tensors, and verification of each side's fleet by the other side; in both
assemblies of the signer preimages ("fold" and "spec")."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import fusion_cryptography_tpu as ftpu
from fusion_cryptography_tpu.scheme import device_setup as jsetup
from fusion_cryptography_tpu.scheme import lifecycle as lc
from fusion_cryptography_tpu_torch import params_from_numpy
from fusion_cryptography_tpu_torch.scheme import device_pipeline as tdp
from fusion_cryptography_tpu_torch.scheme import device_setup as tsetup


def _host_groups(params, G, N, seed0=100):
    """Keys, sorted messages, aggregates and the host path's challenge/alpha
    coefficients from the JAX package's object-free lifecycle (the oracle of
    tests/test_device_pipeline.py)."""
    keys = ftpu.keygen(params, [seed0 + k for k in range(G * N)])
    msgs = [f"m{g}:{i}" for g in range(G) for i in range(N)]
    sigs = ftpu.sign(params, keys, msgs)
    vk_np = np.array(keys.vk_np())
    reprs = keys.vk_strs()
    order = np.empty((G, N), dtype=np.int64)
    for g in range(G):
        idx = list(range(g * N, (g + 1) * N))
        idx.sort(key=lambda i: reprs[i])
        order[g] = idx
    flat = order.reshape(-1)
    s_msgs = [msgs[i] for i in flat]
    cc, al = lc.derive_alphas_grouped(params, [reprs[i] for i in flat], s_msgs, G, N)
    sig_np = np.asarray(sigs.sig)
    aggs = lc._ctx(params)["aggregate_core"](jnp.asarray(sig_np[order]), jnp.asarray(al))
    return vk_np[order], s_msgs, np.array(aggs), cc, al


@pytest.mark.parametrize("secpar,G,N", [(128, 3, 4), (256, 2, 3)])
def test_derive_coeffs_matches_jax(secpar, G, N):
    jp = ftpu.fusion_setup(secpar, 77)
    vks, msgs, aggs, cc_host, al_host = _host_groups(jp, G, N)
    eq, norm_ok, w_ok, cc, al = tdp.derive_coeffs_device(
        params_from_numpy(jp), torch.from_numpy(vks), msgs, torch.from_numpy(aggs)
    )
    np.testing.assert_array_equal(cc.numpy(), np.asarray(cc_host).reshape(G, N, -1))
    np.testing.assert_array_equal(al.numpy(), np.asarray(al_host))
    assert eq.dtype == torch.bool and eq.shape == (G,)
    assert bool(eq.all() & norm_ok.all() & w_ok.all())
    # the "spec" assembly (the JAX package's pallas_assembly configuration)
    spec = tdp.derive_coeffs_device(params_from_numpy(jp), torch.from_numpy(vks), msgs,
                                    torch.from_numpy(aggs), assembly="spec", device="cpu")
    for a, b in zip(spec, (eq, norm_ok, w_ok, cc, al)):
        assert torch.equal(a, b)


def test_unknown_assembly_raises():
    p = params_from_numpy(ftpu.fusion_setup(128, 3))
    with pytest.raises(ValueError, match="assembly"):
        tdp.make_stages(p, 2, assembly="merge")
    with pytest.raises(ValueError, match="assembly"):
        tsetup.build_fleet(p, 1, 2, device="cpu", assembly="pallas")


def test_get_pipeline_one_per_configuration():
    """A caller that names the default assembly and one that leaves it out
    get the same pipeline; another assembly or signer count gets its own."""
    p = params_from_numpy(ftpu.fusion_setup(128, 3))
    P = tdp.get_pipeline(p, 2, "cpu")
    assert tdp.get_pipeline(p, 2, "cpu", "fold") is P
    assert tdp.get_pipeline(p, 2, "cpu", assembly="fold") is P
    assert tdp.get_pipeline(p, 2, "cpu", "spec") is not P
    assert tdp.get_pipeline(p, 3, "cpu") is not P


def test_tampered_aggregate_rejected_and_chunking():
    jp = ftpu.fusion_setup(128, 99)
    p = params_from_numpy(jp)
    G, N = 3, 2
    vks, msgs, aggs, _, _ = _host_groups(jp, G, N, seed0=500)
    bad = aggs.copy()
    bad[1, 0, 0] = (bad[1, 0, 0] + 1) % jp.modulus
    one = tdp.verify_batch_device(p, torch.from_numpy(vks), msgs, torch.from_numpy(bad))
    # chunks of complete groups (2 + 1) give the same verdicts
    two = tdp.verify_batch_device(p, torch.from_numpy(vks), msgs, torch.from_numpy(bad),
                                  group_chunk=2)
    for a, b in zip(one, two):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert one[0].tolist() == [True, False, True]
    # an over-norm aggregate fails the norm check
    big = aggs.copy()
    big[2] = jp.modulus // 2
    _, norm_ok, _ = tdp.verify_batch_device(p, torch.from_numpy(vks), msgs, torch.from_numpy(big))
    assert norm_ok.tolist() == [True, True, False]


@pytest.fixture(scope="module")
def fleets():
    """The same fleet (secpar=128, G=4, N=3, seed0=41) from both packages."""
    jp = ftpu.fusion_setup(128, 7)
    p = params_from_numpy(jp)
    jv, jm, ja = jsetup.build_fleet(jp, 4, 3, seed0=41)
    tv, tm, ta = tsetup.build_fleet(p, 4, 3, seed0=41, device="cpu")
    return jp, p, (np.array(jv), jm, np.array(ja)), (tv, tm, ta)


def test_build_fleet_matches_jax(fleets):
    _, _, (jv, jm, ja), (tv, tm, ta) = fleets
    assert tv.dtype == torch.int32 and ta.dtype == torch.int32
    np.testing.assert_array_equal(tv.numpy(), jv)
    assert tm == jm
    np.testing.assert_array_equal(ta.numpy(), ja)


def test_build_fleet_spec_assembly_equals_default(fleets):
    _, p, _, (tv, tm, ta) = fleets
    sv, sm, sa = tsetup.build_fleet(p, 4, 3, seed0=41, device="cpu", assembly="spec")
    assert torch.equal(sv, tv) and sm == tm and torch.equal(sa, ta)
    eq, norm_ok, w_ok = tdp.verify_batch_device(p, sv, sm, sa, assembly="spec")
    assert bool(eq.all() & norm_ok.all() & w_ok.all())


def test_port_verifies_jax_fleet(fleets):
    _, p, (jv, jm, ja), _ = fleets
    eq, norm_ok, w_ok = tdp.verify_batch_device(p, torch.from_numpy(jv), jm, torch.from_numpy(ja))
    assert bool(eq.all() & norm_ok.all() & w_ok.all())


def test_jax_verifies_port_fleet(fleets):
    jp, _, _, (tv, tm, ta) = fleets
    N = tv.shape[1]
    for g in range(tv.shape[0]):
        ok, why = lc.verify(jp, tv[g].numpy(), tm[g * N : (g + 1) * N], jnp.asarray(ta[g].numpy()))
        assert ok, why


def test_vk_sort_ranks_with_duplicates():
    jp = ftpu.fusion_setup(128, 5)
    seeds = [100 + k for k in range(30)]
    seeds[1] = seeds[0]  # identical reprs inside group 0: the sort is stable
    vk_np = np.array(ftpu.keygen(jp, seeds).vk_np())
    got = tsetup.vk_sort_ranks(params_from_numpy(jp), torch.from_numpy(vk_np), 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jsetup.vk_sort_ranks(jp, vk_np, 5)))
