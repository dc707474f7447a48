"""The benchmark's plain reference against the port's CPU path on tiny
inputs: the grouped verify's verdicts with tampered groups, and batched
keygen and sign bit for bit."""
import numpy as np
import pytest
import torch

from portbench import traffic as tf
from portbench.reference import fusion_ref as ref


def test_verify_verdicts_match_the_port():
    from fusion_cryptography_tpu_torch.params import fusion_setup
    from fusion_cryptography_tpu_torch.scheme import device_pipeline as dp
    from fusion_cryptography_tpu_torch.scheme.device_setup import build_fleet

    params = fusion_setup(128, 42)
    G, N, seed = 3, 4, 2**35 + 11
    traffic = {"message_length": {"multiple": 33, "k_min": 1, "k_max": 5}, "batches": 1,
               "tamper_share": 0.67}
    msgs = tf.messages(traffic, G * N, seed, 0)
    vks, msgs, aggs = build_fleet(params, G, N, seed0=tf.key_seed_base(seed, 0), messages=msgs,
                                  device="cpu")
    plan = {0: "message", 2: "aggregate"}
    tf.tamper(params.modulus, plan, N, msgs, aggs, seed, 0)
    got = torch.stack(dp.verify_batch_device(params, vks, msgs, aggs, device="cpu")).T.numpy()
    want = ref.verify_groups(ref.setup(128, 42), vks.numpy(),
                             [msgs[g * N:(g + 1) * N] for g in range(G)], aggs.numpy())
    assert want.tolist() == got.tolist()
    assert want.all(axis=1).tolist() == tf.plan_verdicts(plan, G).tolist()
    assert want[2].tolist() == [False, False, True]


def test_keygen_and_sign_match_the_port():
    from fusion_cryptography_tpu_torch.params import fusion_setup
    from fusion_cryptography_tpu_torch.scheme import lifecycle as lc

    params, rp = fusion_setup(128, 42), ref.setup(128, 42)
    seeds = [2**61 + 5, 77, 2**40]
    msgs = ["x" * 59, "", "tail"]
    keys = lc.keygen(params, seeds, device="cpu")
    sigs = lc.sign(params, keys, msgs)
    for k, (s, m) in enumerate(zip(seeds, msgs)):
        sk_hat, vk = ref.keygen(rp, s)
        assert np.array_equal(keys.vk[k].numpy(), vk)
        assert np.array_equal(sigs.sig[k].numpy(), ref.sign(rp, sk_hat, vk, m))


def test_reference_groups_in_a_port_batch():
    """The sampled groups a verify cell runs are the reference's own:
    written into the program's batch, tampered alike in both copies, and
    the port's verdicts on them agree with the plan and the reference."""
    from fusion_cryptography_tpu_torch.params import fusion_setup
    from fusion_cryptography_tpu_torch.scheme import device_pipeline as dp
    from fusion_cryptography_tpu_torch.scheme.device_setup import build_fleet

    params, rp = fusion_setup(128, 42), ref.setup(128, 42)
    G, N, seed = 4, 2, 2**36 + 1
    every = tf.messages({"message_length": {"fixed": 20}}, G * N, seed, 0)
    vks, msgs, aggs = build_fleet(params, G, N, seed0=tf.key_seed_base(seed, 0), messages=every,
                                  device="cpu")
    plan = {1: "aggregate", 2: "message"}
    own_vks, own_msgs, own_aggs = tf.put_reference_groups(rp, plan, seed, 0, [1, 3], every,
                                                          msgs, vks, aggs)
    assert np.array_equal(vks[[1, 3]].numpy(), own_vks)
    assert np.array_equal(aggs[[1, 3]].numpy(), own_aggs)
    assert own_msgs == [msgs[2:4], msgs[6:8]] and sorted(own_msgs[1]) == sorted(every[6:8])
    got = torch.stack(dp.verify_batch_device(params, vks, msgs, aggs, device="cpu")).T.numpy()
    assert got.all(axis=1).tolist() == tf.plan_verdicts(plan, G).tolist()
    assert got[[1, 3]].tolist() == ref.verify_groups(rp, own_vks, own_msgs, own_aggs).tolist()


def test_configuration_widths_are_held():
    from portbench.driver_base import scheme_params

    config = {"secpar": 128, "setup_seed": 42, "degree": 64, "rank": 195, "modulus": ref.PRIME}
    program, reference = scheme_params(config)
    assert (program.degree, reference.rank) == (64, 195)
    with pytest.raises(ValueError, match="rank"):
        scheme_params({**config, "rank": 83})
