"""The frozen roofline arithmetic against counts worked out by hand."""
import numpy as np

from portbench import roofline
from portbench.reference import fusion_ref as ref


def test_sponge_and_ntt_counts():
    # pad10*1: 135 bytes fit one block, 136 need a second
    assert roofline.absorb_perms([0, 135, 136, 271, 272]) == 1 + 1 + 2 + 2 + 3
    assert roofline.squeeze_perms(136, 5) == 0
    assert roofline.squeeze_perms(137, 5) == 5
    assert roofline.squeeze_perms(8423, 1) == 61  # ceil(8423 / 136) - 1
    # d = 256: 128 butterflies a stage, 8 stages, 5 operations each
    assert roofline.ntt_ops(3, 256) == 3 * 128 * 8 * 5
    assert roofline.KECCAK_OPS == 4320
    assert roofline.str_lengths(np.array([[0, -1, 9, 10, -2147465728]])).tolist() == [1 + 2 + 1 + 2 + 11]


def test_challenge_bytes_consumed():
    # secpar 256: 8 signum bytes, 60 blocks of 33, then 195 indices of 33
    assert roofline.challenge_bytes_consumed(ref.setup(256, 42)) == 8 + 60 * 33 + 195 * 33
    # secpar 128: 4 signum bytes, 27 blocks of 17, 36 indices of 17
    assert roofline.challenge_bytes_consumed(ref.setup(128, 42)) == 4 + 27 * 17 + 36 * 17


def test_verify_work_by_hand():
    """One group of one signer at secpar 128 with all-zero vks, counted by
    building each preimage."""
    p = ref.setup(128, 42)
    vks = np.zeros((1, 1, 2, p.degree), dtype=np.int64)
    msg = "m" * 200
    work = roofline.verify_work(p, vks, [msg])
    vk_s = ref.vk_str(p, vks[0, 0])
    pre = ref.prehash(p, msg)
    c_hat = ref.challenges(p, [vk_s], [pre])[0]
    pre_image = p.pre_dst + b"," + msg.encode()
    ch_image = p.ch_dst + b"," + vk_s.encode() + b"," + str(pre).encode()
    ag_image = (p.ag_dst + b"," + f"[({vk_s}, {pre}, {ref.challenge_str(p, c_hat)})]".encode())
    blocks = sum(len(x) // 136 + 1 for x in (pre_image, ch_image, ag_image))
    squeeze = (-(-roofline.challenge_bytes_consumed(p) // 136) - 1
               + -(-ref.agg_block_len(p) // 136) - 1)
    assert work["keccak_perms"] == blocks + squeeze
    assert work["int_ops"] == (blocks + squeeze) * 4320 + (2 + p.rank) * 32 * 6 * 5
    assert work["bytes"] == 4 * p.rank * p.degree + 4 * 2 * p.degree + 200 + 3
    assert roofline.least_seconds(work) == max(work["bytes"] / 3.35e12,
                                               work["int_ops"] / (132 * 64 * 1.98e9))
