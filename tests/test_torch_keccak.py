"""Port sponge (ops/keccak.py plain versions, ops/keccak_sponge.py wrappers on
CPU tensors) vs hashlib and the JAX package's XLA sponge.

The JAX package's fused Pallas sponge cannot be interpreted on the CPU in
reasonable time (tests/test_keccak_assemble_pallas.py), so the JAX side is
its XLA twin (shake256_absorb_words + shake256_squeeze_words,
sha3_256_words) plus the Pallas wrapper's padding function."""
from hashlib import sha3_256, shake_256

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fusion_cryptography_tpu.ops import keccak as jk
from fusion_cryptography_tpu.ops.keccak_pallas import _pad_words_lm as j_pad_words_lm
from fusion_cryptography_tpu_torch.ops import keccak as tk
from fusion_cryptography_tpu_torch.ops import keccak_sponge as ks

LENS = [0, 1, 3, 4, 135, 136, 137, 271, 272, 273, 300, 409]


@pytest.fixture(scope="module")
def payloads():
    """Zero-padded payload words int32[rows, B] (+ the raw bytes)."""
    rng = np.random.default_rng(5)
    msgs = [bytes(rng.integers(0, 256, n, dtype=np.uint8)) for n in LENS]
    rows = -(-(max(LENS) + 1) // tk.RATE) * tk.RATE_WORDS
    buf = np.zeros((len(msgs), 4 * rows), np.uint8)
    for i, m in enumerate(msgs):
        buf[i, : len(m)] = np.frombuffer(m, np.uint8)
    words = buf.view("<u4").T.copy()  # uint32[rows, B]
    return msgs, words, np.array(LENS, np.int32)


def _t(words):
    return torch.from_numpy(words.view(np.int32))


def _bytes(words_t):
    return words_t.t().contiguous().view(torch.uint8).numpy()


def test_keccak_f_matches_jax():
    rng = np.random.default_rng(0)
    st = rng.integers(0, 2**32, size=(25, 2, 16), dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jk.keccak_f(jnp.asarray(st)))
    lanes = tk.words_to_lanes(torch.from_numpy(st.reshape(50, 16).view(np.int32)))
    got = tk.lanes_to_words(tk.keccak_f(lanes)).numpy().view(np.uint32).reshape(25, 2, 16)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_words", [8, 34, 35, 100])
def test_shake256_words_vs_hashlib_and_jax(payloads, n_words):
    msgs, words, lens = payloads
    state = tk.shake256_absorb_words(_t(words), torch.from_numpy(lens))
    got = tk.shake256_squeeze_words(state, n_words)
    gb = _bytes(got)
    for i, m in enumerate(msgs):
        assert gb[i].tobytes() == shake_256(m).digest(4 * n_words), LENS[i]
    want = np.asarray(jk.shake256_squeeze_words(
        jk.shake256_absorb_words(jnp.asarray(words), jnp.asarray(lens)), n_words))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    # the kernel wrappers' CPU path is the same sponge
    np.testing.assert_array_equal(
        ks.shake256_words_w(_t(words), torch.from_numpy(lens), n_words).numpy(), got.numpy()
    )
    np.testing.assert_array_equal(
        ks.shake256_words_plain(_t(words), torch.from_numpy(lens), n_words).numpy(), got.numpy()
    )


def test_sha3_256_words_vs_hashlib_and_jax(payloads):
    msgs, words, lens = payloads
    got = tk.sha3_256_words(_t(words), torch.from_numpy(lens))
    gb = _bytes(got)
    for i, m in enumerate(msgs):
        assert gb[i].tobytes() == sha3_256(m).digest(), LENS[i]
    want = np.asarray(jk.sha3_256_words(jnp.asarray(words), jnp.asarray(lens)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(
        ks.sha3_256_words_w(_t(words), torch.from_numpy(lens)).numpy(), got.numpy()
    )


def test_pad_words_matches_pallas_wrapper(payloads):
    _, words, lens = payloads
    for head in (0x1F, 0x06):
        got, nb = tk.pad_words(_t(words), torch.from_numpy(lens), head, assume_clean=True)
        if head == 0x1F:
            want, wnb = j_pad_words_lm(jnp.asarray(words), jnp.asarray(lens))
            np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want))
            np.testing.assert_array_equal(nb.numpy(), np.asarray(wnb))
        # masking a dirty tail gives the same padded words
        dirty = words.copy()
        dirty[-1] = 0xFFFFFFFF
        again, _ = tk.pad_words(_t(dirty), torch.from_numpy(lens), head)
        np.testing.assert_array_equal(again.numpy(), got.numpy())


def test_absorb_squeeze_kernel_plain_versions(payloads):
    _, words, lens = payloads
    padded, nb = ks._pad_words_lm(_t(words), torch.from_numpy(lens))
    state = ks.absorb(padded, nb)
    assert state.shape == (50, len(LENS)) and state.dtype == torch.int32
    np.testing.assert_array_equal(state.numpy(), tk.absorb_padded(padded, nb).numpy())
    np.testing.assert_array_equal(ks.squeeze(state, 40).numpy(), tk.shake256_squeeze_words(state, 40).numpy())


def test_wrappers_never_fall_back_off_cpu():
    """A tensor that is neither on the CPU nor on a CUDA device is refused,
    not silently hashed by the plain version."""
    w = torch.zeros((34, 4), dtype=torch.int32, device="meta")
    n = torch.ones(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        ks.absorb(w, n)
    with pytest.raises(ValueError):
        ks.squeeze(torch.zeros((50, 4), dtype=torch.int32, device="meta"), 8)


def test_absorb_team_and_warp_ratio():
    """A warp a sponge up to two sponges a scheduler (4 an SM), two threads
    while the pairs' warps (16 sponges each) do not outnumber the
    schedulers, one above; the idle-lane ratio counts each warp's longest
    sponge for each of its sponges."""
    from fusion_cryptography_tpu_torch import bounds

    assert ks.absorb_team(1, 132) == 32
    assert ks.absorb_team(8192, 132) == 2  # a verify call's aggregation
    assert ks.absorb_team(16 * 4 * 132, 132) == 2
    assert ks.absorb_team(16 * 4 * 132 + 1, 132) == 1
    assert ks.absorb_team(32768, 132) == 1  # its prehash and challenge
    nb = torch.tensor([1, 3, 2, 2, 5], dtype=torch.int32)
    assert bounds.keccak_warp_ratio(nb, 2) == (3 + 3 + 2 + 2 + 5) / 13
    assert bounds.keccak_warp_ratio(nb, 1) == 1.0
    assert bounds.keccak_warp_ratio(torch.tensor([4, -2, 0, 4]), 4) == 16 / 8


def test_squeeze_team():
    """The squeeze takes the absorb's rule, except that one rate block (at
    most 34 words: no permutation) takes one thread: at a verify call's
    G = 8,192 the aggregation squeeze (3,968 words) two threads a sponge,
    the challenge squeeze (32,768 sponges) and the prehash digest (8
    words) one."""
    assert ks.squeeze_team(8192, 3968, 132) == 2
    assert ks.squeeze_team(32768, 2106, 132) == 1
    assert ks.squeeze_team(32768, 8, 132) == 1
    assert ks.squeeze_team(8192, 34, 132) == 1
    assert ks.squeeze_team(8192, 35, 132) == 2


# (sponges, squeeze words, SMs) -> (absorb team, squeeze team).  At 132
# SMs: the wide group (32 sponges, 1,015,818 words) a warp each; the
# measured crossover's two sides (1,024 a warp, 2,048 the pair) and the
# rule's edge (2 sponges x 528 schedulers); the short and nist cells' group
# (8,192) the pair; the prehash and challenge (32,768) one thread; a
# squeeze of at most 34 words one thread whatever the batch.
TEAM_CASES = [
    ((32, 1015818, 132), (32, 32)),
    ((1, 35, 132), (32, 32)),
    ((1024, 2106, 132), (32, 32)),
    ((1056, 3968, 132), (32, 32)),
    ((1057, 3968, 132), (2, 2)),
    ((2048, 3968, 132), (2, 2)),
    ((8192, 3968, 132), (2, 2)),
    ((8448, 3968, 132), (2, 2)),
    ((8449, 3968, 132), (1, 1)),
    ((32768, 2106, 132), (1, 1)),
    ((32, 34, 132), (32, 1)),
    ((32, 8, 132), (32, 1)),
    ((32768, 8, 132), (1, 1)),
    ((528, 3968, 66), (32, 32)),
    ((529, 3968, 66), (2, 2)),
]


@pytest.mark.parametrize("shape,teams", TEAM_CASES,
                         ids=[f"{b}x{w}w@{s}" for (b, w, s), _ in TEAM_CASES])
def test_team_rule_from_batch_and_sms(shape, teams):
    """The team is chosen from the batch, the SM count and (for the squeeze)
    the words alone: a warp a sponge up to two sponges a scheduler, the
    pair up to 16, one thread above; one thread for a squeeze with no
    permutation."""
    batch, n_words, sms = shape
    assert (ks.absorb_team(batch, sms), ks.squeeze_team(batch, n_words, sms)) == teams
