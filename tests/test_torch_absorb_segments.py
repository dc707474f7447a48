"""keccak.shake256_absorb_segments_words of the port vs the JAX package's on
tests/test_absorb_segments.py's cases: the same states (read through the same
squeeze) from the same ragged packed-word segments, equal to hashlib and to
the port's contiguous absorb of the concatenation."""
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusion_cryptography_tpu.ops import keccak as jkc
from fusion_cryptography_tpu.ops import ragged_words as jrw
from fusion_cryptography_tpu_torch.ops import keccak as tkc

SPECS = [
    [(3, 13)],
    [(0, 0 + 5), (1, 78), (2, 2)],
    [(130, 150), (1, 300), (7, 7), (0, 140), (136, 136)],
    [(400, 700), (1, 78), (200, 420), (1, 1)],
]
CONTIGUOUS_SPEC = [(10, 260), (1, 78), (50, 413)]


def _segments(rng, B, spec):
    """Normal-form segments as uint32 word arrays uint32[W, B] (zero past each
    length), their lengths, and each lane's concatenated bytes."""
    segs, payloads = [], [b""] * B
    for mn, mx in spec:
        lens = rng.integers(mn, mx + 1, B).astype(np.int32)
        W = jrw.words_for(mx)
        by = np.zeros((B, W * 4), np.uint8)
        for b in range(B):
            by[b, :lens[b]] = rng.integers(1, 256, lens[b])
            payloads[b] += by[b, :lens[b]].tobytes()
        segs.append((by.view("<u4").T.copy(), lens, mn, mx))
    return segs, payloads


def _port_segments(segs):
    return [(torch.from_numpy(w.view(np.int32)), torch.from_numpy(ln), mn, mx)
            for w, ln, mn, mx in segs]


@pytest.mark.parametrize("spec", SPECS, ids=["single", "tiny", "rate-straddling", "triple-like"])
def test_segments_match_jax_and_hashlib(spec):
    rng = np.random.default_rng(len(str(spec)))
    B, n_words = 13, 40
    segs, payloads = _segments(rng, B, spec)
    bounds = [(mn, mx) for _, _, mn, mx in segs]

    @jax.jit
    def jax_xof(words, lens):
        segments = [(w, ln, mn, mx) for w, ln, (mn, mx) in zip(words, lens, bounds)]
        return jkc.shake256_squeeze_words(jkc.shake256_absorb_segments_words(segments), n_words)

    want = np.asarray(jax_xof([jnp.asarray(w) for w, *_ in segs],
                              [jnp.asarray(ln) for _, ln, *_ in segs])).view(np.int32)
    t_state = tkc.shake256_absorb_segments_words(_port_segments(segs))
    assert t_state.dtype == torch.int32 and tuple(t_state.shape) == (50, B)
    got = tkc.shake256_squeeze_words(t_state, n_words).numpy()
    np.testing.assert_array_equal(got, want)
    for b in range(B):
        assert got[:, b].tobytes() == hashlib.shake_256(payloads[b]).digest(4 * n_words)


def test_segments_match_contiguous_absorb():
    rng = np.random.default_rng(9)
    B = 13
    segs, payloads = _segments(rng, B, CONTIGUOUS_SPEC)
    rows = -(-(sum(mx for *_, mx in segs) + 1) // tkc.RATE) * tkc.RATE_WORDS
    by = np.zeros((B, 4 * rows), np.uint8)
    for b in range(B):
        by[b, :len(payloads[b])] = np.frombuffer(payloads[b], np.uint8)
    lens = torch.tensor([len(x) for x in payloads], dtype=torch.int32)
    want = tkc.shake256_absorb_words(torch.from_numpy(by.view(np.int32).T.copy()), lens)
    assert torch.equal(tkc.shake256_absorb_segments_words(_port_segments(segs)), want)
