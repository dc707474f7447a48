"""Port XOF decode (ops/xof_decode.py word path) vs the JAX package's
decode_coeffs_w and the host decoder, on the same random streams."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import fusion_cryptography_tpu as ftpu
from fusion_cryptography_tpu.hashing import decode as host_decode
from fusion_cryptography_tpu.hashing.xof import agg_block_len, challenge_xof_len
from fusion_cryptography_tpu.ops import xof_decode as jxd
from fusion_cryptography_tpu_torch.ops import xof_decode as txd

Q = 2147465729


def _geometries(secpar):
    p = ftpu.fusion_setup(secpar, 1)
    out = []
    for beta, omega in ((p.beta_ch, p.omega_ch), (p.beta_ag, p.omega_ag)):
        geo = (p.secpar, p.modulus, p.degree, max(1, min(Q // 2, beta)), omega)
        out.append(geo)
    n_ch = challenge_xof_len(p.secpar, p.degree, p.modulus, p.beta_ch, p.omega_ch)
    n_ag = agg_block_len(p.secpar, p.degree, p.modulus, p.beta_ag, p.omega_ag)
    return out, n_ch, n_ag


@pytest.mark.parametrize("secpar", [128, 256])
def test_geometry_and_consumed_bytes(secpar):
    (g_ch, g_ag), n_ch, n_ag = _geometries(secpar)
    for geo, n in ((g_ch, n_ch), (g_ag, n_ag)):
        tg, jg = txd.geometry(*geo), jxd.geometry(*geo)
        for f in ("degree", "weight_bound", "bound", "bytes_per_coefficient",
                  "bytes_per_index", "bytes_for_signums", "index_stream_offset",
                  "num_swaps", "min_bytes"):
            assert getattr(tg, f) == getattr(jg, f), f
        assert txd.consumed_bytes(tg, n) == jxd.consumed_bytes(jg, n)


def _streams(seed, n_bytes, B):
    W = -(-n_bytes // 4) + 1  # one spare word: bytes past n_bytes must be ignored
    return np.random.default_rng(seed).integers(0, 2**32, size=(W, B), dtype=np.uint64).astype(np.uint32)


CASES = [
    # (secpar, which geometry, stream bytes: None = the pipeline's length)
    (128, "ch", None),
    (256, "ch", None),
    (256, "ag", None),  # truncated index stream: empty reads give j = 0
    (256, "ch", 5000),  # a stream cut inside the index region
]


@pytest.mark.parametrize("secpar,which,n_bytes", CASES)
def test_decode_coeffs_w_matches_jax_and_host(secpar, which, n_bytes):
    (g_ch, g_ag), n_ch, n_ag = _geometries(secpar)
    geo = g_ch if which == "ch" else g_ag
    tg, jg = txd.geometry(*geo), jxd.geometry(*geo)
    if n_bytes is None:
        n_bytes = txd.consumed_bytes(tg, n_ch) if which == "ch" else n_ag
    words = _streams(secpar + len(which) + n_bytes, n_bytes, 6)
    got = txd.decode_coeffs_w(torch.from_numpy(words.view(np.int32)), tg, n_bytes)
    assert got.dtype == torch.int32 and got.shape == (tg.degree, 6)
    want = jax.jit(lambda w: jxd.decode_coeffs_w(w, jg, n_bytes))(jnp.asarray(words))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    stream = words.T.copy().view(np.uint8)[:, :n_bytes]
    for b in range(6):
        host = host_decode.decode_bytes_to_coefficients(stream[b].tobytes(), *geo)
        np.testing.assert_array_equal(got[:, b].numpy(), host)
        assert int((got[:, b] != 0).sum()) == tg.weight_bound


def test_decode_with_magnitudes():
    """bound > 1 (the magnitude blocks are reduced, not all-ones)."""
    geo = (128, Q, 64, 5, 27)
    tg, jg = txd.geometry(*geo), jxd.geometry(*geo)
    n = tg.min_bytes + 40
    words = _streams(77, n, 5)
    got = txd.decode_coeffs_w(torch.from_numpy(words.view(np.int32)), tg, n)
    want = jxd.decode_coeffs_w(jnp.asarray(words), jg, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.abs().max()) > 1


@pytest.mark.parametrize("stream_bytes", [3968, 1001])
def test_split_and_realign(stream_bytes):
    N = 4
    words = _streams(stream_bytes, N * stream_bytes, 3)
    got = txd.split_streams_w(torch.from_numpy(words.view(np.int32)), N, stream_bytes)
    want = jxd.split_streams_w(jnp.asarray(words), N, stream_bytes)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want))
    for off in (0, 1, 6, 4 * words.shape[0] - 5):
        got = txd.realign_words(torch.from_numpy(words.view(np.int32)), off, 9)
        want = jxd.realign_words(jnp.asarray(words), off, 9)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want))
