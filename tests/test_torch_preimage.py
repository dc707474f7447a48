"""Port preimage assembly (ops/ragged_words.py, interop/device_serial.py) vs
the JAX package's word path: packed words, lengths and bounds byte-identical."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import fusion_cryptography_tpu as ftpu
from fusion_cryptography_tpu.interop import device_serial as jds
from fusion_cryptography_tpu.interop import serial
from fusion_cryptography_tpu.ops import ragged_words as jrw
from fusion_cryptography_tpu_torch.interop import device_serial as tds
from fusion_cryptography_tpu_torch.ops import ragged_words as trw
from fusion_cryptography_tpu_torch.params import params_from_numpy

Q = 2147465729
EDGE = [0, 1, -1, 9, -9, 10, -10, 99, 100, Q // 2, -(Q // 2), 123456789, -1000000000]


def _centered(rng, shape):
    v = rng.integers(-(Q // 2), Q // 2 + 1, size=shape).astype(np.int32)
    flat = v.reshape(-1)
    flat[: len(EDGE)] = EDGE
    # short renders too, so lengths vary a lot between lanes
    flat[len(EDGE) :: 7] = rng.integers(-999, 1000, size=flat[len(EDGE) :: 7].shape)
    return v


def _u32(t):
    return t.numpy().view(np.uint32)


def _same_chunk(port, jax_chunk):
    np.testing.assert_array_equal(_u32(port.buf), np.asarray(jax_chunk.buf))
    np.testing.assert_array_equal(port.length.numpy(), np.asarray(jax_chunk.length))
    assert (port.max_len, port.min_len) == (jax_chunk.max_len, jax_chunk.min_len)


def _same_pair(port, jax_pair):
    np.testing.assert_array_equal(_u32(port[0]), np.asarray(jax_pair[0]))
    np.testing.assert_array_equal(port[1].numpy(), np.asarray(jax_pair[1]))


def _digests(B, seed):
    d = np.random.default_rng(seed).integers(0, 2**32, size=(8, B), dtype=np.uint64)
    d = d.astype(np.uint32)
    d[:, 0] = 0
    d[:, 1] = 0xFFFFFFFF
    d[:, 2] = 0
    d[0, 2] = 7  # one digit
    ten77 = 10**77
    d[:, 3] = [(ten77 >> (32 * k)) & 0xFFFFFFFF for k in range(8)]
    return d


def test_render_bigint_dec_w():
    d = _digests(9, 1)
    got = trw.render_bigint_dec_w(torch.from_numpy(d.view(np.int32)))
    _same_chunk(got, jrw.render_bigint_dec_w(jnp.asarray(d)))
    for b in range(9):
        n = int.from_bytes(d[:, b].astype("<u4").tobytes(), "little")
        s = str(n).encode()
        row = got.buf[:, b].contiguous().view(torch.uint8).numpy().tobytes()
        assert row[: len(s)] == s and not any(row[len(s) :]) and int(got.length[b]) == len(s)


@pytest.mark.parametrize("sep", [b"", b", ", b"abcde"])
def test_render_decimal_cells_w(sep):
    v = _centered(np.random.default_rng(2), (6, 11))
    v[0, :2] = [-(2**31), 2**31 - 1]
    got = trw.render_decimal_cells_w(torch.from_numpy(v), sep)
    _same_chunk(got, jrw.render_decimal_cells_w(jnp.asarray(v), sep))


def test_pack_unpack_and_merge():
    rng = np.random.default_rng(3)
    by = rng.integers(0, 256, size=(2, 13, 5), dtype=np.uint8)
    got = trw.pack_bytes_to_words(torch.from_numpy(by))
    np.testing.assert_array_equal(_u32(got), np.asarray(jrw.pack_bytes_to_words(jnp.asarray(by))))
    back = trw.unpack_words_to_bytes(got, 13)
    np.testing.assert_array_equal(back.numpy(), by)
    # merge of two ragged chunks == merge_w of the JAX package
    la = np.array([0, 3, 7, 12, 5], np.int32)
    lb = np.array([4, 0, 9, 1, 6], np.int32)
    mk = lambda n, lens: np.where(np.arange(n)[:, None] < lens, rng.integers(1, 256, (n, 5)), 0).astype(np.uint8)  # noqa: E731
    a8, b8 = mk(12, la), mk(9, lb)
    ja = jrw.WChunk(jrw.pack_bytes_to_words(jnp.asarray(a8)), jnp.asarray(la), 12, 0)
    jb = jrw.WChunk(jrw.pack_bytes_to_words(jnp.asarray(b8)), jnp.asarray(lb), 9, 0)
    ta = trw.WChunk(trw.pack_bytes_to_words(torch.from_numpy(a8)), torch.from_numpy(la), 12, 0)
    tb = trw.WChunk(trw.pack_bytes_to_words(torch.from_numpy(b8)), torch.from_numpy(lb), 9, 0)
    _same_chunk(trw.merge_w(ta, tb), jrw.merge_w(ja, jb))
    _same_chunk(trw.fold_chunks_w([ta, tb, ta]), jrw.fold_chunks_w([ja, jb, ja]))


N_AGG = 3


def _host_strings(jp, vk2d, c_hat, digest, b):
    """The reference str() preimages of lane b, from the JAX package's host
    serializer (interop/serial.py, KAT-pinned)."""
    d = jp.degree
    vk = serial.vk_str(jp, vk2d[:, b].reshape(2, d))
    pre = int.from_bytes(digest[:, b].astype("<u4").tobytes(), "little")
    ch = serial.challenge_str(jp, c_hat[:, b])
    challenge = bytes(jp.sign_hash_dst) + f",{vk},{pre}".encode()
    triple = f"({vk}, {pre}, {ch})".encode()
    return vk.encode(), challenge, triple


def _lane_bytes(buf, length, b):
    row = buf[:, b].contiguous().view(torch.uint8).numpy().tobytes()
    n = int(length[b])
    assert not any(row[n:]), "bytes past the length must be zero"
    return row[:n]


@functools.lru_cache(maxsize=None)
def _port_preimages(secpar):
    """Port preimages of 5 random signers (+ one aggregation preimage over
    the first N_AGG of them) and their inputs."""
    jp = ftpu.fusion_setup(secpar, 11)
    tp = params_from_numpy(jp)
    B = 5
    rng = np.random.default_rng(secpar)
    vk2d = _centered(rng, (2 * jp.degree, B))
    c_hat = _centered(rng, (jp.degree, B))
    digest = _digests(B, secpar)
    pre = trw.render_bigint_dec_w(torch.from_numpy(digest.view(np.int32)))
    vk = tds.vk_chunk_w(tp, torch.from_numpy(vk2d))
    ch = tds.fold_challenge_preimage_w(tp, vk, pre, pad_words=PAD_CH)
    tri = tds.fold_triple_w(tp, vk, pre, torch.from_numpy(c_hat))
    tri_spec = tds.triple_spec(tp)
    bounds = [(tds.spec_min_total(tri_spec, [1]), tri_spec.out_max)] * N_AGG
    agg = tds.assemble_chunks_words(
        tds.agg_preimage_spec(tp, N_AGG, tri_spec.out_max), None,
        [(tri[0][:, k : k + 1].contiguous(), tri[1][k : k + 1]) for k in range(N_AGG)],
        bounds, pad_words=PAD_AGG[secpar],
    )
    return jp, vk2d, c_hat, digest, dict(vk=vk, ch=ch, tri=tri, agg=agg)


@pytest.fixture(scope="module", params=[128, 256])
def port_preimages(request):
    return _port_preimages(request.param)


PAD_CH = 2 * 1843
PAD_AGG = {128: 3 * 1200, 256: 3 * 2700}


def test_preimages_match_host_serializer(port_preimages):
    jp, vk2d, c_hat, digest, got = port_preimages
    triples = []
    for b in range(vk2d.shape[1]):
        vk, challenge, triple = _host_strings(jp, vk2d, c_hat, digest, b)
        assert _lane_bytes(got["vk"].buf, got["vk"].length, b) == vk
        assert _lane_bytes(*got["ch"], b) == challenge
        assert _lane_bytes(*got["tri"], b) == triple
        triples.append(triple)
    agg = bytes(jp.agg_xof_dst) + b",[" + b", ".join(triples[:N_AGG]) + b"]"
    assert _lane_bytes(*got["agg"], 0) == agg
    assert got["ch"][0].shape[0] == PAD_CH and got["agg"][0].shape[0] == PAD_AGG[jp.secpar]


def test_preimages_match_jax_word_path():
    """Word-for-word against the JAX package's word path (jitted; at
    secpar=128, where its CPU compile is short — secpar=256 is held to the
    host serializer above and, end to end, by tests/test_torch_pipeline.py)."""
    jp, vk2d, c_hat, digest, got = _port_preimages(128)
    tri_spec = jds.triple_spec(jp)
    bounds = [(jds.spec_min_total(tri_spec, [1]), tri_spec.out_max)] * N_AGG
    agg_spec = jds.agg_preimage_spec(jp, N_AGG, tri_spec.out_max)

    @jax.jit
    def oracle(vk2d, c_hat, digest):
        pre = jrw.render_bigint_dec_w(digest)
        vk = jds.vk_chunk_w(jp, vk2d)
        ch = jds.fold_challenge_preimage_w(jp, vk, pre, pad_words=PAD_CH)
        tri = jds.fold_triple_w(jp, vk, pre, c_hat)
        agg = jds.assemble_chunks_words(
            agg_spec, None, [(tri[0][:, k : k + 1], tri[1][k : k + 1]) for k in range(N_AGG)],
            bounds, pad_words=PAD_AGG[128],
        )
        return (vk.buf, vk.length), ch, tri, agg

    want = oracle(jnp.asarray(vk2d), jnp.asarray(c_hat), jnp.asarray(digest))
    vk = got["vk"]
    _same_pair((vk.buf, vk.length), want[0])
    assert (vk.max_len, vk.min_len) == (jds.vk_body_spec(jp).out_max,
                                        jds.spec_min_total(jds.vk_body_spec(jp), []))
    _same_pair(got["ch"], want[1])
    _same_pair(got["tri"], want[2])
    _same_pair(got["agg"], want[3])


def test_specs_and_terminators():
    for secpar in (128, 256):
        jp = ftpu.fusion_setup(secpar, 3)
        tp = params_from_numpy(jp)
        for name in ("challenge_preimage_spec", "triple_spec", "vk_body_spec",
                     "challenge_body_spec"):
            js, ts = getattr(jds, name)(jp), getattr(tds, name)(tp)
            np.testing.assert_array_equal(ts.template, js.template)
            np.testing.assert_array_equal(ts.kind, js.kind)
            assert ts.out_max == js.out_max
            assert tds.spec_min_total(ts, [1] * ts.num_extras) == jds.spec_min_total(
                js, [1] * js.num_extras)
            assert ts.nodes == jds._compile_spec(js)
        np.testing.assert_array_equal(
            tds.number_terminators(tds.vk_body_spec(tp)),
            jds.number_terminators(jds.vk_body_spec(jp)),
        )


def test_prehash_stage_renders_host_prehash():
    """The placed message preimages (device_pipeline._message_tensors) + the
    device prehash stage (SHA3-256 on the sponge wrappers, decimal render)
    give str(hash_message_to_int(dst, m)), and the placed words are the JAX
    package's msg_preimage_words rows padded by its SHA3 padding."""
    from fusion_cryptography_tpu.hashing.xof import hash_message_to_int as j_hash
    from fusion_cryptography_tpu.ops.keccak import _payload_words_to_blocks
    from fusion_cryptography_tpu.scheme.device_pipeline import msg_preimage_words as j_words
    from fusion_cryptography_tpu_torch.hashing.xof import hash_message_to_int
    from fusion_cryptography_tpu_torch.scheme import device_pipeline as tdp

    jp = ftpu.fusion_setup(256, 3)
    tp = params_from_numpy(jp)
    # dst + "," is 3 bytes: 133 and 134 characters end at the rate edge
    msgs = ["", "a", "x" * 133, "y" * 134, "é" * 70, "m" * 300, "group7:msg3"]
    mw, mb, ml = tdp._message_tensors(tp, msgs, "cpu")
    jw, jl = j_words(jp, msgs)
    rows, B = mw.shape
    full = -(-max(rows, jw.shape[1]) // 34) * 34
    jt = np.zeros((full, B), np.uint32)
    jt[:jw.shape[1]] = jw.T
    blocks, jb = _payload_words_to_blocks(jnp.asarray(jt), jnp.asarray(jl), pad_head=0x06,
                                          assume_clean=True)
    want = np.asarray(blocks).reshape(full, B)
    np.testing.assert_array_equal(_u32(mw), want[:rows])
    assert not want[rows:].any()
    np.testing.assert_array_equal(mb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(ml.numpy(), jl)
    prehash, _, _ = tdp.make_stages(tp, 2)
    pre_w, pre_len = prehash(mw, mb)
    assert pre_w.shape == (tds.PREHASH_W // 4 + 1, len(msgs))
    for b, m in enumerate(msgs):
        want = hash_message_to_int(tp.sign_pre_hash_dst, m)
        assert want == j_hash(jp.sign_pre_hash_dst, m)
        assert _lane_bytes(pre_w, pre_len, b) == str(want).encode()
