"""The port's binary format (scheme/serde.py) vs the JAX package's: the same
bytes for the same objects at both security levels, decoding across the
packages, decoded parameters that equal and hash as the encoded ones, the
same ValueErrors, and a port lifecycle that still verifies after a round
trip."""
import numpy as np
import pytest
import torch

import fusion_cryptography_tpu as ftpu
from fusion_cryptography_tpu.scheme import serde as jserde
from fusion_cryptography_tpu_torch import fusion_setup as tsetup
from fusion_cryptography_tpu_torch.interop import serial as tserial
from fusion_cryptography_tpu_torch.scheme import device_pipeline as tdp
from fusion_cryptography_tpu_torch.scheme import lifecycle as tlc
from fusion_cryptography_tpu_torch.scheme import serde as tserde


def _objects(secpar: int, seed: int):
    """Both packages' params and random int32 vk, sk, signature and
    aggregate arrays of that level's shapes."""
    jp, tp = ftpu.fusion_setup(secpar, seed), tsetup(secpar, seed)
    rng = np.random.default_rng(seed)
    d, rank = tp.degree, tp.rank

    def draw(*shape):
        return rng.integers(-2**31, 2**31, size=shape, dtype=np.int64).astype(np.int32)

    return jp, tp, dict(vk=draw(2, d), sk=draw(2, rank, d), sig=draw(rank, d), agg=draw(rank, d))


@pytest.mark.parametrize("secpar", [128, 256])
def test_same_bytes_as_jax(secpar):
    jp, tp, o = _objects(secpar, 42)
    assert tserde.encode_params(tp) == jserde.encode_params(jp)
    # tensors on the CPU and numpy arrays encode alike
    for as_in in (np.asarray, torch.from_numpy):
        assert tserde.encode_vk(tp, as_in(o["vk"])) == jserde.encode_vk(jp, o["vk"])
        for seed in (7, None, 2**32, -1):
            assert (tserde.encode_sk(tp, seed, as_in(o["sk"]))
                    == jserde.encode_sk(jp, seed, o["sk"]))
        for kind in ("sig", "agg"):
            assert (tserde.encode_signature(tp, as_in(o[kind]))
                    == jserde.encode_signature(jp, o[kind]))


@pytest.mark.parametrize("secpar", [128, 256])
def test_decodes_across_packages(secpar):
    jp, tp, o = _objects(secpar, 9)
    for enc, dec in ((jserde, tserde), (tserde, jserde)):
        p_in = jp if enc is jserde else tp
        secpar_out, vk = dec.decode_vk(enc.encode_vk(p_in, o["vk"]))
        assert secpar_out == secpar and vk.dtype == np.int32
        np.testing.assert_array_equal(vk, o["vk"])
        for seed in (7, None):
            s_out, seed_out, sk = dec.decode_sk(enc.encode_sk(p_in, seed, o["sk"]))
            assert (s_out, seed_out) == (secpar, seed)
            np.testing.assert_array_equal(sk, o["sk"])
        _, sig = dec.decode_signature(enc.encode_signature(p_in, o["sig"]))
        np.testing.assert_array_equal(sig, o["sig"])
    # decoded params: equal to the encoded ones, the same hash, the same repr
    for data in (jserde.encode_params(jp), tserde.encode_params(tp)):
        p2 = tserde.decode_params(data)
        assert p2 == tp and hash(p2) == hash(tp) and p2.seed is None
        assert tserial.params_str(p2) == tserial.params_str(tp)
        assert tdp.get_pipeline(p2, 2, "cpu") is tdp.get_pipeline(tp, 2, "cpu")
        np.testing.assert_array_equal(jserde.decode_params(data).public_challenge,
                                      p2.public_challenge)


@pytest.mark.parametrize("data", [
    b"XXXX" + b"\x00" * 32,  # magic
    jserde._HDR.pack(b"FTPU", 2, jserde.KIND_VK, 128, 2, 64) + b"\x00" * 512,  # version
    jserde._HDR.pack(b"FTPU", 1, jserde.KIND_SIG, 128, 2, 64) + b"\x00" * 512,  # kind
], ids=["magic", "version", "kind"])
def test_bad_headers_raise_value_error_in_both(data):
    for mod in (jserde, tserde):
        with pytest.raises(ValueError):
            mod.decode_vk(data)
    for mod in (jserde, tserde):
        with pytest.raises(ValueError):
            mod.decode_sk(data[:4] + bytes([1, jserde.KIND_VK]) + data[6:])


def test_port_lifecycle_round_trips_and_verifies():
    p = tsetup(128, 42)
    keys = tlc.keygen(p, [7, 8], device="cpu")
    msgs = ["a", "b"]
    sigs = tlc.sign(p, keys, msgs)
    agg = tlc.aggregate(p, keys.vk, msgs, sigs.sig)
    p2 = tserde.decode_params(tserde.encode_params(p))
    vks = torch.stack([torch.from_numpy(tserde.decode_vk(tserde.encode_vk(p, v))[1])
                       for v in keys.vk])
    _, seed, sk = tserde.decode_sk(tserde.encode_sk(p, 7, keys.sk_hat[0]))
    assert seed == 7 and torch.equal(torch.from_numpy(sk), keys.sk_hat[0])
    _, agg2 = tserde.decode_signature(tserde.encode_signature(p, agg))
    assert tlc.verify(p2, vks, msgs, torch.from_numpy(agg2)) == (True, "")
