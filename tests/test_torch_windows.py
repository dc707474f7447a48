"""The windowed verify (scheme/device_pipeline.py) on the CPU: the JAX
package's chunk and window schedule, and at every window geometry the
challenge and alpha coefficients equal to JAX's ``derive_alphas_grouped`` and
to the one-chunk call, with a tampered group in the last window failing
alone."""
import numpy as np
import pytest
import torch

import fusion_cryptography_tpu as ftpu
from fusion_cryptography_tpu.scheme import device_pipeline as jdp
from fusion_cryptography_tpu.scheme import lifecycle as jlc
from fusion_cryptography_tpu_torch import params_from_numpy
from fusion_cryptography_tpu_torch.interop import serial as tserial
from fusion_cryptography_tpu_torch.scheme import device_pipeline as tdp
from fusion_cryptography_tpu_torch.scheme import device_setup as tsetup


def _jax_windows(G, gc, ghc):
    """The JAX package's _verify_windows schedule, from its _launch_chunks."""
    ghc = max(gc, (ghc // gc) * gc)
    chunks = jdp._launch_chunks(G, gc)
    return [(wlo, whi, [c for c in chunks if c[0] >= wlo and c[1] <= whi])
            for wlo, whi in jdp._launch_chunks(G, ghc)]


@pytest.mark.parametrize("G", [1, 5, 8, 17])
def test_schedule_is_jax_schedule(G):
    for gc in (1, 2, 3, 8, 64):
        for ghc in (1, gc, 2 * gc, 2 * gc + 1, 5, 100):
            assert tdp.windows(G, gc, ghc) == [
                (wlo, whi, list(cs)) for wlo, whi, cs in _jax_windows(G, gc, ghc)]


@pytest.fixture(scope="module", params=[(128, 5, 3), (256, 3, 2)], ids=["128-G5-N3", "256-G3-N2"])
def fleet(request):
    """A port fleet on the CPU with messages of 0-300 bytes (some non-ASCII),
    its last group's aggregate tampered, and JAX's derive_alphas_grouped on
    its vk reprs and messages."""
    secpar, G, N = request.param
    jp = ftpu.fusion_setup(secpar, 31)
    p = params_from_numpy(jp)
    msgs = ["", "a", "é" * 68, "x" * 136, "ü" * 68 + "y", "z" * 300, "日本", "m7", "m8",
            "w" * 135, "q" * 137, "r", "s", "t", "u"][:G * N]
    vks, msgs, aggs = tsetup.build_fleet(p, G, N, seed0=3, messages=msgs, device="cpu")
    reprs = [tserial.vk_str(p, v) for v in vks.reshape(G * N, 2, -1)]
    cc_j, al_j = jlc.derive_alphas_grouped(jp, reprs, msgs, G, N)
    bad = aggs.clone()
    bad[G - 1, 0, 0] = (bad[G - 1, 0, 0] + 1) % p.modulus
    return p, vks, msgs, bad, np.asarray(cc_j).reshape(G, N, -1), np.asarray(al_j)


@pytest.mark.parametrize("gc,ghc", [(2, 2), (1, 2), (2, 3), (2, 100)],
                         ids=["equal", "multiple", "not-multiple", "larger-than-G"])
def test_windows_match_jax(fleet, gc, ghc):
    """The call verify_batch_device makes, with the coefficients kept."""
    p, vks, msgs, bad, cc_j, al_j = fleet
    G = vks.shape[0]
    eq, norm_ok, w_ok, cc, al = tdp._verify_windows(p, vks, msgs, bad, gc, ghc, True, None, "fold")
    np.testing.assert_array_equal(cc.numpy(), cc_j)
    np.testing.assert_array_equal(al.numpy(), al_j)
    assert eq.tolist() == [True] * (G - 1) + [False]
    assert bool(norm_ok[:-1].all() & w_ok[:-1].all())


def test_chunked_calls_equal_one_chunk(fleet):
    p, vks, msgs, bad, cc_j, al_j = fleet
    G = vks.shape[0]
    one = tdp.derive_coeffs_device(p, vks, msgs, bad)
    two = tdp.derive_coeffs_device(p, vks, msgs, bad, group_chunk=2)
    for a, b in zip(one, two):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(one[3].numpy(), cc_j)
    np.testing.assert_array_equal(one[4].numpy(), al_j)
    got = tdp.verify_batch_device(p, vks, msgs, bad, group_chunk=1, group_hash_chunk=2)
    for a, b in zip(got, one[:3]):
        assert torch.equal(a, b)
    assert one[0].tolist() == [True] * (G - 1) + [False]


def test_message_count_and_empty_batch_raise():
    p = params_from_numpy(ftpu.fusion_setup(128, 31))
    vks = torch.zeros((2, 2, 2, p.degree), dtype=torch.int32)
    aggs = torch.zeros((2, p.rank, p.degree), dtype=torch.int32)
    with pytest.raises(ValueError, match="messages"):
        tdp.verify_batch_device(p, vks, ["a"] * 3, aggs)
    with pytest.raises(ValueError, match="group"):
        tdp.verify_batch_device(p, vks[:0], [], aggs[:0])
