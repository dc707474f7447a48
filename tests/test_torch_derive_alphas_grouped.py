"""lifecycle.derive_alphas_grouped of the port vs the JAX package's, on the
CPU: the same challenge and alpha coefficients from the same vk reprs and
messages (0, 1, 135-137 and 300 bytes, some non-ASCII), and a ValueError
for a repr that is not the str() of a vk."""
import numpy as np
import pytest

import fusion_cryptography_tpu as ftpu
from fusion_cryptography_tpu.scheme import lifecycle as jlc
from fusion_cryptography_tpu_torch import params_from_numpy
from fusion_cryptography_tpu_torch.interop import serial as tserial
from fusion_cryptography_tpu_torch.scheme import lifecycle as tlc

# 0, 1, 135, 136, 137 and 300 bytes first (the 136- and 137-byte ones
# non-ASCII), then more
MESSAGES = ["", "a", "b" * 135, "é" * 68, "日本語" * 15 + "xy", "e" * 300, "✓" * 45 + "f",
            "g", "h", "i", "j", "k", "l", "m", "n"]


def _inputs(secpar, G, N):
    jp = ftpu.fusion_setup(secpar, 13)
    p = params_from_numpy(jp)
    keys = tlc.keygen(p, range(50, 50 + G * N), device="cpu")
    reprs = keys.vk_strs()
    msgs = MESSAGES[:G * N]
    return jp, p, reprs, msgs


@pytest.mark.parametrize("secpar,G,N", [(128, 5, 3), (256, 3, 2)])
def test_matches_jax(secpar, G, N):
    jp, p, reprs, msgs = _inputs(secpar, G, N)
    assert [len(m.encode()) for m in msgs[:6]] == [0, 1, 135, 136, 137, 300]
    cc, al = tlc.derive_alphas_grouped(p, reprs, msgs, G, N, device="cpu")
    cc_j, al_j = jlc.derive_alphas_grouped(jp, reprs, msgs, G, N)
    assert isinstance(cc, np.ndarray) and cc.dtype == np.int32 and cc.shape == (G, N, p.degree)
    assert isinstance(al, np.ndarray) and al.dtype == np.int32 and al.shape == (G, N, p.degree)
    np.testing.assert_array_equal(cc, np.asarray(cc_j).reshape(G, N, -1))
    np.testing.assert_array_equal(al, np.asarray(al_j))


def test_vk_values_round_trip_and_refusals():
    _, p, reprs, _ = _inputs(128, 2, 2)
    vals = tserial.vk_values(p, reprs)
    assert [tserial.vk_str(p, v) for v in vals] == reprs
    r = reprs[1]
    for bad in (r.replace(", ", ",", 1), r.replace(", ", ", +", 1), r.replace(", ", ", 0", 1),
                r + " ", r.replace("modulus", "Modulus", 1), r.replace("]", "", 1),
                r.replace("values=[", "values=[-0, ", 1), r.replace(", ", ", ٣", 1),
                tserial.vk_str(p, np.full((2, p.degree), 2**31, dtype=np.int64)), "x"):
        with pytest.raises(ValueError, match="not the str"):
            tserial.vk_values(p, [reprs[0], bad])


def test_bad_inputs_raise():
    _, p, reprs, msgs = _inputs(128, 2, 2)
    with pytest.raises(ValueError, match="not the str"):
        tlc.derive_alphas_grouped(p, reprs[:3] + [reprs[3][:-1]], msgs[:4], 2, 2, device="cpu")
    with pytest.raises(ValueError, match="need 4"):
        tlc.derive_alphas_grouped(p, reprs, msgs[:3], 2, 2, device="cpu")
