"""Object-level Fusion API: the surface of the reference ``fusion.fusion``.

The port of the JAX package's ``interop/api.py``: ``fusion_setup / keygen /
sign / aggregate / verify`` plus the hash pipeline (``hash_message_to_int``,
``hash_vk_and_int_to_bytes``, ``hash_ch``, ``hash_ag``,
``hash_vks_and_ints_and_challs_to_bytes``,
``decode_bytes_to_polynomial_coefficients``, ``parse_challenge``,
``decode_bytes_to_agg_coefs``) with the reference's exact wire behaviour
(fusion/fusion.py:294-728).

Objects returned here (keys, signatures, challenges, aggregation
coefficients) carry torch tensors on a device and reference-exact ``str``
forms.  A function that creates tensors from bytes or seeds takes
``device=None``, meaning the card (``device="cpu"`` for the CPU); otherwise
it follows the device of the objects it is given.  On the card the
challenge and coefficient NTTs are the ``ntt_centered`` kernel, keygen runs
``ntt_centered``, and verify runs the grouped pipeline's kernels; hashing and
the byte decoder run on the host, as in the reference.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..hashing import decode as _decode
from ..hashing import xof as _xof
from ..ops.ntt import ntt_fwd
from ..ops.upload import input_device, resolve_device
from ..params import Params, fusion_setup as _tensor_setup
from ..scheme import lifecycle as _lc
from . import serial

__all__ = [
    "Params",
    "fusion_setup",
    "OneTimeSigningKey",
    "OneTimeVerificationKey",
    "SignatureChallenge",
    "Signature",
    "AggregationCoefficient",
    "keygen",
    "sign",
    "aggregate",
    "verify",
    "hash_message_to_int",
    "hash_vk_and_int_to_bytes",
    "decode_bytes_to_polynomial_coefficients",
    "parse_challenge",
    "hash_ch",
    "hash_vks_and_ints_and_challs_to_bytes",
    "decode_bytes_to_agg_coefs",
    "hash_ag",
]

# the tensor attributes of this module's objects
_TENSOR_ATTRS = ("vk", "sk_hat", "c_hat", "signature_hat", "alpha_hat")


def _tensor(x, device) -> torch.Tensor:
    """int32 tensor of ``x`` on ``device``; a tensor keeps its device when
    ``device`` is None, anything else goes to the card."""
    return torch.as_tensor(x, dtype=torch.int32, device=input_device(device, x))


def _device_of(device, *objs) -> torch.device:
    """``input_device`` of the tensors carried by ``objs``, searched through
    tuples and lists in order."""
    def carried(o):
        if isinstance(o, (tuple, list)):
            for x in o:
                yield from carried(x)
        else:
            yield from (getattr(o, name, None) for name in _TENSOR_ATTRS)
    return input_device(device, *(t for o in objs for t in carried(o)))


def fusion_setup(secpar: int, seed: Optional[int]) -> Params:
    """Parameter setup (reference fusion.py:294-295)."""
    return _tensor_setup(secpar, seed)


class OneTimeSigningKey:
    """Tensor-backed signing key with reference repr (fusion.py:298-317).

    sk_hat: int32[2, rank, degree] NTT-domain (left, right)."""

    def __init__(self, params: Params, seed: Optional[int], sk_hat, *, device=None):
        self.params = params
        self.seed = seed
        self.sk_hat = _tensor(sk_hat, device)

    def __str__(self):
        return serial.sk_str(self.params, self.seed, self.sk_hat)

    __repr__ = __str__


class OneTimeVerificationKey:
    """Tensor-backed verification key with reference repr (fusion.py:320-332).

    vk: int32[2, degree] NTT-domain (left, right), each a 1x1 matrix entry."""

    def __init__(self, params: Params, vk, *, device=None):
        self.params = params
        self.vk = _tensor(vk, device)

    def __str__(self):
        return serial.vk_str(self.params, self.vk)

    __repr__ = __str__


OneTimeKeyTuple = Tuple[OneTimeSigningKey, OneTimeVerificationKey]


class SignatureChallenge:
    """c_hat: int32[degree] NTT-domain challenge (fusion.py:376-389)."""

    def __init__(self, params: Params, c_hat, *, device=None):
        self.params = params
        self.c_hat = _tensor(c_hat, device)

    def __str__(self):
        return serial.challenge_str(self.params, self.c_hat)

    __repr__ = __str__

    def __eq__(self, other):
        return isinstance(other, SignatureChallenge) and torch.equal(
            self.c_hat, other.c_hat.to(self.c_hat.device))


class Signature:
    """signature_hat: int32[rank, degree] NTT-domain signature
    (fusion.py:392-402)."""

    def __init__(self, params: Params, sig, *, device=None):
        self.params = params
        self.signature_hat = _tensor(sig, device)

    def __str__(self):
        return serial.sig_str(self.params, self.signature_hat)

    __repr__ = __str__


class AggregationCoefficient:
    """alpha_hat: int32[degree] NTT-domain aggregation coefficient
    (fusion.py:560-570)."""

    def __init__(self, params: Params, alpha_hat, *, device=None):
        self.params = params
        self.alpha_hat = _tensor(alpha_hat, device)

    def __str__(self):
        return serial.agg_coef_str(self.params, self.alpha_hat)

    __repr__ = __str__


def keygen(params: Params, seed: Optional[int], *, device=None) -> OneTimeKeyTuple:
    """Single-key keygen (fusion.py:338-373) through the batched lifecycle, on
    ``device`` (the card unless ``device="cpu"``)."""
    batch = _lc.keygen(params, [seed], device=device)
    return (
        OneTimeSigningKey(params, seed, batch.sk_hat[0]),
        OneTimeVerificationKey(params, batch.vk[0]),
    )


def hash_message_to_int(params: Params, message: str) -> int:
    """SHA3-256 message pre-hash (fusion.py:405-409)."""
    return _xof.hash_message_to_int(params.sign_pre_hash_dst, message)


def hash_vk_and_int_to_bytes(params: Params, key, i: int, n: int) -> bytes:
    """SHAKE256(dst + "," + str(key) + "," + str(i)).digest(n) (fusion.py:412-419).
    ``key`` may be any object whose str() is the wire form."""
    payload = params.sign_hash_dst + b"," + str(key).encode("utf-8") + b"," + str(i).encode()
    return _xof.shake_digest(payload, n)


def decode_bytes_to_polynomial_coefficients(
    b: bytes, log2_bias: int, modulus: int, degree: int, norm_bound: int, weight_bound: int
) -> List[int]:
    """Byte decoder (fusion.py:422-481); returns a plain int list like the
    reference."""
    return [
        int(x)
        for x in _decode.decode_bytes_to_coefficients(
            b, log2_bias, modulus, degree, norm_bound, weight_bound
        )
    ]


def _ntt_of_coeffs(params: Params, coefs: np.ndarray, device) -> torch.Tensor:
    """Host-decoded coefficients int32[..., d] -> centered NTT values on
    ``device`` (kernel ``ntt_centered`` on the card)."""
    return ntt_fwd(params.plan, torch.from_numpy(coefs).to(resolve_device(device)))


def parse_challenge(params: Params, b: bytes, *, device=None) -> SignatureChallenge:
    """Decode + NTT a challenge from XOF bytes (fusion.py:484-508), the NTT on
    ``device`` (the card unless ``device="cpu"``).  Returns the challenge
    object; use ``.c_hat`` for the tensor."""
    if (
        len(b)
        < params.omega_ch * params.bytes_for_one_coef_bdd_by_beta_ch
        + params.bytes_for_poly_shuffle
    ):
        raise ValueError("hashed_vk_and_pre_hashed_message is too short")
    coefs = _decode.decode_bytes_to_coefficients(
        b,
        log2_bias=params.secpar,
        modulus=params.modulus,
        degree=params.degree,
        norm_bound=params.beta_ch,
        weight_bound=params.omega_ch,
    )
    return SignatureChallenge(params, _ntt_of_coeffs(params, coefs, device))


def hash_ch(params: Params, key, message: str, *, device=None) -> SignatureChallenge:
    """Full challenge derivation (fusion.py:511-531), on the device of
    ``key``'s tensors unless ``device`` is given."""
    dev = _device_of(device, key)
    i = hash_message_to_int(params, message)
    n = _xof.challenge_xof_len(
        params.secpar, params.degree, params.modulus, params.beta_ch, params.omega_ch
    )
    return parse_challenge(params, hash_vk_and_int_to_bytes(params, key, i, n), device=dev)


def sign(params: Params, key: OneTimeKeyTuple, message: str) -> Signature:
    """Sign one message (fusion.py:534-557) on the device of the signing key."""
    sk, vk = key
    dev = sk.sk_hat.device
    chall = hash_ch(params, vk, message, device=dev)
    return Signature(params, _lc.sign_from_c_hat(params, sk.sk_hat, chall.c_hat))


def hash_vks_and_ints_and_challs_to_bytes(
    params: Params,
    keys: Sequence,
    prehashed_messages: Sequence[int],
    challenges: Sequence,
) -> bytes:
    """Aggregation XOF (fusion.py:573-591); ``keys``/``challenges`` may be any
    objects whose str() is the wire form (the KAT generator passes key tuples)."""
    n = len(keys) * _xof.agg_block_len(
        params.secpar, params.degree, params.modulus, params.beta_ag, params.omega_ag
    )
    body = serial.zip_triples_str(
        [str(k) for k in keys], [int(i) for i in prehashed_messages], [str(c) for c in challenges]
    )
    return _xof.shake_digest(params.agg_xof_dst + b"," + body.encode("utf-8"), n)


def decode_bytes_to_agg_coefs(params: Params, b: bytes, *,
                              device=None) -> List[AggregationCoefficient]:
    """Per-signer block decode + NTT (fusion.py:594-629), the NTT on
    ``device`` (the card unless ``device="cpu"``) in one call for all
    blocks."""
    block = _xof.agg_block_len(
        params.secpar, params.degree, params.modulus, params.beta_ag, params.omega_ag
    )
    num = len(b) // block
    coefs = np.zeros((num, params.degree), dtype=np.int32)
    for i in range(num):
        coefs[i] = _decode.decode_bytes_to_coefficients(
            b[i * block : (i + 1) * block],
            log2_bias=params.secpar,
            modulus=params.modulus,
            degree=params.degree,
            norm_bound=params.beta_ag,
            weight_bound=params.omega_ag,
        )
    alpha_hats = _ntt_of_coeffs(params, coefs, device)
    return [AggregationCoefficient(params, alpha_hats[i]) for i in range(num)]


def hash_ag(params: Params, keys: Sequence, messages: Sequence[str], *,
            device=None) -> List[AggregationCoefficient]:
    """Aggregation coefficient derivation (fusion.py:632-652).  ``keys`` entries
    are hashed via str(); challenge derivation uses them directly, matching the
    reference (which hashes whatever object it is given).  Runs on the device
    of the keys' tensors unless ``device`` is given."""
    dev = _device_of(device, keys)
    pre = [hash_message_to_int(params, m) for m in messages]
    challs = [hash_ch(params, k, m, device=dev) for k, m in zip(keys, messages)]
    b = hash_vks_and_ints_and_challs_to_bytes(params, keys, pre, challs)
    return decode_bytes_to_agg_coefs(params, b, device=dev)


def aggregate(
    params: Params,
    keys: Sequence[OneTimeVerificationKey],
    messages: Sequence[str],
    signatures: Sequence[Signature],
    *,
    device=None,
) -> Signature:
    """Aggregate N signatures (fusion.py:655-677), on the device of the
    signatures unless ``device`` is given."""
    dev = _device_of(device, signatures, keys)
    order = sorted(range(len(keys)), key=lambda i: str(keys[i]))
    s_keys = [keys[i] for i in order]
    s_msgs = [messages[i] for i in order]
    s_sigs = torch.stack([signatures[i].signature_hat.to(dev) for i in order])
    alphas = hash_ag(params, s_keys, s_msgs, device=dev)
    alpha_hats = torch.stack([a.alpha_hat for a in alphas])
    return Signature(params, _lc.aggregate_from_alpha_hat(params, s_sigs, alpha_hats))


def verify(
    params: Params,
    keys: Sequence[OneTimeVerificationKey],
    messages: Sequence[str],
    aggregate_signature: Signature,
    *,
    device=None,
) -> Tuple[bool, str]:
    """Verify an aggregate signature (fusion.py:680-728), reference-exact
    reason strings included, on the device of the aggregate unless
    ``device`` is given."""
    dev = _device_of(device, aggregate_signature, keys)
    vks = torch.stack([k.vk.to(dev) for k in keys])
    return _lc.verify(params, vks, list(messages), aggregate_signature.signature_hat.to(dev))
