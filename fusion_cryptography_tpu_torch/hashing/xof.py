"""SHA3/SHAKE hash pipeline: message pre-hash and XOF output sizing.

The functions the port needs from the JAX package's ``hashing/xof.py``
(stdlib only), copied so the port never imports that package.

Wire format (KAT-observable, reference fusion/fusion.py:405-419):

* message pre-hash: SHA3-256 over ``dst_utf8 + "," + message``, digest read as a
  little-endian integer;
* challenge / aggregation XOFs: SHAKE256 over ``dst_utf8 + "," + <repr> + ...``
  where ``<repr>`` is the reference's ``str()`` serialization of the key or
  key/int/challenge tuples (built on the device by interop/device_serial.py).

Output-length arithmetic follows fusion.py:515-527 (challenge) and :579-585
(aggregation blocks) exactly.
"""
from __future__ import annotations

from hashlib import sha3_256, shake_256
from math import ceil, log2


def hash_message_to_int(pre_hash_dst: bytes, message: str) -> int:
    """SHA3-256(dst + "," + message) as a little-endian integer
    (reference fusion.py:405-409)."""
    salted = (pre_hash_dst.decode("utf-8") + "," + message).encode()
    return int.from_bytes(sha3_256(salted).digest(), byteorder="little")


def shake_digest(payload: bytes, n: int) -> bytes:
    """SHAKE256 XOF of ``payload`` with ``n`` output bytes."""
    return shake_256(payload).digest(n)


def challenge_xof_len(secpar: int, degree: int, modulus: int, beta_ch: int, omega_ch: int) -> int:
    """Output length for the signature-challenge XOF (fusion.py:541-550):
    signum bytes + per-coefficient bytes * num_coefs + degree * per-index bytes."""
    num_coefs = max(0, min(degree, omega_ch))
    bound = max(0, min(modulus // 2, beta_ch))
    bytes_per_coefficient = ceil((log2(bound) + 1 + secpar) / 8)
    bytes_per_index = ceil((log2(degree) + secpar) / 8)
    bytes_for_signums = ceil(omega_ch / 8)
    return bytes_for_signums + bytes_per_coefficient * num_coefs + degree * bytes_per_index


def agg_block_len(secpar: int, degree: int, modulus: int, beta_ag: int, omega_ag: int) -> int:
    """Per-signer block length of the aggregation-coefficient XOF
    (fusion.py:579-585): signums + (coef bytes + index bytes) * omega_ag."""
    bound = max(0, min(modulus // 2, beta_ag))
    bytes_per_coefficient = ceil((log2(bound) + 1 + secpar) / 8)
    bytes_per_index = ceil((log2(degree) + secpar) / 8)
    bytes_for_signums = ceil(omega_ag / 8)
    return bytes_for_signums + (bytes_per_coefficient + bytes_per_index) * omega_ag
