"""XOF bytes -> bounded-coefficient polynomial decoder (host).

The port's copy of the JAX package's ``hashing/decode.py`` (stdlib + numpy
only), the twin of the reference decoder (fusion/fusion.py:422-481):

  [ signum bytes ][ weight_bound coefficient blocks ][ partial Fisher–Yates index stream ]

* signums: big-endian integer over the signum bytes, bit string reversed, bit i
  gives the sign (2*bit - 1) of nonzero coefficient i;
* magnitudes: each block read big-endian, ``(block % bound) + 1`` (for the
  production runtime bounds beta=1 every magnitude is exactly 1 — the XOF bytes
  are still consumed, which keeps the index-stream offsets aligned);
* placement: partial Fisher–Yates from i = degree-1 **down to weight_bound+1**
  (exclusive bound quirk, fusion.py:473 — preserved since it is KAT-observable).

The object API decodes one challenge or one aggregation block at a time with
it; the device pipeline decodes whole batches on the card
(ops/xof_decode.py).
"""
from __future__ import annotations

from math import ceil, log2
from typing import List

import numpy as np


def decode_bytes_to_coefficients(
    b: bytes,
    log2_bias: int,
    modulus: int,
    degree: int,
    norm_bound: int,
    weight_bound: int,
) -> np.ndarray:
    """Decode XOF bytes into int32[degree] sparse bounded coefficients."""
    num_coefs = max(1, min(degree, weight_bound))
    bound = max(1, min(modulus // 2, norm_bound))
    bytes_per_coefficient = ceil((log2(bound) + 1 + log2_bias) / 8)
    bytes_per_index = ceil((log2(degree) + log2_bias) / 8)
    bytes_for_signums = ceil(weight_bound / 8)
    total = bytes_for_signums + (bytes_per_coefficient + bytes_per_index) * weight_bound
    if len(b) < total:
        raise ValueError(
            f"Too few bytes to decode polynomial. Expected {total} but got {len(b)}"
        )

    # Signums: big-endian int over the signum bytes; the reference reverses the
    # bit string, which makes signum i simply bit i (LSB-first) of that integer.
    signums_int = int.from_bytes(b[:bytes_for_signums], byteorder="big")
    signums = 2 * np.array(
        [(signums_int >> i) & 1 for i in range(weight_bound)], dtype=np.int64
    ) - 1

    # Magnitudes: weight_bound big-endian blocks of bytes_per_coefficient bytes.
    off = bytes_for_signums
    if bound == 1:
        # (block % 1) + 1 == 1 for every block; the bytes are still consumed.
        mags = np.ones(weight_bound, dtype=np.int64)
    else:
        blocks = np.frombuffer(
            b[off : off + weight_bound * bytes_per_coefficient], dtype=np.uint8
        ).reshape(weight_bound, bytes_per_coefficient)
        acc = np.zeros(weight_bound, dtype=object)
        for col in range(bytes_per_coefficient):
            acc = acc * 256 + blocks[:, col]
        mags = (acc % bound).astype(np.int64) + 1
    coefs: List[int] = (mags * signums).tolist() + [0] * (degree - weight_bound)

    # Partial Fisher–Yates over the index stream.
    off += weight_bound * bytes_per_coefficient
    if num_coefs < degree:
        for i in range(degree - 1, weight_bound, -1):
            j = int.from_bytes(b[off : off + bytes_per_index], byteorder="big") % (i + 1)
            off += bytes_per_index
            coefs[i], coefs[j] = coefs[j], coefs[i]
    return np.array(coefs, dtype=np.int32)
