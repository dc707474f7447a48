"""Compact binary serialization for keys, signatures and parameters.

The port's copy of the JAX package's ``scheme/serde.py``: the same versioned
byte format, so a file written by one package decodes in the other to equal
arrays, and one object encodes to identical bytes in both.  The reference has
no serialization format beyond ``str()`` reprs; this one is for storage and
transport, beside the repr-compatible encoder (interop/serial.py) that exists
for hash and KAT wire parity.

Format: a 16-byte header (magic, version, kind, secpar, shape ints) followed
by little-endian int32 tensor payloads.  Keys and signatures store centered
NTT-domain representatives exactly as the tensors hold them, so round trips
are bitwise.  Tensors may come in on any device (numpy arrays too); decoded
arrays are numpy.
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Optional, Tuple

import numpy as np

from ..interop.serial import _host
from ..params import Params, fusion_setup

MAGIC = b"FTPU"
VERSION = 1

KIND_VK = 1
KIND_SK = 2
KIND_SIG = 3
KIND_AGG = 4
KIND_PARAMS = 5

_HDR = struct.Struct("<4sBBHII")  # magic, version, kind, secpar, dim0, dim1


def _pack(kind: int, secpar: int, dim0: int, dim1: int, payload) -> bytes:
    return _HDR.pack(MAGIC, VERSION, kind, secpar, dim0, dim1) + _host(payload).astype(
        "<i4"
    ).tobytes()


def _unpack(kind: int, data: bytes) -> Tuple[int, int, int, np.ndarray]:
    magic, ver, k, secpar, d0, d1 = _HDR.unpack_from(data, 0)
    if magic != MAGIC:
        raise ValueError("not a fusion-tpu serialized object")
    if ver != VERSION:
        raise ValueError(f"unsupported version {ver}")
    if k != kind:
        raise ValueError(f"expected kind {kind}, got {k}")
    arr = np.frombuffer(data, dtype="<i4", offset=_HDR.size)
    return secpar, d0, d1, arr


def encode_vk(params: Params, vk) -> bytes:
    """vk int32[2, d] -> bytes."""
    return _pack(KIND_VK, params.secpar, 2, params.degree, vk)


def decode_vk(data: bytes) -> Tuple[int, np.ndarray]:
    secpar, d0, d1, arr = _unpack(KIND_VK, data)
    return secpar, arr.reshape(d0, d1).copy()


def encode_sk(params: Params, seed: Optional[int], sk_hat) -> bytes:
    """sk int32[2, rank, d] -> bytes (seed stored iff it fits u32; the seed is
    metadata for reproduction, not secret material beyond the key itself)."""
    s = seed if seed is not None and 0 <= seed < 2**32 else 0xFFFFFFFF
    hdr = _HDR.pack(MAGIC, VERSION, KIND_SK, params.secpar, 2 * params.rank, params.degree)
    return hdr + struct.pack("<I", s) + _host(sk_hat).astype("<i4").tobytes()


def decode_sk(data: bytes) -> Tuple[int, Optional[int], np.ndarray]:
    magic, ver, k, secpar, d0, d1 = _HDR.unpack_from(data, 0)
    if magic != MAGIC or k != KIND_SK:
        raise ValueError("not a serialized signing key")
    (s,) = struct.unpack_from("<I", data, _HDR.size)
    seed = None if s == 0xFFFFFFFF else s
    arr = np.frombuffer(data, dtype="<i4", offset=_HDR.size + 4)
    rank = d0 // 2
    return secpar, seed, arr.reshape(2, rank, d1).copy()


def encode_signature(params: Params, sig) -> bytes:
    """sig int32[rank, d] -> bytes (also used for aggregate signatures)."""
    return _pack(KIND_SIG, params.secpar, params.rank, params.degree, sig)


def decode_signature(data: bytes) -> Tuple[int, np.ndarray]:
    secpar, d0, d1, arr = _unpack(KIND_SIG, data)
    return secpar, arr.reshape(d0, d1).copy()


def encode_params(params: Params) -> bytes:
    """Parameters serialize as (secpar, public challenge tensor); everything
    else is derived.  Seeded setups could store just the seed, but the tensor
    form also covers seed=None setups."""
    return _pack(
        KIND_PARAMS, params.secpar, params.rank, params.degree, params.public_challenge
    )


def decode_params(data: bytes) -> Params:
    """The Params of ``data``: equal to, and hashing as, the encoded ones."""
    secpar, rank, d, arr = _unpack(KIND_PARAMS, data)
    base = fusion_setup(secpar, 0)
    return dataclasses.replace(
        base, seed=None, public_challenge=arr.reshape(rank, d).copy()
    )
