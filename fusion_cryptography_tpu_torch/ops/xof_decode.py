"""Device decode: packed-word XOF streams -> bounded-coefficient polynomials.

Port of the word path of the JAX package's ``ops/xof_decode.py`` (itself the
twin of the reference decoder, fusion/fusion.py:422-481):

  [ signum bytes ][ weight_bound magnitude blocks ][ Fisher-Yates index stream ]

* signums: bit i (LSB-first) of the big-endian integer over the signum bytes;
* magnitudes: each block big-endian, ``(block % bound) + 1``;
* placement: partial Fisher-Yates from i = degree-1 down to weight_bound+1,
  in the closed form of the JAX package's ``_fy_place_lm``: each live value m
  moves at most once, to d-1-t at the FIRST swap t whose target is m.

Streams are int32[W, B] packed words (batch minor); the decoder reads them as
batch-major bytes.  Geometry is static per parameter set.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from math import ceil, log2
from typing import Tuple

import numpy as np
import torch

from .ragged_words import bytes_to_words, words_to_bytes
from .upload import upload


@dataclass(frozen=True)
class DecodeGeometry:
    """Static byte layout of one XOF-decoded polynomial (fusion.py:541-550)."""

    degree: int
    weight_bound: int
    bound: int
    bytes_per_coefficient: int
    bytes_per_index: int
    bytes_for_signums: int

    @property
    def index_stream_offset(self) -> int:
        return self.bytes_for_signums + self.weight_bound * self.bytes_per_coefficient

    @property
    def num_swaps(self) -> int:
        # fusion.py:473: for i in range(degree - 1, weight_bound, -1)
        return max(0, self.degree - 1 - self.weight_bound)

    @property
    def min_bytes(self) -> int:
        return self.bytes_for_signums + (
            self.bytes_per_coefficient + self.bytes_per_index
        ) * self.weight_bound


def geometry(log2_bias: int, modulus: int, degree: int, norm_bound: int,
             weight_bound: int) -> DecodeGeometry:
    """Derive the static layout exactly as the host decoder does."""
    bound = max(1, min(modulus // 2, norm_bound))
    if bound >= 1 << 24:
        raise NotImplementedError("device decode supports bounds below 2**24")
    if not (0 < weight_bound <= degree):
        raise NotImplementedError("device decoder assumes 0 < weight_bound <= degree")
    return DecodeGeometry(
        degree=degree,
        weight_bound=weight_bound,
        bound=bound,
        bytes_per_coefficient=ceil((log2(bound) + 1 + log2_bias) / 8),
        bytes_per_index=ceil((log2(degree) + log2_bias) / 8),
        bytes_for_signums=ceil(weight_bound / 8),
    )


def consumed_bytes(geom: DecodeGeometry, n_xof: int) -> int:
    """Bytes of an ``n_xof``-byte stream the decoder reads: the partial
    Fisher-Yates takes only ``num_swaps`` (< degree) indices, so squeezing
    this prefix is bit-exact."""
    return min(n_xof, geom.index_stream_offset + geom.num_swaps * geom.bytes_per_index)


def realign_words(words: torch.Tensor, byte_off: int, out_words: int) -> torch.Tensor:
    """int32[W, B] -> int32[out_words, B] whose byte j is byte ``byte_off + j``
    of the input (zero past the end)."""
    by = words_to_bytes(words)[:, byte_off : byte_off + 4 * out_words]
    if by.shape[1] < 4 * out_words:
        by = torch.nn.functional.pad(by, (0, 4 * out_words - by.shape[1]))
    return bytes_to_words(by)


def split_streams_w(blob_w: torch.Tensor, n_streams: int, stream_bytes: int) -> torch.Tensor:
    """Concatenated fixed-length streams int32[Wtot, B] -> int32[ceil(
    stream_bytes/4), B, n_streams] (stream k realigned to byte 0)."""
    bw = -(-stream_bytes // 4)
    return torch.stack(
        [realign_words(blob_w, k * stream_bytes, bw) for k in range(n_streams)], dim=2
    )


@lru_cache(maxsize=64)
def _block_tables(off: int, count: int, bpb: int, mods: tuple, n_bytes: int,
                  device: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`_block_reduce`'s tables on ``device``, made once per (geometry,
    device): P[t, k] = 256^(avail_t-1-k) mod m_t for k < avail_t, else 0,
    where avail_t is how many of row t's bytes lie inside the ``n_bytes``
    stream (the reference slices the stream, so truncated rows read
    truncated big-endian ints and empty rows read 0), and the moduli m."""
    avail = np.clip(n_bytes - (off + np.arange(count) * bpb), 0, bpb)
    P = np.zeros((count, bpb), dtype=np.int64)
    for t in range(count):
        m = int(mods[t])
        for k in range(int(avail[t])):
            P[t, k] = pow(256, int(avail[t]) - 1 - k, m)
    return upload(P, device), upload(np.array(mods, dtype=np.int64), device)


@lru_cache(maxsize=16)
def _signum_tables(n_signum_bytes: int, weight_bound: int,
                   device: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(byte index, bit shift) of each of the ``weight_bound`` signum bits
    on ``device``: bit i is bit i % 8 of byte ``n_signum_bytes - 1 - i // 8``
    (LSB-first over the big-endian signum integer)."""
    i_arr = np.arange(weight_bound)
    return (upload(n_signum_bytes - 1 - i_arr // 8, device), upload(i_arr % 8, device))


def _block_reduce(by: torch.Tensor, n_bytes: int, off: int, count: int, bpb: int,
                  mods: tuple) -> torch.Tensor:
    """Big-endian ``bpb``-byte blocks starting at byte ``off`` of batch-major
    streams uint8[B, n], row t reduced mod ``mods[t]`` -> int64[B, count]."""
    B = by.shape[0]
    need = off + count * bpb
    region = by[:, off:need]
    if region.shape[1] < count * bpb:
        region = torch.nn.functional.pad(region, (0, count * bpb - region.shape[1]))
    P, m = _block_tables(off, count, bpb, mods, n_bytes, str(by.device))
    acc = (region.reshape(B, count, bpb).to(torch.int64) * P).sum(dim=-1)
    return acc % m


def decode_coeffs_w(xof_words: torch.Tensor, geom: DecodeGeometry, n_bytes: int) -> torch.Tensor:
    """Packed-word XOF streams int32[W, B] of logical length ``n_bytes`` ->
    coefficients int32[degree, B]."""
    d, w = geom.degree, geom.weight_bound
    W, B = xof_words.shape
    if n_bytes < geom.min_bytes:
        raise ValueError(
            f"Too few bytes to decode polynomial. Expected {geom.min_bytes} "
            f"but got {n_bytes}"
        )
    if 4 * W < n_bytes:
        raise ValueError(f"{W} words carry fewer than {n_bytes} bytes")
    dev = xof_words.device
    by = words_to_bytes(xof_words)  # [B, 4W]

    nb = geom.bytes_for_signums
    src, shift = _signum_tables(nb, w, str(dev))
    bits = (by[:, src].to(torch.int64) >> shift) & 1
    vals = 2 * bits - 1  # [B, w]
    if geom.bound != 1:
        mods = (geom.bound,) * w
        vals = vals * (_block_reduce(by, n_bytes, nb, w, geom.bytes_per_coefficient, mods) + 1)

    S = geom.num_swaps
    if S == 0:
        out = torch.nn.functional.pad(vals, (0, d - w))
        return out.t().to(torch.int32).contiguous()
    j_all = _block_reduce(by, n_bytes, geom.index_stream_offset, S, geom.bytes_per_index,
                          tuple(range(d, w + 1, -1)))  # [B, S]: swap t takes mod d - t
    # first swap t whose target is live slot m (targets >= w go to a dump slot)
    first_t = torch.full((B, w + 1), S, dtype=torch.int64, device=dev)
    t_idx = torch.arange(S, device=dev).expand(B, S)
    first_t.scatter_reduce_(1, j_all.clamp(max=w), t_idx, reduce="amin")
    first_t = first_t[:, :w]
    m_idx = torch.arange(w, device=dev)
    pos = torch.where(first_t < S, d - 1 - first_t, m_idx)
    out = torch.zeros((B, d), dtype=torch.int64, device=dev)
    out.scatter_(1, pos, vals)
    return out.t().to(torch.int32).contiguous()
