"""Device decode: packed-word XOF streams -> bounded-coefficient polynomials.

Port of the word path of the JAX package's ``ops/xof_decode.py`` (itself the
twin of the reference decoder, fusion/fusion.py:422-481):

  [ signum bytes ][ weight_bound magnitude blocks ][ Fisher-Yates index stream ]

* signums: bit i (LSB-first) of the big-endian integer over the signum bytes;
* magnitudes: each block big-endian, ``(block % bound) + 1``;
* placement: partial Fisher-Yates from i = degree-1 down to weight_bound+1,
  in the closed form of the JAX package's ``_fy_place_lm``: each live value m
  moves at most once, to d-1-t at the FIRST swap t whose target is m.

Streams are int32[W, B] packed words (batch minor), a lane may carry
``n_streams`` consecutive streams (the group stage's per-signer alpha
blocks).  On a CUDA tensor :func:`decode_coeffs_rows` is one launch of
kernel ``xof_decode`` (``csrc/xof_decode.cu``), which reads every stream in
place at its byte offset; on a CPU tensor it runs :func:`decode_rows_plain`
(the streams split by :func:`split_streams_w`, then read as batch-major
bytes).  Geometry is static per parameter set.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from math import ceil, log2
from typing import Tuple

import numpy as np
import torch

from .. import kernels
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


def _powers(off: int, count: int, bpb: int, mods: tuple, n_bytes: int) -> np.ndarray:
    """P[t, k] = 256^(avail_t-1-k) mod m_t for k < avail_t, else 0 (int64
    [count, bpb]), where avail_t is how many of row t's bytes lie inside the
    ``n_bytes`` stream (the reference slices the stream, so truncated rows
    read truncated big-endian ints and empty rows read 0)."""
    avail = np.clip(n_bytes - (off + np.arange(count) * bpb), 0, bpb)
    P = np.zeros((count, bpb), dtype=np.int64)
    for t in range(count):
        m = int(mods[t])
        for k in range(int(avail[t])):
            P[t, k] = pow(256, int(avail[t]) - 1 - k, m)
    return P


@lru_cache(maxsize=64)
def _block_tables(off: int, count: int, bpb: int, mods: tuple, n_bytes: int,
                  device: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`_block_reduce`'s tables on ``device``, made once per (geometry,
    device): the powers of :func:`_powers` and the moduli m."""
    return (upload(_powers(off, count, bpb, mods, n_bytes), device),
            upload(np.array(mods, dtype=np.int64), device))


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


def _planes(geom: DecodeGeometry) -> int:
    """Byte planes of kernel ``xof_decode``'s power table: 1 while every
    modulus (d - t of the index rows, the bound of the magnitude rows) is
    at most 256, so each power is a byte; else 3 (moduli below 2**24)."""
    top = max(geom.degree, geom.bound if geom.bound != 1 else 0)
    return 1 if top <= 256 else 3


@lru_cache(maxsize=16)
def _kernel_table(geom: DecodeGeometry, n_bytes: int, device: str) -> Tuple[torch.Tensor, int]:
    """Kernel ``xof_decode``'s power table on ``device`` and its byte
    planes, made once per (geometry, length, device): the magnitude rows'
    P (when the bound is not 1), then the index rows', each row's powers
    packed four to a uint32 word (byte i of word k is plane p of P[4k + i],
    the row padded with zero powers to whole words), words [row, word,
    plane] flat as int32 bit patterns."""
    w, S = geom.weight_bound, geom.num_swaps
    planes = _planes(geom)
    parts = []
    if geom.bound != 1:
        parts.append(_powers(geom.bytes_for_signums, w, geom.bytes_per_coefficient,
                             (geom.bound,) * w, n_bytes))
    parts.append(_powers(geom.index_stream_offset, S, geom.bytes_per_index,
                         tuple(range(geom.degree, geom.weight_bound + 1, -1)), n_bytes))
    packed = []
    for P in parts:
        rows, width = P.shape
        words = -(-width // 4)
        P = np.pad(P, ((0, 0), (0, 4 * words - width))).reshape(rows, words, 1, 4)
        by = (P >> (8 * np.arange(planes).reshape(1, 1, planes, 1))) & 0xFF
        packed.append((by << (8 * np.arange(4))).sum(axis=-1).reshape(-1))
    flat = np.concatenate(packed).astype(np.uint32)
    return upload(flat.view(np.int32), device), planes


def _check_streams(xof_words: torch.Tensor, geom: DecodeGeometry, n_bytes: int,
                   n_streams: int) -> None:
    if n_bytes < geom.min_bytes:
        raise ValueError(
            f"Too few bytes to decode polynomial. Expected {geom.min_bytes} "
            f"but got {n_bytes}"
        )
    W = xof_words.shape[0]
    if n_streams < 1 or 4 * W < n_streams * n_bytes:
        raise ValueError(f"{W} words carry fewer than {n_streams} streams of {n_bytes} bytes")


def _decode_launch(xof_words: torch.Tensor, geom: DecodeGeometry, n_bytes: int,
                   n_streams: int) -> torch.Tensor:
    """One launch of kernel ``xof_decode`` -> int32[L * n_streams, d]."""
    d, w = geom.degree, geom.weight_bound
    if w > 64:
        raise ValueError(f"xof_decode kernel needs a weight bound <= 64, got {w}")
    if geom.bytes_per_index * 255 * (d - 1) >= 1 << 32:
        raise ValueError("xof_decode kernel needs bytes_per_index * 255 * (d - 1) < 2**32")
    kernels.require_cuda_tensor(xof_words, "xof_words", torch.int32, 2)
    W, L = xof_words.shape
    table, planes = _kernel_table(geom, n_bytes, str(xof_words.device))
    out = torch.empty((L * n_streams, d), dtype=torch.int32, device=xof_words.device)
    rc = kernels.library().fct_xof_decode(
        xof_words.data_ptr(), W, L, n_streams, d, w, geom.bytes_for_signums,
        geom.bytes_per_coefficient, geom.bytes_per_index, n_bytes, geom.bound,
        table.data_ptr(), planes, out.data_ptr(), kernels.cuda_stream())
    kernels.LAUNCHES["xof_decode"] += 1
    kernels.check_launch(rc, "xof_decode")
    return out


def launch_shape(geom: DecodeGeometry, n_bytes: int, lanes: int, n_streams: int = 1) -> dict:
    """The launch :func:`decode_coeffs_rows` makes on the card for ``lanes``
    lanes of ``n_streams`` streams (``kernels.launch_shape``)."""
    return kernels.launch_shape(
        "fct_xof_decode_shape", lanes, n_streams, geom.degree, geom.weight_bound,
        geom.bytes_for_signums, geom.bytes_per_coefficient, geom.bytes_per_index, n_bytes,
        geom.bound, _planes(geom))


def decode_rows_plain(xof_words: torch.Tensor, geom: DecodeGeometry, n_bytes: int,
                      n_streams: int = 1) -> torch.Tensor:
    """:func:`decode_coeffs_rows` in torch: the streams split by
    :func:`split_streams_w`, the signums gathered, the blocks reduced by
    :func:`_block_reduce`, the first hits found by a scatter-min."""
    _check_streams(xof_words, geom, n_bytes, n_streams)
    if n_streams > 1:
        per = split_streams_w(xof_words, n_streams, n_bytes)  # [bw, L, n_streams]
        xof_words = per.reshape(per.shape[0], -1)
    d, w = geom.degree, geom.weight_bound
    B = xof_words.shape[1]
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
        return torch.nn.functional.pad(vals, (0, d - w)).to(torch.int32)
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
    return out.to(torch.int32)


DECODE_WARPS = 4  # csrc/xof_decode.cu kDecodeWarps: the shares a stream's rows split into
# share counts whose edges the crafted streams put first hits on: the
# kernel's, one, an odd count and twice the kernel's
CRAFTED_SHARES = (DECODE_WARPS, 1, 3, 2 * DECODE_WARPS)
PLACEMENT_PLANS = ("one slot in every share", "first hits on share edges", "every slot hit",
                   "no slot hit", "slot 0 on the last live row", "slot 0 never hit",
                   "random bytes", "slot 0 in every share")


def crafted_streams(geom: DecodeGeometry, n_bytes: int, n_streams: int, lanes: int,
                    seed: int) -> np.ndarray:
    """Streams whose index rows read chosen indices, to hold a decoder's
    placement at its edges: words uint32[W + 1, lanes] (a spare word past
    the streams), stream k of lane g following plan (g * n_streams + k) %
    8 of :data:`PLACEMENT_PLANS`.  Index row t reads j < d - t when its
    last byte inside the stream is j and the bytes before it are 0.  Rows
    not named by a plan read a random index >= w (no hit), except in plans
    2, 5 and 6.  The share edges are those of the live rows split into each
    count of :data:`CRAFTED_SHARES` (first hits on the last and the first
    row of a share, later repeats that must read 0); the signum bytes and
    magnitude blocks are random."""
    rng = np.random.default_rng(seed)
    d, w, bpi = geom.degree, geom.weight_bound, geom.bytes_per_index
    off, S = geom.index_stream_offset, geom.num_swaps
    nmag = w if geom.bound != 1 else 0
    T = sum(1 for t in range(S) if off + t * bpi < n_bytes)  # live index rows
    if d > 256 or T == 0:
        raise ValueError("crafted streams need degree <= 256 and a live index row")
    t_idx = np.arange(T)
    last = np.minimum(off + (t_idx + 1) * bpi, n_bytes) - 1  # the byte that carries j
    edges = sorted({(nmag + T) * c // k - nmag for k in CRAFTED_SHARES for c in range(k + 1)}
                   & set(range(T + 1)))
    B = lanes * n_streams
    plan = np.arange(B) % len(PLACEMENT_PLANS)
    span = d - t_idx - w  # indices w .. d-t-1 are no hit
    j = w + (rng.random((B, T)) * span).astype(np.int64)  # no hit anywhere
    for b in range(B):
        p = plan[b]
        if p == 0:
            for t in set(edges[:-1]) | set(range(0, T, 5)):
                j[b, t] = 1
        elif p == 1:
            for i, e in enumerate(edges[1:-1]):
                for t, m in ((e - 1, (2 * i) % w), (e, (2 * i + 1) % w)):
                    j[b, t] = m
                    if t + 2 < T:
                        j[b, t + 2] = m  # a repeat: no first hit
        elif p == 2:
            n = min(w, T)
            j[b, :n] = w - 1 - np.arange(n)
            j[b, n:] = (rng.random(T - n) * (d - t_idx[n:])).astype(np.int64)
        elif p == 4:
            j[b, T - 1] = 0
            hits = rng.choice(T - 1, size=min(T - 1, w // 2), replace=False)
            j[b, hits] = 1 + rng.integers(0, w - 1, size=hits.size)
        elif p == 5:
            j[b] = 1 + (rng.random(T) * (d - t_idx - 1)).astype(np.int64)
        elif p == 7:
            for t in edges[:-1]:
                j[b, t] = 0
    by = rng.integers(0, 256, size=(lanes, n_streams, n_bytes), dtype=np.uint8)
    crafted = plan.reshape(lanes, n_streams) != 6
    region = by[:, :, off:]
    region[crafted] = 0
    sel = by[crafted]
    sel[:, last] = j[plan != 6].astype(np.uint8)
    by[crafted] = sel
    flat = by.reshape(lanes, n_streams * n_bytes)
    W = -(-flat.shape[1] // 4) + 1
    flat = np.concatenate(
        [flat, rng.integers(0, 256, size=(lanes, 4 * W - flat.shape[1]), dtype=np.uint8)], axis=1)
    return np.ascontiguousarray(flat.view("<u4").T)


def decode_coeffs_rows(xof_words: torch.Tensor, geom: DecodeGeometry, n_bytes: int,
                       n_streams: int = 1) -> torch.Tensor:
    """Packed-word XOF streams int32[W, L], each lane carrying ``n_streams``
    streams of logical length ``n_bytes`` (stream k of a lane from byte
    k * n_bytes) -> coefficients int32[L * n_streams, degree], row
    g * n_streams + k: the layout the NTT takes.  CUDA tensors: kernel
    ``xof_decode``; CPU tensors: :func:`decode_rows_plain`."""
    if xof_words.device.type == "cpu":
        return decode_rows_plain(xof_words, geom, n_bytes, n_streams)
    _check_streams(xof_words, geom, n_bytes, n_streams)
    return _decode_launch(xof_words, geom, n_bytes, n_streams)


def decode_coeffs_w(xof_words: torch.Tensor, geom: DecodeGeometry, n_bytes: int) -> torch.Tensor:
    """The JAX package's layout of :func:`decode_coeffs_rows` at one stream
    a lane: coefficients int32[degree, L]."""
    return decode_coeffs_rows(xof_words, geom, n_bytes).t().contiguous()
