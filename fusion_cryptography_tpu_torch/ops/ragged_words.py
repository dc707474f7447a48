"""Ragged byte strings as packed words, assembled by prefix sums and scatter.

Port of the JAX package's ``ops/ragged_words.py``.  A batch of ragged strings
is a :class:`WChunk`: little-endian packed words int32[(K,) Ww, B] (byte j at
bits 8*(j%4) of word j//4, batch minor — the sponge's lane packing), content
left-aligned from byte 0, bytes at or beyond ``length`` zero.

The JAX package concatenates chunks with log-depth barrel shifts, a TPU
design.  Here a concatenation places every byte directly: the parts are laid
side by side at their static widths, a mask marks each part's live bytes, an
inclusive prefix sum of the mask gives every live byte its output position,
and one scatter writes them.  The packed words are byte-identical to the JAX
package's (tests/test_torch_preimage.py).

Shapes follow the JAX package (batch minor); internally a concatenation works
on batch-major bytes uint8[B, W], where each lane's string is contiguous.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import kernels
from .upload import upload

DEC_W = 11  # '-' + 10 digits covers |v| < 2**31
PREHASH_DIGITS = 78  # str(int.from_bytes(sha3_256 digest, 'little')) <= 78 digits


def words_for(nbytes: int) -> int:
    """Words needed to carry ``nbytes`` bytes."""
    return -(-nbytes // 4)


@dataclass
class WChunk:
    """A batch of ragged byte strings in packed-word normal form.

    buf:     int32[(K,) Ww, B] packed words, zero past ``length``
    length:  int32[(K,) B] live BYTES
    max_len: static upper bound on ``length`` (<= 4*Ww)
    min_len: static lower bound on ``length``
    """

    buf: torch.Tensor
    length: torch.Tensor
    max_len: int
    min_len: int


# ---------------------------------------------------------------------------
# words <-> bytes
# ---------------------------------------------------------------------------


def words_to_bytes(words: torch.Tensor) -> torch.Tensor:
    """int32[..., Ww, B] packed words -> batch-major bytes uint8[..., B, 4*Ww]."""
    by = words.transpose(-1, -2).contiguous()
    if by.stride(-1) != 1:  # contiguous() keeps any stride of a size-1 dim (Ww = 1)
        by = by.clone(memory_format=torch.contiguous_format)
    return by.view(torch.uint8)


def bytes_to_words(by: torch.Tensor) -> torch.Tensor:
    """Batch-major bytes uint8[..., B, L] -> packed words int32[..., ceil(L/4), B]
    (zero-filled to a whole word)."""
    L = by.shape[-1]
    pad = (-L) % 4
    if pad:
        by = torch.nn.functional.pad(by, (0, pad))
    # viewing bytes as int32 needs unit-stride rows starting on word boundaries
    if (by.stride(-1) != 1 or by.storage_offset() % 4
            or any(st % 4 for st in by.stride()[:-1])):
        by = by.clone(memory_format=torch.contiguous_format)
    return by.view(torch.int32).transpose(-1, -2).contiguous()


def pack_bytes_to_words(buf: torch.Tensor, nw: Optional[int] = None) -> torch.Tensor:
    """uint8[..., W, B] -> int32[..., nw, B] little-endian packed."""
    W = buf.shape[-2]
    nw = words_for(W) if nw is None else nw
    by = buf.transpose(-1, -2)
    if 4 * nw != W:
        by = torch.nn.functional.pad(by, (0, 4 * nw - W))
    return bytes_to_words(by)


def unpack_words_to_bytes(words: torch.Tensor, nbytes: Optional[int] = None) -> torch.Tensor:
    """int32[..., Ww, B] -> uint8[..., nbytes, B]."""
    by = words_to_bytes(words)
    if nbytes is not None:
        by = by[..., :nbytes]
    return by.transpose(-1, -2).contiguous()


# ---------------------------------------------------------------------------
# constant tables, one per device
# ---------------------------------------------------------------------------


@lru_cache(maxsize=32)
def _powers_of_ten(n: int, descending: bool, device: str) -> torch.Tensor:
    """int64[n]: 10**0 .. 10**(n-1), or the reverse, on ``device``."""
    p = 10 ** np.arange(n, dtype=np.int64)
    return upload(p[::-1].copy() if descending else p, device)


@lru_cache(maxsize=64)
def _const_bytes(data: bytes, device: str) -> torch.Tensor:
    """``data`` as uint8[len(data)] on ``device``."""
    return upload(np.frombuffer(data, dtype=np.uint8).copy(), device)


# ---------------------------------------------------------------------------
# decimal rendering
# ---------------------------------------------------------------------------


def decimal_chars(values: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int32 values [...] -> (``str(v)`` left-aligned as uint8[..., 11], zero
    past the length; lengths int64[...])."""
    v = values.to(torch.int64)
    dev = v.device
    neg = v < 0
    a = v.abs()
    p10 = _powers_of_ten(10, True, str(dev))
    digs = torch.div(a.unsqueeze(-1), p10, rounding_mode="floor") % 10  # MSB first
    nd = 1 + (a.unsqueeze(-1) >= p10[:-1]).sum(-1)
    length = nd + neg
    pos = torch.arange(DEC_W, device=dev)
    src = (10 - nd.unsqueeze(-1) + pos - neg.unsqueeze(-1).to(torch.int64)).clamp(0, 9)
    ch = torch.gather(digs, -1, src) + ord("0")
    ch = torch.where(neg.unsqueeze(-1) & (pos == 0), ord("-"), ch)
    ch = torch.where(pos < length.unsqueeze(-1), ch, 0)
    return ch.to(torch.uint8), length


def _cells_bytes(values: torch.Tensor, sep: bytes) -> Tuple[torch.Tensor, torch.Tensor]:
    """int32[K, B] -> (``sep ++ str(v)`` cells uint8[B, K, len(sep)+11] left
    aligned, cell lengths int64[B, K])."""
    ch, length = decimal_chars(values.t())  # [B, K, 11], [B, K]
    s = len(sep)
    if s:
        sep_t = _const_bytes(bytes(sep), str(ch.device))
        ch = torch.cat([sep_t.expand(*ch.shape[:-1], s), ch], dim=-1)
    return ch, length + s


def render_decimal_cells_w(values: torch.Tensor, sep: bytes) -> WChunk:
    """int32[K, B] -> left-aligned ``sep ++ str(v)`` cells as a word chunk
    buf int32[K, ceil((len(sep)+11)/4), B]."""
    cells, length = _cells_bytes(values, sep)  # [B, K, W]
    s = len(sep)
    buf = bytes_to_words(cells.transpose(0, 1))  # [K, Ww, B]
    return WChunk(buf=buf, length=length.t().to(torch.int32).contiguous(),
                  max_len=s + DEC_W, min_len=s + 1)


def render_bigint_dec_w(digest_words: torch.Tensor) -> WChunk:
    """256-bit little-endian integers int32[8, B] (the SHA3-256 digest words)
    -> ``str(int)`` as a left-aligned word chunk buf int32[20, B] (max 78
    digits, no sign): the prehash rendering of fusion.py:405-409.  CUDA
    tensors: one launch of kernel ``render_prehash``
    (``csrc/render_prehash.cu``); CPU tensors: :func:`render_bigint_dec_plain`."""
    if digest_words.device.type == "cpu":
        return render_bigint_dec_plain(digest_words)
    if digest_words.dim() != 2 or digest_words.shape[0] != 8:
        raise ValueError(f"render_prehash: expected digest words [8, B], got "
                         f"{tuple(digest_words.shape)}")
    digest_words = digest_words.contiguous()
    kernels.require_cuda_tensor(digest_words, "digest_words", torch.int32, 2)
    B = digest_words.shape[1]
    buf = torch.empty((words_for(PREHASH_DIGITS), B), dtype=torch.int32,
                      device=digest_words.device)
    length = torch.empty(B, dtype=torch.int32, device=digest_words.device)
    rc = kernels.library().fct_render_prehash(digest_words.data_ptr(), B, buf.data_ptr(),
                                              length.data_ptr(), kernels.cuda_stream())
    kernels.LAUNCHES["render_prehash"] += 1
    kernels.check_launch(rc, "render_prehash")
    return WChunk(buf=buf, length=length, max_len=PREHASH_DIGITS, min_len=1)


def render_bigint_dec_plain(digest_words: torch.Tensor) -> WChunk:
    """:func:`render_bigint_dec_w` in torch.  Nine divmod-by-10**9 sweeps
    over the 32-bit limbs (each step's dividend r * 2**32 + limb < 10**9 *
    2**32 fits int64) give 81 digits, LSB first."""
    dev = digest_words.device
    B = digest_words.shape[-1]
    limbs = [digest_words[k].to(torch.int64) & 0xFFFFFFFF for k in range(8)]
    base = 10 ** 9
    chunks = []
    for _ in range(9):
        r = torch.zeros(B, dtype=torch.int64, device=dev)
        for k in range(7, -1, -1):
            cur = (r << 32) | limbs[k]
            limbs[k] = torch.div(cur, base, rounding_mode="floor")
            r = cur - limbs[k] * base
        chunks.append(r)
    ch9 = torch.stack(chunks, dim=1)  # [B, 9] base-10**9 digits, LSB first
    p10 = _powers_of_ten(9, False, str(dev))
    digits = (torch.div(ch9.unsqueeze(-1), p10, rounding_mode="floor") % 10).reshape(B, 81)
    digits = digits[:, :PREHASH_DIGITS]  # LSB first
    t = torch.arange(PREHASH_DIGITS, device=dev)
    length = torch.where(digits != 0, t + 1, 0).amax(dim=1).clamp(min=1)
    src = (length.unsqueeze(1) - 1 - t).clamp(min=0)
    ch = torch.gather(digits, 1, src) + ord("0")
    ch = torch.where(t < length.unsqueeze(1), ch, 0).to(torch.uint8)  # [B, 78]
    return WChunk(buf=bytes_to_words(ch), length=length.to(torch.int32),
                  max_len=PREHASH_DIGITS, min_len=1)


# ---------------------------------------------------------------------------
# concatenation
# ---------------------------------------------------------------------------

# One part of a concatenation: a WChunk, static bytes, or a ready segment
# (batch-major bytes uint8[B, w], live mask bool[B, w], max_len, min_len).
Segment = Tuple[torch.Tensor, torch.Tensor, int, int]
Part = Union[WChunk, bytes, Segment]


def _chunk_segment(c: WChunk) -> Segment:
    by = words_to_bytes(c.buf)
    pos = torch.arange(by.shape[-1], device=by.device)
    return by, pos < c.length.unsqueeze(-1), c.max_len, c.min_len


def _const_segment(data: bytes, B: int, device: torch.device) -> Segment:
    t = _const_bytes(data, str(device))
    return t.expand(B, len(data)), torch.ones(1, 1, dtype=torch.bool, device=device).expand(
        B, len(data)), len(data), len(data)


def cells_segment(values: torch.Tensor, sep: bytes) -> Segment:
    """``sep ++ str(v)`` for each row of int32[K, B], in order."""
    cells, length = _cells_bytes(values, sep)  # [B, K, W]
    B, K, W = cells.shape
    live = torch.arange(W, device=cells.device) < length.unsqueeze(-1)
    s = len(sep)
    return cells.reshape(B, K * W), live.reshape(B, K * W), K * (s + DEC_W), K * (s + 1)


def _as_segment(p: Part, B: int, device: torch.device) -> Segment:
    if isinstance(p, WChunk):
        return _chunk_segment(p)
    if isinstance(p, (bytes, bytearray)):
        return _const_segment(bytes(p), B, device)
    return p


def concat_bytes(parts: Sequence[Part], B: int, device: torch.device,
                 out_bytes: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor, int, int]:
    """Concatenate the parts lane by lane -> (bytes uint8[B, out_bytes],
    lengths int32[B], max_len, min_len).

    ``out_bytes`` defaults to the parts' total max_len rounded up to a whole
    word; content past it is dropped (lengths still count it)."""
    segs = [_as_segment(p, B, device) for p in parts]
    max_len = sum(s[2] for s in segs)
    min_len = sum(s[3] for s in segs)
    if out_bytes is None:
        out_bytes = 4 * words_for(max_len)
    pool = torch.cat([s[0] for s in segs], dim=1)
    live = torch.cat([s[1] for s in segs], dim=1)
    dest = torch.cumsum(live, dim=1) - 1  # output position of each live byte
    length = dest[:, -1] + 1
    # dead bytes (and any past out_bytes) go to a dump column; the row stride
    # stays a multiple of 4 so the result can be viewed as words
    dest = torch.where(live & (dest < out_bytes), dest, out_bytes)
    out = torch.zeros((B, out_bytes + 4), dtype=torch.uint8, device=device)
    out.scatter_(1, dest, pool)
    return out[:, :out_bytes], length.to(torch.int32), max_len, min_len


def fold_chunks_w(nodes: Sequence[Part]) -> WChunk:
    """Concatenate a chunk list into one chunk, order preserved."""
    nodes = list(nodes)
    if not nodes:
        raise ValueError("fold_chunks_w needs at least one chunk")
    ref = next(n.buf.transpose(-1, -2) if isinstance(n, WChunk) else n[0]
               for n in nodes if not isinstance(n, (bytes, bytearray)))
    B = ref.shape[0]
    by, length, mx, mn = concat_bytes(nodes, B, ref.device)
    return WChunk(buf=bytes_to_words(by), length=length, max_len=mx, min_len=mn)


def merge_w(a: WChunk, b: WChunk) -> WChunk:
    """result[i] = a[i] ++ b[i]."""
    return fold_chunks_w([a, b])
