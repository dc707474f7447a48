"""Message preimages placed for the prehash sponge: the host's flat byte
stream, and kernel ``place_preimages`` with its plain version.

The prehash absorbs ``dst + "," + message`` for every lane (fusion.py:405-409,
SHA3-256).  The host encodes a chunk's messages as one byte string
(:func:`encode`) and ships it with int64 offsets in one buffer
(:func:`stream_buffer`: offsets int64[B + 1], then the bytes and zeros to a
whole word past the last byte).  :func:`place_preimages` then writes on the
device what kernel ``keccak_absorb`` reads: words int32[rows, B] (rows a
multiple of 34, byte j of a lane at bits 8*(j%4) of word j//4, lanes minor)
holding the prefix, the message, zeros, the SHA3 domain byte 0x06 at the
preimage's length and 0x80 at the last byte of its last rate block, with
block counts and byte lengths int32[B].  Lane j reads message
``(j % c) * n_signers + j // c`` for ``c = B // n_signers``: the signer-major
order of a verify chunk of c groups; ``n_signers = 1`` is the natural order.

Where every message of a chunk is a compact ASCII ``str`` in a list (the
benchmark's traffic, and any ASCII text), :func:`direct_offsets` and
:func:`direct_buffer` make the same buffer straight from the ``str`` objects
(``csrc/pack_messages.c``, built with gcc at first use): one pass for the
offsets, one copy of each message's bytes, split over threads for a large
payload.  :func:`encode` and :func:`stream_buffer` stay the route for
anything else, and the tests' reference.

On a CUDA tensor :func:`place_preimages` is one launch of
``csrc/place_preimages.cu``; on a CPU tensor it runs
:func:`place_preimages_plain`.  The JAX package lays the rows out on the host
(its ``scheme/device_pipeline.py`` ``msg_preimage_words``) and has no such
kernel.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import sysconfig
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .. import kernels
from .._build import build_shared_library
from .keccak import RATE, RATE_WORDS

SHA3_DOMAIN = 0x06
_SRC = Path(__file__).resolve().parent.parent / "csrc" / "pack_messages.c"
# One copy thread for every this many payload bytes, up to half the cores:
# the copy is bound by memory (on an H100 host of 8 cores, 54 MB took
# 13.6-16.5 ms on one thread, 4.1-11.2 ms on 4 and no less on 6 or 8), and
# a thread's start costs more than it saves on a few MB.
BYTES_A_THREAD = 8 << 20
_lock = threading.Lock()
_lib: Optional[ctypes.PyDLL] = None
_tried = False


def encode(messages: Sequence[str]) -> Tuple[bytes, np.ndarray, int]:
    """The messages' UTF-8 bytes back to back, their byte lengths int64[B],
    and the number of messages encoded one by one.

    One join and one encoding; when every message is ASCII (the encoding is
    as long as the text) the lengths are the strings' lengths and nothing is
    encoded one by one, else each message is encoded again for its length
    (all B).  The bytes equal ``b"".join(m.encode("utf-8") for m in
    messages)`` either way, and a message that cannot be encoded raises."""
    joined = "".join(messages)
    data = joined.encode("utf-8")
    B = len(messages)
    if len(data) == len(joined):
        return data, np.fromiter(map(len, messages), np.int64, B), 0
    return data, np.fromiter((len(m.encode("utf-8")) for m in messages), np.int64, B), B


def stream_bytes(n_bytes: int) -> int:
    """Bytes of the stream region that carries ``n_bytes``: whole words and
    at least one zero byte, so the word after any message byte exists."""
    return 4 * (n_bytes // 4 + 1)


def stream_buffer(data: bytes, lengths: np.ndarray, pin: bool) -> torch.Tensor:
    """One host buffer uint8[8 * (B + 1) + stream_bytes(len(data))]: the
    offsets int64[B + 1] (prefix sums of ``lengths``), then ``data`` and
    zeros; in pinned memory when ``pin``."""
    B, n = len(lengths), len(data)
    head = 8 * (B + 1)
    buf = torch.empty(head + stream_bytes(n), dtype=torch.uint8, pin_memory=pin)
    a = buf.numpy()
    offsets = a[:head].view(np.int64)
    offsets[0] = 0
    np.cumsum(lengths, out=offsets[1:])
    a[head:head + n] = np.frombuffer(data, np.uint8)
    a[head + n:] = 0
    return buf


def _library() -> Optional[ctypes.PyDLL]:
    """``csrc/pack_messages.c`` built and loaded once, or None without gcc or
    the interpreter's ``Python.h``."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        include = sysconfig.get_paths()["include"]
        if shutil.which("gcc") is None or not (Path(include) / "Python.h").exists():
            return None
        path = build_shared_library(
            "pack_messages", [_SRC],
            lambda out: ["gcc", "-O3", "-shared", "-fPIC", "-pthread", f"-I{include}",
                         "-o", str(out), str(_SRC)],
            timeout_s=120.0)
        lib = ctypes.PyDLL(str(path))
        lib.fct_pack_offsets.argtypes = [ctypes.py_object, ctypes.c_int64, ctypes.c_void_p]
        lib.fct_pack_offsets.restype = ctypes.c_int64
        lib.fct_pack_fill.argtypes = [ctypes.py_object, ctypes.c_void_p, ctypes.c_int64,
                                      ctypes.c_void_p, ctypes.c_int64, ctypes.c_int]
        lib.fct_pack_fill.restype = ctypes.c_int
        _lib = lib
        return _lib


def direct_offsets(messages: Sequence[str]) -> Optional[Tuple[np.ndarray, int]]:
    """The offsets int64[B + 1] of the messages' bytes and the longest
    message's byte length, read from the ``str`` objects in one pass; None
    where the one-pass route does not apply (no gcc or ``Python.h`` to
    build it with, ``messages`` is not a list, or one is not a compact ASCII
    ``str``)."""
    lib = _library()
    if lib is None or type(messages) is not list:
        return None
    offsets = np.empty(len(messages) + 1, np.int64)
    longest = lib.fct_pack_offsets(messages, len(messages), offsets.ctypes.data)
    return None if longest < 0 else (offsets, longest)


def direct_buffer(messages: Sequence[str], offsets: np.ndarray, pin: bool) -> torch.Tensor:
    """:func:`stream_buffer` of ``messages`` with the offsets of
    :func:`direct_offsets`, each message's bytes copied once from its
    ``str``: by one thread, or by one for every :data:`BYTES_A_THREAD`
    bytes of payload up to half the cores this process may run on."""
    B, n = len(offsets) - 1, int(offsets[-1])
    buf = torch.empty(8 * (B + 1) + stream_bytes(n), dtype=torch.uint8, pin_memory=pin)
    threads = max(1, min(len(os.sched_getaffinity(0)) // 2, n // BYTES_A_THREAD))
    if _library().fct_pack_fill(messages, offsets.ctypes.data, B, buf.data_ptr(), buf.numel(),
                                threads):
        raise RuntimeError("the messages changed while they were packed")
    return buf


def split(buf: torch.Tensor, n_rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(offsets int64[B + 1], stream uint8[...]) views of a
    :func:`stream_buffer` of ``n_rows`` messages."""
    head = 8 * (n_rows + 1)
    return buf[:head].view(torch.int64), buf[head:]


def rows_for(max_len: int) -> int:
    """Word rows that hold a preimage of ``max_len`` bytes with its padding."""
    return (max_len // RATE + 1) * RATE_WORDS


def source_rows(B: int, n_signers: int, device) -> torch.Tensor:
    """int64[B]: the message lane j reads, ``(j % c) * n_signers + j // c``."""
    return torch.arange(B, device=device).view(B // n_signers, n_signers).t().reshape(-1)


def place_preimages_plain(prefix: torch.Tensor, offsets: torch.Tensor, stream: torch.Tensor,
                          n_signers: int, rows: int
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """prefix uint8[P], offsets int64[B + 1], stream uint8[...] -> (words
    int32[rows, B], block counts int32[B], preimage lengths int32[B]), in
    torch."""
    B, P, dev = offsets.numel() - 1, prefix.numel(), offsets.device
    src = source_rows(B, n_signers, dev)
    start = offsets[:-1][src]
    length = P + (offsets[1:] - offsets[:-1])[src]
    n_blocks = length // RATE + 1
    pos = torch.arange(4 * rows, device=dev)
    body = (pos >= P) & (pos < length[:, None])  # [B, 4 * rows]
    at = torch.where(body, start[:, None] + pos - P, 0)
    by = torch.where(body, stream[at], 0).to(torch.uint8)
    by[:, :P] = prefix
    by |= (pos == length[:, None]).to(torch.uint8) * SHA3_DOMAIN
    by |= (pos == n_blocks[:, None] * RATE - 1).to(torch.uint8) * 0x80
    words = by.view(torch.int32).t().contiguous()
    return words, n_blocks.to(torch.int32), length.to(torch.int32)


def place_preimages(prefix: torch.Tensor, offsets: torch.Tensor, stream: torch.Tensor,
                    n_signers: int, rows: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Same contract as :func:`place_preimages_plain`; ``stream`` is a
    :func:`stream_buffer`'s region (whole words, one past the last byte),
    and ``rows`` (a multiple of 34) holds the longest padded preimage.  On
    CUDA one launch of kernel ``place_preimages``."""
    B = offsets.numel() - 1
    if B % n_signers or rows % RATE_WORDS or rows <= 0:
        raise ValueError(f"place_preimages: {B} lanes for {n_signers} signers a group, "
                         f"{rows} rows")
    if offsets.device.type == "cpu":
        return place_preimages_plain(prefix, offsets, stream, n_signers, rows)
    kernels.require_cuda_tensor(prefix, "prefix", torch.uint8, 1)
    kernels.require_cuda_tensor(offsets, "offsets", torch.int64, 1)
    kernels.require_cuda_tensor(stream, "stream", torch.uint8, 1)
    if stream.data_ptr() % 4 or stream.numel() % 4 or not (
            prefix.device == offsets.device == stream.device):
        raise ValueError("place_preimages: the stream must be whole words on the offsets' device")
    words, n_blocks, lengths = kernels.outputs(None, [(rows, B), (B,), (B,)], offsets.device)
    rc = kernels.library().fct_place_preimages(
        prefix.data_ptr(), prefix.numel(), offsets.data_ptr(), stream.data_ptr(), B, n_signers,
        rows, words.data_ptr(), n_blocks.data_ptr(), lengths.data_ptr(), kernels.cuda_stream())
    kernels.LAUNCHES["place_preimages"] += 1
    kernels.check_launch(rc, "place_preimages")
    return words, n_blocks, lengths
