"""Batched Keccak-f[1600] / SHAKE256 / SHA3-256 in plain torch.

Port of the packed-word path of the JAX package's ``ops/keccak.py``.  A batch
of B sponges is an int64[25, B] tensor: lane l = x + 5*y is one 64-bit word
(the TPU's (lo, hi) uint32 halves are not needed).  torch has no unsigned
64-bit type, so right shifts (arithmetic on int64) are masked after shifting.

Payloads and XOF output are little-endian packed words int32[rows, B] in the
JAX layout (byte j at bits 8*(j%4) of word j//4, batch minor), so sponge
lane l of a rate block is words 2l (low half) and 2l+1 (high half).

These functions are the plain versions that the CUDA sponge kernels
(ops/keccak_sponge.py) are held against, and what the kernel wrappers run
for tensors on the CPU.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .upload import upload

RATE = 136  # SHAKE256 rate in bytes
RATE_WORDS = RATE // 4  # 34 packed words per rate block
RATE_LANES = RATE // 8  # 17 sponge lanes per rate block

_MASK32 = 0xFFFFFFFF


def _round_constants() -> np.ndarray:
    """The 24 iota round constants (degree-8 LFSR), as int64 bit patterns."""
    rc = []
    r = 1
    for _ in range(24):
        c = 0
        for j in range(7):
            r = ((r << 1) ^ ((r >> 7) * 0x71)) & 0xFF
            if r & 2:
                c ^= 1 << ((1 << j) - 1)
        rc.append(c)
    return np.array(rc, dtype=np.uint64).view(np.int64)


def _rho_pi_tables() -> Tuple[np.ndarray, np.ndarray]:
    """(rotation offset by flat lane, pi source lane by destination lane);
    pi maps A[x, y] -> B[y, (2x + 3y) % 5]."""
    rot = np.zeros(25, dtype=np.int64)
    x, y = 1, 0
    for t in range(24):
        rot[x + 5 * y] = ((t + 1) * (t + 2) // 2) % 64
        x, y = y, (2 * x + 3 * y) % 5
    pi_src = np.zeros(25, dtype=np.int64)
    for xx in range(5):
        for yy in range(5):
            pi_src[yy + 5 * ((2 * xx + 3 * yy) % 5)] = xx + 5 * yy
    return rot, pi_src


RC = _round_constants()
ROT, PI_SRC = _rho_pi_tables()
_CONSTS: Dict[str, tuple] = {}


def _consts(device: torch.device):
    """(round constants, rho shift of each pi destination, its complement
    shift, low-bit mask, pi source index) on ``device``."""
    key = str(device)
    hit = _CONSTS.get(key)
    if hit is None:
        r = ROT[PI_SRC]  # rotation applied to each destination lane
        hit = (
            upload(RC, device),
            upload(r, device).view(25, 1),
            upload(np.minimum(64 - r, 63), device).view(25, 1),
            upload(np.array([(1 << int(k)) - 1 for k in r], dtype=np.uint64).view(np.int64),
                   device).view(25, 1),
            upload(PI_SRC, device),
        )
        _CONSTS[key] = hit
    return hit


def _rotl1(x: torch.Tensor) -> torch.Tensor:
    return (x << 1) | ((x >> 63) & 1)


def keccak_f(state: torch.Tensor) -> torch.Tensor:
    """Keccak-f[1600] over a batch of sponges: int64[25, B] -> int64[25, B]."""
    rc, rs, crs, low, pi = _consts(state.device)
    B = state.shape[-1]
    a = state
    for i in range(24):
        v = a.reshape(5, 5, B)  # [y, x, B]
        c = v[0] ^ v[1] ^ v[2] ^ v[3] ^ v[4]  # [x, B]
        d = c.roll(1, 0) ^ _rotl1(c.roll(-1, 0))  # C[x-1] ^ rot(C[x+1], 1)
        a = (v ^ d.unsqueeze(0)).reshape(25, B)
        b = a.index_select(0, pi)  # pi: destination <- source lane
        b = (b << rs) | ((b >> crs) & low)  # rho, logical rotate
        bv = b.view(5, 5, B)
        a = (bv ^ (~bv.roll(-1, 1) & bv.roll(-2, 1))).reshape(25, B)  # chi
        a[0] ^= rc[i]  # iota
    return a


# ---------------------------------------------------------------------------
# word <-> lane conversions
# ---------------------------------------------------------------------------


def words_to_lanes(words: torch.Tensor) -> torch.Tensor:
    """int32[..., 2k, B] (lo, hi) word pairs -> int64[..., k, B] lanes."""
    w = words.to(torch.int64)
    return (w[..., 0::2, :] & _MASK32) | (w[..., 1::2, :] << 32)


def lanes_to_words(lanes: torch.Tensor) -> torch.Tensor:
    """int64[..., k, B] lanes -> int32[..., 2k, B] (lo, hi) word pairs."""
    lo = lanes.to(torch.int32)  # int64 -> int32 keeps the low 32 bits
    hi = (lanes >> 32).to(torch.int32)
    return torch.stack([lo, hi], dim=-2).reshape(
        *lanes.shape[:-2], 2 * lanes.shape[-2], lanes.shape[-1]
    )


# ---------------------------------------------------------------------------
# padding and the sponge
# ---------------------------------------------------------------------------


def pad_words(words: torch.Tensor, lens: torch.Tensor, pad_head: int = 0x1F,
              assume_clean: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-rate padding applied on packed words.

    words int32[max_blocks*34, B], lens int[B] in BYTES ->
    (padded words int32[max_blocks*34, B], block counts int32[B]).  The domain
    byte ``pad_head`` (0x1F SHAKE, 0x06 SHA3) lands at byte ``len`` and 0x80 at
    byte 3 of the lane's last rate word (they OR together when they meet).
    ``assume_clean``: bytes at or beyond ``lens`` are already zero (the
    assembler's invariant), so the tail mask is skipped.
    """
    rows, B = words.shape
    if rows % RATE_WORDS:
        raise ValueError(f"word rows {rows} must be a multiple of {RATE_WORDS}")
    lens = lens.to(torch.int64)
    dev = words.device
    w = words.clone()
    if not assume_clean:
        wi = torch.arange(rows, device=dev).view(rows, 1)
        keep = (lens.view(1, B) - 4 * wi).clamp(0, 4)
        mask = torch.where(
            keep >= 4,
            torch.full_like(keep, _MASK32),
            torch.bitwise_left_shift(torch.ones_like(keep), 8 * keep) - 1,
        )
        w = (w.to(torch.int64) & mask).to(torch.int32)
    n_blocks = lens // RATE + 1
    cols = torch.arange(B, device=dev)
    head_w = lens >> 2
    live = head_w < rows  # a length past the buffer pads nothing
    head_v = (pad_head << (8 * (lens & 3))).to(torch.int32)
    hw = head_w.clamp(max=rows - 1)
    w[hw, cols] = w[hw, cols] | torch.where(live, head_v, torch.zeros_like(head_v))
    tail_w = n_blocks * RATE_WORDS - 1
    live = tail_w < rows
    tw = tail_w.clamp(max=rows - 1)
    w[tw, cols] = w[tw, cols] | torch.where(
        live, torch.full_like(head_v, -(1 << 31)), torch.zeros_like(head_v)
    )
    return w, n_blocks.to(torch.int32)


def absorb_padded(words: torch.Tensor, n_blocks: torch.Tensor) -> torch.Tensor:
    """Absorb pre-padded words int32[max_blocks*34, B]: lane b absorbs its
    first ``n_blocks[b]`` rate blocks (later blocks leave its state alone).
    Returns the post-absorb state as words int32[50, B] (word 2l = low half
    of lane l) — the plain version of the CUDA absorb kernel."""
    rows, B = words.shape
    max_blocks = rows // RATE_WORDS
    lanes = words_to_lanes(words.view(max_blocks, RATE_WORDS, B))  # [mb, 17, B]
    state = torch.zeros(25, B, dtype=torch.int64, device=words.device)
    nb = n_blocks.to(torch.int64).view(1, B)
    for j in range(max_blocks):
        nxt = state.clone()
        nxt[:RATE_LANES] ^= lanes[j]
        nxt = keccak_f(nxt)
        state = torch.where(j < nb, nxt, state)
    return lanes_to_words(state)


def shake256_squeeze_words(state_words: torch.Tensor, n_words: int) -> torch.Tensor:
    """Squeeze ``n_words`` packed words int32[n_words, B] from post-absorb
    states int32[50, B], permuting between rate blocks — the plain version
    of the CUDA squeeze kernel."""
    state = words_to_lanes(state_words)
    n_blocks = -(-n_words // RATE_WORDS)
    outs = []
    for k in range(n_blocks):
        if k:
            state = keccak_f(state)
        outs.append(lanes_to_words(state[:RATE_LANES]))
    return torch.cat(outs, dim=0)[:n_words]


def shake256_absorb_words(words: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Absorb packed-word payloads (int32[max_blocks*34, B], lens in bytes;
    bytes past a length are ignored); returns the states as int32[50, B]."""
    padded, nb = pad_words(words, lens, 0x1F)
    return absorb_padded(padded, nb)


def sha3_256_words(words: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Batched SHA3-256 of packed-word payloads -> digest words int32[8, B]
    (the first 32 rate bytes after absorbing with domain byte 0x06)."""
    padded, nb = pad_words(words, lens, 0x06)
    return absorb_padded(padded, nb)[:8]


def shake256_absorb_segments_words(segments, pad_head: int = 0x1F) -> torch.Tensor:
    """Absorb the per-lane concatenation of ragged packed-word segments.

    ``segments``: ``(words int32[Wk, B], lens int[B], min_len, max_len)``
    each, in the ops/ragged_words normal form (bytes at or beyond ``lens``
    zero) -> the post-absorb states int32[50, B], bit-exact with
    :func:`shake256_absorb_words` on the concatenation: the ``str()``
    concatenations the reference feeds SHAKE256 (fusion.py:417, :586-589).

    The JAX package carries a partial rate block from segment to segment,
    because a concatenation costs it barrel shifts on the TPU.  Here the
    concatenation is one prefix-sum scatter (ragged_words.fold_chunks_w),
    padded and absorbed in one pass: on a CUDA tensor one launch of kernel
    ``keccak_absorb``, on the CPU the plain sponge."""
    from . import keccak_sponge
    from . import ragged_words as rw

    joined = rw.fold_chunks_w([
        rw.WChunk(buf=words, length=lens.to(torch.int32), max_len=mx, min_len=mn)
        for words, lens, mn, mx in segments
    ])
    rows = (joined.max_len // RATE + 1) * RATE_WORDS  # room for the pad bytes
    words = torch.nn.functional.pad(joined.buf, (0, 0, 0, rows - joined.buf.shape[0]))
    padded, n_blocks = pad_words(words, joined.length, pad_head, assume_clean=True)
    return keccak_sponge.absorb(padded, n_blocks)
