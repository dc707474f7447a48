"""The least device time the work of a call needs on an NVIDIA H100 SXM.

The work is counted from the scheme's sizes and the call's inputs, never
from the program's buffers, so it stays the same whatever kernels do it
and a faster implementation cannot read above its bound:

* bytes: the call's inputs read once and its outputs written once -- the
  aggregates int32[G, rank, d], the vks int32[G, N, 2, d], the message
  bytes and three verdict bytes a group.  Intermediate results (digests,
  challenges, preimages) are not counted: a fused implementation need not
  store them;
* integer operations: only those the algorithm cannot avoid -- the
  Keccak-f[1600] permutations that the preimage lengths and the bytes the
  decoders consume need, and the NTT butterflies (the challenge and alpha
  transforms, the inverse transform of every aggregate row).

The least time is the larger of bytes over the card's memory rate and
operations over its INT32 issue rate.  Constants (from the H100 SXM's
published peaks): 3.35 TB/s; 67 TFLOP/s float32 from 132 SMs of 128 lanes
gives 1.98 GHz, and an SM issues 64 INT32 instructions a clock, so
132 * 64 * 1.98e9 = 16.7e12 a second.
"""
from __future__ import annotations

from math import ceil, log2
from typing import Sequence

import numpy as np

from .reference import fusion_ref as ref

HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 132 * 64 * 1.98e9
RATE_BYTES = 136  # SHA3-256 and SHAKE256
# 32-bit instructions of one Keccak-f[1600], its 64-bit lanes split in
# halves and three-input XORs fused (LOP3), a round: theta 20 LOP3 for the
# column parities, 10 funnel shifts to rotate them, 50 LOP3 to apply them;
# rho 48 funnel shifts (24 rotations); chi 50 LOP3; iota 2.
KECCAK_OPS = 24 * (20 + 10 + 50 + 48 + 50 + 2)
# a butterfly: a Shoup product (one multiply-high, two multiplies) and the
# add and the subtract; lazy reduction can drop the rest
BUTTERFLY_OPS = 5


def absorb_perms(lengths) -> int:
    """Permutations to absorb preimages of ``lengths`` bytes (pad10*1: one
    more block when the length is a multiple of the rate)."""
    return int((np.asarray(lengths, dtype=np.int64) // RATE_BYTES + 1).sum())


def squeeze_perms(n_bytes: int, streams: int) -> int:
    """Permutations beyond the absorb's last to squeeze ``n_bytes`` a stream."""
    return streams * max(0, ceil(n_bytes / RATE_BYTES) - 1)


def ntt_ops(transforms: int, d: int) -> int:
    return transforms * (d // 2) * int(log2(d)) * BUTTERFLY_OPS


def str_lengths(values: np.ndarray) -> np.ndarray:
    """len(str(v)) of each int64 value below 10**18, summed over the last axis."""
    v = np.asarray(values, dtype=np.int64)
    p10 = 10 ** np.arange(1, 19, dtype=np.int64)
    return (1 + (np.abs(v)[..., None] >= p10).sum(-1) + (v < 0)).sum(-1)


def challenge_bytes_consumed(params: ref.Params) -> int:
    """Bytes of the challenge stream the decoder reads: signums, magnitude
    blocks, and one index for each Fisher-Yates step (d-1 down to w+1)."""
    d, w = params.degree, params.omega_ch
    bpc = ceil((log2(1) + 1 + params.secpar) / 8)
    bpi = ceil((log2(d) + params.secpar) / 8)
    return ceil(w / 8) + w * bpc + (d - 1 - w) * bpi


def verify_work(params: ref.Params, vks: np.ndarray, messages: Sequence[str]) -> dict:
    """The work of one grouped verify call: vks int[G, N, 2, d] sorted as
    the call takes them, the G*N messages in the same order."""
    G, N, _, d = vks.shape
    B = G * N
    flat = np.asarray(vks, dtype=np.int64).reshape(B, 2, d)
    msg_bytes = np.array([len(m.encode("utf-8")) for m in messages], dtype=np.int64)
    vk_strs = [ref.vk_str(params, v) for v in flat]
    vk_len = np.array([len(s) for s in vk_strs], dtype=np.int64)
    pre = [ref.prehash(params, m) for m in messages]
    pre_len = np.array([len(str(i)) for i in pre], dtype=np.int64)
    c_hat = ref.challenges(params, vk_strs, pre)
    ch_len = len(ref.challenge_str(params, np.zeros(d, np.int64))) - d + str_lengths(c_hat)
    dst = len(params.pre_dst) + 1  # dst + ","
    # "(" vk ", " prehash ", " challenge ")", joined by ", " inside "[" "]"
    triple = (vk_len + pre_len + ch_len + 6).reshape(G, N)
    agg_len = dst + 2 + triple.sum(axis=1) + 2 * (N - 1)
    perms = (absorb_perms(dst + msg_bytes)
             + absorb_perms(dst + vk_len + 1 + pre_len)
             + squeeze_perms(challenge_bytes_consumed(params), B)
             + absorb_perms(agg_len)
             + squeeze_perms(N * ref.agg_block_len(params), G))
    int_ops = perms * KECCAK_OPS + ntt_ops(2 * B + G * params.rank, d)
    n_bytes = 4 * G * params.rank * d + 4 * B * 2 * d + int(msg_bytes.sum()) + 3 * G
    return {"bytes": n_bytes, "int_ops": int_ops, "keccak_perms": perms}


def least_seconds(work: dict) -> float:
    return max(work["bytes"] / HBM_BYTES_PER_S, work["int_ops"] / INT_OPS_PER_S)
