"""The least time each kernel of the port could take on an NVIDIA H100 SXM.

A kernel's bound is the larger of two times: the bytes it must move (each
input read once, each output written once) over the card's memory rate, and
the 32-bit integer instructions it needs over the card's INT32 issue rate.
The H100 SXM's published peaks give 3.35 TB/s and 67 TFLOP/s float32 (an FMA
counted as two) from 132 SMs of 128 float32 lanes, i.e. 1.98 GHz; an SM has
64 INT32 lanes, so 132 * 64 * 1.98e9 = 16.7e12 integer instructions/s.

Where the work depends on the data (the sponge's permutations, the rendered
lengths of the preimages) the functions take the lengths the call saw.
``chip_smoke.py`` prints these bounds beside each kernel's time, and
``profile_verify`` sums them over the launches of one verify call.
"""
from __future__ import annotations

from typing import Sequence

import torch

HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 132 * 64 * 1.98e9
RATE_BYTES = 136  # SHAKE256 / SHA3-256 rate
# 32-bit instructions one Keccak-f[1600] needs at least, its 64-bit lanes
# split in halves and three-input XORs fused (LOP3), per round: theta 20
# LOP3 for the column parities, 10 funnel shifts to rotate them, 50 LOP3 to
# apply them; rho 48 funnel shifts (24 rotations); chi 50 LOP3; iota 2.
KECCAK_OPS = 24 * (20 + 10 + 50 + 48 + 50 + 2)
# Estimates, not counts: decimal rendering of one value (digit count, ten
# divide-by-10 steps, byte packing) and the word stream per output word.
# The fold kernels' bounds are set by their bytes, several times above
# these operations at the main path's shapes.
RENDER_OPS, WORD_OPS, AGG_WORD_OPS = 70, 4, 20
# Estimates of the glue kernels' instructions: the prehash render of one
# digest (72 limb steps of a 64-bit multiply-high by 10^-9, ~12 each; nine
# chunks rendered, ~40 each; the 20-word stream), one (coefficient, signer)
# term of the lattice target (two lifts, two Barrett products of ~12, two
# modular adds), and the XOF decode's per byte read (extract, table load,
# multiply-add), per row (one 32-bit `%`, ~20), per swap placed.
PREHASH_RENDER_OPS, LATTICE_TERM_OPS = 1500, 36
DECODE_BYTE_OPS, DECODE_ROW_OPS, DECODE_SWAP_OPS = 3, 20, 8
# Kernel sample_short, one CPython MT19937 stream a thread: a stream's
# seeding is init_by_array's 1,247 dependent steps of 5 instructions (a
# shift, two XORs, a multiply, an add); a word drawn twists and tempers one
# state word (~15 instructions).  Its third bound is one stream's chain of
# steps, seeding and draws, at ~12 cycles a step of the 1.98-GHz clock,
# once a wave of the kernel's 8,448 streams (two 32-stream blocks an SM:
# the 78-KiB shared state of a block).
MT_SEED_STEPS, MT_STEP_OPS, MT_WORD_OPS = 1247, 5, 15
MT_STEP_CYCLES, MT_WAVE_STREAMS, CLOCK_HZ = 12, 132 * 2 * 32, 1.98e9


def bound(n_bytes: float, n_ops: float) -> dict:
    """{"bound_ms", "bound_by"} of a kernel that moves ``n_bytes`` and
    issues ``n_ops`` integer instructions."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def live_bytes(lens: torch.Tensor) -> int:
    """Bytes of the whole words that carry ``lens`` bytes per lane."""
    return int(((lens.to(torch.int64) + 3) // 4 * 4).sum().item())


def keccak_absorb(n_blocks: torch.Tensor) -> dict:
    """Absorb of ``n_blocks`` int32[B] rate blocks per lane: the blocks,
    the counts, the state out; one permutation per block."""
    B = n_blocks.numel()
    n_perm = int(n_blocks.to(torch.int64).sum().item())
    return bound(n_perm * RATE_BYTES + 4 * B + 200 * B, n_perm * KECCAK_OPS)


def keccak_warp_ratio(n_blocks: torch.Tensor, sponges_per_warp: int) -> float:
    """The idle-lane loss of an absorb whose warps hold ``sponges_per_warp``
    consecutive sponges: the sum over warps of (its sponges x its largest
    block count) over the sum of the block counts.  A warp runs its longest
    sponge's permutations; 1.0 means no lane waits."""
    nb = n_blocks.to(torch.int64).clamp(min=0)
    pad = -nb.numel() % sponges_per_warp
    longest = torch.nn.functional.pad(nb, (0, pad)).view(-1, sponges_per_warp).amax(dim=1)
    run = int(longest.repeat_interleave(sponges_per_warp)[: nb.numel()].sum())
    return run / max(int(nb.sum()), 1)


def keccak_squeeze(B: int, n_words: int) -> dict:
    """Squeeze of ``n_words`` words from B states (the first rate block
    needs no permutation)."""
    return bound(200 * B + 4 * n_words * B, B * (-(-n_words // 34) - 1) * KECCAK_OPS)


def agg_check(groups: int, rank: int, d: int) -> dict:
    """Kernel ``intt_norm_weight``: int32 aggregates [groups, rank, d] in,
    the observed sums (int64 [groups, d]) and norms and weights out, the
    table A (two uint32 [rank, d]).  Operations: butterflies, Shoup multiply
    (5) + add/sub with reductions (4); per coefficient the n^-1 scale (5),
    centering and the two reductions (6), the lift and the observed sum's
    multiply-accumulate (8)."""
    rows = groups * rank
    log2d = d.bit_length() - 1
    return bound(4 * rows * d + 8 * rank * d + 8 * groups * d + 8 * rows,
                 rows * (9 * (d // 2) * log2d + 11 * d + 8 * d))


def ntt(rows: int, d: int, bytes_per_coef: int, inverse: bool = False) -> dict:
    """Kernels ``ntt_u`` (8 + 8 bytes a coefficient) and ``ntt_centered``
    (4 + 4): butterflies as above, 2 operations a coefficient for the load
    and store conversions and, inverse, 5 for the n^-1 scale."""
    log2d = d.bit_length() - 1
    per_coef = 7 if inverse else 2
    return bound(rows * d * bytes_per_coef, rows * (9 * (d // 2) * log2d + per_coef * d))


def signer_fold_a(d: int, pre_len: torch.Tensor, ch_words: int, vk_words: int) -> dict:
    """2d centered values and the live prehash digits of B lanes in; the
    challenge preimage and the str(vk) chunk at full width, with their
    lengths, out."""
    B = pre_len.numel()
    return bound(4 * 2 * d * B + live_bytes(pre_len) + 4 * B + 4 * (ch_words + vk_words + 2) * B,
                 B * (2 * d * RENDER_OPS + (ch_words + vk_words) * WORD_OPS))


def signer_fold_b(d: int, vk_len: torch.Tensor, pre_len: torch.Tensor, tri_words: int) -> dict:
    """The live str(vk) chunk and prehash digits, d centered values and
    both lengths in; the triple at full width and its length out."""
    B = vk_len.numel()
    return bound(live_bytes(vk_len) + live_bytes(pre_len) + 4 * d * B + 8 * B
                 + 4 * (tri_words + 1) * B, B * (d * RENDER_OPS + tri_words * WORD_OPS))


def agg_fold(tri_lens: torch.Tensor, n_signers: int, agg_words: int) -> dict:
    """The N triples' live words and lengths in (``tri_lens``: int32[N, G]
    or [N*G]); the aggregation preimage at full width and its length out."""
    B = tri_lens.numel()
    G = B // n_signers
    return bound(live_bytes(tri_lens) + 4 * B + 4 * (agg_words + 1) * G,
                 G * agg_words * AGG_WORD_OPS)


def assemble_spec(n_values: int, lanes: int, extra_lens: Sequence[torch.Tensor],
                  width: int) -> dict:
    """``n_values`` centered values and the extras' live words and lengths
    in; ``width`` words and the length out, per lane."""
    return bound(4 * n_values * lanes + sum(live_bytes(el) + 4 * lanes for el in extra_lens)
                 + 4 * (width + 1) * lanes,
                 lanes * (n_values * RENDER_OPS + width * WORD_OPS))


def xof_decode(geom, n_bytes: int, streams: int) -> dict:
    """Kernel ``xof_decode`` over ``streams`` streams of ``n_bytes`` (an
    ``ops/xof_decode.DecodeGeometry``): the bytes a stream's decode needs
    (the signum bytes, the magnitude blocks when the bound is not 1, the
    index rows up to the stream's end) and its power table in, int32 [d]
    a stream out."""
    nmag = geom.weight_bound if geom.bound != 1 else 0
    off, S = geom.index_stream_offset, geom.num_swaps
    index_bytes = max(0, min(n_bytes, off + S * geom.bytes_per_index) - off)
    read = geom.bytes_for_signums + nmag * geom.bytes_per_coefficient + index_bytes
    table = 4 * (nmag * geom.bytes_per_coefficient + S * geom.bytes_per_index)
    return bound(streams * (read + 4 * geom.degree) + table,
                 streams * (DECODE_BYTE_OPS * read + DECODE_ROW_OPS * (nmag + S)
                            + DECODE_SWAP_OPS * S + 2 * geom.degree))


def render_prehash(lanes: int) -> dict:
    """Kernel ``render_prehash``: 8 digest words in, 20 words and a length
    out, per lane."""
    return bound(lanes * (32 + 80 + 4), lanes * PREHASH_RENDER_OPS)


def lattice_target(groups: int, n: int, d: int, rank: int) -> dict:
    """Kernel ``lattice_target``: vks int32 [G, N, 2, d], c_hat and
    alpha_hat int64 [G, N, d], observed int64 [G, d], norms and weights
    int32 [G, rank] in, three bytes a group out."""
    return bound(groups * (8 * n * d + 16 * n * d + 8 * d + 8 * rank + 3),
                 groups * (d * (n * LATTICE_TERM_OPS + 3) + 2 * rank))


def place_preimages(lanes: int, rows: int, n_bytes: int) -> dict:
    """Kernel ``place_preimages``: the messages' ``n_bytes`` and the offsets
    int64[lanes + 1] in; words int32[rows, lanes], block counts and lengths
    out.  Operations: ~``WORD_OPS`` a word (a funnel shift of two loads,
    the compare and the store)."""
    return bound(n_bytes + 8 * (lanes + 1) + 4 * (rows + 2) * lanes, rows * lanes * WORD_OPS)


def _draws(n: int) -> float:
    """Words _randbelow(n) draws on average: 2**bit_length(n) / n."""
    return (1 << n.bit_length()) / n


def sample_short(keys: int, degree: int, norm_bound: int, weight_bound: int,
                 modulus: int) -> dict:
    """Kernel ``sample_short``: the seeds uint64[keys] and the 624-word table
    in, int32[keys, 2, degree] out; the larger of that, the streams'
    operations and the chain of steps one stream takes, once a wave
    (``bound_by`` "chain"), at the words a stream draws on average."""
    streams, num = 2 * keys, max(0, min(degree, weight_bound))
    words = num * (_draws(max(1, min(norm_bound, modulus // 2))) + _draws(2))
    if num < degree:  # the Fisher-Yates pass: randrange(n) for n = degree .. 2
        words += sum(_draws(n) for n in range(2, degree + 1))
    out = bound(8 * keys + 4 * 624 + 4 * streams * degree,
                streams * (MT_SEED_STEPS * MT_STEP_OPS + words * MT_WORD_OPS))
    waves = -(-streams // MT_WAVE_STREAMS)
    t_chain = waves * (MT_SEED_STEPS + words) * MT_STEP_CYCLES / CLOCK_HZ * 1e3
    if t_chain > out["bound_ms"]:
        out = dict(bound_ms=t_chain, bound_by="chain")
    return dict(out, words_per_stream=words, waves=waves)
