"""On-device construction of the reference's hashed ``str()`` preimages
(packed-word path).

Port of the word path of the JAX package's ``interop/device_serial.py``.  A
preimage is a fixed template (static text per parameter set) interleaved
with decimal renderings of tensor values and per-lane "extra" strings (the
prehash digits, or the aggregation XOF's triple strings).  A
:class:`PreimageSpec` is the compiled slot table; ``assemble_chunks_words``
evaluates it for a batch as one concatenation (ops/ragged_words), giving
packed words byte-identical to the JAX package's and so to the reference
``str()`` formats (fusion/fusion.py:417, :586-589).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import ragged_words as rw
from ..ops.ragged_words import DEC_W
from ..ops.upload import upload
from .serial import NTT_CLASS

_KIND_CONST, _KIND_NUMBER, _KIND_EXTRA = 0, 1, 2

# width of str(prehashed message int): SHA3-256 digest as an integer, <= 78
# decimal digits (fusion.py:405-409)
PREHASH_W = 78

# A cells run only absorbs short separators (the ", " between numbers).
_MAX_SEP = 8


@dataclass(frozen=True, eq=False)
class PreimageSpec:
    """Compiled slot table for one preimage layout."""

    template: np.ndarray  # uint8[T] — all constant bytes, concatenated
    kind: np.ndarray  # int32[S]
    arg: np.ndarray  # int32[S]: template offset / number index / extra index
    const_len: np.ndarray  # int32[S] (0 for non-const slots)
    num_numbers: int
    num_extras: int
    extra_widths: Tuple[int, ...]  # static per-extra field width
    out_max: int  # static bound on assembled length
    # evaluation nodes: ("const", bytes) | ("cells", sep, i0, count) | ("extra", e)
    nodes: Tuple[tuple, ...] = ()


class TemplateBuilder:
    """Accumulates const/number/extra slots into a :class:`PreimageSpec`."""

    def __init__(self):
        self._template = bytearray()
        self._slots: List[Tuple[int, int, int]] = []  # (kind, arg, const_len)
        self._extra_widths: List[int] = []
        self._num_numbers = 0

    def const(self, b: bytes) -> "TemplateBuilder":
        if b:
            if self._slots and self._slots[-1][0] == _KIND_CONST:
                k, off, ln = self._slots[-1]
                if off + ln == len(self._template):
                    self._template.extend(b)
                    self._slots[-1] = (k, off, ln + len(b))
                    return self
            self._slots.append((_KIND_CONST, len(self._template), len(b)))
            self._template.extend(b)
        return self

    def number(self) -> "TemplateBuilder":
        self._slots.append((_KIND_NUMBER, self._num_numbers, 0))
        self._num_numbers += 1
        return self

    def numbers(self, n: int, sep: bytes = b", ") -> "TemplateBuilder":
        for k in range(n):
            if k:
                self.const(sep)
            self.number()
        return self

    def extra(self, width: int) -> "TemplateBuilder":
        self._slots.append((_KIND_EXTRA, len(self._extra_widths), 0))
        self._extra_widths.append(width)
        return self

    def build(self) -> PreimageSpec:
        kind = np.array([s[0] for s in self._slots], dtype=np.int32)
        arg = np.array([s[1] for s in self._slots], dtype=np.int32)
        clen = np.array([s[2] for s in self._slots], dtype=np.int32)
        out_max = int(clen.sum()) + self._num_numbers * DEC_W + sum(self._extra_widths)
        template = np.frombuffer(bytes(self._template), dtype=np.uint8)
        return PreimageSpec(
            template=template,
            kind=kind,
            arg=arg,
            const_len=clen,
            num_numbers=self._num_numbers,
            num_extras=len(self._extra_widths),
            extra_widths=tuple(self._extra_widths),
            out_max=out_max,
            nodes=_compile_nodes(kind, arg, clen, template),
        )


def _compile_nodes(kind, arg, const_len, template) -> Tuple[tuple, ...]:
    """Group slots into evaluation nodes: const runs, uniform (sep + number)
    cell runs over consecutive values, and extra fields."""
    nodes = []
    pending = b""
    run: list = []  # open cell run: [sep, i0, count]

    def flush_pending():
        nonlocal pending
        if pending:
            nodes.append(("const", pending))
            pending = b""

    def flush_run():
        if run:
            nodes.append(("cells", run[0], run[1], run[2]))
            run.clear()

    for k in range(len(kind)):
        kd, a = int(kind[k]), int(arg[k])
        if kd == _KIND_CONST:
            cl = int(const_len[k])
            pending += bytes(template[a : a + cl].tobytes())
        elif kd == _KIND_NUMBER:
            if run and run[0] == pending and run[1] + run[2] == a:
                run[2] += 1
                pending = b""
            else:
                flush_run()
                if len(pending) > _MAX_SEP:
                    flush_pending()
                sep, pending = pending, b""
                run.extend([sep, a, 1])
        else:
            flush_run()
            flush_pending()
            nodes.append(("extra", a))
    flush_run()
    flush_pending()
    return tuple(nodes)


# ---------------------------------------------------------------------------
# Fusion preimage layouts (formats pinned by the reference's str() output);
# built once per parameter set and shared (specs are never mutated)
# ---------------------------------------------------------------------------


def _poly_ntt_body(b: TemplateBuilder, params, degree: int) -> None:
    b.const(
        (
            f"PolynomialNTTRepresentation(modulus={params.modulus}, "
            f"degree={params.degree}, root={params.root}, "
            f"inv_root={params.inv_root}, root_order={params.root_order}, values=["
        ).encode()
    )
    b.numbers(degree)
    b.const(b"])")


def _vk_body(b: TemplateBuilder, params) -> None:
    """OneTimeVerificationKey repr: numbers are vk[0] ++ vk[1] (2*degree)."""
    b.const(b"OneTimeVerificationKey(left_vk_hat=")
    b.const(f"GeneralMatrix(elem_class={NTT_CLASS}, matrix=[[".encode())
    _poly_ntt_body(b, params, params.degree)
    b.const(b"]]), right_vk_hat=")
    b.const(f"GeneralMatrix(elem_class={NTT_CLASS}, matrix=[[".encode())
    _poly_ntt_body(b, params, params.degree)
    b.const(b"]]))")


def _challenge_body(b: TemplateBuilder, params) -> None:
    b.const(b"SignatureChallenge(c_hat=")
    _poly_ntt_body(b, params, params.degree)
    b.const(b")")


@lru_cache(maxsize=32)
def challenge_preimage_spec(params) -> PreimageSpec:
    """dst + "," + str(vk) + "," + str(i) (fusion.py:412-419).
    values: vk[0] ++ vk[1] centered (2*degree); extra 0: prehash digits."""
    b = TemplateBuilder()
    b.const(bytes(params.sign_hash_dst) + b",")
    _vk_body(b, params)
    b.const(b",")
    b.extra(PREHASH_W)
    return b.build()


@lru_cache(maxsize=32)
def triple_spec(params) -> PreimageSpec:
    """str((vk, i, challenge)) — one signer's entry in the aggregation XOF
    preimage (fusion.py:586-589).  values: vk[0] ++ vk[1] ++ c_hat centered
    (3*degree); extra 0: prehash digits."""
    b = TemplateBuilder()
    b.const(b"(")
    _vk_body(b, params)
    b.const(b", ")
    b.extra(PREHASH_W)
    b.const(b", ")
    _challenge_body(b, params)
    b.const(b")")
    return b.build()


@lru_cache(maxsize=32)
def agg_preimage_spec(params, n_signers: int, triple_width: int) -> PreimageSpec:
    """dst + "," + str(list(zip(...))) around N pre-assembled triple buffers
    (fusion.py:573-591)."""
    b = TemplateBuilder()
    b.const(bytes(params.agg_xof_dst) + b",[")
    for k in range(n_signers):
        if k:
            b.const(b", ")
        b.extra(triple_width)
    b.const(b"]")
    return b.build()


@lru_cache(maxsize=32)
def vk_body_spec(params) -> PreimageSpec:
    """str(vk) alone (fusion.py:328-329) — the shared subtree of the challenge
    preimage and the triple."""
    b = TemplateBuilder()
    _vk_body(b, params)
    return b.build()


@lru_cache(maxsize=32)
def challenge_body_spec(params) -> PreimageSpec:
    """str(challenge) alone (fusion.py:382-383) — the triple's third field."""
    b = TemplateBuilder()
    _challenge_body(b, params)
    return b.build()


# ---------------------------------------------------------------------------
# Word-carrier assembly
# ---------------------------------------------------------------------------


def _spec_parts(spec: PreimageSpec, values, extras, extra_bounds) -> List[rw.Part]:
    """A spec's nodes as concatenation parts (static bytes, decimal cell
    runs, extra chunks)."""
    parts: List[rw.Part] = []
    for node in spec.nodes:
        if node[0] == "const":
            parts.append(node[1])
        elif node[0] == "cells":
            _, sep, i0, count = node
            parts.append(rw.cells_segment(values[i0 : i0 + count], sep))
        else:
            e = node[1]
            eb, el = extras[e]
            w = spec.extra_widths[e]
            if eb.shape[0] != rw.words_for(w):
                raise ValueError(
                    f"extra word width {eb.shape[0]} != ceil(spec width {w} / 4)"
                )
            lo, hi = (0, w) if extra_bounds is None else extra_bounds[e]
            parts.append(rw.WChunk(buf=eb, length=el.to(torch.int32), max_len=hi, min_len=lo))
    return parts


def _finish(parts: Sequence[rw.Part], B: int, device, out_max: int,
            pad_words: Optional[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Concatenate to ``pad_words`` (default ``words_for(out_max)``) words."""
    Ww = rw.words_for(out_max) if pad_words is None else pad_words
    by, length, _, _ = rw.concat_bytes(parts, B, device, out_bytes=4 * Ww)
    return rw.bytes_to_words(by), length


def _batch(values, extras) -> Tuple[int, torch.device]:
    t = values if values is not None else extras[0][0]
    return t.shape[-1], t.device


def assemble_chunks_words(
    spec: PreimageSpec,
    values=None,
    extras: Sequence[Tuple[torch.Tensor, torch.Tensor]] = (),
    extra_bounds: Optional[Sequence[Tuple[int, int]]] = None,
    pad_words: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Evaluate ``spec`` for a batch.

    values int32[num_numbers, B]; extras (int32[ceil(width/4), B] words, zero
    past the length; int32[B] lengths) pairs; extra_bounds optional static
    (min_len, max_len) per extra.  Returns (buf int32[Ww, B], total int32[B])
    with Ww = ``pad_words`` or ceil(out_max / 4).
    """
    if len(extras) != spec.num_extras:
        raise ValueError(f"spec needs {spec.num_extras} extras, got {len(extras)}")
    if values is not None and values.shape[0] != spec.num_numbers:
        raise ValueError(f"spec needs int32[{spec.num_numbers}, B] values")
    B, device = _batch(values, extras)
    parts = _spec_parts(spec, values, extras, extra_bounds)
    return _finish(parts, B, device, spec.out_max, pad_words)


def vk_chunk_w(params, vk2d_t: torch.Tensor) -> rw.WChunk:
    """The ``str(vk)`` body of int32[2d, B] centered keys as one word chunk —
    the subtree shared by the challenge preimage and the triple."""
    return rw.fold_chunks_w(_spec_parts(vk_body_spec(params), vk2d_t, (), None))


def fold_challenge_preimage_w(params, vk_chunk: rw.WChunk, pre_chunk: rw.WChunk,
                              pad_words: Optional[int] = None):
    """dst + "," + str(vk) + "," + str(i) from pre-built chunks -> (buf, total)."""
    B = vk_chunk.buf.shape[-1]
    parts = [bytes(params.sign_hash_dst) + b",", vk_chunk, b",", pre_chunk]
    return _finish(parts, B, vk_chunk.buf.device,
                   challenge_preimage_spec(params).out_max, pad_words)


def fold_triple_w(params, vk_chunk: rw.WChunk, pre_chunk: rw.WChunk,
                  c_hat_t: torch.Tensor):
    """str((vk, i, challenge)) from the shared vk chunk and the centered
    challenge NTT values int32[d, B] -> (buf, total)."""
    B = vk_chunk.buf.shape[-1]
    parts = (
        [b"(", vk_chunk, b", ", pre_chunk, b", "]
        + _spec_parts(challenge_body_spec(params), c_hat_t, (), None)
        + [b")"]
    )
    return _finish(parts, B, vk_chunk.buf.device, triple_spec(params).out_max, None)


def number_terminators(spec: PreimageSpec) -> np.ndarray:
    """uint8[num_numbers]: the template byte that FOLLOWS each rendered
    number (',' between values, ']' after a poly body's last value).

    Two reprs of one template compare lexicographically at the first
    differing rendered number; when one rendering is a proper prefix of the
    other the following template byte decides, so ``render(v) ++ terminator``
    is the per-number sort key (scheme/device_setup.vk_sort_ranks).
    """
    terms = np.zeros(spec.num_numbers, np.uint8)
    slots = list(zip(spec.kind, spec.arg, spec.const_len))
    for s, (k, a, _cl) in enumerate(slots):
        if k == _KIND_NUMBER:
            if s + 1 >= len(slots) or slots[s + 1][0] != _KIND_CONST:
                raise ValueError(
                    "number slot must be followed by template text for "
                    "terminator derivation"
                )
            terms[a] = spec.template[slots[s + 1][1]]
    return terms


def spec_min_total(spec: PreimageSpec, extra_min_lens: Sequence[int]) -> int:
    """Static lower bound on a spec's assembled length: every const byte, at
    least one digit per number, plus the given per-extra minimums."""
    return int(spec.const_len.sum()) + spec.num_numbers + sum(extra_min_lens)


# ---------------------------------------------------------------------------
# Op tables of the preimage kernels (ops/preimage_fold.py, ops/assemble_spec.py)
# ---------------------------------------------------------------------------

# op kinds; an op is int32[OP_FIELDS] = (kind, writer mask, a0, a1, a2, a3):
#   const: a0 = pool word offset, a1 = byte count
#   cells: a0 = separator's pool word offset, a1 = its byte count,
#          a2 = first value row, a3 = number of values (sep ++ str(v) each)
#   extra: a0 = extra index (a per-lane string in packed words)
OP_CONST, OP_CELLS, OP_EXTRA = 0, 1, 2
OP_FIELDS = 6


def _pad_rate_words(out_max: int) -> int:
    """Words of a preimage padded to whole SHAKE256 rate blocks (+1: the pad
    byte may start a block)."""
    return -(-(out_max + 1) // 136) * 34


@dataclass(frozen=True, eq=False)
class FoldTable:
    """A fold kernel's program: ops over a const-byte pool, evaluated per lane
    into one or two packed-word outputs (the ``writer mask`` bits), each
    zero-filled to its width."""

    pool: np.ndarray  # int32 words; every const and separator starts a word
    ops: np.ndarray  # int32[n_ops, OP_FIELDS]
    widths: Tuple[int, ...]  # output words per writer
    _device: dict = field(default_factory=dict, repr=False)

    def on(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """(ops, pool) tensors on ``device``, made once per device."""
        key = str(device)
        if key not in self._device:
            self._device[key] = (upload(self.ops, device), upload(self.pool, device))
        return self._device[key]


class _TableBuilder:
    def __init__(self):
        self._pool: List[int] = []
        self._at: dict = {}
        self._ops: List[Tuple[int, ...]] = []

    def _intern(self, data: bytes) -> int:
        if data not in self._at:
            self._at[data] = len(self._pool)
            padded = data + b"\0" * (-len(data) % 4)
            self._pool.extend(int(w) for w in np.frombuffer(padded, "<u4"))
        return self._at[data]

    def const(self, data: bytes, mask: int = 1) -> "_TableBuilder":
        if data:
            self._ops.append((OP_CONST, mask, self._intern(data), len(data), 0, 0))
        return self

    def extra(self, e: int, mask: int = 1) -> "_TableBuilder":
        self._ops.append((OP_EXTRA, mask, e, 0, 0, 0))
        return self

    def nodes(self, nodes, mask: int = 1) -> "_TableBuilder":
        """A spec's evaluation nodes, in order."""
        for node in nodes:
            if node[0] == "const":
                self.const(node[1], mask)
            elif node[0] == "cells":
                _, sep, i0, count = node
                if len(sep) > _MAX_SEP:
                    raise ValueError(f"cell separator of {len(sep)} bytes > {_MAX_SEP}")
                off = self._intern(sep) if sep else 0
                self._ops.append((OP_CELLS, mask, off, len(sep), i0, count))
            else:
                self.extra(node[1], mask)
        return self

    def build(self, widths: Sequence[int]) -> FoldTable:
        ops = np.asarray(self._ops, dtype=np.int32).reshape(-1, OP_FIELDS)
        pool = np.asarray(self._pool or [0], dtype=np.uint32).view(np.int32)
        return FoldTable(pool=pool, ops=ops, widths=tuple(widths))


@lru_cache(maxsize=32)
def signer_fold_a_table(params) -> FoldTable:
    """Writers: 1 = the challenge preimage dst + "," + str(vk) + "," + str(i)
    padded to whole rate blocks, 2 = the str(vk) chunk; extra 0 = the prehash
    digits.  Values: vk[0] ++ vk[1] centered (2*degree)."""
    b = _TableBuilder()
    b.const(bytes(params.sign_hash_dst) + b",", 1)
    b.nodes(vk_body_spec(params).nodes, 3)
    b.const(b",", 1).extra(0, 1)
    return b.build((_pad_rate_words(challenge_preimage_spec(params).out_max),
                    rw.words_for(vk_body_spec(params).out_max)))


@lru_cache(maxsize=32)
def signer_fold_b_table(params) -> FoldTable:
    """Writer 1 = the triple str((vk, i, challenge)); extra 0 = the str(vk)
    chunk, extra 1 = the prehash digits.  Values: c_hat centered (degree)."""
    b = _TableBuilder()
    b.const(b"(").extra(0).const(b", ").extra(1).const(b", ")
    b.nodes(challenge_body_spec(params).nodes).const(b")")
    return b.build((rw.words_for(triple_spec(params).out_max),))


@lru_cache(maxsize=32)
def agg_fold_table(params, n_signers: int) -> FoldTable:
    """Writer 1 = the aggregation preimage dst + "," + str(list(zip(...)))
    padded to whole rate blocks; extra k = signer k's triple."""
    spec = agg_preimage_spec(params, n_signers, triple_spec(params).out_max)
    return spec_table(spec, _pad_rate_words(spec.out_max))


@lru_cache(maxsize=64)
def spec_table(spec: PreimageSpec, pad_words: Optional[int] = None) -> FoldTable:
    """Any spec's program for the ``assemble_spec`` kernel: its nodes in
    order into one writer of ``pad_words`` words (default
    ``ceil(out_max / 4)``); value row k is the spec's number k, extra e its
    extra e."""
    width = rw.words_for(spec.out_max) if pad_words is None else pad_words
    return _TableBuilder().nodes(spec.nodes).build((width,))
