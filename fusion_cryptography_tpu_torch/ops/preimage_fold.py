"""The three preimage folds: CUDA kernels and their plain versions.

Port of the JAX package's ``ops/fold_pallas.py`` (TPU kernels
``_signer_a_call``, ``_signer_b_call`` and ``_agg_fold_call``), with its
names and contracts:

* :func:`signer_fold_a`: centered vk values + prehash digits -> the padded
  challenge preimage ``dst + "," + str(vk) + "," + str(i)`` and the
  ``str(vk)`` chunk (fusion.py:412-419);
* :func:`signer_fold_b`: the ``str(vk)`` chunk + prehash digits + centered
  challenge values -> the triple ``str((vk, i, challenge))``
  (fusion.py:586-589);
* :func:`agg_fold`: N triples of G groups, one strided view -> the padded
  aggregation preimage ``dst + "," + str(list(zip(...)))``
  (fusion.py:573-591).

Words are int32 carrying uint32 bit patterns, batch minor ([W, B]); every
output is zero past its length up to its full width.  The kernels are in
``csrc/preimage_fold.cu`` and read the op tables of
``interop/device_serial`` (``signer_fold_a_table`` ...).  On a CUDA tensor a
wrapper launches its kernel (or raises); on a CPU tensor it runs the plain
version, built from the word-assembly functions of ``interop/device_serial``.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from .. import kernels
from ..interop import device_serial as ds
from . import ragged_words as rw
from .upload import upload

PRE_ROWS = rw.words_for(ds.PREHASH_W)  # 20 words of prehash digits
AGG_OPS_HELD = 32  # op lengths an agg_fold block holds (csrc/preimage_fold.cu kAggOps)


def _pre_chunk(pre_w: torch.Tensor, pre_len: torch.Tensor) -> rw.WChunk:
    return rw.WChunk(buf=pre_w, length=pre_len.to(torch.int32), max_len=ds.PREHASH_W,
                     min_len=1)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def signer_fold_a_plain(params, vk2d_t: torch.Tensor, pre_w: torch.Tensor,
                        pre_len: torch.Tensor):
    """Plain version of :func:`signer_fold_a` (the str(vk) chunk is
    ceil(out_max / 4) words wide, the kernel's width)."""
    vk_chunk = ds.vk_chunk_w(params, vk2d_t)
    chb, cht = ds.fold_challenge_preimage_w(params, vk_chunk, _pre_chunk(pre_w, pre_len),
                                            pad_words=ds.signer_fold_a_table(params).widths[0])
    return chb, cht, vk_chunk.buf, vk_chunk.length


def signer_fold_b_plain(params, vk_buf: torch.Tensor, vk_len: torch.Tensor,
                        pre_w: torch.Tensor, pre_len: torch.Tensor, c_hat_t: torch.Tensor):
    """Plain version of :func:`signer_fold_b`."""
    vk_spec = ds.vk_body_spec(params)
    vk_chunk = rw.WChunk(buf=vk_buf, length=vk_len.to(torch.int32), max_len=vk_spec.out_max,
                         min_len=ds.spec_min_total(vk_spec, []))
    return ds.fold_triple_w(params, vk_chunk, _pre_chunk(pre_w, pre_len), c_hat_t)


def agg_fold_plain(params, n_signers: int, tbuf: torch.Tensor, tlen: torch.Tensor):
    """Plain version of :func:`agg_fold`."""
    tri_spec = ds.triple_spec(params)
    spec = ds.agg_preimage_spec(params, n_signers, tri_spec.out_max)
    bounds = [(ds.spec_min_total(tri_spec, [1]), tri_spec.out_max)] * n_signers
    return ds.assemble_chunks_words(
        spec, values=None, extras=[(tbuf[:, k], tlen[k]) for k in range(n_signers)],
        extra_bounds=bounds,
        pad_words=ds.agg_fold_table(params, n_signers).widths[0],
    )


def agg_op_at(ops: np.ndarray) -> np.ndarray:
    """int32[n_ops + 1, 2] of an aggregation op table: the const bytes and
    the extras before each op (and in all), the extras in op order being
    triples 0, 1, ...: op j starts at ``[j, 0]`` plus the bytes of the
    group's first ``[j, 1]`` triples."""
    out = np.zeros((len(ops) + 1, 2), np.int32)
    for j, (kind, _, arg, n, _, _) in enumerate(ops):
        out[j + 1] = out[j]
        if kind == ds.OP_CONST:
            out[j + 1, 0] += n
        else:
            if arg != out[j, 1]:
                raise ValueError(f"op {j} reads triple {arg}, not triple {out[j, 1]} in turn")
            out[j + 1, 1] += 1
    return out


@lru_cache(maxsize=16)
def _agg_op_at_on(params, n_signers: int, device: str) -> torch.Tensor:
    return upload(agg_op_at(ds.agg_fold_table(params, n_signers).ops), device)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_lanes(name: str, t: torch.Tensor, rows: int, B: int, device) -> None:
    kernels.require_cuda_tensor(t, name, torch.int32, 2 if rows else 1)
    want = (rows, B) if rows else (B,)
    if tuple(t.shape) != want or t.device != device:
        raise ValueError(f"{name}: expected int32{list(want)} on {device}, "
                         f"got {tuple(t.shape)} on {t.device}")


def signer_fold_a(params, vk2d_t: torch.Tensor, pre_w: torch.Tensor, pre_len: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """vk2d_t int32[2d, B] centered, pre_w int32[20, B] prehash digits,
    pre_len int32[B] -> (ch_wbuf int32[Wch, B], ch_total int32[B],
    vk_buf int32[Wvk, B], vk_len int32[B]): the challenge preimage padded to
    whole SHAKE256 rate blocks and the ``str(vk)`` chunk (kernel
    ``signer_fold_a``)."""
    if vk2d_t.device.type == "cpu":
        return signer_fold_a_plain(params, vk2d_t, pre_w, pre_len)
    return _signer_fold_a_launch(params, vk2d_t, pre_w, pre_len)


def _signer_fold_a_launch(params, vk2d_t, pre_w, pre_len, outs=None):
    """Kernel ``signer_fold_a`` into ``outs`` (its four outputs, for example
    pre-filled by a test) or new tensors."""
    table = ds.signer_fold_a_table(params)
    dev = vk2d_t.device
    B = vk2d_t.shape[-1]
    _check_lanes("vk2d_t", vk2d_t, 2 * params.degree, B, dev)
    _check_lanes("pre_w", pre_w, PRE_ROWS, B, dev)
    _check_lanes("pre_len", pre_len, 0, B, dev)
    ops, pool = table.on(dev)
    ch_words, vk_words = table.widths
    chb, cht, vkb, vkl = kernels.outputs(outs, ((ch_words, B), (B,), (vk_words, B), (B,)), dev)
    rc = kernels.library().fct_signer_fold_a(
        ops.data_ptr(), ops.shape[0], pool.data_ptr(), vk2d_t.data_ptr(), pre_w.data_ptr(),
        PRE_ROWS, pre_len.data_ptr(), B, chb.data_ptr(), ch_words, cht.data_ptr(),
        vkb.data_ptr(), vk_words, vkl.data_ptr(), kernels.cuda_stream(),
    )
    kernels.LAUNCHES["signer_fold_a"] += 1
    kernels.check_launch(rc, "signer_fold_a")
    return chb, cht, vkb, vkl


def signer_fold_b(params, vk_buf: torch.Tensor, vk_len: torch.Tensor, pre_w: torch.Tensor,
                  pre_len: torch.Tensor, c_hat_t: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``str(vk)`` chunk of :func:`signer_fold_a`, the prehash digits and
    the centered challenge NTT values int32[d, B] -> (tri_wbuf int32[Wtri, B],
    tri_total int32[B]) (kernel ``signer_fold_b``)."""
    if vk_buf.device.type == "cpu":
        return signer_fold_b_plain(params, vk_buf, vk_len, pre_w, pre_len, c_hat_t)
    return _signer_fold_b_launch(params, vk_buf, vk_len, pre_w, pre_len, c_hat_t)


def _signer_fold_b_launch(params, vk_buf, vk_len, pre_w, pre_len, c_hat_t, outs=None):
    """Kernel ``signer_fold_b`` into ``outs`` (its two outputs) or new
    tensors."""
    table = ds.signer_fold_b_table(params)
    dev = vk_buf.device
    B = vk_buf.shape[-1]
    vk_words = ds.signer_fold_a_table(params).widths[1]
    _check_lanes("vk_buf", vk_buf, vk_words, B, dev)
    _check_lanes("vk_len", vk_len, 0, B, dev)
    _check_lanes("pre_w", pre_w, PRE_ROWS, B, dev)
    _check_lanes("pre_len", pre_len, 0, B, dev)
    _check_lanes("c_hat_t", c_hat_t, params.degree, B, dev)
    ops, pool = table.on(dev)
    (tri_words,) = table.widths
    trib, trit = kernels.outputs(outs, ((tri_words, B), (B,)), dev)
    rc = kernels.library().fct_signer_fold_b(
        ops.data_ptr(), ops.shape[0], pool.data_ptr(), vk_buf.data_ptr(), vk_words,
        vk_len.data_ptr(), pre_w.data_ptr(), PRE_ROWS, pre_len.data_ptr(),
        c_hat_t.data_ptr(), B, trib.data_ptr(), tri_words, trit.data_ptr(),
        kernels.cuda_stream(),
    )
    kernels.LAUNCHES["signer_fold_b"] += 1
    kernels.check_launch(rc, "signer_fold_b")
    return trib, trit


def agg_fold(params, n_signers: int, tbuf: torch.Tensor, tlen: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The N triples of G groups as strided views, int32[Wtri, N, G] words
    (zero past their lengths) and int32[N, G] lengths -> (agg_wbuf
    int32[Wagg, G], agg_total int32[G]), the aggregation preimage padded to
    whole SHAKE256 rate blocks (kernel ``agg_fold``).  The kernel reads a
    row of 32 neighbouring groups of one triple at a time, fastest when a
    triple's groups are contiguous (signer-major lanes, as the pipeline lays
    them out: ``buf.view(Wtri, N, G)`` of a [Wtri, N*G] buffer).  Beyond 15
    signers (more ops than a block holds) a first launch sums each group's
    triple lengths into prefix offsets, so that each run of output rows
    starts at its first op."""
    if (tbuf.dim() != 3 or tlen.dim() != 2 or tuple(tbuf.shape[1:]) != tuple(tlen.shape)
            or tlen.shape[0] != n_signers or not tlen.shape[1]):
        raise ValueError(f"agg_fold: triples {tuple(tbuf.shape)} and lengths "
                         f"{tuple(tlen.shape)} are not [Wtri, {n_signers}, G] and "
                         f"[{n_signers}, G]")
    if tbuf.device.type == "cpu":
        return agg_fold_plain(params, n_signers, tbuf, tlen)
    return _agg_fold_launch(params, n_signers, tbuf, tlen)


def _agg_fold_launch(params, n_signers, tbuf, tlen, outs=None):
    """Kernel ``agg_fold`` (with its prefix launch beyond 15 signers) into
    ``outs`` (its two outputs, for example pre-filled by a test) or new
    tensors."""
    table = ds.agg_fold_table(params, n_signers)
    dev = tbuf.device
    tri_words = rw.words_for(ds.triple_spec(params).out_max)
    G = tlen.shape[1]
    if tbuf.shape[0] != tri_words:
        raise ValueError(f"agg_fold: triples of {tbuf.shape[0]} words, not {tri_words}")
    for name, t in (("tbuf", tbuf), ("tlen", tlen)):
        if t.device != dev or t.dtype != torch.int32:
            raise ValueError(f"agg_fold: {name} must be int32 on {dev}, got {t.dtype} on "
                             f"{t.device}")
    ops, pool = table.on(dev)
    (out_words,) = table.widths
    out, total = kernels.outputs(outs, ((out_words, G), (G,)), dev)
    op_at = prefix = None
    if ops.shape[0] > AGG_OPS_HELD:
        op_at = _agg_op_at_on(params, n_signers, str(dev))
        prefix = torch.empty((n_signers, G), dtype=torch.int32, device=dev)
    rc = kernels.library().fct_agg_fold(
        ops.data_ptr(), ops.shape[0], pool.data_ptr(), tbuf.data_ptr(), tlen.data_ptr(),
        n_signers, *tbuf.stride(), *tlen.stride(), tri_words, G, out.data_ptr(), out_words,
        total.data_ptr(), None if op_at is None else op_at.data_ptr(),
        None if prefix is None else prefix.data_ptr(), kernels.cuda_stream(),
    )
    kernels.LAUNCHES["agg_fold"] += 1 if prefix is None else 2
    kernels.check_launch(rc, "agg_fold")
    return out, total
