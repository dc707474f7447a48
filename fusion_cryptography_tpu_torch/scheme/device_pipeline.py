"""Grouped aggregate-verify with the whole hash pipeline on the device.

Port of the JAX package's ``scheme/device_pipeline.py`` (packed-word hash
path, SHA3 prehash on the device, fused sponge, preimage folds, fused
observed sum + INTT + norm/weight):

  vks int32[G, N, 2, d], messages, aggs int32[G, rank, d]
    -> packing:     the messages as one flat byte stream, placed as the
                    sponge's padded ``dst + "," + message`` input
                    (place_preimages kernel)
    -> prehash:     SHA3-256 (sponge kernels) + 78-digit decimal render
                    (render_prehash kernel)
    -> signer hash: str(vk) chunk + challenge preimage (signer_fold_a
                    kernel), SHAKE256 (sponge kernels), challenge decode
                    (xof_decode kernel), challenge NTT (ntt_u kernel),
                    triple preimage (signer_fold_b kernel)
    -> group hash:  aggregation preimage (agg_fold kernel), SHAKE256,
                    per-signer alpha decode read in place from the blob
                    (xof_decode kernel)
    -> lattice:     alpha NTT (ntt_u kernel), observed sum + INTT +
                    norm/weight in one pass over the int32 aggregates
                    (intt_norm_weight kernel), then the target sum and the
                    verdicts (lattice_target kernel)

Two assemblies of the two signer preimages give the same bytes, chosen by
the ``assembly`` argument:

* ``"fold"`` (the default): the fold kernels of ops/preimage_fold.py, the
  JAX package's ``make_stages(pallas_folds=True)`` configuration, which
  render ``str(vk)`` once for both preimages;
* ``"spec"``: the generic spec assembler of ops/assemble_spec.py on the
  challenge and triple specs, the JAX package's
  ``make_stages(pallas_assembly=True)`` configuration (``str(vk)`` is
  rendered twice).

The group stage takes the ``agg_fold`` kernel in both.  On the CPU the
kernels' plain versions assemble the same bytes by prefix sum + scatter
(interop/device_serial, ops/ragged_words).

A call runs the JAX package's window schedule (``_verify_windows``): the
signer stage and the lattice in chunks of ``group_chunk`` complete groups
(every chunk holds all N signers of its groups), which bounds the working
set at any G, and the group stage over windows of whole chunks of about
``group_hash_chunk`` groups.  The host packs each chunk's messages while
the device runs the chunk before it: every constant table is built once
per device (ops/upload.py), every upload goes from pinned memory, and the
call does not wait for the device between its first launch and its
return.  Results are bool[G] tensors on the device the inputs live on: on
a CUDA device the kernels run, on the CPU their plain versions.  Numpy
inputs go to the card unless ``device="cpu"`` is given.
"""
from __future__ import annotations

from functools import lru_cache
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..hashing.xof import agg_block_len, challenge_xof_len
from ..interop import device_serial as ds
from ..ops import keccak_sponge as ks
from ..ops import place_preimages as pp
from ..ops import preimage_fold as pf
from ..ops import ragged_words as rw
from ..ops import xof_decode
from ..ops.assemble_spec import assemble_spec
from ..ops.intt_norm_weight import agg_check, agg_table
from ..ops.lattice_target import lattice_target
from ..ops.keccak import RATE
from ..ops.keccak_sponge import shake256_words_w
from ..ops.ntt import ntt_fwd_u
from ..ops.upload import input_device, upload
from ..params import Params
from ..utils.profiling import count, span

DEFAULT_GROUP_CHUNK = 8192
DEFAULT_GROUP_HASH_CHUNK = 16384
ASSEMBLIES = ("fold", "spec")


def _pad_rate(n: int) -> int:
    return -(-(n + 1) // RATE) * RATE  # +1: the pad byte may start a block


@lru_cache(maxsize=16)
def _geometries(params: Params) -> dict:
    bound_ch = max(1, min(params.modulus // 2, params.beta_ch))
    bound_ag = max(1, min(params.modulus // 2, params.beta_ag))
    n_xof_ch = challenge_xof_len(
        params.secpar, params.degree, params.modulus, params.beta_ch, params.omega_ch
    )
    geom_ch = xof_decode.geometry(
        params.secpar, params.modulus, params.degree, bound_ch, params.omega_ch
    )
    return dict(
        # the decoder never reads the stream tail: squeeze only the prefix
        n_xof_ch_used=xof_decode.consumed_bytes(geom_ch, n_xof_ch),
        block_ag=agg_block_len(
            params.secpar, params.degree, params.modulus, params.beta_ag, params.omega_ag
        ),
        geom_ch=geom_ch,
        geom_ag=xof_decode.geometry(
            params.secpar, params.modulus, params.degree, bound_ag, params.omega_ag
        ),
    )


def make_stages(params: Params, n_signers: int, assembly: str = "fold"):
    """The hash stages shared by grouped verify and the fleet build
    (scheme/device_setup.py), as (prehash_stage, signer_stage, group_stage);
    ``assembly`` ("fold" or "spec", see the module docstring) picks the
    signer preimages' kernels:

    prehash_stage(msg_words int32[rows, B], msg_blocks int32[B]; the placed
                  preimages of :func:`_message_tensors`)
        -> (pre_w int32[20, B], pre_len int32[B])
    signer_stage(vk2d_t int32[2d, B], pre_w int32[20, B], pre_len int32[B])
        -> (cc int32[B, d], c_hat_u int64[B, d], tbuf int32[Lt, B], tlen int32[B])
    group_stage(tbuf int32[Lt, N, G], tlen int32[N, G]; strided views, fastest
                with each signer's G triples contiguous)
        -> alphas int32[G, N, d]
    """
    if assembly not in ASSEMBLIES:
        raise ValueError(f"assembly must be one of {ASSEMBLIES}, got {assembly!r}")
    plan = params.plan
    F = plan.field
    g = _geometries(params)
    d = params.degree
    N = n_signers
    n_ch_words = -(-g["n_xof_ch_used"] // 4)
    ch_spec, tri_spec = ds.challenge_preimage_spec(params), ds.triple_spec(params)
    pre_bounds = [(1, ds.PREHASH_W)]
    n_ag_words = -(-(N * g["block_ag"]) // 4)
    agg_words = ds.agg_fold_table(params, N).widths[0]

    def prehash_stage(msg_words, msg_blocks):
        """Placed, padded preimage words (dst + "," + message) -> prehash
        digit words: SHA3-256 on the sponge kernels, then the decimal render."""
        with span("fct.prehash"):
            digest = ks.squeeze(ks.absorb(msg_words, msg_blocks), 8)
            chunk = rw.render_bigint_dec_w(digest)
            return chunk.buf, chunk.length

    def signer_stage(vk2d_t, pre_w, pre_len):
        """With "fold" the str(vk) chunk of signer_fold_a is folded into both
        the challenge preimage and the triple (JAX device_pipeline.py:261-275);
        with "spec" each preimage comes from its spec (JAX :276-297)."""
        with span("fct.signer"):
            pre_len = pre_len.to(torch.int32)
            extras = [(pre_w, pre_len)]
            if assembly == "spec":
                wbuf, total = assemble_spec(ch_spec, values=vk2d_t, extras=extras,
                                            extra_bounds=pre_bounds,
                                            pad_words=_pad_rate(ch_spec.out_max) // 4)
            else:
                wbuf, total, vk_buf, vk_len = pf.signer_fold_a(params, vk2d_t, pre_w, pre_len)
            xw = shake256_words_w(wbuf, total, n_ch_words)
            cc = xof_decode.decode_coeffs_rows(xw, g["geom_ch"], g["n_xof_ch_used"])  # [B, d]
            c_hat_u = ntt_fwd_u(plan, F.to_unsigned(cc))  # [B, d]
            c_hat_t = F.to_centered(c_hat_u).t().contiguous()
            if assembly == "spec":
                tbuf, tlen = assemble_spec(tri_spec, values=torch.cat([vk2d_t, c_hat_t]),
                                           extras=extras, extra_bounds=pre_bounds,
                                           pad_words=rw.words_for(tri_spec.out_max))
            else:
                tbuf, tlen = pf.signer_fold_b(params, vk_buf, vk_len, pre_w, pre_len, c_hat_t)
            return cc, c_hat_u, tbuf, tlen

    def group_stage(tbuf, tlen):
        with span("fct.group"):
            G = tlen.shape[1]
            count("group.signers", N)
            count("group.agg_words", agg_words)
            with span("fct.group.fold"):
                wbuf, total = pf.agg_fold(params, N, tbuf, tlen)
            with span("fct.group.sponge"):
                blob_w = shake256_words_w(wbuf, total, n_ag_words)  # [ceil(N*block/4), G]
            with span("fct.group.decode"):
                # signer k's stream starts at byte k * block_ag of the group's blob
                al = xof_decode.decode_coeffs_rows(blob_w, g["geom_ag"], g["block_ag"], N)
            return al.reshape(G, N, d)

    return prehash_stage, signer_stage, group_stage


class _Pipeline:
    """Stage functions and device constants for one (params, N, device,
    assembly)."""

    def __init__(self, params: Params, n_signers: int, device: torch.device,
                 assembly: str = "fold"):
        self.params = params
        self.N = n_signers
        self.plan = params.plan
        self.a_tab = agg_table(self.plan.field, params.public_challenge, device)  # [rank, d]
        self.prehash, self.signer, self.group = make_stages(params, n_signers, assembly)

    def challenges(self, vk: torch.Tensor, mw: torch.Tensor, mb: torch.Tensor):
        """The signer half alone, for B keys in any grouping: vk int32[B, 2, d],
        the keys' placed message words int32[rows, B] and block counts
        int32[B] (:func:`_message_tensors` with one signer) -> (cc int32[B,
        d], c_hat_u int64[B, d], triple words int32[Lt, B], lengths
        int32[B])."""
        B, d = vk.shape[0], self.params.degree
        return self._signer_hash(vk.reshape(B, 2 * d).t().contiguous(), mw, mb)

    def _signer_hash(self, vk2d_t: torch.Tensor, mw: torch.Tensor, mb: torch.Tensor):
        pre_w, pre_len = self.prehash(mw, mb)
        return self.signer(vk2d_t, pre_w, pre_len)

    def signer_chunk(self, vkc: torch.Tensor, mw: torch.Tensor, mb: torch.Tensor):
        """The signer half of one chunk of complete groups: vkc int32[c, N,
        2, d], the chunk's placed message words int32[rows, N*c] and block
        counts int32[N*c] in signer-major order (:func:`_message_tensors`
        with N signers) -> (cc int32[c*N, d], c_hat_u int64[c*N, d], triple
        words int32[Lt, N*c], triple lengths int32[N*c]).

        The stage runs on lanes in signer-major order (lane k*c + g is
        signer k of group g), so each signer's triples are contiguous
        columns of the triple buffer and agg_fold reads a row of a tile's
        groups as one 128-B segment; the per-lane stages do not care.  cc
        and c_hat_u go back to group-major order; the triples stay
        signer-major, as :meth:`group_window` takes them."""
        c, N = vkc.shape[0], self.N
        vk2d_t = vkc.reshape(c, N, -1).permute(2, 1, 0).reshape(-1, N * c).contiguous()
        cc, c_hat_u, tbuf, tlen = self._signer_hash(vk2d_t, mw, mb)

        def group_major(x):
            return x.reshape(N, c, -1).transpose(0, 1).reshape(c * N, -1)

        return group_major(cc), group_major(c_hat_u), tbuf, tlen

    def group_window(self, triples: Sequence[Tuple[torch.Tensor, torch.Tensor]]) -> torch.Tensor:
        """The group half over a window of consecutive chunks: ``triples``
        holds each chunk's signer-major (triple words int32[Lt, N*c],
        lengths int32[N*c]) from :meth:`signer_chunk`, in order -> alphas
        int32[Σc, N, d].  One chunk is read in place; several are joined
        into one signer-major buffer first (one ``torch.cat`` each for the
        words and the lengths)."""
        N = self.N
        tbs = [tb.reshape(tb.shape[0], N, -1) for tb, _ in triples]
        tls = [tl.reshape(N, -1) for _, tl in triples]
        if len(triples) == 1:
            return self.group(tbs[0], tls[0])
        return self.group(torch.cat(tbs, dim=2), torch.cat(tls, dim=1))

    def hash_chunk(self, vkc: torch.Tensor, mw: torch.Tensor, mb: torch.Tensor):
        """Both hash halves of one chunk of complete groups (arguments as
        :meth:`signer_chunk`'s) -> (cc int32[c*N, d], c_hat_u int64[c*N, d],
        alphas int32[c, N, d])."""
        cc, c_hat_u, tbuf, tlen = self.signer_chunk(vkc, mw, mb)
        return cc, c_hat_u, self.group_window([(tbuf, tlen)])

    def lattice(self, vks, c_hat_u, al, aggs):
        """Lattice verification (reference fusion.py:680-728 semantics) ->
        (eq, norm_ok, weight_ok) bool[G]."""
        params = self.params
        F = self.plan.field
        G, N, d = vks.shape[0], self.N, params.degree
        with span("fct.lattice"):
            alpha_u = ntt_fwd_u(self.plan, F.to_unsigned(al))  # [G, N, d]
            # observed [G, d] and the rows' norms and weights [G, rank]: one
            # kernel launch over the int32 aggregates on the card
            observed, nrm, wgt = agg_check(self.plan, self.a_tab, aggs.contiguous())
            # the target sum against observed, and the limits: one more
            # launch, or two with few groups of many signers
            with span("fct.lattice.target"):
                return lattice_target(F, vks, c_hat_u.reshape(G, N, d), alpha_u, observed, nrm,
                                      wgt, min(params.beta_vf, 2**31 - 1), params.omega_vf)


def get_pipeline(params: Params, n_signers: int, device: str,
                 assembly: str = "fold") -> _Pipeline:
    """The pipeline of one configuration, built once: callers that name the
    default assembly and callers that leave it out share it."""
    return _cached_pipeline(params, n_signers, device, assembly)


@lru_cache(maxsize=16)
def _cached_pipeline(params: Params, n_signers: int, device: str, assembly: str) -> _Pipeline:
    return _Pipeline(params, n_signers, torch.device(device), assembly)


@lru_cache(maxsize=16)
def _prefix_on(prefix: bytes, device: str) -> torch.Tensor:
    """The preimages' constant ``dst + ","`` bytes on a device, uploaded once."""
    return upload(np.frombuffer(prefix, np.uint8).copy(), device)


def _message_tensors(params: Params, messages: Sequence[str], device, n_signers: int = 1
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The prehash sponge's input for one chunk of B messages on
    ``device``: (words int32[rows, B], block counts int32[B], preimage byte
    lengths int32[B]) of the ``dst + "," + message`` preimages, padded for
    SHA3-256, lanes in the signer-major order of B / ``n_signers`` groups of
    ``n_signers`` (the natural order for one).

    The host writes the messages' offsets and bytes into one buffer (pinned
    for a CUDA device), straight from a list of ASCII ``str`` objects
    (``pp.direct_offsets``, ``pp.direct_buffer``), else from one encoded
    byte string (``pp.encode``, ``pp.stream_buffer``), and uploads it
    without waiting for the device; kernel ``place_preimages`` lays the
    words out there.  Counts the message bytes (``pack.payload_bytes``),
    the uploaded stream's (``pack.shipped_bytes``), the messages copied
    straight from their ``str`` (``pack.rows_direct``) and those encoded
    one by one because their chunk was not all ASCII
    (``pack.rows_fallback``)."""
    dev = torch.device(device)
    prefix = bytes(params.sign_pre_hash_dst) + b","
    pin = dev.type == "cuda"
    with span("fct.pack"):
        with span("fct.pack.encode"):
            direct = pp.direct_offsets(messages)
            if direct is None:
                data, lens, fallback = pp.encode(messages)
                n, longest = len(data), int(lens.max(initial=0))
            else:
                (host_offsets, longest), fallback = direct, 0
                n = int(host_offsets[-1])
            rows = pp.rows_for(len(prefix) + longest)
        count("pack.payload_bytes", n)
        count("pack.shipped_bytes", pp.stream_bytes(n))
        count("pack.rows_direct", 0 if direct is None else len(messages))
        count("pack.rows_fallback", fallback)
        with span("fct.pack.upload"):
            buf = (pp.stream_buffer(data, lens, pin) if direct is None
                   else pp.direct_buffer(messages, host_offsets, pin))
            buf = upload(buf, dev)
        with span("fct.pack.scatter"):
            offsets, stream = pp.split(buf, len(messages))
            return pp.place_preimages(_prefix_on(prefix, str(dev)), offsets, stream, n_signers,
                                      rows)


def windows(G: int, group_chunk: int, group_hash_chunk: int) -> List[Tuple[int, int, list]]:
    """The schedule of a call over G groups, the JAX package's
    ``_verify_windows``: [(wlo, whi, [(lo, hi) signer chunks])].  Signer
    chunks hold ``group_chunk`` complete groups (the last fewer); a window
    is ``max(group_chunk, (group_hash_chunk // group_chunk) * group_chunk)``
    groups, so it holds whole chunks."""
    gc = max(1, group_chunk)
    window = max(gc, (group_hash_chunk // gc) * gc)
    return [(wlo, min(G, wlo + window),
             [(lo, min(G, lo + gc, wlo + window)) for lo in range(wlo, min(G, wlo + window), gc)])
            for wlo in range(0, G, window)]


def _hash_windows(params: Params, P: _Pipeline, vks: torch.Tensor, msgs: List[str],
                  group_chunk: int, group_hash_chunk: int):
    """The hash half of a call, window by window: yields (wlo, [(lo, hi, cc
    int32[(hi-lo)*N, d], c_hat_u int64[(hi-lo)*N, d]) per signer chunk],
    alphas int32[whi-wlo, N, d]).

    The host packs chunk k's messages after chunk k-1's launches are queued,
    so the packing overlaps the device's work: nothing here waits for the
    device, and the uploads go from pinned memory."""
    N = P.N
    for wlo, _, chunks in windows(vks.shape[0], group_chunk, group_hash_chunk):
        signed, triples = [], []
        for lo, hi in chunks:
            mw, mb, _ = _message_tensors(params, msgs[lo * N:hi * N], vks.device, N)
            cc, c_hat_u, tbuf, tlen = P.signer_chunk(vks[lo:hi], mw, mb)
            signed.append((lo, hi, cc, c_hat_u))
            triples.append((tbuf, tlen))
        al = P.group_window(triples)
        del triples
        yield wlo, signed, al


def _verify_windows(params: Params, vks, messages: Sequence[str], aggs, group_chunk: int,
                    group_hash_chunk: int, want_coeffs: bool, device, assembly: str):
    with span("fct.verify"):
        dev = input_device(device, vks)
        vks = torch.as_tensor(vks, device=dev)
        aggs = torch.as_tensor(aggs, device=dev)
        G, N = vks.shape[0], vks.shape[1]
        msgs = messages if isinstance(messages, list) else list(messages)
        if len(msgs) != G * N:
            raise ValueError(f"need {G * N} messages, got {len(msgs)}")
        if G == 0:
            raise ValueError("need at least one group")
        P = get_pipeline(params, N, str(vks.device), assembly)
        outs, ccs, als = [], [], []
        for wlo, signed, al in _hash_windows(params, P, vks, msgs, group_chunk, group_hash_chunk):
            for lo, hi, cc, c_hat_u in signed:
                outs.append(P.lattice(vks[lo:hi], c_hat_u, al[lo - wlo:hi - wlo], aggs[lo:hi]))
                if want_coeffs:
                    ccs.append(cc.reshape(hi - lo, N, -1))
            if want_coeffs:
                als.append(al)
        eq, norm_ok, weight_ok = (torch.cat([o[k] for o in outs]) for k in range(3))
        if not want_coeffs:
            return eq, norm_ok, weight_ok
        return eq, norm_ok, weight_ok, torch.cat(ccs), torch.cat(als)


def verify_batch_device(params: Params, vks, messages: Sequence[str], aggs, *,
                        group_chunk: int = DEFAULT_GROUP_CHUNK,
                        group_hash_chunk: int = DEFAULT_GROUP_HASH_CHUNK, device=None,
                        assembly: str = "fold"):
    """Grouped verify with the full hash pipeline on one device.

    vks int32[G, N, 2, d] (sorted within each group by vk repr — the
    reference's canonical order, fusion.py:661-663); messages flat G*N
    strings in the same order; aggs int32[G, rank, d].  The device is
    ``device`` if given, else that of a ``vks`` tensor, else CUDA (numpy
    inputs; raises without a card).  ``assembly`` ("fold" or "spec") picks
    the signer preimages' kernels; both give the same bits.  Returns (eq,
    norm_ok, weight_ok) bool[G] tensors on that device.

    The signer stage and the lattice run in launches of ``group_chunk``
    complete groups, the group hash over windows of whole chunks of about
    ``group_hash_chunk`` groups (:func:`windows`); the host packs chunk
    k+1's messages while the device runs chunk k, and between its first
    launch and its return the call does not wait for the device.
    """
    return _verify_windows(params, vks, messages, aggs, group_chunk, group_hash_chunk, False,
                           device, assembly)


def derive_coeffs_device(params: Params, vks, messages: Sequence[str], aggs, *,
                         group_chunk: int = DEFAULT_GROUP_CHUNK, device=None,
                         assembly: str = "fold"):
    """Debug/test entry: (eq, norm_ok, weight_ok, challenge coefficients
    int32[G, N, d], alpha coefficients int32[G, N, d]); arguments as
    :func:`verify_batch_device`, the group hash over windows of one chunk
    (``group_hash_chunk = group_chunk``, as in the JAX package)."""
    return _verify_windows(params, vks, messages, aggs, group_chunk, group_chunk, True, device,
                           assembly)
