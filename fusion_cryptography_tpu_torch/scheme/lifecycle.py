"""Batched Fusion lifecycle on tensors: keygen -> sign -> aggregate -> verify.

Port of the JAX package's ``scheme/lifecycle.py``, its tensor API: the same
names, shapes, dtypes and reason strings, and bit-identical outputs.  A batch
of B one-time keys is a dense int32 tensor, and every stage runs on the
device of its tensors: on a CUDA device the port's kernels, on the CPU their
plain versions.

* keygen: short coefficients from the CPython-exact sampler (on the card
  kernel ``sample_short``), sk_hat = NTT(sk) (kernel ``ntt_centered``),
  vk = A·sk (fusion.py:338-373);
* sign: the challenge from the verifier's prehash and signer stages
  (scheme/device_pipeline), sig = sk_l ⊙ c + sk_r (fusion.py:534-557);
* aggregate: the signers in str(vk) order (device_setup.vk_sort_ranks), the
  alphas from the group stage, agg = Σ α̂ ⊙ sig (fusion.py:632-677);
* verify, verify_many, verify_batch: the pipeline's hash stages and lattice
  check, with the reference's reasons (fusion.py:680-728);
* derive_alphas_grouped: G groups' challenge and alpha coefficients from
  vk reprs and messages, through the grouped verify's device stages;
* for the object API (interop/api.py): the NTT-domain products
  ``sign_from_c_hat`` and ``aggregate_from_alpha_hat``, and ``derive_alphas``,
  the host hash route from repr strings (hashlib + the host decoder, the
  challenge NTT on the device).

The JAX package picks a host or a device hash route by batch size
(``device_hash_threshold``, ``device_bucket_threshold``); both give the same
bits.  The port has one route, the device stages, so it takes neither
keyword.

Devices: ``keygen`` runs on the card unless given ``device="cpu"``; the other
entry points run where their tensors are, and numpy inputs go to the card
unless given ``device="cpu"`` (``ops/upload.input_device``).  Without a
card they raise.  The NTT-domain products are scheme/ring.py's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..hashing.decode import decode_bytes_to_coefficients
from ..hashing.sampler import sample_short_poly_coeffs
from ..hashing.xof import agg_block_len, challenge_xof_len, hash_message_to_int, shake_digest
from ..interop import serial
from ..ops.ntt import ntt_fwd, ntt_fwd_u
from ..ops.upload import input_device, resolve_device, upload
from ..params import Params
from ..utils.profiling import span
from . import device_pipeline as dp
from . import device_setup as ds
from . import ring

# keys per pass of sign's challenge stages and signature product; the int64
# temporaries of one pass at secpar=256 are 1.4 GB each
SIGN_CHUNK = 8192

# Reference-exact verification failure strings (fusion.py:687-727).
REASON_TOO_MANY = "Too many keys."
REASON_LEN_MISMATCH = "Number of keys and messages must be equal."
REASON_TARGET = "Target doesn't match image of aggregate signature."
REASON_NORM = "Norm of aggregate signature too large."
REASON_WEIGHT = "Weight of aggregate signature too large."


@dataclass
class KeyBatch:
    """A batch of one-time key pairs as dense tensors on one device.

    sk_hat: int32[B, 2, rank, d] NTT-domain signing keys (left, right); from
            :func:`keygen` a rank-broadcast view of int32[B, 2, d], since
            every rank entry is the same polynomial
    vk:     int32[B, 2, d]       NTT-domain verification keys (left, right)
    """

    params: Params
    seeds: List[Optional[int]]
    sk_hat: torch.Tensor
    vk: torch.Tensor

    def __len__(self) -> int:
        return self.vk.shape[0]

    def vk_np(self) -> np.ndarray:
        return self.vk.cpu().numpy()

    def vk_strs(self) -> List[str]:
        vk = self.vk_np()
        return [serial.vk_str(self.params, vk[i]) for i in range(len(self))]


@dataclass
class SignatureBatch:
    """sig: int32[B, rank, d] NTT-domain signatures (rank x 1 matrices)."""

    params: Params
    sig: torch.Tensor

    def __len__(self) -> int:
        return self.sig.shape[0]


def key_batch_from_numpy(params: Params, src, *, device=None) -> KeyBatch:
    """The port's :class:`KeyBatch` from another implementation's: ``src``
    carries ``seeds``, ``sk_hat`` int32[B, 2, rank, d] and ``vk``
    int32[B, 2, d] as arrays numpy can read (for example the JAX package's
    KeyBatch).  The tensors go to the card unless ``device="cpu"``."""
    dev = resolve_device(device)
    return KeyBatch(
        params=params,
        seeds=list(src.seeds),
        sk_hat=torch.as_tensor(np.asarray(src.sk_hat, dtype=np.int32), device=dev),
        vk=torch.as_tensor(np.asarray(src.vk, dtype=np.int32), device=dev),
    )


def keygen(params: Params, seeds: Sequence[Optional[int]], *, device=None) -> KeyBatch:
    """Batched one-time keygen (fusion.py:338-373 per key) on ``device``
    (the card unless ``device="cpu"``).

    Key b samples its left side from ``seeds[b]`` and its right side from
    ``seeds[b] + 1``.  With integer seeds the reference's per-entry reseed
    makes all rank entries identical, so one polynomial per side is
    transformed and ``sk_hat`` is its rank-broadcast view.  ``seed=None`` is
    rejected as the reference rejects it (it fails on ``seed + 1``).
    """
    with span("fct.keygen"):
        seeds = list(seeds)
        for seed in seeds:
            if seed is None:
                raise TypeError(
                    "keygen requires an integer seed: the reference implementation "
                    "fails on seed=None at fusion.py:352 (seed + 1)"
                )
        dev = resolve_device(device)
        B, d, rank = len(seeds), params.degree, params.rank
        sk_hat, vk = ring.keygen(params, ds._sample_sk(params, seeds, dev), dev)
        if B:
            # the reference leaves CPython's global random in the state of its
            # last seeded sample (polynomials.py:447-448); the C sampler and
            # the kernel do not
            sample_short_poly_coeffs(params.modulus, d, params.beta_sk, params.omega_sk,
                                     seeds[-1] + 1)
        return KeyBatch(params=params, seeds=seeds,
                        sk_hat=sk_hat.unsqueeze(2).expand(B, 2, rank, d), vk=vk)


def sign(params: Params, keys: KeyBatch, messages: Sequence[str]) -> SignatureBatch:
    """Batched signing (fusion.py:534-557) on the device of ``keys``: one
    challenge per (vk, message) from the verifier's prehash and signer
    stages (``get_pipeline(params, 1)``), then sig = sk_l ⊙ c + sk_r for every
    rank entry, ``SIGN_CHUNK`` keys at a time."""
    with span("fct.sign"):
        msgs = list(messages)
        if len(msgs) != len(keys):
            raise ValueError("need exactly one message per key")
        B, d, rank = len(keys), params.degree, params.rank
        F = params.plan.field
        dev = keys.vk.device
        P = dp.get_pipeline(params, 1, str(dev))
        sig = torch.empty((B, rank, d), dtype=torch.int32, device=dev)
        for lo in range(0, B, SIGN_CHUNK):
            hi = min(B, lo + SIGN_CHUNK)
            mw, mb, _ = dp._message_tensors(params, msgs[lo:hi], dev)
            _, c_hat_u, _, _ = P.challenges(keys.vk[lo:hi], mw, mb)
            with span("fct.sign.product"):
                sk_u = F.to_unsigned(keys.sk_hat[lo:hi])  # [b, 2, rank, d]
                sig[lo:hi] = F.to_centered(ring.sign(params.modulus, sk_u, c_hat_u))
        return SignatureBatch(params=params, sig=sig)


def _sorted_group(params: Params, vks: torch.Tensor, messages: Sequence[str]):
    """One group's signers in the reference's order, the stable sort by
    str(vk) (fusion.py:661-663): (order int64[N], vks int32[1, N, 2, d],
    messages)."""
    msgs = list(messages)
    order = torch.argsort(ds.vk_sort_ranks(params, vks, vks.shape[0])[0])
    return order, vks[order].unsqueeze(0), [msgs[i] for i in order.tolist()]


def _group_hash(params: Params, vks_s: torch.Tensor, msgs_s: List[str]):
    """(pipeline, c_hat_u int64[N, d], alphas int32[1, N, d]) of one sorted
    group."""
    N = vks_s.shape[1]
    P = dp.get_pipeline(params, N, str(vks_s.device))
    mw, mb, _ = dp._message_tensors(params, msgs_s, vks_s.device, N)
    _, c_hat_u, al = P.hash_chunk(vks_s, mw, mb)
    return P, c_hat_u, al


def aggregate(params: Params, vks, messages: Sequence[str], sigs, *, device=None) -> torch.Tensor:
    """Aggregate N signatures (fusion.py:655-677): vks int32[N, 2, d],
    messages, sigs int32[N, rank, d] in any order -> int32[rank, d]."""
    dev = input_device(device, vks, sigs)
    vks = torch.as_tensor(vks, device=dev)
    sigs = torch.as_tensor(sigs, device=dev)
    if len(messages) != vks.shape[0] or sigs.shape[0] != vks.shape[0]:
        raise ValueError("need exactly one message and one signature per key")
    order, vks_s, msgs_s = _sorted_group(params, vks, messages)
    _, _, al = _group_hash(params, vks_s, msgs_s)
    return aggregate_from_alpha_hat(params, sigs[order], ntt_fwd(params.plan, al[0]))


def _reason(eq: bool, norm_ok: bool, weight_ok: bool) -> Tuple[bool, str]:
    if not eq:
        return False, REASON_TARGET
    if not norm_ok:
        return False, REASON_NORM
    if not weight_ok:
        return False, REASON_WEIGHT
    return True, ""


def verify(params: Params, vks, messages: Sequence[str], aggregate_signature, *,
           device=None) -> Tuple[bool, str]:
    """Verify one aggregate signature (fusion.py:680-728): vks int32[N, 2, d]
    in any order, messages, aggregate int32[rank, d] -> (ok, reason) with
    the reference's exact reason strings."""
    N = vks.shape[0]
    if N > params.capacity:
        return False, REASON_TOO_MANY
    if N != len(messages):
        return False, REASON_LEN_MISMATCH
    dev = input_device(device, vks, aggregate_signature)
    vks = torch.as_tensor(vks, device=dev)
    agg = torch.as_tensor(aggregate_signature, device=dev)
    _, vks_s, msgs_s = _sorted_group(params, vks, messages)
    P, c_hat_u, al = _group_hash(params, vks_s, msgs_s)
    eq, norm_ok, weight_ok = P.lattice(vks_s, c_hat_u, al, agg.unsqueeze(0))
    return _reason(bool(eq[0]), bool(norm_ok[0]), bool(weight_ok[0]))


def verify_many(params: Params, groups: Sequence[tuple], *, device=None) -> List[Tuple[bool, str]]:
    """Verify independent aggregates with any signer counts: ``groups`` holds
    (vks int32[N_i, 2, d], messages, agg int32[rank, d]) -> one (ok, reason)
    per group.  After the capacity and length guards the groups go in
    buckets by N; each bucket is sorted by ``vk_sort_ranks`` and verified by
    one ``verify_batch_device`` call."""
    results: List[Optional[Tuple[bool, str]]] = [None] * len(groups)
    by_n: dict = {}
    for gi, (vks, messages, _) in enumerate(groups):
        N = int(vks.shape[0])
        if N > params.capacity:
            results[gi] = (False, REASON_TOO_MANY)
        elif N != len(messages):
            results[gi] = (False, REASON_LEN_MISMATCH)
        else:
            by_n.setdefault(N, []).append(gi)
    if not by_n:
        return results
    live = [groups[gi] for gis in by_n.values() for gi in gis]
    dev = input_device(device, *(x for g in live for x in (g[0], g[2])))
    d = params.degree
    for N, gis in sorted(by_n.items()):
        Gb = len(gis)
        vks_b = torch.stack([torch.as_tensor(groups[gi][0], device=dev) for gi in gis])
        aggs_b = torch.stack([torch.as_tensor(groups[gi][2], device=dev) for gi in gis])
        order = torch.argsort(ds.vk_sort_ranks(params, vks_b.reshape(Gb * N, 2, d), N), dim=1)
        vks_s = torch.take_along_dim(vks_b, order[:, :, None, None], dim=1)
        msgs_s = [list(groups[gi][1])[j] for gi, row in zip(gis, order.tolist()) for j in row]
        eq, norm_ok, weight_ok = dp.verify_batch_device(params, vks_s, msgs_s, aggs_b)
        for gi, e, n, w in zip(gis, eq.tolist(), norm_ok.tolist(), weight_ok.tolist()):
            results[gi] = _reason(e, n, w)
    return results


def verify_batch(params: Params, vks, c_coeffs, alpha_coeffs, aggs, *, device=None):
    """Grouped verify of G aggregates from pre-derived coefficients: vks
    int32[G, N, 2, d] sorted within groups, challenge and alpha coefficients
    int8 or int32 [G, N, d], aggs int32[G, rank, d] -> (eq, norm_ok,
    weight_ok) bool[G] on the device."""
    dev = input_device(device, vks, c_coeffs, alpha_coeffs, aggs)
    vks, c, al, aggs = (torch.as_tensor(x, device=dev)
                        for x in (vks, c_coeffs, alpha_coeffs, aggs))
    F = params.plan.field
    P = dp.get_pipeline(params, vks.shape[1], str(vks.device))
    return P.lattice(vks, ntt_fwd_u(params.plan, F.to_unsigned(c)), al, aggs)


# ---------------------------------------------------------------------------
# The object API's pieces (JAX lifecycle.py:84-99, :183-250, :348-378)
# ---------------------------------------------------------------------------


def sign_from_c_hat(params: Params, sk_hat: torch.Tensor, c_hat: torch.Tensor) -> torch.Tensor:
    """NTT-domain signing, the challenge already transformed: sk_hat
    int32[..., 2, rank, d], c_hat int32[..., d] centered -> sig int32[...,
    rank, d] = sk_l ⊙ c + sk_r, on the device of the tensors."""
    F = params.plan.field
    return F.to_centered(ring.sign(params.modulus, F.to_unsigned(sk_hat), F.to_unsigned(c_hat)))


def aggregate_from_alpha_hat(params: Params, sigs: torch.Tensor,
                             alpha_hat: torch.Tensor) -> torch.Tensor:
    """NTT-domain aggregation: sigs int32[..., N, rank, d], alpha_hat
    int32[..., N, d] centered -> int32[..., rank, d] = Σ α̂ ⊙ sig, on the
    device of the tensors."""
    F = params.plan.field
    return F.to_centered(ring.aggregate(params.modulus, F.to_unsigned(alpha_hat),
                                        F.to_unsigned(sigs)))


def _decode(params: Params, b: bytes, norm_bound: int, weight_bound: int) -> np.ndarray:
    return decode_bytes_to_coefficients(b, log2_bias=params.secpar, modulus=params.modulus,
                                        degree=params.degree, norm_bound=norm_bound,
                                        weight_bound=weight_bound)


def derive_alphas_grouped(params: Params, vk_reprs_flat: Sequence[str],
                          messages_flat: Sequence[str], n_groups: int, group_size: int, *,
                          device=None) -> Tuple[np.ndarray, np.ndarray]:
    """The hash pipeline for G independent aggregation groups of N signers
    each, inputs already sorted within each group (the JAX package's
    ``derive_alphas_grouped``): (challenge coefficients int32[G, N, d], alpha
    coefficients int32[G, N, d]) as numpy arrays.

    The reprs are turned back into vk values (``serial.vk_values``: a repr
    that is not the ``str()`` of a vk raises ValueError) and go, with the
    messages, through the grouped verify's signer and group stages on
    ``device`` (the card unless ``device="cpu"``), in its chunks and
    windows (``device_pipeline.windows``)."""
    G, N, d = n_groups, group_size, params.degree
    reprs, msgs = list(vk_reprs_flat), list(messages_flat)
    if not len(reprs) == G * N == len(msgs):
        raise ValueError(f"need {G * N} vk reprs and messages, got {len(reprs)} and {len(msgs)}")
    dev = resolve_device(device)
    if G * N == 0:
        return np.zeros((G, N, d), np.int32), np.zeros((G, N, d), np.int32)
    vks = upload(serial.vk_values(params, reprs).reshape(G, N, 2, d), dev)
    P = dp.get_pipeline(params, N, str(dev))
    ccs, als = [], []
    for _, signed, al in dp._hash_windows(params, P, vks, msgs, dp.DEFAULT_GROUP_CHUNK,
                                          dp.DEFAULT_GROUP_HASH_CHUNK):
        ccs += [cc for _, _, cc, _ in signed]
        als.append(al)
    return (torch.cat(ccs).reshape(G, N, d).cpu().numpy(), torch.cat(als).cpu().numpy())


def derive_alphas(params: Params, vk_reprs: Sequence[str], messages: Sequence[str],
                  key_reprs: Optional[Sequence[str]] = None, *, device=None):
    """The hash_ag pipeline on already-sorted inputs, from repr strings:
    (prehashed ints, challenge coefficients int32[N, d], alpha coefficients
    int32[N, d]), the tensors on ``device`` (the card unless
    ``device="cpu"``), where the challenge NTT runs.

    ``key_reprs`` overrides the reprs hashed throughout (the challenge
    derivation and the zip-triples preimage alike — the reference's hash_ag
    uses the same key objects for both, fusion.py:632-652; the KAT generator
    hashes (sk, vk) tuple reprs)."""
    dev = resolve_device(device)
    reprs = list(key_reprs) if key_reprs is not None else list(vk_reprs)
    msgs = list(messages)
    N, d = len(reprs), params.degree
    pre = [hash_message_to_int(params.sign_pre_hash_dst, m) for m in msgs]
    n_ch = challenge_xof_len(params.secpar, d, params.modulus, params.beta_ch, params.omega_ch)
    cc = np.zeros((N, d), dtype=np.int32)
    for k, (r, i) in enumerate(zip(reprs, pre)):
        payload = params.sign_hash_dst + b"," + r.encode("utf-8") + b"," + str(i).encode()
        cc[k] = _decode(params, shake_digest(payload, n_ch), params.beta_ch, params.omega_ch)
    c_coeffs = torch.from_numpy(cc).to(dev)
    c_hat = ntt_fwd(params.plan, c_coeffs).cpu().numpy()
    chall_reprs = [serial.challenge_str(params, c_hat[k]) for k in range(N)]
    block = agg_block_len(params.secpar, d, params.modulus, params.beta_ag, params.omega_ag)
    body = serial.zip_triples_str(reprs, pre, chall_reprs)
    b = shake_digest(params.agg_xof_dst + b"," + body.encode("utf-8"), N * block)
    al = np.zeros((N, d), dtype=np.int32)
    for k in range(N):
        al[k] = _decode(params, b[k * block:(k + 1) * block], params.beta_ag, params.omega_ag)
    return pre, c_coeffs, torch.from_numpy(al).to(dev)
