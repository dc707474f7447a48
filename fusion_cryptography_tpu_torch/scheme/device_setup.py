"""On-device fleet construction: keygen -> sort -> sign -> aggregate.

Port of the JAX package's ``scheme/device_setup.py``:

  host:   message byte packing
  device: the short secret coefficients (kernel ``sample_short``, one
          CPython-exact MT19937 a seed; on the CPU the C sampler of
          native/fusion_native.c), NTT keygen + vk = A·sk
          (fusion.py:338-373), the sort-by-str(vk)
          ranks inside each group (fusion.py:661-663), the verifier's hash
          stages (scheme/device_pipeline), sig = sk_l⊙c + sk_r
          (fusion.py:534-557), and the alpha-weighted aggregate
          (fusion.py:632-677); the products are scheme/ring.py's

With integer seeds the reference re-seeds per matrix entry, so all ``rank``
entries of a key are identical: sk/sig carry one polynomial per side (a
rank axis of 1), vk = (Σ_r A_r)·sk, and the aggregate is one polynomial per
group broadcast to the int32[G, rank, d] layout the verifier reads.
"""
from __future__ import annotations

from array import array
from itertools import repeat
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import native
from ..hashing.sampler import sample_short_poly_coeffs
from ..interop import device_serial as ds
from ..ops import ragged_words as rw
from ..ops.ntt import ntt_fwd_u
from ..ops.sample_short import sample_short
from ..ops.upload import resolve_device, upload
from ..params import Params
from ..utils.profiling import count, span
from . import device_pipeline as dp
from . import ring


def _uint64_seeds(seeds: Sequence[int]) -> Optional[np.ndarray]:
    """``seeds`` as uint64[B] when every one is an int s with 0 <= s and
    s + 1 < 2**64 (the seeds of the C sampler and of the kernel), else
    None."""
    if not all(map(isinstance, seeds, repeat(int))):
        return None
    try:
        arr = np.frombuffer(array("Q", seeds), dtype=np.uint64)
    except OverflowError:  # a seed below 0 or past 2**64 - 1
        return None
    return None if (arr == np.uint64(2**64 - 1)).any() else arr


def _sample_sk(params: Params, seeds: Sequence[int], device=None):
    """Short secret coefficients [B, 2, d]: left from seed, right from
    seed+1 (reference keygen, fusion.py:339-362).

    With no ``device``, host numpy int32 (the sharded step's inputs).  On a
    ``device``, an int32 tensor there: on a CUDA device, with every seed an
    int s with 0 <= s and s + 1 < 2**64, drawn by kernel ``sample_short``;
    else drawn on the host (the C sampler for such seeds, otherwise
    CPython's random) and uploaded as int8 (|c| <= beta_sk = 52).  Counts
    the seeds drawn each way (``sample.seeds_device``, ``sample.seeds_host``:
    two a key) while a profiler records."""
    with span("fct.sample"):
        B = len(seeds)
        d = params.degree
        # the C sampler and the kernel take uint64 seeds; others go through CPython's random
        as_u64 = _uint64_seeds(seeds)
        if as_u64 is not None and device is not None and torch.device(device).type == "cuda":
            count("sample.seeds_device", 2 * B)
            return sample_short(as_u64, d, params.beta_sk, params.omega_sk, params.modulus,
                                device)
        count("sample.seeds_host", 2 * B)
        if as_u64 is not None and native.available():
            interleaved = [x for s in seeds for x in (s, s + 1)]
            out = native.sample_short_batch(
                interleaved, d, params.beta_sk, params.omega_sk, params.modulus
            ).reshape(B, 2, d)
        else:
            out = np.empty((B, 2, d), dtype=np.int32)
            for b, s in enumerate(seeds):
                out[b, 0] = sample_short_poly_coeffs(params.modulus, d, params.beta_sk,
                                                     params.omega_sk, s)
                out[b, 1] = sample_short_poly_coeffs(params.modulus, d, params.beta_sk,
                                                     params.omega_sk, s + 1)
        if device is None:
            return out
        return upload(out.astype(np.int8), device).to(torch.int32)


KEY_BYTES = 12  # str(v) of an int32 (at most 11 bytes) and its terminator
KEY_BITS = 4  # a key byte's code: the bytes of str(vk)'s numbers and terminators are few


def _number_keys(params: Params, vk: torch.Tensor) -> torch.Tensor:
    """vk int32[B, 2, d] -> int64[B, 2d]: each rendered number's sort key,
    ``str(v) ++ terminator`` (the template byte after it,
    interop/device_serial.number_terminators) zero-padded to 12 bytes, each
    byte replaced by its rank among the bytes such keys hold (4 bits) and
    packed most significant first.  Two keys compare as integers as their
    byte strings compare lexicographically."""
    B, d = vk.shape[0], params.degree
    terms = ds.number_terminators(ds.vk_body_spec(params))
    alphabet = sorted({0, ord("-"), *range(ord("0"), ord("9") + 1), *terms.tolist()})
    if len(alphabet) > 1 << KEY_BITS:
        raise ValueError(f"str(vk) keys hold {len(alphabet)} distinct bytes, more than "
                         f"{1 << KEY_BITS}")
    lut = np.zeros(256, np.int64)
    lut[alphabet] = np.arange(len(alphabet))
    chars, length = rw.decimal_chars(vk.reshape(B, 2 * d))  # [B, 2d, 11], [B, 2d]
    keys = torch.nn.functional.pad(chars, (0, 1))  # [B, 2d, 12]
    keys.scatter_(2, length.unsqueeze(-1),
                  upload(terms, vk.device).view(1, 2 * d, 1).expand(B, 2 * d, 1))
    codes = upload(lut, vk.device)[keys.long()]
    shifts = upload(KEY_BITS * np.arange(KEY_BYTES - 1, -1, -1, dtype=np.int64), vk.device)
    return (codes << shifts).sum(-1)


def vk_sort_ranks(params: Params, vk: torch.Tensor, n_signers: int) -> torch.Tensor:
    """vk int32[B, 2, d] with groups of ``n_signers`` contiguous -> ranks
    int32[G, N]: each key's position in its group under the reference's
    stable sort by str(vk) (fusion.py:661-663).

    str(vk) order is the lexicographic order of the keys of its 2d numbers
    (:func:`_number_keys`) in turn.  A stable sort of each group by one
    number's key, from the last number to the first, gives that order, ties
    in the original order (the reference's stable sort): 2d sorts of the
    [G, N] keys, whatever N, and no wait for the device."""
    d = params.degree
    N = n_signers
    B = vk.shape[0]
    G = B // N
    keys = _number_keys(params, vk).reshape(G, N, 2 * d).permute(2, 0, 1).contiguous()
    order = torch.arange(N, device=vk.device).expand(G, N)
    for c in range(2 * d - 1, -1, -1):
        _, idx = torch.sort(keys[c].gather(1, order), dim=1, stable=True)
        order = order.gather(1, idx)
    rank = torch.empty((G, N), dtype=torch.int32, device=vk.device)
    return rank.scatter_(1, order, torch.arange(N, dtype=torch.int32,
                                                device=vk.device).expand(G, N))


def build_fleet(
    params: Params,
    n_groups: int,
    n_signers: int,
    *,
    seed0: int = 1,
    messages: Optional[Sequence[str]] = None,
    group_chunk: int = dp.DEFAULT_GROUP_CHUNK,
    device=None,
    assembly: str = "fold",
) -> Tuple[torch.Tensor, List[str], torch.Tensor]:
    """Build G aggregate-signature groups of N signers on ``device`` (CUDA
    when None; raises without a card, and only ``device="cpu"`` runs on the
    CPU).

    Key k of the flat batch uses seeds (seed0 + k, seed0 + k + 1).  Returns
    (vks int32[G, N, 2, d] sorted within groups by str(vk), messages flat
    G*N strings in that order, aggs int32[G, rank, d]) — valid under
    verify_batch_device and the reference verify.  The hash half runs on the
    verifier's stages, in the same ``group_chunk`` chunks, with the signer
    preimages of ``assembly`` ("fold" or "spec"; the same bits).
    """
    G, N = n_groups, n_signers
    B = G * N
    d = params.degree
    device = resolve_device(device)
    if messages is None:
        messages = [f"group{g}:msg{i}" for g in range(G) for i in range(N)]
    messages = list(messages)
    if len(messages) != B:
        raise ValueError(f"need {B} messages, got {len(messages)}")

    sk_hat, vk = ring.keygen(params, _sample_sk(params, range(seed0, seed0 + B), device),
                             device)

    ranks = vk_sort_ranks(params, vk, N).cpu().numpy()
    order = np.argsort(ranks, axis=1)  # ranks are a permutation per group
    flat = (order + np.arange(G)[:, None] * N).reshape(-1)
    s_msgs = [messages[i] for i in flat]
    oflat = torch.from_numpy(flat).to(device)
    sk_s = sk_hat.index_select(0, oflat)
    vks = vk.index_select(0, oflat).reshape(G, N, 2, d)

    F, q = params.plan.field, params.modulus
    P = dp.get_pipeline(params, N, str(device), assembly)
    aggs = torch.empty((G, params.rank, d), dtype=torch.int32, device=device)
    for lo in range(0, G, max(1, group_chunk)):
        hi = min(G, lo + group_chunk)
        mw, mb, _ = dp._message_tensors(params, s_msgs[lo * N : hi * N], device, N)
        _, c_hat_u, al = P.hash_chunk(vks[lo:hi], mw, mb)
        sig = ring.sign(q, F.to_unsigned(sk_s[lo * N : hi * N]).unsqueeze(2), c_hat_u)
        alpha = ntt_fwd_u(params.plan, F.to_unsigned(al))
        aggs[lo:hi] = F.to_centered(ring.aggregate(q, alpha, sig.view(hi - lo, N, 1, d)))
    return vks, s_msgs, aggs
