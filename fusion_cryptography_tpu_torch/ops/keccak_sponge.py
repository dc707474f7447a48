"""Fused SHAKE256 / SHA3-256 sponge: CUDA kernels and their plain versions.

Port of the JAX package's ``ops/keccak_pallas.py`` (TPU kernels
``_build_absorb`` and ``_build_squeeze``).  The kernels are in
``csrc/keccak_sponge.cu``; on a CUDA tensor the wrappers launch them (or
raise), on a CPU tensor they run the plain torch versions of ops/keccak.py.

Layouts are the JAX package's: payload words int32[max_blocks*34, B] with
bytes past each lane's length zero, block counts int32[B], the post-absorb
state int32[50, B] (word 2l = low half of lane l), XOF words int32[n, B].
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import kernels
from . import keccak
from .keccak import RATE_WORDS


def _pad_words_lm(words: torch.Tensor, lens: torch.Tensor,
                  pad_head: int = 0x1F) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-rate padding on packed words that are already zero past
    ``lens``: (padded words, block counts int32[B])."""
    return keccak.pad_words(words, lens, pad_head, assume_clean=True)


SCHEDULERS_PER_SM = 4  # warp schedulers of a Hopper SM


def absorb_team(batch: int, sms: int) -> int:
    """Threads per sponge of kernel ``keccak_absorb`` for ``batch`` sponges
    on a card of ``sms`` SMs.

    A warp's time is its longest sponge's chain of permutations, so below
    one warp per scheduler the card idles.  Two threads a sponge (16 sponges
    a warp) while their warps do not outnumber the schedulers; one thread
    (the 64-bit form, fewer instructions a sponge) above that."""
    return 2 if batch <= 16 * SCHEDULERS_PER_SM * sms else 1


def squeeze_team(batch: int, n_words: int, sms: int) -> int:
    """Threads per sponge of kernel ``keccak_squeeze``: the absorb's rule
    (:func:`absorb_team`), except that a squeeze of one rate block (at most
    34 words) has no permutation to share and takes one thread."""
    return 1 if n_words <= RATE_WORDS else absorb_team(batch, sms)


def absorb(words: torch.Tensor, n_blocks: torch.Tensor) -> torch.Tensor:
    """Padded words int32[max_blocks*34, B] + block counts int32[B] ->
    post-absorb state int32[50, B] (kernel ``keccak_absorb``)."""
    if words.device.type == "cpu":
        return keccak.absorb_padded(words, n_blocks)
    return _absorb_launch(words, n_blocks)


def _absorb_launch(words: torch.Tensor, n_blocks: torch.Tensor, team: Optional[int] = None,
                   state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One launch of kernel ``keccak_absorb``, at :func:`absorb_team`'s
    choice unless ``team`` is given, into a new tensor unless ``state`` (a
    contiguous int32[50, B] on the card) is given: chip_smoke and the tests
    hold both teams at every shape, on outputs they pre-fill."""
    kernels.require_cuda_tensor(words, "words", torch.int32, 2)
    kernels.require_cuda_tensor(n_blocks, "n_blocks", torch.int32, 1)
    rows, B = words.shape
    if rows % RATE_WORDS or n_blocks.shape[0] != B or n_blocks.device != words.device:
        raise ValueError(f"absorb: bad shapes words {tuple(words.shape)}, "
                         f"n_blocks {tuple(n_blocks.shape)}")
    if team is None:
        team = absorb_team(B, torch.cuda.get_device_properties(words.device).multi_processor_count)
    (state,) = kernels.outputs(None if state is None else [state], [(50, B)], words.device)
    lib = kernels.library()
    rc = lib.fct_keccak_absorb(words.data_ptr(), n_blocks.data_ptr(), state.data_ptr(),
                               rows // RATE_WORDS, B, team, kernels.cuda_stream())
    kernels.LAUNCHES["keccak_absorb"] += 1
    kernels.check_launch(rc, "keccak_absorb")
    return state


def squeeze(state: torch.Tensor, n_words: int) -> torch.Tensor:
    """Post-absorb state int32[50, B] -> XOF words int32[n_words, B]
    (kernel ``keccak_squeeze``)."""
    if state.device.type == "cpu":
        return keccak.shake256_squeeze_words(state, n_words)
    return _squeeze_launch(state, n_words)


def _squeeze_launch(state: torch.Tensor, n_words: int, team: Optional[int] = None,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One launch of kernel ``keccak_squeeze``, at :func:`squeeze_team`'s
    choice unless ``team`` is given, into a new tensor unless ``out`` (a
    contiguous int32[n_words, B] on the card) is given: chip_smoke and the
    tests hold both teams at every shape, on outputs they pre-fill."""
    kernels.require_cuda_tensor(state, "state", torch.int32, 2)
    if state.shape[0] != 50:
        raise ValueError(f"squeeze: state must be int32[50, B], got {tuple(state.shape)}")
    B = state.shape[1]
    if team is None:
        team = squeeze_team(B, n_words,
                            torch.cuda.get_device_properties(state.device).multi_processor_count)
    (out,) = kernels.outputs(None if out is None else [out], [(n_words, B)], state.device)
    rc = kernels.library().fct_keccak_squeeze(state.data_ptr(), out.data_ptr(), n_words, B,
                                              team, kernels.cuda_stream())
    kernels.LAUNCHES["keccak_squeeze"] += 1
    kernels.check_launch(rc, "keccak_squeeze")
    return out


def shake256_words_w(words: torch.Tensor, lens: torch.Tensor, n_words: int) -> torch.Tensor:
    """SHAKE256, packed words in and out: int32[max_blocks*34, B] payloads
    (zero past ``lens`` bytes) -> int32[n_words, B] XOF words (port of
    ``shake256_words_pallas_w``; feeds ops/xof_decode.decode_coeffs_w)."""
    padded, nb = _pad_words_lm(words, lens)
    return squeeze(absorb(padded, nb), n_words)


def sha3_256_words_w(words: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """SHA3-256 on the same kernels (domain byte 0x06): payload words (zero
    past ``lens``) -> digest words int32[8, B]."""
    padded, nb = _pad_words_lm(words, lens, 0x06)
    return squeeze(absorb(padded, nb), 8)


def shake256_words_plain(words: torch.Tensor, lens: torch.Tensor, n_words: int) -> torch.Tensor:
    """Plain torch SHAKE256 of the same contract as :func:`shake256_words_w`."""
    return keccak.shake256_squeeze_words(keccak.shake256_absorb_words(words, lens), n_words)
