"""The one-time keys' short secret coefficients drawn on the card: kernel
``sample_short`` (``csrc/sample_short.cu``), one CPython-exact MT19937
stream a thread.

Key b's row 0 is ``hashing.sampler.sample_short_poly_coeffs(modulus,
degree, norm_bound, weight_bound, s)`` for s = ``seeds[b]``, and its row 1
the same from s + 1 (the reference's keygen, fusion.py:339-362).  Its plain
version is the host C sampler, ``native.sample_short_batch``
(``native/fusion_native.c``), which ``scheme/device_setup._sample_sk`` runs
for a CPU device.  The JAX package samples on the host and has no such
kernel.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np
import torch

from .. import kernels
from .upload import upload

MT_INIT_SEED = 19650218  # init_by_array starts from init_genrand(19650218)
SEED_LIMIT = 2**64 - 1  # a seed s takes s + 1 too, and both go up as uint64
INT32_MAX = 2**31 - 1


def mt_init_words() -> np.ndarray:
    """init_genrand(19650218): the MT19937 state words uint32[624] that
    every CPython seeding starts from."""
    mt = [MT_INIT_SEED]
    for i in range(1, 624):
        prev = mt[-1]
        mt.append((1812433253 * (prev ^ (prev >> 30)) + i) & 0xFFFFFFFF)
    return np.array(mt, dtype=np.uint32)


@lru_cache(maxsize=16)
def _init_table(device: str) -> torch.Tensor:
    return upload(mt_init_words().view(np.int32), device)


def sample_short(seeds: np.ndarray, degree: int, norm_bound: int, weight_bound: int,
                 modulus: int, device, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Keys' short coefficients int32[B, 2, degree] on the CUDA ``device``
    (into ``out`` when given): row 0 of key b from seed ``seeds[b]``, row 1
    from ``seeds[b] + 1``.  ``seeds`` is a host uint64[B] array below
    2**64 - 1; the bounds fit int32 and the modulus int64, as the C sampler
    takes them.  The seeds go up as one array; one launch."""
    if not isinstance(seeds, np.ndarray) or seeds.dtype != np.uint64 or seeds.ndim != 1:
        raise ValueError("sample_short: seeds must be a host uint64[B] array")
    if (seeds == np.uint64(SEED_LIMIT)).any():
        raise ValueError("sample_short: a seed s needs s + 1 < 2**64")
    if not (0 <= degree <= INT32_MAX and -INT32_MAX - 1 <= norm_bound <= INT32_MAX
            and -INT32_MAX - 1 <= weight_bound <= INT32_MAX and -2**63 <= modulus < 2**63):
        raise ValueError(f"sample_short: degree {degree}, bounds {norm_bound}, {weight_bound} "
                         f"or modulus {modulus} out of range")
    if max(0, min(degree, weight_bound)) > 0 and max(0, min(modulus // 2, norm_bound)) < 1:
        raise ValueError("empty range for randrange() (0, 0, 0)")
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"sample_short: expected a CUDA device, got {device}")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    B = seeds.shape[0]
    (out,) = kernels.outputs(None if out is None else [out], [(B, 2, degree)], device)
    if B == 0 or degree == 0:
        return out
    on_card = upload(seeds.view(np.int64), device)  # the kernel reads the bits as uint64
    rc = kernels.library().fct_sample_short(
        on_card.data_ptr(), B, _init_table(str(device)).data_ptr(), degree, norm_bound,
        weight_bound, modulus, out.data_ptr(), kernels.cuda_stream())
    kernels.LAUNCHES["sample_short"] += 1
    kernels.check_launch(rc, "sample_short")
    return out
