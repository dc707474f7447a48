"""PyTorch / CUDA port of fusion_cryptography_tpu for NVIDIA Hopper GPUs.

Fusion is an aggregatable post-quantum lattice signature scheme (eprint
2023/303).  This package ports the JAX package (``fusion_cryptography_tpu``,
the reference it is tested against) to PyTorch, with the TPU's Pallas
kernels rewritten as CUDA kernels for ``sm_90a`` (``csrc/``): the batched
tensor lifecycle, the grouped aggregate-verify and the on-device fleet
build.  It imports neither JAX nor the JAX package.

Entry points::

    params = fusion_setup(256, seed)
    keys = keygen(params, seeds)                    # on the card
    sigs = sign(params, keys, messages)
    agg = aggregate(params, keys.vk[:n], messages[:n], sigs.sig[:n])
    ok, reason = verify(params, keys.vk[:n], messages[:n], agg)
    verify_many(params, groups); verify_batch(params, vks, c, alpha, aggs)

    vks, msgs, aggs = build_fleet(params, n_groups, n_signers)  # on the card
    eq, norm_ok, weight_ok = verify_batch_device(params, vks, msgs, aggs)

``python -m fusion_cryptography_tpu_torch`` is the command line (setup,
keygen, sign, aggregate, verify over files in the JAX package's format,
``scheme/serde.py``).

``keygen`` and ``build_fleet`` run on the CUDA device unless given
``device="cpu"``; the other entry points run on the device of their tensors,
and numpy inputs go to the card unless given ``device="cpu"``.  Without a
card they raise.  Tensors on a CUDA device run the CUDA kernels (built by
nvcc at first use); tensors on the CPU run the kernels' plain torch versions.
"""
from .params import PRIME, Params, fusion_setup, params_from_numpy
from .scheme.device_pipeline import derive_coeffs_device, verify_batch_device
from .scheme.device_setup import build_fleet
from .scheme.lifecycle import (
    KeyBatch,
    SignatureBatch,
    aggregate,
    key_batch_from_numpy,
    keygen,
    sign,
    verify,
    verify_batch,
    verify_many,
)

__version__ = "0.1.0"

__all__ = [
    "Params",
    "fusion_setup",
    "PRIME",
    "params_from_numpy",
    "KeyBatch",
    "SignatureBatch",
    "key_batch_from_numpy",
    "keygen",
    "sign",
    "aggregate",
    "verify",
    "verify_batch",
    "verify_many",
    "build_fleet",
    "verify_batch_device",
    "derive_coeffs_device",
    "__version__",
]
